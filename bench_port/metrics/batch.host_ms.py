"""Per solve_batch() call: the span around it less the device's busy time
in it."""


def read(run):
    return run.trace.host_ms_per_request()
