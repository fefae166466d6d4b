"""1 - (the union of device kernel, copy and set intervals / the traced
window), in %."""


def read(run):
    return run.trace.idle_percent()
