"""Right-hand sides solved to the configuration's epsilon, as the port
reports it, over all the seconds of the window."""


def read(run):
    return run.ok_answers / run.window_s
