"""Personalized PageRank queries answered to the configuration's epsilon,
over all the seconds of the window."""


def read(run):
    return run.ok_answers / run.window_s
