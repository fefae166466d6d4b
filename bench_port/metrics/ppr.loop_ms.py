"""Mean ms of graph/pagerank.py::pagerank_run per query, to the end of its
device work."""


def read(run):
    ms = run.trace.durations_ms("bench.pagerank_run")
    return sum(ms) / len(ms) if ms else None
