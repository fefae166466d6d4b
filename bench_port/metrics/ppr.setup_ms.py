"""Mean ms of graph/pagerank.py::pagerank_inputs per query: P^T, the
teleport vector and the dangling mask, built on the host and packed."""


def read(run):
    ms = run.trace.durations_ms("bench.pagerank_inputs")
    return sum(ms) / len(ms) if ms else None
