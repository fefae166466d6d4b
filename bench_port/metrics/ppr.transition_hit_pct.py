"""Share of the profiled PageRank calls that found P^T's operator and
dangling mask already built on their adjacency: the port's counters
``pagerank_transition_hits`` and ``pagerank_transition_builds``
(``graph/pagerank.py::_transition_inputs``), 100 hits / (hits + builds).
None where the port has no ``tracing`` module or moved neither counter."""


def read(run):
    try:
        from sublinear_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    hits = counts.get("pagerank_transition_hits", 0)
    builds = counts.get("pagerank_transition_builds", 0)
    if hits + builds == 0:
        return None
    return 100.0 * hits / (hits + builds)
