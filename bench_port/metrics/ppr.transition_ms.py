"""Per query: the self time of the port's span ``slt.pagerank.transition``
(``graph/pagerank.py::_transition_matrix``: the out-degrees and P^T's
COO), ``Matrix.from_coo`` left out.  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.self_ms(run, "slt.pagerank.transition")
