"""Per solve() call: the self time of the port's span ``slt.solve``
(``solvers/dispatch.py::solve``): validation, the diagonal-dominance gate,
the threshold, the tail norms, the bounds and the outcome, its child spans
(``slt.to_device``, ``slt.loop``, ``slt.to_host``) left out.  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.self_ms(run, "slt.solve")
