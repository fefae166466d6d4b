"""Per solve_batch() call: the self time of the port's span
``slt.solve_batch`` (``parallel/sharded.py::solve_batch``): B as float64,
the column norms and thresholds, the 128 results, its child spans
(``slt.to_device``, ``slt.loop``, ``slt.to_host``) left out.  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.self_ms(run, "slt.solve_batch")
