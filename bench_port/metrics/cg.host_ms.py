"""Per solve(method="cg") call: the port's span ``slt.solve``
(``solvers/dispatch.py::solve``) less the device's busy time inside it: the
port's own host time, where ``solve.host_ms`` reads the benchmark's
``bench.request`` span.  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.host_ms(run, "slt.solve")
