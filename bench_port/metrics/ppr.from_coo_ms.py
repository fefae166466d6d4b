"""Per query: the port's span ``slt.matrix.from_coo`` (``Matrix.from_coo``
on P^T's COO: the sort and the CSR build).  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.matrix.from_coo")
