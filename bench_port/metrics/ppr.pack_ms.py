"""Per query: the port's span ``slt.matrix.pack`` (``Matrix.op`` on a cache
miss: the memory guard and ``pack_csr`` of P^T, its upload included).  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.matrix.pack")
