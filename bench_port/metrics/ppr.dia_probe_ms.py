"""Per query: the port's span ``slt.matrix.dia_probe`` (``Matrix.op``'s
first look at P^T for the DIA route: the distinct offsets of its 5.1e6
entries by ``np.unique``).  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.matrix.dia_probe")
