"""Per solve_batch() call: the port's spans ``slt.to_device`` (B to
float32 and up) and ``slt.to_host`` (X down and to float64).  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.to_device", "slt.to_host")
