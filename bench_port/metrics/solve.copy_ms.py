"""Per solve() call: the port's spans ``slt.to_device`` (the upload of b)
and ``slt.to_host`` (the download of x and its conversion to float64).
See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.to_device", "slt.to_host")
