"""Per solve() call: the port's span ``slt.loop`` (``solvers/base.py::
while_iterate``, the chunk loop) less the device's busy time inside it:
the host's launches and waits around the chunks.  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.host_ms(run, "slt.loop")
