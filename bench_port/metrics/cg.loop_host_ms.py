"""Per solve(method="cg") call: the port's span ``slt.loop`` around CG's
loop (``solvers/cg.py``: the initial residual, the chunks and their reads)
less the device's busy time inside it.  None where no request holds that
span: a port whose CG loop records none.  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    if not any(name == "slt.loop" for spans in program.request_spans(run.trace)
               for _, _, name in spans):
        return None
    return program.host_ms(run, "slt.loop")
