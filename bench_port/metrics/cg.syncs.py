"""Blocking reads of device data per solve(method="cg") call: the port's
counter ``host_syncs`` (the initial residual, one per chunk of the chain,
x), over the profiled requests.  None where no request holds CG's
``slt.loop`` span: a port that does not count CG's reads.  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    if not any(name == "slt.loop" for spans in program.request_spans(run.trace)
               for _, _, name in spans):
        return None
    return program.per_request_count(run, "host_syncs")
