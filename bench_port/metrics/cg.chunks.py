"""Chunks of CG steps per solve(method="cg") call: the port's counter
``cg_chain_calls`` (one per ``op.cg_chain`` call), over the profiled
requests; 0 means CG's chain path did not run (the per-step loop or
BiCGSTAB did).  None where no request holds CG's ``slt.loop`` span: a port
that does not count them.  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    if not any(name == "slt.loop" for spans in program.request_spans(run.trace)
               for _, _, name in spans):
        return None
    return program.per_request_count(run, "cg_chain_calls") or 0.0
