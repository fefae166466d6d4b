"""Device ms per Neumann chain step: the summed time of the kernels whose
name holds ``neumann_chain`` in the request spans, per request, over the
port's counter ``neumann_chain_steps`` per profiled request (the steps
of the chains that ``op.neumann_chain`` ran, counted in
``ops/csr_spmv.py::neumann_chain``).  None where
the port does not count the steps or no chain kernel ran on a device.
See ``bench_port/program.py``."""
from bench_port import program
from bench_port.trace import REQUEST


def read(run):
    steps = program.per_request_count(run, "neumann_chain_steps")
    spans = run.trace.spans.get(REQUEST, [])
    ns = sum(op.end - op.start for s, e in spans for op in run.trace.ops_in(s, e)
             if op.kernel and "neumann_chain" in op.name)
    if not steps or not ns:
        return None
    return ns / len(spans) / 1e6 / steps
