"""The least time of the sparse products the CG solves needed, at HBM
bandwidth, over the summed kernel time of the solve() calls, in %.  A CG
solve of k iterations needs k products with the whole matrix and one more
for its initial residual; the yardstick of ``solve_roofline``."""
from bench_port import roofline
from bench_port.trace import REQUEST


def read(run):
    d = run.data
    need = sum(roofline.least_seconds((k + 1) * roofline.spmv_bytes(d.n, d.nnz),
                                      2 * (k + 1) * d.nnz)
               for r in run.requests for k in r.iterations)
    ns, _ = run.trace.kernel_ns(run.trace.spans.get(REQUEST, []))
    return roofline.share_percent(need, ns / 1e9)
