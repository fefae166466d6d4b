"""The least time of the sparse products the Neumann solves needed, at HBM
bandwidth, over the summed kernel time of the solve() calls, in %.  A solve
of k iterations needs k products with the off-diagonal part and one with
the whole matrix to verify its residual."""
from bench_port import roofline
from bench_port.trace import REQUEST


def read(run):
    d = run.data
    off = d.nnz - d.nnz_diag
    need = sum(roofline.least_seconds(
        k * roofline.spmv_bytes(d.n, off) + roofline.spmv_bytes(d.n, d.nnz),
        2 * (k * off + d.nnz))
        for r in run.requests for k in r.iterations)
    ns, _ = run.trace.kernel_ns(run.trace.spans.get(REQUEST, []))
    return roofline.share_percent(need, ns / 1e9)
