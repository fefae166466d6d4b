"""The least time of the sparse products the batch solves needed, at HBM
bandwidth, over the summed kernel time of the solve_batch() calls, in %.
A batch that reports k iterations needs k products of the whole matrix with
its (n, columns) block: k - 1 series terms and one verifying residual."""
from bench_port import roofline
from bench_port.trace import REQUEST


def read(run):
    d, cols = run.data, int(run.cell.traffic["columns"])
    need = sum(roofline.least_seconds(k * roofline.spmv_bytes(d.n, d.nnz, cols),
                                      2 * k * d.nnz * cols)
               for r in run.requests for k in r.iterations)
    ns, _ = run.trace.kernel_ns(run.trace.spans.get(REQUEST, []))
    return roofline.share_percent(need, ns / 1e9)
