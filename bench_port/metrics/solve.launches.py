"""Device kernels launched per solve() call, whatever their names."""
from bench_port.trace import REQUEST


def read(run):
    spans = run.trace.spans.get(REQUEST, [])
    _, count = run.trace.kernel_ns(spans)
    return count / len(spans) if spans and count else None
