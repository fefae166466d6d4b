"""The port's own spans and counters (``sublinear_tpu_torch/tracing.py``),
read per request of a traced run.

Spans: the ``slt.*`` host events of ``run.trace.host_ops`` that start
inside a ``bench.request`` span are that request's; the profiler records
them on the clock of the device's work.  A span's self time is its
duration less the time its child ``slt.*`` spans cover.  A reader gives
the mean over the window's requests of the summed time per request (0 in a
request without the span), and None where no request holds a ``slt.*``
span: a port that records none.

Counters: ``sublinear_tpu_torch.tracing.counters()`` after the run.  The
port counts only while a profiler records, and the harness profiles the
traffic's ``trace_warmup`` requests and then the window's, once per
process; a counter is divided by that many requests.  None where the port
has no ``tracing`` module or never moved the counter.
"""
from __future__ import annotations

import bisect

from .trace import REQUEST, _merge

PREFIX = "slt."


def request_spans(trace) -> list[list[tuple]]:
    """For each request span, the port's spans that start inside it, as
    (start ns, end ns, name) sorted by start."""
    ours = [op for op in trace.host_ops if op[2].startswith(PREFIX)]
    starts = [s for s, _, _ in ours]
    return [ours[bisect.bisect_left(starts, s):bisect.bisect_left(starts, e)]
            for s, e in trace.spans.get(REQUEST, [])]


def self_ns(spans, i: int) -> int:
    """Span ``spans[i]``'s duration less the union of the other spans of
    ``spans`` that lie inside it."""
    s, e, _ = spans[i]
    kids = [(cs, ce) for j, (cs, ce, _) in enumerate(spans)
            if j != i and s <= cs and ce <= e]
    return (e - s) - sum(ke - ks for ks, ke in _merge(kids))


def _per_request_ms(run, names, measure):
    requests = request_spans(run.trace)
    if not any(requests):
        return None
    ns = sum(measure(spans, i) for spans in requests
             for i, (_, _, name) in enumerate(spans) if name in names)
    return ns / len(requests) / 1e6


def total_ms(run, *names):
    """Mean ms per request of the spans ``names``, end to end."""
    def measure(spans, i):
        s, e, _ = spans[i]
        return e - s
    return _per_request_ms(run, names, measure)


def self_ms(run, *names):
    """Mean ms per request of the spans ``names``, their children left
    out."""
    return _per_request_ms(run, names, self_ns)


def host_ms(run, *names):
    """Mean ms per request of the spans ``names`` less the device's busy
    time inside them (0 on the CPU)."""
    def measure(spans, i):
        s, e, _ = spans[i]
        return (e - s) - run.trace.busy_ns(s, e)
    return _per_request_ms(run, names, measure)


def per_request_count(run, *names):
    """The summed counters ``names`` per profiled request."""
    try:
        from sublinear_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not any(name in counts for name in names):
        return None
    requests = int(run.cell.traffic["trace_warmup"]) + len(run.requests)
    return sum(counts.get(name, 0) for name in names) / requests
