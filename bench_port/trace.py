"""The traced run's record: the benchmark's spans and the device's work, as
``torch.profiler`` recorded them on one clock.

Spans are ``record_function`` ranges the benchmark opens around its calls
into the port (``bench.window``, ``bench.request``, and those a traffic file
asks for, such as ``bench.pagerank_inputs``).  Device intervals are the
kernels, copies and sets that ran on the card.  The raw events are read
from the profiler's result list (``kineto_results.events()``):
``key_averages()`` takes minutes on a window of 10^5 events.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

PREFIX = "bench."
WINDOW = PREFIX + "window"
REQUEST = PREFIX + "request"


def short_name(name: str) -> str:
    """A kernel's name without its argument list (a copy's as it is)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:160]


def _merge(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class DeviceOp:
    start: int   # ns
    end: int
    name: str
    kernel: bool  # False for copies and sets


class Trace:
    def __init__(self, spans, device_ops, host_ops):
        self.spans = spans              # {name: [(start, end)]} sorted
        self.device_ops = device_ops    # [DeviceOp] sorted by start
        self.host_ops = host_ops        # [(start, end, name)] sorted
        self._starts = [op.start for op in device_ops]
        self._busy = _merge((op.start, op.end) for op in device_ops)
        self._busy_starts = [s for s, _ in self._busy]
        self._host_starts = [s for s, _, _ in host_ops]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        spans = collections.defaultdict(list)
        device_ops, host_ops = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith(PREFIX) or e.is_user_annotation():
                    continue  # the profiler's device-side copy of a span
                low = name.lower()
                device_ops.append(DeviceOp(start, end, name, not (
                    low.startswith("memcpy") or low.startswith("memset"))))
            elif name.startswith(PREFIX):
                spans[name].append((start, end))
            else:
                host_ops.append((start, end, name))
        for v in spans.values():
            v.sort()
        device_ops.sort(key=lambda op: op.start)
        host_ops.sort()
        return cls(dict(spans), device_ops, host_ops)

    # -- spans ---------------------------------------------------------
    @property
    def window(self):
        return self.spans[WINDOW][0]

    def durations_ms(self, name: str) -> list[float]:
        """Durations of the spans ``name`` that started inside the window."""
        start, end = self.window
        return [(e - s) / 1e6 for s, e in self.spans.get(name, [])
                if start <= s < end]

    # -- device ----------------------------------------------------------
    def ops_in(self, start: int, end: int):
        """Device operations that started inside [start, end)."""
        lo = bisect.bisect_left(self._starts, start)
        hi = bisect.bisect_left(self._starts, end)
        return self.device_ops[lo:hi]

    def busy_ns(self, start: int, end: int) -> int:
        """Length of the union of device intervals clipped to [start, end)."""
        i = max(bisect.bisect_right(self._busy_starts, start) - 1, 0)
        total = 0
        for s, e in self._busy[i:]:
            if s >= end:
                break
            total += max(0, min(e, end) - max(s, start))
        return total

    def kernel_ns(self, spans) -> tuple[int, int]:
        """(summed kernel ns, kernel count) of kernels launched in spans."""
        ns = count = 0
        for s, e in spans:
            for op in self.ops_in(s, e):
                if op.kernel:
                    ns += op.end - op.start
                    count += 1
        return ns, count

    def host_ms_per_request(self):
        """Mean over request spans of (span - device busy inside it), ms."""
        spans = self.spans.get(REQUEST, [])
        if not spans:
            return None
        return sum((e - s) - self.busy_ns(s, e) for s, e in spans) / len(spans) / 1e6

    def idle_percent(self):
        start, end = self.window
        busy = self.busy_ns(start, end)
        return None if busy == 0 else 100.0 * (1.0 - busy / (end - start))

    # -- breakdown ---------------------------------------------------------
    def top_device_ops(self, k: int = 10):
        start, end = self.window
        by_name = collections.Counter()
        for op in self.ops_in(start, end):
            by_name[short_name(op.name)] += (min(op.end, end) - op.start) / 1e9
        return [[name, s] for name, s in by_name.most_common(k)]

    def _host_label(self, t: int) -> str:
        """The innermost host operation running at t, else the innermost
        benchmark span around t (the host then ran Python or NumPy)."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self.host_ops[max(0, i - 64):i]):
            if e >= t:
                return name
        inner, inner_start = "python", -1
        for name, spans in self.spans.items():
            j = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if j >= 0 and spans[j][1] >= t and spans[j][0] > inner_start:
                inner, inner_start = name + " (host code)", spans[j][0]
        return inner

    def idle_gaps(self, k: int = 10):
        """Idle seconds of the window summed by what the host was doing in
        the middle of each gap, the k largest."""
        start, end = self.window
        by_label = collections.Counter()
        t = start
        i = max(bisect.bisect_right(self._busy_starts, start) - 1, 0)
        for s, e in self._busy[i:] + [[end, end]]:
            s, e = min(max(s, start), end), min(e, end)
            if s > t:
                by_label[self._host_label((t + s) // 2)] += (s - t) / 1e9
            t = max(t, e)
            if t >= end:
                break
        return [[label, s] for label, s in by_label.most_common(k)]
