"""One run of one cell: data from the seed, set-up, the measured window, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric, data
generator or request kind is a file found by its name in ``BENCHMARK.json``
(``lookup.py`` says where).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import entries, gen, lookup, trace as trace_mod

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list        # [metric entry of BENCHMARK.json], end to end first


def load_cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    w = cells[name]
    config = json.loads(
        (lookup.CONFIGS_DIR / f"{w['config']}.json").read_text())
    traffic = json.loads(
        (lookup.TRAFFIC_DIR / f"{w['traffic']}.json").read_text())
    # a kind or an entry that is nowhere to be found fails before any data
    gen.kind(config["kind"])
    entries.find(traffic["entry"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    for m in e2e:
        m["kind"] = "end_to_end"
    for m in layer:
        m["kind"] = "per_layer"
    return Cell(name, int(w["chips"]), config, traffic, e2e + layer)


def reader(metric: str):
    return lookup.load(lookup.METRICS_DIR, metric).read


@dataclasses.dataclass
class Request:
    start: float
    end: float
    answers: int
    ok: int
    iterations: list


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    data: gen.Data
    setup_s: float
    requests: list
    window_s: float
    trace: object = None

    @property
    def ok_answers(self) -> int:
        return sum(r.ok for r in self.requests)


class Reservoir:
    """A uniform sample of ``size`` of the window's requests (Algorithm R),
    drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.default_rng(seed & gen.SEED_MASK)

    def offer(self, item):
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _spans(targets, device):
    """Wrap each ``module:function`` target in a benchmark span; a target
    marked ``sync`` ends its span when the device has finished its work."""
    from torch.profiler import record_function

    undo = []
    for t in targets:
        mod_name, fn_name = t["target"].split(":")
        mod = importlib.import_module(mod_name)
        original = getattr(mod, fn_name)

        def wrapped(*a, _f=original, _name=trace_mod.PREFIX + t["name"],
                    _sync_it=bool(t.get("sync")), **kw):
            with record_function(_name):
                out = _f(*a, **kw)
                if _sync_it:
                    _sync(device)
                return out

        functools.update_wrapper(wrapped, original)
        setattr(mod, fn_name, wrapped)
        undo.append((mod, fn_name, original))
    try:
        yield
    finally:
        for mod, fn_name, original in undo:
            setattr(mod, fn_name, original)


def _window(entry, seconds, sample, limit=None, span=None):
    """Closed loop, one caller: requests back to back until ``seconds`` have
    passed (the request running then finishes and counts) or ``limit``
    requests are done.  Returns ([Request], seconds from the first start
    to the last end)."""
    requests = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        with (span() if span else contextlib.nullcontext()):
            out = entry.request(i)
        t1 = time.perf_counter()
        requests.append(Request(t0, t1, out.answers, out.ok, out.iterations))
        if out.keep is not None:
            sample.offer(out.keep)
        i += 1
        if t1 >= deadline or (limit is not None and i >= limit):
            return requests, t1 - t_start


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, impl=None) -> dict:
    """Run ``cell`` once and return its result line (a dict).

    ``impl``, where given, is ``impl(data, cell, device)``, which returns the
    function that answers requests in the port's place (``control.py``)."""
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    g = gen.generator(seed, device)
    data = gen.make(config, g, device)
    entry = entries.find(traffic["entry"])(
        data, config, traffic, g, device,
        impl(data, cell, device) if impl else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    entry.build()
    for i in range(int(traffic["warmup"])):
        entry.request(i)
    _sync(device)
    setup_s = time.perf_counter() - t0

    sample = Reservoir(int(traffic["check_sample"]), seed)
    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with _spans(traffic.get("spans", []), device), \
                profile(activities=activities) as prof:
            for i in range(int(traffic["trace_warmup"])):
                entry.request(i)
            _sync(device)
            with record_function(trace_mod.WINDOW):
                requests, window_s = _window(
                    entry, seconds, sample,
                    limit=int(traffic["trace_requests"]),
                    span=lambda: record_function(trace_mod.REQUEST))
            _sync(device)
        tr = trace_mod.Trace.from_profile(prof)
    else:
        requests, window_s = _window(entry, seconds, sample)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell, data, setup_s, requests, window_s, tr)
    attempted = sum(r.answers for r in requests)
    failed = attempted - run.ok_answers
    numbers = entry.check(sample.items) if sample.items else {}
    numbers["unconverged"] = failed
    limits = config["checks"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(sample.items) and all(
        c["value"] <= c["limit"] for c in checks.values())

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if tr is not None:
        start, end = tr.window
        dev["busy_s"] = tr.busy_ns(start, end) / 1e9
        dev["window_s"] = (end - start) / 1e9
        line["breakdown"] = {"device_ops": tr.top_device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line
