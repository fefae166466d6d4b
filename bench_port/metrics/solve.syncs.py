"""Blocking reads of device data per solve() call: the port's counter
``host_syncs`` (the initial residual, one per chunk, the two tail norms and
x), over the profiled requests (the traffic's ``trace_warmup`` and the
window's).  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.per_request_count(run, "host_syncs")
