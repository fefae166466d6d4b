"""MB (10^6 bytes) copied between host and device per solve_batch() call:
the port's counters ``h2d_bytes`` (B) and ``d2h_bytes`` (X and each
iteration's column norms), over the profiled requests (the traffic's
``trace_warmup`` and the window's).  See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    count = program.per_request_count(run, "h2d_bytes", "d2h_bytes")
    return None if count is None else count / 1e6
