"""Share of the bytes read back from the device that landed in pinned host
memory, over the profiled requests: the port's counters
``pinned_d2h_bytes`` and ``d2h_bytes`` (``parallel/sharded.py``'s
``_download`` of X counts both), 100 pinned / all.  None where the port
has no ``tracing`` module, has no ``pinned_d2h_bytes`` counter or read
nothing back."""


def read(run):
    try:
        from sublinear_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    pinned, read_back = counts.get("pinned_d2h_bytes"), counts.get("d2h_bytes", 0)
    if pinned is None or read_back == 0:
        return None
    return 100.0 * pinned / read_back
