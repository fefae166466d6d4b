"""Share of the bytes uploaded to the device that went up through pinned
staging buffers, over the profiled requests: the port's counters
``pinned_h2d_bytes`` and ``h2d_bytes`` (``parallel/sharded.py``'s
``_prepare`` of B counts both), 100 staged / all.  None where the port
has no ``tracing`` module, has no ``pinned_h2d_bytes`` counter or
uploaded nothing."""


def read(run):
    try:
        from sublinear_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    pinned, uploaded = counts.get("pinned_h2d_bytes"), counts.get("h2d_bytes", 0)
    if pinned is None or uploaded == 0:
        return None
    return 100.0 * pinned / uploaded
