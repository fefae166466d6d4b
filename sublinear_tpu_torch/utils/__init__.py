"""Host utilities of the port.  ``lru`` is a copy of
``sublinear_tpu/utils/lru.py``; the JAX package's other utilities
(checkpoint, profiling, complexity, convergence) are still to be ported."""
