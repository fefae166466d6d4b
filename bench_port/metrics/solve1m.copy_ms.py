"""``solve.copy_ms`` read in the 1m stream: the same reader, under a name
of its own, because ``bench_port/tests/test_program.py`` holds
``solve.copy_ms``'s cells to the 100k stream alone."""
from bench_port import lookup

read = lookup.load(lookup.METRICS_DIR, "solve.copy_ms").read
