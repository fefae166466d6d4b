"""The port's benchmark: ``run.py`` runs one cell of ``BENCHMARK.json``."""
