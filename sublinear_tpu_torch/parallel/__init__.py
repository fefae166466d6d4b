"""Batched and (later) distributed solvers, as in ``sublinear_tpu/parallel``.

Ported so far: the single-device ``sharded.solve_batch``.  The device mesh
and the row-sharded solvers are still to be ported (ROADMAP queue 1,
item 11).
"""
