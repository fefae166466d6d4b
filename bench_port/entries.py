"""The general traffic generator's entries: what one request is.

A traffic file names its ``entry``; ``ENTRIES`` maps the three names here,
and ``find`` any other to the ``ENTRY`` of ``calls/<entry>.py``: a class
that hands the configuration's data to the port through its public API
(``Matrix.from_coo``, ``solve``, ``parallel.sharded.solve_batch``,
``graph.personalized_pagerank``), makes the pool of inputs from the run's
generator, issues request ``i``, and checks kept answers against the plain
reference (``reference.py``, or a file of the entry's own) once the window
has closed.

``impl``, where given, is called in the port's place with the same
arguments: ``control.py`` passes the reference in a lower precision.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import gen, lookup, reference


@dataclasses.dataclass
class Outcome:
    answers: int          # answers the request returned
    ok: int               # of those, the ones that report convergence
    iterations: list      # the iterations the port reported
    keep: object          # what check() needs of this request's answers


class Entry:
    def __init__(self, data, config, traffic, g, device, impl=None):
        # the port is imported on use: the benchmark's modules load without it
        import sublinear_tpu_torch

        self.port = sublinear_tpu_torch
        self.data, self.config, self.traffic = data, config, traffic
        self.device = device
        self.impl = impl
        self.pool = self.make_pool(g)

    def build(self):
        d = self.data
        self.system = self.port.Matrix.from_coo(d.rows, d.cols, d.vals,
                                                (d.n, d.n))

    def release(self):
        self.system = None

    def pool_item(self, i):
        return self.pool[i % len(self.pool)]

    def request(self, i) -> Outcome:
        """Request ``i``; one that the port ends with ``ConvergenceError``
        (its report of answers that did not converge) fails them all."""
        try:
            return self.answer(i)
        except self.port.ConvergenceError:
            return Outcome(self.answers_per_request, 0, [], None)


class Solve(Entry):
    """``solve(A, b, method=..., epsilon=...)`` on one RHS of the pool."""

    answers_per_request = 1

    def make_pool(self, g):
        return gen.uniform_block((int(self.traffic["pool"]), self.data.n), g,
                                 self.device)

    def call(self, A, b):
        return self.port.solve(A, b, method=self.traffic["method"],
                               epsilon=float(self.config["epsilon"]))

    def answer(self, i):
        b = self.pool_item(i)
        r = (self.impl or self.call)(self.system, b)
        return Outcome(1, int(bool(r.converged)), [int(r.iterations)],
                       (i % len(self.pool), r.solution))

    def check(self, kept):
        A = reference.Coo.of(self.data, self.device)
        worst = max(float(reference.relative_residuals(A, x, self.pool[j]))
                    for j, x in kept)
        return {"residual_max": worst}


class SolveBatch(Entry):
    """``solve_batch(A, B, SolverOptions(epsilon=...), method=...)`` on one
    (n, columns) block of the pool."""

    @property
    def answers_per_request(self):
        return int(self.traffic["columns"])

    def make_pool(self, g):
        return gen.uniform_block((int(self.traffic["pool"]), self.data.n,
                                  int(self.traffic["columns"])), g, self.device)

    def call(self, A, B):
        from sublinear_tpu_torch.parallel.sharded import solve_batch

        opts = self.port.SolverOptions(epsilon=float(self.config["epsilon"]))
        return solve_batch(A, B, opts, method=self.traffic["method"])

    def answer(self, i):
        results = (self.impl or self.call)(self.system, self.pool_item(i))
        return Outcome(len(results), sum(bool(r.converged) for r in results),
                       [max(int(r.iterations) for r in results)],
                       (i % len(self.pool), results))

    def check(self, kept):
        A = reference.Coo.of(self.data, self.device)
        worst = 0.0
        for j, results in kept:
            X = np.column_stack([r.solution for r in results])
            worst = max(worst, float(reference.relative_residuals(
                A, X, self.pool[j]).max()))
        return {"residual_max": worst}


class PersonalizedPageRank(Entry):
    """``personalized_pagerank(G, [s], damping=..., epsilon=...)`` from one
    source node s, drawn among the nodes with out-degree > 0."""

    answers_per_request = 1

    def make_pool(self, g):
        d = self.data
        sources = np.flatnonzero(np.bincount(d.rows, minlength=d.n) > 0)
        return gen.draw(sources, int(self.traffic["pool"]), g, self.device)

    def call(self, G, s):
        from sublinear_tpu_torch.graph import personalized_pagerank

        return personalized_pagerank(G, [s],
                                     damping=float(self.config["damping"]),
                                     epsilon=float(self.config["epsilon"]))

    def answer(self, i):
        s = int(self.pool_item(i))
        r = (self.impl or self.call)(self.system, s)
        return Outcome(1, int(bool(r.converged)), [int(r.iterations)],
                       (s, r.scores))

    def check(self, kept):
        T = reference.Transition.of(reference.Coo.of(self.data, self.device))
        damping = float(self.config["damping"])
        worst = max(reference.l1_error(x, reference.pagerank(T, s, damping))
                    for s, x in kept)
        return {"l1_err_max": worst}


ENTRIES = {"solve": Solve, "solve_batch": SolveBatch,
           "personalized_pagerank": PersonalizedPageRank}


def find(name: str) -> type[Entry]:
    """The class of entry ``name``: ``ENTRIES``, else the ``ENTRY`` of
    ``calls/<name>.py``, which has to be a subclass of ``Entry``."""
    cls = lookup.find(ENTRIES, "entries.ENTRIES", lookup.CALLS_DIR, name,
                      "ENTRY")
    if not (isinstance(cls, type) and issubclass(cls, Entry)):
        raise TypeError(f"ENTRY of {lookup.CALLS_DIR / name}.py is not a "
                        f"subclass of entries.Entry: {cls!r}")
    return cls
