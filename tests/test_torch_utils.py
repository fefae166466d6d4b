"""The port's utilities against the JAX package's, on the CPU.

Pure host code is held exactly: the complexity fits, the convergence
checker, the checkpoint file format (a checkpoint written by either package
loads in the other with the same fields) and the record layouts.  The warm
restarts (``resume``, ``update_rhs``) agree with the JAX package on the
solution within 1e-4 of its largest entry and with the f64 solve.  The
device counters of the profiling helpers are those of the CPU here
(``backend == "cpu"``, no device bytes); the card's are read by
``chip_smoke.py``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu import types as JT
from sublinear_tpu import utils as JU
from sublinear_tpu.utils import memory_profiler as JMP
from sublinear_tpu.utils import profiling as JP
from sublinear_tpu_torch import types as PT
from sublinear_tpu_torch import utils as U
from sublinear_tpu_torch.utils import memory_profiler as MP
from sublinear_tpu_torch.utils import profiling as P

from torch_parity import port_on_cpu

torch.set_num_threads(2)

FITS = [
    (np.array([100, 200, 400, 800]), lambda ns: 3e-6 * ns ** 2.0),
    (np.array([1e3, 1e4, 1e5, 1e6]), lambda ns: 0.2 * np.sqrt(ns)),
    (np.array([10, 20, 40]), lambda ns: 5.0 + 0 * ns),
    (np.array([100, 0, 400]), lambda ns: 1e-3 * ns),
    (np.array([50]), lambda ns: ns),
]


@pytest.mark.parametrize("case", range(len(FITS)))
def test_complexity_identical(case):
    ns, f = FITS[case]
    times = f(ns.astype(np.float64))
    got, want = U.fit_power_law(ns, times), JU.fit_power_law(ns, times)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want),
                                                    nan_ok=True)
    assert got.classification == want.classification
    for claimed in (0.5, 1.0, 2.0):
        g, w = (U.validate_complexity(ns, times, claimed),
                JU.validate_complexity(ns, times, claimed))
        assert json.dumps(g) == json.dumps(w)
    for k in (0.0, 0.5, 1.0, 1.5, 2.0, 3.14):
        assert U.classify_exponent(k) == JU.classify_exponent(k)


@pytest.mark.parametrize("window,history", [
    (5, [1.0, 0.5, 0.25, 0.125, 1e-7]),
    (4, [0.5] * 6),
    (10, [3.0, 0.0, 1e-3, 2.0, 1e-9]),
])
def test_convergence_checker_identical(window, history):
    got, want = U.ConvergenceChecker(window=window), JU.ConvergenceChecker(window=window)
    for r in history:
        assert dataclasses.asdict(got.check(r, 1e-6)) == \
            dataclasses.asdict(want.check(r, 1e-6))
    got.reset()
    assert got.history == []


def _system(n=100):
    a = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    p = slp.Matrix(slp.generate("tridiagonal", n).csr.add_diagonal(0.5))
    return a, p, slt.rhs(n, seed=1), np.linalg.solve(a.to_dense(), slt.rhs(n, seed=1))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_both(tmp_path, writer):
    a, p, b, x = _system()
    if writer == "port":
        r = slp.solve(p, b, method="jacobi", max_iterations=5, raise_on_fail=False)
        ckpt = U.checkpoint_of(r, b)
    else:
        r = slt.solve(a, b, method="jacobi", max_iterations=5, raise_on_fail=False)
        ckpt = JU.checkpoint_of(r, b)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save(path)
    for loaded in (U.SolverCheckpoint.load(path), JU.SolverCheckpoint.load(path)):
        np.testing.assert_array_equal(loaded.solution, ckpt.solution)
        np.testing.assert_array_equal(loaded.rhs, ckpt.rhs)
        assert (loaded.method, loaded.residual, loaded.iterations) == \
            (ckpt.method, ckpt.residual, ckpt.iterations) == ("jacobi",
                                                             r.residual, 5)
    # the loaded checkpoint resumes in the port as in the JAX package
    opts = dict(method="conjugate-gradient")
    got = U.resume(p, U.SolverCheckpoint.load(path),
                   slp.SolverOptions(epsilon=1e-8), **opts)
    want = JU.resume(a, JU.SolverCheckpoint.load(path),
                     slt.SolverOptions(epsilon=1e-8), **opts)
    assert got.converged and want.converged
    assert got.iterations - 5 >= 0 and want.iterations - 5 >= 0
    _close(got.solution, want.solution)
    _close(got.solution, x)


@pytest.mark.parametrize("method", [None, "neumann", "bmssp(cg-fallback)"])
def test_resume_matches(method):
    a, p, b, x = _system()
    ckpt = U.checkpoint_of(slp.solve(p, b, method="jacobi", max_iterations=5,
                                     raise_on_fail=False), b)
    jckpt = JU.SolverCheckpoint(**dataclasses.asdict(ckpt))
    b2 = b + 0.1
    got = U.resume(p, ckpt, method=method, b=b2)
    want = JU.resume(a, jckpt, method=method, b=b2)
    assert got.method == want.method
    assert got.converged == want.converged
    _close(got.solution, want.solution)
    _close(got.solution, np.linalg.solve(a.to_dense(), b2))


def test_update_rhs_matches():
    a, p, b, _ = _system(80)
    r1 = slp.solve(p, b, method="conjugate-gradient", epsilon=1e-8)
    jr1 = slt.solve(a, b, method="conjugate-gradient", epsilon=1e-8)
    idx, vals = np.array([3, 10]), np.array([0.05, -0.02])
    r2, b_new = U.update_rhs(p, r1, PT.DeltaUpdate(indices=idx, values=vals), b,
                             slp.SolverOptions(epsilon=1e-8))
    jr2, jb_new = JU.update_rhs(a, jr1, JT.DeltaUpdate(indices=idx, values=vals),
                                b, slt.SolverOptions(epsilon=1e-8))
    np.testing.assert_array_equal(b_new, jb_new)
    assert r2.converged and jr2.converged
    _close(r2.solution, jr2.solution)
    _close(r2.solution, np.linalg.solve(a.to_dense(), b_new))
    assert r2.iterations - r1.iterations <= r1.iterations


def test_record_and_log_match(tmp_path):
    n = 64
    a, p = slt.generate("tridiagonal", n), slp.generate("tridiagonal", n)
    b = slt.rhs(n)
    r, jr = (slp.solve(p, b, method="conjugate-gradient"),
             slt.solve(a, b, method="conjugate-gradient"))
    rec = U.record_solve(p, r, matvec_count=r.iterations + 1)
    jrec = JU.record_solve(a, jr, matvec_count=jr.iterations + 1)
    assert [f.name for f in dataclasses.fields(rec)] == \
        [f.name for f in dataclasses.fields(jrec)]
    assert (rec.backend, rec.chips) == ("cpu", 1)
    assert (rec.n, rec.nnz, rec.method, rec.matvec_count) == \
        (jrec.n, jrec.nnz, jrec.method, r.iterations + 1)
    assert rec.nnz_per_second > 0
    assert json.loads(rec.to_json())["method"] == "conjugate-gradient"
    log = U.ProfileLog(str(tmp_path / "log.jsonl"))
    log.add(p, r)
    log.add(p, r, matvec_count=3)
    lines = Path(tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == len(log.records) == 2
    assert json.loads(lines[1])["matvec_count"] == 3
    assert json.loads(lines[0])["matvec_count"] == max(r.iterations, 1)


def test_memory_info_and_trace_on_cpu(tmp_path):
    info = P.memory_info()
    assert info["devices"] == [{"id": 0, "platform": "cpu"}]
    assert sorted(info) == sorted(JP.memory_info())
    assert info["hostPeakRssKb"] > 0
    out = tmp_path / "trace"
    with P.device_trace(str(out)) as tr:
        slp.solve(slp.generate("tridiagonal", 32), slt.rhs(32),
                  method="conjugate-gradient")
    doc = json.loads(Path(tr.path).read_text())
    assert Path(tr.path).parent == out and doc["traceEvents"]


def test_memory_profiles_on_cpu():
    assert [f.name for f in dataclasses.fields(MP.MemoryProfile)] == \
        [f.name for f in dataclasses.fields(JMP.MemoryProfile)]
    with MP.profile_memory("alloc", n=3, nnz=4) as prof:
        blob = np.ones(1_000_000)
    del blob
    assert prof.backend == "cpu" and prof.host_peak_mb >= 8.0
    assert (prof.device_bytes_before, prof.device_peak_bytes,
            prof.device_delta_bytes) == (0, 0, 0)
    p = slp.generate("random-sparse", 300, seed=2, density=0.02)
    doc = MP.profile_solve(p, slt.rhs(300, seed=2)).to_dict()
    assert doc["operation"].startswith("solve[") and doc["n"] == 300
    assert doc["backend"] == "cpu" and doc["nnz"] == p.nnz
    sweep = MP.memory_sweep(sizes=(50, 120))
    assert [d["n"] for d in sweep] == [50, 120]


def test_utils_exports_match():
    assert sorted(U.__all__) == sorted(JU.__all__)
