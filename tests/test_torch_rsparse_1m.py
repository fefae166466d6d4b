"""The million-row headline system (``bench_port/configs/rsparse-1m.json``)
under ``solve(method="neumann")``, at the configuration's own CPU size,
held to a plain float64 reference (``bench_port/reference.py``).

The matrix is the benchmark's ``random-sparse`` kind at the ``small`` size
of the configuration: n = 20,000 with ~10 off-diagonal entries a row, as at
full size, built as the benchmark builds it, so that Neumann takes its
chain path (``neumann_chain``'s plain version on the CPU).  Plain torch
only: this module imports neither JAX nor the JAX package.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sublinear_tpu_torch as slp
from sublinear_tpu_torch import tracing
from bench_port import control, gen, reference, roofline

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "bench_port"
                     / "configs" / "rsparse-1m.json").read_text())
SMALL = {**CONFIG, **CONFIG["small"]}
EPS = CONFIG["epsilon"]
# The error a residual at EPS leaves: with M = D^-1 R, each row's
# off-diagonal |sum| is under 2/3 of its diagonal, so ||M||_inf < 2/3, and
# D^-1 A = I + M has ||(D^-1 A)^-1||_inf < 3 and ||D^-1 A||_inf < 5/3: a
# condition number under 5 in the diagonally scaled infinity norm.  The
# error is then a few times the scaled residual; 1e-5 = 10 EPS leaves room,
# and a bfloat16 solve misses it by far.
ERR_TOL = 1e-5
# float64 terms of the reference series: (2/3)^80 < 1e-14
REFERENCE_TERMS = 80
L2_BYTES = 50e6  # the H100's L2


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLT_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def system():
    g = gen.generator(2**35 + 21, "cpu")
    d = gen.make(SMALL, g, "cpu")
    A = slp.Matrix.from_coo(d.rows, d.cols, d.vals, (d.n, d.n))
    B = gen.uniform_block((3, d.n), g, "cpu")
    A64 = reference.Coo.of(d, "cpu")
    X = reference.neumann(A64, torch.from_numpy(B.T.copy()), REFERENCE_TERMS)
    return d, A, A64, B, X.numpy().T


def _forward_error(x, x_star) -> float:
    x = np.asarray(x, dtype=np.float64)
    return float(np.abs(x - x_star).max() / np.abs(x_star).max())


def test_the_small_size_keeps_ten_entries_a_row(system):
    d = system[0]
    off = round(SMALL["density"] * d.n * (d.n - 1))
    assert d.rows.size == off + d.n
    assert 9.5 < off / d.n < 10.5
    full = CONFIG["n"]
    assert round(CONFIG["density"] * full * (full - 1)) == 9_999_990


def test_the_full_size_csr_streams_past_l2():
    n = CONFIG["n"]
    off = round(CONFIG["density"] * n * (n - 1))
    # indptr, column indices and values of the off-diagonal part, without
    # the vectors a product reads and writes
    csr = roofline.spmv_bytes(n, off) - 8 * n
    assert csr == 4 * (n + 1) + 8 * off
    assert csr > L2_BYTES
    # and with the diagonal the port keeps apart: ~88 MB, 1.8 times L2
    assert 1.7 < (csr + 4 * n) / L2_BYTES < 1.8


@pytest.mark.parametrize("column", range(3))
def test_neumann_chain_solve_matches_the_float64_reference(system, column):
    _, A, A64, B, X = system
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r = slp.solve(A, B[column], method="neumann", epsilon=EPS)
    counts = tracing.counters()
    tracing.reset()
    assert r.method == "neumann" and r.converged
    assert counts["neumann_chain_calls"] >= 1
    assert counts["neumann_chain_steps"] == r.iterations
    res = float(reference.relative_residuals(A64, r.solution, B[column]))
    assert res <= EPS, res
    assert _forward_error(r.solution, X[column]) <= ERR_TOL


def test_a_bfloat16_solve_fails_both_tolerances(system):
    d, _, A64, B, X = system
    # the benchmark's control: the reference series in bfloat16
    A16 = reference.Coo.of(d, "cpu", torch.bfloat16)
    x = reference.neumann(A16, torch.from_numpy(B[0]).to(torch.bfloat16),
                          control.NEUMANN_TERMS).double().numpy()
    res = float(reference.relative_residuals(A64, x, B[0]))
    assert res > EPS and _forward_error(x, X[0]) > ERR_TOL, res
