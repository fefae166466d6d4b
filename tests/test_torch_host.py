"""Host modules of the port against the JAX package: generators, CSR,
analysis, the operator router, the split diagonal, error codes — and the
rule that the port imports neither jax nor the JAX package."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu import native
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu_torch.errors import SolverError as PortSolverError

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)

GENERATED = [
    ("random-sparse", 1000, {"density": 1e-3}),
    ("random-sparse", 300, {"density": 0.1, "dominance": False}),
    ("diagonally-dominant", 200, {}),
    ("laplacian", 300, {}),
    ("tridiagonal", 500, {}),
    # > 200k entries: the JAX package's CSR comes from its native packer
    ("random-sparse", 20_000, {"density": 6e-4}),
]


@pytest.mark.parametrize("kind,n,params", GENERATED,
                         ids=[f"{k}-{n}" for k, n, _ in GENERATED])
def test_generate_bit_identical(kind, n, params):
    a = slt.generate(kind, n, seed=7, **params)
    p = slp.generate(kind, n, seed=7, **params)
    for name in ("indptr", "indices", "data"):
        ja, pa = getattr(a.csr, name), getattr(p.csr, name)
        assert ja.dtype == pa.dtype, name
        np.testing.assert_array_equal(ja, pa, err_msg=name)
    assert a.shape == p.shape


def test_native_packer_case_is_large():
    """The last GENERATED case must take the JAX package's native branch
    (more than 200k COO entries) for the bit-identity claim to cover it."""
    kind, n, params = GENERATED[-1]
    assert slt.generate(kind, n, seed=7, **params).nnz > 200_000
    assert native.available()


@pytest.mark.parametrize("kind", ["uniform", "ones", "unit"])
def test_rhs_bit_identical(kind):
    np.testing.assert_array_equal(slt.rhs(777, seed=3, kind=kind),
                                  slp.rhs(777, seed=3, kind=kind))


@pytest.mark.parametrize("kind,n,params", GENERATED[:5],
                         ids=[f"{k}-{n}" for k, n, _ in GENERATED[:5]])
def test_analyze_fields_match(kind, n, params):
    a = slt.analyze(slt.generate(kind, n, seed=11, **params))
    p = slp.analyze(slp.generate(kind, n, seed=11, **params))
    assert dataclasses.asdict(a) == dataclasses.asdict(p)


ROUTES = [
    # (description, n, density, prefer)
    ("dense", 1000, 1e-3, None),
    ("sparse", 5000, 1e-3, None),
    ("banded", 600, None, None),
    ("forced-dense", 5000, 1e-3, "dense"),
    ("forced-sparse", 600, 1e-2, "xbar"),
]


@pytest.mark.parametrize("desc,n,density,prefer", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_op_kind_matches(desc, n, density, prefer):
    if density is None:
        a = slt.generate("tridiagonal", n)
    else:
        a = slt.generate("random-sparse", n, seed=5, density=density)
    a = slt.Matrix(a.csr, prefer=prefer)
    p = slp.Matrix(slp.generate("tridiagonal", n).csr if density is None
                   else slp.generate("random-sparse", n, seed=5,
                                     density=density).csr,
                   prefer=prefer, device="cpu")
    want = {"xbar": "csr"}.get(a._op_kind(), a._op_kind())
    assert p._op_kind() == want


def test_sparse_route_has_no_size_ceiling():
    """The JAX package's TPU-geometry test is not ported: a large sparse
    matrix takes the CSR kernels whatever its size."""
    rows, cols, vals = dd_coo(5000, deg=3, seed=2)
    p = slp.Matrix.from_coo(rows, cols, vals, (5000, 5000), device="cpu")
    assert p._op_kind() == "csr"
    assert p._op_kind(batch=True) == "dense"


def test_inv_diag_bit_identical():
    n = 600
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=8), (n, n), prefer="xbar")
    jop, pop = a.op(), p.op()
    assert type(jop).__name__ == "XbarOperator"
    np.testing.assert_array_equal(np.asarray(jop.inv_diag)[:n],
                                  pop.inv_diag.numpy())
    np.testing.assert_array_equal(np.asarray(jop.diag)[:n], pop.diag.numpy())
    assert pop.nnz == jop.nnz and pop.tail_nnz == 0 and pop.diag_split


def test_dense_diag_arrays_bit_identical():
    n = 300
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=9), (n, n))
    jop, pop = a.op(), p.op()
    np.testing.assert_array_equal(np.asarray(jop.inv_diag)[:n],
                                  pop.inv_diag.numpy())
    np.testing.assert_array_equal(np.asarray(jop.data)[:n, :n],
                                  pop.data.numpy())


def _non_dd():
    return np.array([[1.0, 2.0, 0.0], [0.5, 1.0, 3.0], [0.0, 1.0, 1.0]])


ERROR_CASES = {
    "E001": lambda pkg: pkg.solve(pkg.Matrix.from_dense(_non_dd()),
                                  np.ones(3), method="neumann"),
    "E005": lambda pkg: pkg.solve(pkg.generate("random-sparse", 50, seed=1),
                                  np.ones(49), method="neumann"),
    "E008": lambda pkg: pkg.solve(pkg.generate("random-sparse", 50, seed=1),
                                  np.ones(50), method="neumann", epsilon=-1.0),
}


@pytest.mark.parametrize("code", sorted(ERROR_CASES))
def test_error_codes_match(code):
    with pytest.raises(JaxSolverError) as jexc:
        ERROR_CASES[code](slt)
    with pytest.raises(PortSolverError) as pexc:
        ERROR_CASES[code](slp)
    assert jexc.value.code == pexc.value.code == code
    assert type(jexc.value).__name__ == type(pexc.value).__name__


def test_memory_budget_raises_e007(monkeypatch):
    monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES", "1000")
    a = slp.generate("random-sparse", 100, seed=1)
    with pytest.raises(PortSolverError) as exc:
        a.op()
    assert exc.value.code == "E007"


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    return any(module == root or module.startswith(root + ".")
               for root in ("jax", "sublinear_tpu"))


def test_forbidden_rule_matches_names_exactly():
    assert _forbidden("jax.numpy") and _forbidden("sublinear_tpu.ops.xbar")
    assert not _forbidden("sublinear_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_port_imports_no_jax():
    root = Path(slp.__file__).resolve().parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    scripts = [root.parent / "chip_smoke.py",
               root.parent / "sweep_sparse_kernels.py",
               root.parent / "times.py"]
    for path in files + scripts:
        tree = ast.parse(path.read_text(), filename=str(path))
        bad = [m for m in _imported_modules(tree) if _forbidden(m)]
        assert not bad, f"{path.name} imports {bad}"


def test_device_never_takes_the_cpu_by_itself(monkeypatch):
    """With no argument, no SLT_TORCH_DEVICE and no card, resolving the
    device raises and names both ways to ask for the CPU."""
    from sublinear_tpu_torch import config

    monkeypatch.delenv("SLT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SLT_TORCH_DEVICE=cpu"):
        config.device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slp.Matrix.from_dense(np.eye(3))
    assert config.device("cpu") == torch.device("cpu")
    assert slp.Matrix.from_dense(np.eye(3), device="cpu").device.type == "cpu"
    monkeypatch.setenv("SLT_TORCH_DEVICE", "cpu")
    assert config.device() == torch.device("cpu")


def test_device_defaults_to_the_card(monkeypatch):
    from sublinear_tpu_torch import config

    monkeypatch.delenv("SLT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.device() == torch.device("cuda")


def test_solve_timer_syncs_only_its_device(monkeypatch):
    """A CPU solve never touches the card's synchronisation."""
    from sublinear_tpu_torch.solvers.base import SolveTimer

    def no_sync(*_):
        raise AssertionError("synchronised a card for a CPU solve")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with SolveTimer(torch.device("cpu")) as t:
        pass
    assert t.ms >= 0.0
