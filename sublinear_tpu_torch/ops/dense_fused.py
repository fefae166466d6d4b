"""Dense fused iterations and their hand-written CUDA kernels, as in
``sublinear_tpu/ops/pallas_kernels.py``.

Each function runs a fixed block of ``iters`` iterations of one dense
product and a short elementwise epilogue, with the JAX package's names,
signatures and shapes: ``a`` (and ``pt``) is ``(n, n)``, ``diag`` and
``inv_diag`` are ``(n, 1)``, and ``b``, ``x0``, ``v`` and ``dangling`` are
``(n, B)``; all f32, except the bf16 halves of ``split_bf16``.

  ``dense_neumann_fused``          x0 + the series on the residual b - A x0
  ``dense_neumann_fused_bf16x3``   the same with A = A_hi + A_lo (bf16) and
                                   the three-pass product
  ``dense_jacobi_fused``           Jacobi sweeps
  ``dense_power_fused``            PageRank power steps with P^T

Kernels: ``csrc/dense_kernels.cu`` (one kernel family, built by
``ops/_kernels.py``).  Each function has a ``*_plain`` PyTorch twin beside
it.  A CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel calls: one per call of a wrapper that
reaches the card, which issues one cooperative device launch (the two
Neumann variants: A's rows held in shared memory for all ``iters + 1``
products, a grid barrier between each two), ``iters`` (Jacobi) or
``2 * iters`` (power) device launches, as one ``pallas_call`` ran the block
on the TPU.

``FUSED_MAX_NPAD`` and ``FUSED_HIGHEST_MAX_NPAD`` are the TPU's VMEM limits,
kept so that both packages choose the same path for a matrix.  They apply
to each side rounded up to 128, as the JAX package's operators pad it; the
port's operators are unpadded, and its kernels take any square n.
"""
from __future__ import annotations

import torch

from ..formats.ell import DenseOperator
from ._kernels import library, ptr, raise_on, stream_of

# the JAX package's VMEM budgets, on 128-rounded sides
FUSED_MAX_NPAD = 1536
FUSED_HIGHEST_MAX_NPAD = 768
LANE = 128

LAUNCHES = {"dense_neumann_fused": 0, "dense_neumann_fused_bf16x3": 0,
            "dense_jacobi_fused": 0, "dense_power_fused": 0}


def lanes(n: int) -> int:
    """``n`` rounded up to a multiple of 128 (at least 128): the JAX
    package's padded side."""
    return -(-max(int(n), 1) // LANE) * LANE


def fused_supported(op) -> bool:
    """Is the fused path applicable to this operator?  The JAX package's
    test on its padded sides."""
    return (isinstance(op, DenseOperator)
            and lanes(op.n_pad) <= FUSED_MAX_NPAD
            and lanes(op.n_pad) == lanes(op.m_pad))


def split_bf16(a: torch.Tensor):
    """(hi, lo) bf16 halves with a ~= hi + lo, rounded to nearest even."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


# ---------------------------------------------------------------- plain

def dense_neumann_fused_plain(a, diag, inv_diag, b, x0, iters: int = 16):
    term = inv_diag * (b - a @ x0)
    x = x0 + term
    for _ in range(iters):
        term = -inv_diag * (a @ term - diag * term)
        x = x + term
    return x


def _dot3(a_hi, a_lo, t):
    """a_hi th + a_hi tl + a_lo th, with a_hi and a_lo already f32."""
    th = t.to(torch.bfloat16).to(t.dtype)
    tl = (t - th).to(torch.bfloat16).to(t.dtype)
    return a_hi @ th + a_hi @ tl + a_lo @ th


def dense_neumann_fused_bf16x3_plain(a_hi, a_lo, diag, inv_diag, b, x0,
                                     iters: int = 16):
    ah, al = a_hi.to(torch.float32), a_lo.to(torch.float32)
    term = inv_diag * (b - _dot3(ah, al, x0))
    x = x0 + term
    for _ in range(iters):
        term = -inv_diag * (_dot3(ah, al, term) - diag * term)
        x = x + term
    return x


def dense_jacobi_fused_plain(a, diag, inv_diag, b, x0, iters: int = 16):
    x = x0.clone()
    for _ in range(iters):
        x = inv_diag * (b - (a @ x - diag * x))
    return x


def dense_power_fused_plain(pt, v, dangling, alpha: float, iters: int = 32):
    x = v.clone()
    for _ in range(iters):
        mass = torch.sum(dangling * x)
        x = (1.0 - alpha) * v + alpha * (pt @ x + mass * v)
    return x


# ---------------------------------------------------------------- kernels

def _check(iters: int, **operands):
    """Raise unless ``iters >= 0`` and each ``name=(tensor, dtype, shape)``
    is a contiguous tensor of that dtype and shape, all on one CUDA device;
    returns the device."""
    if int(iters) != iters or iters < 0:
        raise ValueError(f"iters must be a non-negative int, got {iters!r}")
    dev = next(iter(operands.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel operands on {dev}")
    for name, (t, dtype, shape) in operands.items():
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); the kernel takes "
                f"contiguous {dtype} {shape} on {dev}")
    return dev


def _system_shape(b) -> tuple[int, int]:
    """(n, B) of the right-hand block."""
    if b.dim() != 2 or min(b.shape) < 1:
        raise ValueError(f"vectors must be (n, B) with n, B >= 1, got "
                         f"{tuple(b.shape)}")
    return tuple(b.shape)


def _neumann(name, a, a_lo, diag, inv_diag, b, x0, iters):
    n, B = _system_shape(b)
    f32 = torch.float32
    adt = f32 if a_lo is None else torch.bfloat16
    halves = {} if a_lo is None else {"a_lo": (a_lo, adt, (n, n))}
    dev = _check(iters, a=(a, adt, (n, n)), **halves,
                 diag=(diag, f32, (n, 1)), inv_diag=(inv_diag, f32, (n, 1)),
                 b=(b, f32, (n, B)), x0=(x0, f32, (n, B)))
    lib = library("dense_kernels")
    x = torch.empty_like(b)
    t = torch.empty((2, n, B), dtype=f32, device=dev)
    t0 = t.data_ptr()  # the two term buffers, without building views
    LAUNCHES[name] += 1
    rc = lib.slt_dense_neumann(
        dev.index or 0, n, B, ptr(a), ptr(a_lo), ptr(diag), ptr(inv_diag),
        ptr(b), ptr(x0), int(iters), ptr(x), t0, t0 + 4 * n * B,
        stream_of(b))
    raise_on(rc, name, lib)
    return x


def dense_neumann_fused(a, diag, inv_diag, b, x0, iters: int = 16):
    """T fused Neumann iterations: x0 + sum_{k=0..T} M^k D^-1 (b - A x0),
    M = I - D^-1 A.  a: (n, n); diag, inv_diag: (n, 1); b, x0: (n, B)."""
    if a.device.type == "cpu":
        return dense_neumann_fused_plain(a, diag, inv_diag, b, x0, iters)
    return _neumann("dense_neumann_fused", a, None, diag, inv_diag, b, x0,
                    iters)


def dense_neumann_fused_bf16x3(a_hi, a_lo, diag, inv_diag, b, x0,
                               iters: int = 16):
    """``dense_neumann_fused`` with A = a_hi + a_lo (``split_bf16``) and the
    product a_hi th + a_hi tl + a_lo th of the JAX package's bf16x3 path."""
    if a_hi.device.type == "cpu":
        return dense_neumann_fused_bf16x3_plain(a_hi, a_lo, diag, inv_diag, b,
                                                x0, iters)
    return _neumann("dense_neumann_fused_bf16x3", a_hi, a_lo, diag, inv_diag,
                    b, x0, iters)


def dense_jacobi_fused(a, diag, inv_diag, b, x0, iters: int = 16):
    """T Jacobi sweeps x <- D^-1 (b - (A - D) x) from x0."""
    if a.device.type == "cpu":
        return dense_jacobi_fused_plain(a, diag, inv_diag, b, x0, iters)
    n, B = _system_shape(b)
    f32 = torch.float32
    dev = _check(iters, a=(a, f32, (n, n)), diag=(diag, f32, (n, 1)),
                 inv_diag=(inv_diag, f32, (n, 1)), b=(b, f32, (n, B)),
                 x0=(x0, f32, (n, B)))
    if iters == 0:
        return x0.clone()
    lib = library("dense_kernels")
    xs = torch.empty((2, n, B), dtype=f32, device=dev)
    LAUNCHES["dense_jacobi_fused"] += 1
    rc = lib.slt_dense_jacobi(
        dev.index or 0, n, B, ptr(a), ptr(diag), ptr(inv_diag), ptr(b),
        ptr(x0), int(iters), ptr(xs[0]), ptr(xs[1]), stream_of(b))
    raise_on(rc, "dense_jacobi_fused", lib)
    return xs[(iters - 1) % 2]


def dense_power_fused(pt, v, dangling, alpha: float, iters: int = 32):
    """T PageRank power steps x <- (1 - alpha) v + alpha (P^T x + mass v)
    from x = v, mass = sum(dangling * x) over all entries."""
    if pt.device.type == "cpu":
        return dense_power_fused_plain(pt, v, dangling, alpha, iters)
    n, B = _system_shape(v)
    f32 = torch.float32
    dev = _check(iters, pt=(pt, f32, (n, n)), v=(v, f32, (n, B)),
                 dangling=(dangling, f32, (n, B)))
    if iters == 0:
        return v.clone()
    lib = library("dense_kernels")
    xs = torch.empty((2, n, B), dtype=f32, device=dev)
    mass = torch.empty(int(iters), dtype=f32, device=dev)
    LAUNCHES["dense_power_fused"] += 1
    rc = lib.slt_dense_power(
        dev.index or 0, n, B, ptr(pt), ptr(v), ptr(dangling),
        float(1.0 - alpha), float(alpha), int(iters), ptr(xs[0]), ptr(xs[1]),
        ptr(mass), stream_of(v))
    raise_on(rc, "dense_power_fused", lib)
    return xs[(iters - 1) % 2]
