#!/usr/bin/env python3
"""Sweep the compile-time shapes of the two sparse kernels on one CUDA card.

    python3 sweep_sparse_kernels.py

Run from the root of a checkout, on a machine with a card and nvcc.  It
builds variants of sublinear_tpu_torch/csrc/csr_kernels.cu (csr_spmv's tile
of entries and threads per block; the row partition is cut with the same
limits) and of spmm_kernels.cu (entries whose gathers are in flight
together, the column-slab width S forced to a fixed value instead of the
built-in rules, and the (col, val) loads forced to be shared by shuffle or
private to each lane instead of chosen by lanes per row), one nvcc per
variant, all started together, into build/sweep/.
Each variant is held to the plain PyTorch version (max |diff| <= 1e-5 *
max |plain|, or the script fails) and timed on the matrices of
chip_smoke.py: csr_spmv at n=100k (density 1e-4) and n=1M (density 1e-5),
csr_spmm at n=100k for B in {8, 128}, f32 with the split diagonal and, at
B=128, onehot_spmm's two bf16 products (SPMM_CASES).  Times:
the device time alone (torch.profiler over back-to-back calls) and the time
per back-to-back call (CUDA events, host work included).  Beside them, two
yardsticks the port never calls: the bare gather of every x[col]
(torch index_select) for csr_spmv, and torch.nn.functional.embedding_bag
(mode "sum", the values as per-sample weights) for csr_spmm.  The last line
is a JSON object of every reading.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "sweep"
RTOL = 1e-5
REPS = 50
# csr_spmv: (kTile entries, kStreamThreads threads); the first is the kernel's
SPMV_SHAPES = ((1024, 256), (2048, 256), (2048, 512), (512, 128),
               (1024, 128), (4096, 512))
# csr_spmm: (kUnroll, forced slab width S or None for the built-in rules:
# half of L2 for the f32 product, the widest slab for the bf16 products,
# forced loads "shared" / "private" or None for the built-in choice)
SPMM_SHAPES = ((4, None, None), (4, 8, None), (4, 16, None), (4, 32, None),
               (4, 64, None), (4, 128, None), (8, None, None),
               (4, None, "shared"), (4, None, "private"))
# (mode, B, the shapes it runs)
SPMM_CASES = (("f32", 8, SPMM_SHAPES), ("f32", 128, SPMM_SHAPES),
              ("split", 128, ((4, None, None), (4, 32, None),
                              (4, 64, None), (4, None, "private"))),
              ("bf16", 128, ((4, None, None), (4, 32, None),
                             (4, 64, None), (4, None, "private"))))
# slab_width's two rules, replaced by one forced width
SPMM_FIT = ("long long fit = 32 * V;",
            "  if (M == kF32) fit = (long long)l2 / 2 / (4LL * ((long long)m"
            " + n));\n")
SPMM_LOADS = "  if (group >= kUnroll) {"


def spmm_name(shape):
    unroll, slab, loads = shape
    return f"spmm_unroll{unroll}_slab{slab or 'rule'}_loads{loads or 'rule'}"


def variant(text, old, new):
    if old not in text:
        raise RuntimeError(f"source line not found: {old}")
    return text.replace(old, new)


def build(sources, nvcc, flags):
    """{name: loaded library} of each {name: source text}, built in
    parallel; raises with nvcc's stderr on a failed build."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        spills = sorted({line.strip() for line in (out + err).splitlines()
                         if "spill" in line
                         and " 0 bytes spill stores" not in line})
        print(f"built {name}{'; ' + ' | '.join(spills) if spills else ''}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    import sublinear_tpu_torch as slt
    from sublinear_tpu_torch.ops import _kernels, csr_spmv as K
    from chip_smoke import device_ms, fmt_ms, time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    csrc = HERE / "sublinear_tpu_torch" / "csrc"
    spmv_src = (csrc / "csr_kernels.cu").read_text()
    spmm_src = (csrc / "spmm_kernels.cu").read_text()
    sources = {}
    for tile, threads in SPMV_SHAPES:
        text = variant(spmv_src, "constexpr int kStreamThreads = 256;",
                       f"constexpr int kStreamThreads = {threads};")
        sources[f"spmv_tile{tile}_threads{threads}"] = variant(
            text, "constexpr int kTile = 1024; ",
            f"constexpr int kTile = {tile}; ")
    for shape in SPMM_SHAPES:
        unroll, slab, loads = shape
        text = variant(spmm_src, "constexpr int kUnroll = 4;",
                       f"constexpr int kUnroll = {unroll};")
        if slab is not None:
            text = variant(variant(text, SPMM_FIT[1], ""), SPMM_FIT[0],
                           f"long long fit = {slab};")
        if loads is not None:
            text = variant(text, SPMM_LOADS,
                           f"  if ({str(loads == 'shared').lower()}) {{")
        sources[spmm_name(shape)] = text
    libs = build(sources, _kernels._nvcc(), _kernels.NVCC_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        if name.startswith("spmv"):
            lib.slt_csr_spmv.argtypes = [I, I] + [P] * 8
        else:
            lib.slt_csr_spmm.argtypes = [I] * 5 + [P] * 7

    dev = torch.device("cuda")
    stream = lambda: torch._C._cuda_getCurrentRawStream(0)  # noqa: E731
    readings = {}

    def record(key, fn, want, got):
        fn()
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        if not err <= RTOL:
            raise RuntimeError(f"{key}: max rel err {err} > {RTOL}")
        # the profiler now and then sees no device time: one more window
        dev_time = device_ms(torch, fn, REPS) or device_ms(torch, fn, REPS)
        readings[key] = {"device_ms": dev_time, "ms": time_ms(torch, fn, REPS)}
        print(f"{key}: device {fmt_ms(dev_time)} ms, per call "
              f"{readings[key]['ms']:.5f} ms (max rel err {err:.2e})",
              flush=True)

    ops = {}
    for n, density in ((100_000, 1e-4), (1_000_000, 1e-5)):
        op = ops[n] = slt.generate("random-sparse", n, seed=7,
                                   density=density).op()
        x = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, n),
                            dtype=torch.float32, device=dev)
        cols = op.indices.long()
        key = f"n={n} gather x[col] (index_select)"
        readings[key] = {"device_ms": device_ms(
            torch, lambda: x.index_select(0, cols), REPS)}
        print(f"{key}, {cols.numel()} entries: device "
              f"{fmt_ms(readings[key]['device_ms'])} ms", flush=True)
        want = K.csr_spmv_plain(op, x, op.diag)
        indptr = op.indptr.cpu().numpy()
        for tile, threads in SPMV_SHAPES:
            blocks = torch.as_tensor(
                K.spmv_row_blocks(indptr, tile=tile, rows=threads),
                dtype=torch.int32, device=dev)
            y = torch.empty(n, device=dev)
            lib = libs[f"spmv_tile{tile}_threads{threads}"]
            args = (0, blocks.numel() - 1, blocks.data_ptr(),
                    op.indptr.data_ptr(), op.indices.data_ptr(),
                    op.vals.data_ptr(), x.data_ptr(), op.diag.data_ptr(),
                    y.data_ptr())
            record(f"n={n} csr_spmv tile={tile} threads={threads}",
                   lambda: lib.slt_csr_spmv(*args, stream()), want, y)
    op = ops[100_000]
    for mode, B, shapes in SPMM_CASES:
        X = torch.as_tensor(np.random.default_rng(B).standard_normal(
            (op.m_pad, B)), dtype=torch.float32, device=dev)
        diag = op.diag if mode == "f32" else None
        if mode == "f32":
            off, cols = op.indptr[:-1].long(), op.indices.long()
            key = f"n=100000 B={B} embedding_bag"
            readings[key] = {"device_ms": device_ms(
                torch, lambda: torch.nn.functional.embedding_bag(
                    cols, X, off, mode="sum", per_sample_weights=op.vals),
                REPS)}
            print(f"{key}: device {fmt_ms(readings[key]['device_ms'])} ms",
                  flush=True)
        want = K.csr_spmm_plain(op, X, diag, mode)
        for shape in shapes:
            unroll, slab, loads = shape
            Y = torch.empty(op.n_pad, B, device=dev)
            lib = libs[spmm_name(shape)]
            args = (0, K.SPMM_MODES[mode], op.n_pad, op.m_pad, B,
                    op.indptr.data_ptr(), op.indices.data_ptr(),
                    op.vals.data_ptr(), X.data_ptr(),
                    None if diag is None else diag.data_ptr(), Y.data_ptr())
            record(f"n=100000 B={B} csr_spmm {mode} unroll={unroll} "
                   f"slab={slab or 'rule'} loads={loads or 'rule'}",
                   lambda: lib.slt_csr_spmm(*args, stream()), want, Y)
    print(json.dumps({"card": smi, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
