"""Matrix file IO: JSON (native), MatrixMarket (.mtx), CSV and GML, a NumPy
copy of ``sublinear_tpu/formats/io.py``.  Loaded matrices are port
``Matrix`` objects on the default device.
"""
from __future__ import annotations

import json

import numpy as np

from ..errors import InvalidMatrixError
from ..matrix import Matrix


def load_matrix(path: str) -> Matrix:
    p = str(path)
    if p.endswith(".mtx"):
        return read_matrix_market(p)
    if p.endswith(".csv"):
        return read_csv(p)
    if p.endswith(".gml"):
        return read_gml(p)
    with open(p) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return Matrix.from_dict(data.get("matrix", data))
    return Matrix.from_dense(np.asarray(data, dtype=np.float64))


def save_matrix(matrix: Matrix, path: str, fmt: str | None = None):
    p = str(path)
    fmt = fmt or ("mtx" if p.endswith(".mtx") else "csv" if p.endswith(".csv") else "json")
    if fmt == "mtx":
        write_matrix_market(matrix, p)
    elif fmt == "csv":
        np.savetxt(p, matrix.to_dense(), delimiter=",")
    else:
        with open(p, "w") as f:
            json.dump(matrix.to_dict(), f)


def read_matrix_market(path: str) -> Matrix:
    """Coordinate-format MatrixMarket reader (general/symmetric, real)."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise InvalidMatrixError("not a MatrixMarket file")
        parts = header.split()
        symmetric = "symmetric" in parts
        coordinate = "coordinate" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if coordinate:
            nr, nc, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            rows, cols, vals = [], [], []
            for _ in range(nnz):
                tok = f.readline().split()
                r, c = int(tok[0]) - 1, int(tok[1]) - 1
                v = float(tok[2]) if len(tok) > 2 else 1.0
                rows.append(r)
                cols.append(c)
                vals.append(v)
                if symmetric and r != c:
                    rows.append(c)
                    cols.append(r)
                    vals.append(v)
            return Matrix.from_coo(rows, cols, vals, (nr, nc))
        # array (dense) format
        nr, nc = int(dims[0]), int(dims[1])
        vals = [float(f.readline()) for _ in range(nr * nc)]
        dense = np.asarray(vals).reshape((nc, nr)).T  # column-major per spec
        return Matrix.from_dense(dense)


def write_matrix_market(matrix: Matrix, path: str):
    r, c, v = matrix.csr.to_coo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{matrix.shape[0]} {matrix.shape[1]} {len(v)}\n")
        for i, j, x in zip(r, c, v):
            f.write(f"{i + 1} {j + 1} {x:.17g}\n")


def read_csv(path: str) -> Matrix:
    dense = np.loadtxt(path, delimiter=",", ndmin=2)
    return Matrix.from_dense(dense)


def read_gml(path: str) -> Matrix:
    """Minimal GML graph reader -> adjacency matrix.  Supports node/edge
    blocks with id/source/target/value(weight) keys."""
    import re

    text = open(path).read()
    node_ids = [int(m) for m in re.findall(r"node\s*\[[^\]]*?\bid\s+(-?\d+)", text, re.S)]
    edges = re.findall(
        r"edge\s*\[([^\]]*)\]", text, re.S
    )
    id_map = {nid: i for i, nid in enumerate(sorted(set(node_ids)))}
    rows, cols, vals = [], [], []
    for body in edges:
        src = re.search(r"\bsource\s+(-?\d+)", body)
        tgt = re.search(r"\btarget\s+(-?\d+)", body)
        w = re.search(r"\b(?:value|weight)\s+([-\d.eE]+)", body)
        if not src or not tgt:
            continue
        s, t = int(src.group(1)), int(tgt.group(1))
        if s not in id_map or t not in id_map:
            continue
        rows.append(id_map[s])
        cols.append(id_map[t])
        vals.append(float(w.group(1)) if w else 1.0)
    n = len(id_map)
    directed = re.search(r"\bdirected\s+1\b", text) is not None
    if not directed:
        rows, cols = rows + cols, cols + rows
        vals = vals + vals
    return Matrix.from_coo(rows, cols, vals, (n, n))


def load_vector(path: str) -> np.ndarray:
    p = str(path)
    if p.endswith(".csv"):
        return np.loadtxt(p, delimiter=",").reshape(-1)
    with open(p) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("vector", data.get("b"))
    return np.asarray(data, dtype=np.float64).reshape(-1)
