"""MatrixMarket reader and writer (counterpart of
``fvm_tpu/io/matrixmarket.py``; the reference's MMReader, MMReader.h:16,
and the matrix dumps of FlowModel_impl.h:1560 dumpContinuityMatrix)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import as_dtype, resolve_device
from ..exceptions import MeshError
from ..ops.ell import ELLMatrix
from .persistence import host


def read_matrix_market(matrix_path: str, rhs_path: str | None = None,
                       device=None, dtype=None):
    """Read a general real MatrixMarket coordinate matrix (and an optional
    rhs array file): (ELLMatrix, b or None) on ``device`` (``"cuda"``
    unless given) in ``dtype`` (the default dtype unless given).  Off-
    diagonal entries fill the slots row by row in file order."""
    dev = resolve_device(device)
    dt = as_dtype(dtype)
    with open(matrix_path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise MeshError(f"{matrix_path}: not a MatrixMarket file")
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = map(int, line.split())
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.empty(nnz, np.float64)
        for k in range(nnz):
            parts = f.readline().split()
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            vals[k] = float(parts[2]) if len(parts) > 2 else 1.0
    if symmetric:
        off = rows != cols
        r0, c0, v0 = rows, cols, vals
        rows = np.concatenate([r0, c0[off]])
        cols = np.concatenate([c0, r0[off]])
        vals = np.concatenate([v0, v0[off]])

    diag = np.zeros(nrow)
    isdiag = rows == cols
    np.add.at(diag, rows[isdiag], vals[isdiag])
    orows, ocols, ovals = rows[~isdiag], cols[~isdiag], vals[~isdiag]
    counts = np.bincount(orows, minlength=nrow)
    K = max(int(counts.max()) if len(counts) else 1, 1)
    colsE = np.tile(np.arange(nrow)[:, None], (1, K))
    offE = np.zeros((nrow, K))
    maskE = np.zeros((nrow, K), dtype=bool)
    ptr = np.zeros(nrow + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    order = np.argsort(orows, kind="stable")
    orows, ocols, ovals = orows[order], ocols[order], ovals[order]
    slot = np.arange(len(orows)) - ptr[orows]
    colsE[orows, slot] = ocols
    offE[orows, slot] = ovals
    maskE[orows, slot] = True

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # the device layout is slot-leading (K, n)
    A = ELLMatrix(diag=t(diag, dt), off=t(offE.T, dt),
                  cols=t(colsE.T, torch.int64), mask=t(maskE.T, torch.bool))
    b = None
    if rhs_path:
        with open(rhs_path) as f:
            f.readline()
            line = f.readline()
            while line.startswith("%"):
                line = f.readline()
            n = int(line.split()[0])
            b = np.fromiter((float(f.readline()) for _ in range(n)),
                            np.float64, count=n)
        b = t(b, dt)
    return A, b


def write_matrix_market(path: str, A, b=None, rhs_path: str | None = None):
    """Write an ELLMatrix (and an optional rhs) as MatrixMarket coordinate
    files: the diagonal first, then the valid off-diagonal slots in
    row-major order, exact zeros dropped; the rhs to ``rhs_path`` or
    ``<path stem>_rhs.mtx``."""
    diag = host(A.diag)
    off = host(A.off).T  # the device layout is slot-leading (K, n)
    cols = host(A.cols).T
    mask = host(A.mask).T
    n = diag.shape[0]
    rows_i, cols_i, vals = [np.arange(n)], [np.arange(n)], [diag]
    r, c = np.nonzero(mask)
    rows_i.append(r)
    cols_i.append(cols[r, c])
    vals.append(off[r, c])
    rows_all = np.concatenate(rows_i)
    cols_all = np.concatenate(cols_i)
    vals_all = np.concatenate(vals)
    keep = vals_all != 0.0
    rows_all, cols_all, vals_all = (rows_all[keep], cols_all[keep],
                                    vals_all[keep])
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {len(vals_all)}\n")
        for i, j, v in zip(rows_all, cols_all, vals_all):
            f.write(f"{i + 1} {j + 1} {v:.17g}\n")
    if b is not None:
        b = host(b)
        rp = rhs_path or (path.rsplit(".", 1)[0] + "_rhs.mtx")
        with open(rp, "w") as f:
            f.write("%%MatrixMarket matrix array real general\n")
            f.write(f"{b.shape[0]} 1\n")
            for v in b.ravel():
                f.write(f"{v:.17g}\n")
