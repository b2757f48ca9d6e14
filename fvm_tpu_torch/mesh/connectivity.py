"""Compressed-row connectivity between index spaces (host, numpy).

Counterpart of ``fvm_tpu/mesh/connectivity.py`` (the reference's
``CRConnectivity``, CRConnectivity.h:52): a CSR graph between two index
spaces, with the transpose / multiply / subset algebra.
"""

from __future__ import annotations

import numpy as np

from ..exceptions import MeshError


class CRConnectivity:
    """CSR graph: ``count_from`` rows, entries index into [0, count_to)."""

    def __init__(self, row_ptr: np.ndarray, col: np.ndarray, count_to: int):
        self.row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
        self.col = np.ascontiguousarray(col, dtype=np.int64)
        self.count_to = int(count_to)
        if self.row_ptr.ndim != 1 or self.col.ndim != 1:
            raise MeshError("CRConnectivity arrays must be 1-D")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != len(self.col):
            raise MeshError("CRConnectivity row_ptr inconsistent with col")

    @property
    def count_from(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.col)

    def row(self, i: int) -> np.ndarray:
        return self.col[self.row_ptr[i]: self.row_ptr[i + 1]]

    def row_counts(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def __repr__(self) -> str:
        return (
            f"CRConnectivity({self.count_from} -> {self.count_to}, "
            f"nnz={self.nnz})"
        )

    @staticmethod
    def from_rows(rows, count_to: int) -> "CRConnectivity":
        """Build from a sequence of index sequences."""
        counts = np.fromiter((len(r) for r in rows), dtype=np.int64,
                             count=len(rows))
        row_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        col = (np.concatenate([np.asarray(r, dtype=np.int64) for r in rows])
               if len(rows) else np.empty(0, dtype=np.int64))
        return CRConnectivity(row_ptr, col, count_to)

    @staticmethod
    def from_pairs(row_idx, col_idx, count_from: int,
                   count_to: int) -> "CRConnectivity":
        """Build from COO (row, col) pairs; entries sorted by row (stable)."""
        order = np.argsort(row_idx, kind="stable")
        row_idx = np.asarray(row_idx)[order]
        col_idx = np.asarray(col_idx)[order]
        counts = np.bincount(row_idx, minlength=count_from)
        row_ptr = np.zeros(count_from + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return CRConnectivity(row_ptr, col_idx.astype(np.int64), count_to)

    # -- algebra (reference: CRConnectivity.h:74-100) ----------------------

    def transpose(self, count_from_override: int | None = None
                  ) -> "CRConnectivity":
        """Reverse the graph: (a -> b) becomes (b -> a)."""
        n_to = (self.count_to if count_from_override is None
                else count_from_override)
        rows = np.repeat(np.arange(self.count_from, dtype=np.int64),
                         self.row_counts())
        return CRConnectivity.from_pairs(self.col, rows, n_to,
                                         self.count_from)

    def multiply(self, other: "CRConnectivity",
                 drop_self: bool = True) -> "CRConnectivity":
        """Compose: self (a -> b) * other (b -> c) = (a -> c), each row
        deduplicated in first-seen order; ``drop_self`` removes i from row
        i (cellCells from cellFaces * faceCells, as
        CRConnectivity::multiply).  Vectorized: the same rows as the JAX
        package's per-row loop."""
        if self.count_to != other.count_from:
            raise MeshError("multiply: incompatible connectivities")
        # every (row, entry) of the product before deduplication, in the
        # per-row loop's order
        cnt = other.row_counts()[self.col]
        row = np.repeat(np.repeat(np.arange(self.count_from, dtype=np.int64),
                                  self.row_counts()), cnt)
        starts = np.repeat(other.row_ptr[:-1][self.col], cnt)
        pos = np.arange(len(row), dtype=np.int64)
        seg = np.repeat(np.cumsum(cnt) - cnt, cnt)
        val = other.col[starts + pos - seg]
        # first occurrence of each (row, value)
        order = np.lexsort((pos, val, row))
        r_s, v_s = row[order], val[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = (r_s[1:] != r_s[:-1]) | (v_s[1:] != v_s[:-1])
        keep = np.sort(order[first])
        if drop_self:
            keep = keep[val[keep] != row[keep]]
        counts = np.bincount(row[keep], minlength=self.count_from)
        row_ptr = np.zeros(self.count_from + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return CRConnectivity(row_ptr, val[keep], other.count_to)

    def subset(self, row_indices: np.ndarray) -> "CRConnectivity":
        """Rows restricted to ``row_indices`` (renumbered 0..k-1)."""
        row_indices = np.asarray(row_indices, dtype=np.int64)
        counts = self.row_counts()[row_indices]
        out_ptr = np.zeros(len(row_indices) + 1, dtype=np.int64)
        np.cumsum(counts, out=out_ptr[1:])
        starts = self.row_ptr[row_indices]
        take = (
            np.arange(out_ptr[-1], dtype=np.int64)
            - np.repeat(out_ptr[:-1], counts)
            + np.repeat(starts, counts)
        )
        return CRConnectivity(out_ptr, self.col[take], self.count_to)
