"""Compressed-row connectivity between index spaces (host, numpy).

Counterpart of ``fvm_tpu/mesh/connectivity.py`` (the reference's
``CRConnectivity``, CRConnectivity.h:52): a CSR graph between two index
spaces.  Only the row subset the main path uses is carried here.
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

    def row_counts(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def __repr__(self) -> str:
        return (
            f"CRConnectivity({self.count_from} -> {self.count_to}, "
            f"nnz={self.nnz})"
        )

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
