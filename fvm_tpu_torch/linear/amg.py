"""Algebraic multigrid, aggregation type (``fvm_tpu/linear/amg.py``).

Counterpart of the reference's agglomeration AMG (AMG.h:27,
CRMatrix.h:468-700).  The aggregation hierarchy is static, built once on
the host from the matrix structure; the coarse matrix values are the
Galerkin product recomputed on the device each solve.  Two kinds of level:

* on a tensor-product row graph (``detect_grid``) the levels pair cells
  along the longer grid axis (``_StructuredLevel``): restriction and
  prolongation are strided views and the Galerkin product is elementwise
  on the DIA coefficient grids;
* on every other graph (3D and triangle meshes, the deeper levels of a
  general mesh), or with ``structured=False``, greedy graph aggregation
  (``_Level``): restriction and the Galerkin product are segment sums
  (``index_add``) over host-built index maps, prolongation a gather.  Its
  coarse matrices carry DIA structure where ``analyze_offsets`` finds it
  (then products go through ``dia_stencil``), else they use the gather-ELL
  products of ``ops/ell.py``.

The coarsest level is factored once per solve with ``torch.linalg.inv_ex``
(the role of ``linear/dense.dense_inverse``).  ``DirectSolver`` solves
densely with ``torch.linalg.solve_ex``.  Both check their ``info`` with
``base.check_info``: at once when eager, after the replay inside a CUDA
graph.

Cycles V, W and F (AMG.h:40-70).  ``precision="bf16"`` runs the cycle in
bfloat16 (``fvm_tpu/linear/amg.py:1144-1175``): the hierarchy's matrices
and the coarse inverse are cast once per solve, and the cycle casts only
at its edges (``_cycle0``); on a CUDA tensor the DIA levels' products go
through the bfloat16 ``dia_stencil`` kernel.

Distributed (``setup_structure_dist``, ``fvm_tpu/linear/amg.py:603-1100``):
each rank runs a LOCAL cycle on the block of rows it owns, its couplings
into halo columns dropped (additive Schwarz), as the preconditioner of a
Krylov solve whose reductions all-reduce; a standalone distributed AMG
solve is BiCGStab around that cycle.  Each rank builds only its own row of
the JAX package's stacked hierarchy.  Its boundary rows are condensed
with its own plan (``CondensePlan(drop_beyond=n_owned)``).  Then:

* structured, when every rank's condensed block is the same
  tensor-product grid (regular partitions of structured meshes): the
  fine level is a ``DIAMatrix`` over the condensed shard grid, offsets
  (+-1, +-nx), and every level below it a ``_StructuredLevel``, so every
  smoothing sweep and residual of the cycle launches ``dia_stencil``;
* general, on any other mesh or partition: the rank's greedy-aggregation
  hierarchy, padded with identity levels to the deepest rank's depth; its
  fine level is gather-ELL and its coarse levels take the DIA route where
  their graph has DIA structure.

The agreement (the same grid on every rank, the deepest depth) is one
all-reduce each, so every rank takes the same branch.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from .. import hostlib
from ..exceptions import ConfigError
from ..ops.dia import CondensePlan, DIAInfo, DIAMatrix, index_tensor
from ..ops.dia_kernel import cast_coef, empty_coef
from ..ops.ell import ELLMatrix
from .base import (LinearSolver, SolveStats, check_info, condensed,
                   distributed, norm)


def aggregate_plain(cols: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Greedy aggregation of the host (n, K) row graph, as a numpy loop:
    seed an unaggregated row, absorb its unaggregated neighbours; rows left
    alone join an adjacent aggregate; ids compressed in increasing order
    (CRMatrix::createCoarsening).  The plain version of the compiled
    helper ``hostlib.aggregate`` (~8 s per million rows)."""
    n, K = cols.shape
    agg = -np.ones(n, dtype=np.int64)
    next_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        agg[i] = next_agg
        for k in range(K):
            if mask[i, k]:
                j = cols[i, k]
                if agg[j] < 0:
                    agg[j] = next_agg
        next_agg += 1
    sizes = np.bincount(agg, minlength=next_agg)
    for i in range(n):
        if sizes[agg[i]] == 1:
            for k in range(K):
                if mask[i, k] and agg[cols[i, k]] != agg[i]:
                    old = agg[i]
                    agg[i] = agg[cols[i, k]]
                    sizes[old] -= 1
                    sizes[agg[i]] += 1
                    break
    used = np.unique(agg)
    remap = np.zeros(next_agg, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return remap[agg]


def aggregate(cols: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Aggregate id per row: the compiled greedy aggregation, then the
    diagonal-only rows lumped together (``_lump_isolated``)."""
    return _lump_isolated(hostlib.aggregate(cols, mask), mask)


def _lump_isolated(agg: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Merge diagonal-only singleton rows (condensed boundary ghosts, dead
    padding) into one inert aggregate: one Jacobi sweep solves such a row
    exactly, so its coarse image carries nothing, and left alone these
    rows would ride every level down to the dense coarse solve."""
    iso = ~mask.any(axis=1)
    if iso.sum() <= 1:
        return agg
    sizes = np.bincount(agg)
    single = iso & (sizes[agg] == 1)
    if single.sum() <= 1:
        return agg
    agg = agg.copy()
    agg[single] = agg.max() + 1
    _, inv = np.unique(agg, return_inverse=True)
    return inv


def detect_grid(cols: np.ndarray, mask: np.ndarray):
    """Detect a tensor-product grid structure in a row graph.

    Returns (nx, ny, merge) where rows [0, nx*ny) form a (ny, nx) grid
    (x fastest) whose in-grid couplings are exactly offsets {+-1, +-nx}
    with consistent boundary behavior, and rows [nx*ny, n) are "tail" rows
    (boundary ghosts / padding), each coupling to at most ONE grid cell
    (merge target; -1 for dead rows) such that every grid->tail coupling
    points back at its own row.  Returns None otherwise.
    """
    n, K = cols.shape
    delta = np.where(mask, cols - np.arange(n)[:, None], 0)
    pos = delta[delta > 1]
    if len(pos) == 0:
        return None
    vals, counts = np.unique(pos, return_counts=True)
    nx = int(vals[np.argmax(counts)])
    if nx <= 1 or counts.max() < 0.25 * n:
        return None
    rows_up = np.nonzero((delta == nx).any(axis=1))[0]
    if len(rows_up) == 0:
        return None
    ny = int(rows_up.max()) // nx + 2
    m = nx * ny
    if m > n:
        return None

    g_rows = np.arange(m)
    gx, gy = g_rows % nx, g_rows // nx
    d_g = delta[:m]
    c_g = cols[:m]
    m_g = mask[:m]
    to_tail = m_g & (c_g >= m)
    in_grid = m_g & ~to_tail
    dg = np.where(in_grid, d_g, 0)
    if not np.isin(dg, (0, 1, -1, nx, -nx)).all():
        return None
    # boundary consistency: no +-1 across x edges, no +-nx outside y range
    if ((dg == -1) & (gx == 0)[:, None]).any():
        return None
    if ((dg == 1) & (gx == nx - 1)[:, None]).any():
        return None
    if ((dg == -nx) & (gy == 0)[:, None]).any():
        return None
    if ((dg == nx) & (gy == ny - 1)[:, None]).any():
        return None

    # tail rows: at most one distinct grid target each
    merge = np.full(n - m, -1, dtype=np.int64)
    t_cols = cols[m:]
    t_mask = mask[m:] & (cols[m:] != np.arange(m, n)[:, None])
    if (t_mask & (t_cols >= m)).any():
        return None  # tail-tail coupling
    for kk in range(t_mask.shape[1]):
        sel = t_mask[:, kk]
        tgt = t_cols[:, kk]
        if (sel & (merge >= 0) & (merge != tgt)).any():
            return None
        merge = np.where(sel, tgt, merge)
    # grid->tail couplings must point back at their own row
    ti, tk = np.nonzero(to_tail)
    if len(ti):
        g = c_g[ti, tk] - m
        if not (merge[g] == ti).all():
            return None
    return nx, ny, merge


class _StructuredLevel:
    """Index-pairing coarsening on a detected (ny, nx) grid.

    Pairs cells along the longer grid axis: restrict is a pairwise sum of
    strided views, prolong a repeat, and the Galerkin product is
    elementwise on the DIA coefficient grids.  Tail rows (boundary ghosts)
    are agglomerated into their owner's aggregate; their entries fold into
    the coarse diagonal.  The semantics are agglomeration AMG with size-2
    aggregates.  (The JAX package does the pair selections as matmuls
    against 0/1 selection matrices for the TPU's MXU; the values are the
    same sums.)
    """

    def __init__(self, nx: int, ny: int, n: int, device, merge=None,
                 cols=None, mask=None):
        self.nx, self.ny = nx, ny
        self.n = n  # total fine rows incl. tail
        self.m = nx * ny
        self.device = device
        self.pair_x = nx >= ny
        if self.pair_x:
            self.nx_c, self.ny_c = (nx + 1) // 2, ny
            self.odd = nx % 2 == 1
        else:
            self.nx_c, self.ny_c = nx, (ny + 1) // 2
            self.odd = ny % 2 == 1
        self.nC = self.nx_c * self.ny_c
        off_c = {}
        for name, d in (("xp", 1), ("xm", -1), ("yp", self.nx_c),
                        ("ym", -self.nx_c)):
            off_c.setdefault(d, []).append(name)
        self.coarse_offsets = tuple(off_c.keys())
        self._off_c_names = off_c
        self._extra = {}

        if merge is not None and len(merge):
            live = merge >= 0
            self.tail_rows = index_tensor(np.arange(self.m, n)[live], device)
            self.tail_agg = index_tensor(self._agg_of_cell(merge[live]), device)
        else:
            self.tail_rows = torch.zeros(0, dtype=torch.int64, device=device)
            self.tail_agg = torch.zeros(0, dtype=torch.int64, device=device)

        # the fine level's own ELL-slot -> offset-role map, for a fine
        # matrix without DIA metadata (a mesh whose offsets analyze_offsets
        # declines): bucket[k, i] in {0..3} indexes (+1, -1, +nx, -nx);
        # every other coupling (to tail rows) folds into the coarse
        # diagonal of its grid-side cell (fvm_tpu/linear/amg.py:268-291)
        self._bucket = None
        if cols is not None:
            delta = np.where(mask, cols - np.arange(n)[:, None], 0)
            bucket = np.full(cols.shape, -1, dtype=np.int64)
            grid_rows = (np.arange(n) < self.m)[:, None]
            for i, d in enumerate((1, -1, nx, -nx)):
                bucket[(delta == d) & mask & grid_rows
                       & (cols < self.m)] = i
            fr, fk = np.nonzero(mask & (bucket < 0)
                                & (cols != np.arange(n)[:, None]))
            self._bucket = index_tensor(bucket.T, device)
            self._fb_rows = index_tensor(fr, device)
            self._fb_slots = index_tensor(fk, device)
            self._fb_cols = index_tensor(cols[fr, fk], device)

    def _agg_of_cell(self, i):
        x, y = i % self.nx, i // self.nx
        if self.pair_x:
            return y * self.nx_c + x // 2
        return (y // 2) * self.nx_c + x

    # -- helpers ------------------------------------------------------------

    def _grid(self, v):
        """(n,) -> (ny, nx) grid view of the grid block."""
        return v[: self.m].reshape(self.ny, self.nx)

    def _even(self, g):
        """Zero-pad the pairing axis of a grid to an even length."""
        if not self.odd:
            return g
        return F.pad(g, (0, 1) if self.pair_x else (0, 0, 0, 1))

    def _pair(self, g, j):
        """j-th member (0/1) of each pair -> (ny_c, nx_c)."""
        g = self._even(g)
        return g[:, j::2] if self.pair_x else g[j::2, :]

    def _pairsum(self, g):
        """Sum fine pairs along the pairing axis -> (ny_c, nx_c)."""
        return self._pair(g, 0) + self._pair(g, 1)

    # -- transfers ----------------------------------------------------------

    def restrict(self, r):
        c = self._pairsum(self._grid(r)).reshape(-1)
        if self.tail_rows.shape[0]:
            c = c.index_add(0, self.tail_agg, r[self.tail_rows])
        return c

    def prolong(self, xc):
        g = xc.reshape(self.ny_c, self.nx_c)
        if self.pair_x:
            f = g.repeat_interleave(2, dim=1)[:, : self.nx]
        else:
            f = g.repeat_interleave(2, dim=0)[: self.ny]
        out = f.reshape(-1)
        if self.n > self.m:
            tail = torch.zeros(self.n - self.m, dtype=xc.dtype,
                               device=xc.device)
            if self.tail_rows.shape[0]:
                tail[self.tail_rows - self.m] = xc[self.tail_agg]
            out = torch.cat([out, tail])
        return out

    # -- Galerkin -----------------------------------------------------------

    def _coef_named(self, A):
        """Fine coefficient grids keyed by role xp/xm/yp/ym (zeros when the
        fine matrix lacks that offset), plus diagonal fold entries.  A is a
        coarse DIAMatrix, a prepared fine ELLMatrix with DIA structure, or
        a fine ELLMatrix without it (then the level's own bucketing)."""
        if isinstance(A, DIAMatrix):
            offsets, coef, diag = A.offsets, A.coef, A.diag
            fb = None
        elif A.dia is not None:
            offsets, coef, diag = A.dia.offsets, A.dia_coef, A.diag
            fb = (A.dia.fb_rows, A.dia.fb_cols, A.dia_fb_vals)
        else:
            # no DIA metadata: the level's own slot bucketing
            offv = torch.where(A.mask, A.off, 0.0)
            coef = torch.stack([
                torch.where(self._bucket == i, offv, 0.0).sum(dim=0)
                for i in range(4)])
            offsets = (1, -1, self.nx, -self.nx)
            diag = A.diag
            fb = (self._fb_rows, self._fb_cols,
                  offv[self._fb_slots, self._fb_rows])
        lut = {int(d): i for i, d in enumerate(offsets)}
        zero = torch.zeros((self.ny, self.nx), dtype=diag.dtype,
                           device=diag.device)

        def get(d):
            i = lut.get(d)
            return self._grid(coef[i]) if i is not None else zero

        if self.nx == 1:
            # degenerate single-column grid: flat +-1 IS the y-coupling
            names = {"xp": zero, "xm": zero, "yp": get(1), "ym": get(-1)}
            expected = (1, -1)
        else:
            names = {
                "xp": get(1), "xm": get(-1),
                "yp": get(self.nx), "ym": get(-self.nx),
            }
            expected = (1, -1, self.nx, -self.nx)
        # extra offsets = grid<->tail couplings inside the DIA set (small
        # grids); detect_grid guarantees they fold into the coarse diagonal
        extras = [
            (int(d), coef[i]) for i, d in enumerate(offsets)
            if int(d) not in expected
        ]
        return names, self._grid(diag), diag, fb, extras

    def _extra_agg(self, d):
        """The coarse aggregate of each tail row's owner across offset d,
        made on the host once per offset (no host copy while a CUDA graph
        is captured)."""
        agg = self._extra.get(d)
        if agg is None:
            owner = np.clip(np.arange(self.m, self.n) + d, 0, self.m - 1)
            agg = index_tensor(self._agg_of_cell(owner), self.device)
            self._extra[d] = agg
        return agg

    def galerkin(self, A):
        """Coarse DIAMatrix = R A P, elementwise on the DIA grids."""
        C, Dg, diag_full, fb, extras = self._coef_named(A)
        if self.pair_x:
            diag_c = (self._pairsum(Dg) + self._pair(C["xp"], 0)
                      + self._pair(C["xm"], 1))
            parts = {
                "xp": self._pair(C["xp"], 1),
                "xm": self._pair(C["xm"], 0),
                "yp": self._pairsum(C["yp"]),
                "ym": self._pairsum(C["ym"]),
            }
        else:
            diag_c = (self._pairsum(Dg) + self._pair(C["yp"], 0)
                      + self._pair(C["ym"], 1))
            parts = {
                "xp": self._pairsum(C["xp"]),
                "xm": self._pairsum(C["xm"]),
                "yp": self._pair(C["yp"], 1),
                "ym": self._pair(C["ym"], 0),
            }
        diag_c = diag_c.reshape(-1)
        for d, cvec in extras:
            diag_c = diag_c + self._pairsum(self._grid(cvec)).reshape(-1)
            if self.n > self.m:
                diag_c = diag_c.index_add(0, self._extra_agg(d),
                                          cvec[self.m:])
        # tail entries: ghost diagonals fold into the owner aggregate
        if self.tail_rows.shape[0]:
            diag_c = diag_c.index_add(0, self.tail_agg,
                                      diag_full[self.tail_rows])
        if fb is not None and fb[0].shape[0]:
            fb_rows, fb_cols, fb_vals = fb
            tgt_cell = torch.where(fb_rows < self.m, fb_rows, fb_cols)
            diag_c = diag_c.index_add(0, self._agg_of_cell(tgt_cell),
                                      fb_vals)
        coef_rows = []
        for d in self.coarse_offsets:
            acc = None
            for name in self._off_c_names[d]:
                v = parts[name].reshape(-1)
                acc = v if acc is None else acc + v
            coef_rows.append(acc)
        coef = torch.stack(coef_rows, out=empty_coef(
            len(coef_rows), self.nC, diag_c.dtype, diag_c.device))
        return DIAMatrix(diag_c, coef, self.coarse_offsets)


class _Level:
    """One greedy-aggregation level: host-built index maps, device tables.

    ``agg`` maps each fine row to its aggregate.  Every fine off-diagonal
    entry (flat in the slot-leading (k, i) order of ``ELLMatrix.off``)
    maps to the coarse diagonal (``to_diag``) when both ends share an
    aggregate, else to its coarse off-diagonal slot (``to_off``, flat
    ``sl * nC + ic`` so the sum reshapes to the (Kc, nC) coarse values);
    masked entries go to a trash slot.  These host tables are the JAX
    package's, entry for entry; the device holds only the entries that
    land somewhere."""

    def __init__(self, cols: np.ndarray, mask: np.ndarray, device,
                 agg: np.ndarray | None = None):
        n, K = cols.shape
        if agg is None:
            agg = aggregate(cols, mask)
        nC = int(agg.max()) + 1

        # coarse graph: the distinct (I, J) aggregate pairs of the fine
        # off-diagonal entries, sorted by (I, J); the 1-D key I nC + J
        # sorts the same way as the pairs themselves
        fi = np.repeat(np.arange(n), K)
        valid = mask.reshape(-1)
        I = agg[fi]
        J = agg[cols.reshape(-1)]
        del fi
        offd = valid & (I != J)
        keys, inverse = np.unique(I[offd] * nC + J[offd], return_inverse=True)
        pi, pj = keys // nC, keys % nC
        counts = np.bincount(pi, minlength=nC)
        Kc = max(int(counts.max()) if len(keys) else 1, 1)
        ptr = np.zeros(nC + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        slot = np.arange(len(keys)) - ptr[pi]
        cols_c = np.tile(np.arange(nC, dtype=np.int64)[:, None], (1, Kc))
        mask_c = np.zeros((nC, Kc), dtype=bool)
        cols_c[pi, slot] = pj
        mask_c[pi, slot] = True

        # fine entry -> coarse target, host (i, k) order
        to_off = np.full(n * K, nC * Kc, dtype=np.int64)  # trash slot
        to_diag = np.full(n * K, nC, dtype=np.int64)  # trash slot
        same = valid & (I == J)
        to_diag[same] = I[same]
        to_off[offd] = (pi * Kc + slot)[inverse]

        self.n, self.K, self.nC, self.Kc = n, K, nC, Kc
        self.cols_c_np, self.mask_c_np = cols_c, mask_c
        # the maps in the slot-leading layout (flat (k, i) fine order, sl *
        # nC + ic coarse off-diagonal targets), as the JAX package holds
        # them on its device
        to_diag = np.ascontiguousarray(to_diag.reshape(n, K).T).reshape(-1)
        to_off = np.ascontiguousarray(to_off.reshape(n, K).T).reshape(-1)
        to_off = np.where(to_off == nC * Kc, nC * Kc,
                          (to_off % Kc) * nC + to_off // Kc)
        self.to_diag, self.to_off = to_diag, to_off
        # the device keeps only the entries that land somewhere: summed
        # into one trash slot, the rest (most of the n K entries) would be
        # millions of float atomics on one address of a CUDA device
        self.agg = index_tensor(agg, device)
        keep = np.nonzero(to_diag < nC)[0]
        self._diag_src = index_tensor(keep, device)
        self._diag_dst = index_tensor(to_diag[keep], device)
        keep = np.nonzero(to_off < nC * Kc)[0]
        self._off_src = index_tensor(keep, device)
        self._off_dst = index_tensor(to_off[keep], device)
        self.cols_c = index_tensor(cols_c.T, device)
        self.mask_c = torch.from_numpy(np.ascontiguousarray(mask_c.T)).to(
            device)
        # the coarse products take the DIA route where the coarse graph has
        # DIA structure (aggregation keeps locality), else gather-ELL
        self.dia_c = DIAInfo.build(cols_c, mask_c, device)

    def galerkin(self, A: ELLMatrix) -> ELLMatrix:
        """Coarse matrix values R A P: three segment sums on the device
        (``index_add``, float atomics on a CUDA tensor)."""
        off_flat = torch.where(A.mask, A.off, 0.0).reshape(-1)
        z = A.diag.new_zeros
        diag_c = z(self.nC).index_add(0, self.agg, A.diag)
        diag_c = diag_c + z(self.nC).index_add(0, self._diag_dst,
                                               off_flat[self._diag_src])
        off_c = z(self.nC * self.Kc).index_add(0, self._off_dst,
                                               off_flat[self._off_src])
        return ELLMatrix(diag=diag_c, off=off_c.reshape(self.Kc, self.nC),
                         cols=self.cols_c, mask=self.mask_c, dia=self.dia_c)

    def restrict(self, r):
        return r.new_zeros((self.nC,) + r.shape[1:]).index_add(0, self.agg, r)

    def prolong(self, xc):
        return xc[self.agg]


def _to_bf16(A):
    """A prepared level matrix with its values in bfloat16 (the
    coefficients kept in the kernel's layout)."""
    bf = torch.bfloat16
    if isinstance(A, DIAMatrix):
        return DIAMatrix(A.diag.to(bf), cast_coef(A.coef, bf), A.offsets)
    return A.replace(
        diag=A.diag.to(bf), off=A.off.to(bf),
        dia_coef=None if A.dia_coef is None else cast_coef(A.dia_coef, bf),
        dia_fb_vals=None if A.dia_fb_vals is None else A.dia_fb_vals.to(bf))


def _dense_from_ell(A: ELLMatrix, n: int):
    D = torch.diag(A.diag)
    rows = torch.arange(n, device=A.diag.device).repeat(A.cols.shape[0])
    vals = torch.where(A.mask, A.off, 0.0).reshape(-1)
    return D.index_put((rows, A.cols.reshape(-1)), vals, accumulate=True)


class AMG(LinearSolver):
    """Aggregation AMG; usable standalone or as a Krylov preconditioner.

    Options mirror the reference (AMG.h:40-70): cycle type (V/W/F),
    smoother sweeps, max coarse levels, coarsest-size threshold.
    ``structured=True`` takes index-pairing levels where the row graph is a
    tensor-product grid; ``False`` forces greedy graph aggregation
    everywhere.  ``precision="bf16"`` runs the cycle in bfloat16: as a
    preconditioner the lost mantissa costs at worst a few more outer
    iterations, and the cycle moves half the bytes."""

    def __init__(
        self,
        max_levels: int = 20,
        coarse_size: int = 64,
        nu_pre: int = 1,
        nu_post: int = 1,
        smoother_omega: float = 0.7,
        smoother_sweeps: int = 2,
        cycle: str = "V",
        precision: str | None = None,
        structured: bool = True,
        **kw,
    ):
        kw.setdefault("max_iterations", 30)
        super().__init__(**kw)
        if cycle not in ("V", "W", "F"):
            raise ConfigError(f"AMG: unknown cycle {cycle!r} (V, W or F)")
        if precision not in (None, "bf16"):
            raise ConfigError(f"AMG: unknown precision {precision!r} "
                              f"(None or 'bf16')")
        self.max_levels = max_levels
        self.coarse_size = coarse_size
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.omega = smoother_omega
        self.smoother_sweeps = smoother_sweeps
        self.cycle_type = cycle
        self.precision = precision
        self.structured = structured
        # hierarchies keyed by (device (K, n) shape, structure digest,
        # device); and the same hierarchies keyed by the identity of the
        # device cols tensor they serve (the tensor is held, so its id
        # cannot be reused), so a solve finds its levels without copying
        # the structure back to the host
        self._levels_cache: dict = {}
        self._levels_by_cols: dict = {}
        # the rank's shard-local hierarchy (setup_structure_dist), or None
        self._dist_setup = None

    # -- setup --------------------------------------------------------------

    def setup_structure(self, cols_np: np.ndarray, mask_np: np.ndarray,
                        device):
        """Build the static hierarchy from HOST (n, K) structure tables
        (``mesh.host_cf()``), cached by the (K, n) shape and a digest of
        the whole structure (cols and mask), as the JAX package keys it by
        shape and structure bytes."""
        device = torch.device(device)
        cols_np = np.ascontiguousarray(cols_np, dtype=np.int64)
        mask_np = np.ascontiguousarray(mask_np, dtype=bool)
        digest = hashlib.blake2b(cols_np.tobytes(), digest_size=16)
        digest.update(mask_np.tobytes())
        key = (cols_np.shape[::-1], digest.hexdigest(), str(device))
        if key in self._levels_cache:
            return self._levels_cache[key]
        # mirror the solve-entry boundary condensation: the levels must
        # match the structure the cycle actually smooths
        dia = DIAInfo.build(cols_np, mask_np, device)
        if dia is not None and dia.cond_plan is not None:
            mask_np = dia.cond_plan.mask2
        levels = []
        n = cols_np.shape[0]
        grid = detect_grid(cols_np, mask_np) if self.structured else None
        if grid is not None:
            nx, ny, merge = grid
            c_np, m_np = cols_np, mask_np
            while n > self.coarse_size and len(levels) < self.max_levels \
                    and max(nx, ny) > 1:
                lev = _StructuredLevel(nx, ny, n, device, merge=merge,
                                       cols=c_np, mask=m_np)
                levels.append(lev)
                nx, ny, merge, n = lev.nx_c, lev.ny_c, None, lev.nC
                c_np = m_np = None
        else:
            cols, mask = cols_np, mask_np
            while n > self.coarse_size and len(levels) < self.max_levels:
                lev = _Level(cols, mask, device)
                if lev.nC >= n:  # no coarsening progress
                    break
                levels.append(lev)
                cols, mask, n = lev.cols_c_np, lev.mask_c_np, lev.nC
        self._levels_cache[key] = levels
        return levels

    def setup_structure_dist(self, cols_np: np.ndarray, mask_np: np.ndarray,
                             n_owned: int, group, device=None) -> bool:
        """The static shard-local hierarchy of this rank (``fvm_tpu/linear/
        amg.py:852-1005``) from its HOST (n, K) tables; structured when
        every rank presents the same condensed grid, else general.  Returns
        False only when no coarsening is possible on any rank (then the
        preconditioner is the diagonal, as in the JAX package).  Every rank
        of ``group`` must call it."""
        device = torch.device(group.device if device is None else device)
        cols_np = np.ascontiguousarray(cols_np, dtype=np.int64)
        mask_np = np.ascontiguousarray(mask_np, dtype=bool)
        plan = CondensePlan(cols_np, mask_np, device, drop_beyond=n_owned)
        ds = None
        if self.structured:
            ds = self._setup_dist_structured(cols_np, plan, group, device)
        if ds is None:
            ds = self._setup_dist_general(cols_np, plan, group, device)
        self._dist_setup = ds
        return ds is not None

    def _setup_dist_structured(self, cols_np, plan, group, device):
        """The structured shard hierarchy, or None unless every rank's
        condensed block is the same (ny, nx) grid with dead tail rows and
        couplings only at (+-1, +-nx)."""
        from ..ops.halo import all_reduce

        n = cols_np.shape[0]
        mask2 = plan.mask2
        grid = detect_grid(cols_np, mask2)
        ok, nx, ny = grid is not None, 0, 0
        if ok:
            nx, ny, merge = grid
            m = nx * ny
            ok = not (merge >= 0).any() and not mask2[m:].any()
        offsets = tuple(sorted((1, -1, nx, -nx)))
        buckets = np.full(cols_np.shape, -1, dtype=np.int64)
        if ok:
            delta = np.where(mask2, cols_np - np.arange(n)[:, None], 0)
            covered = ~mask2
            for i, off in enumerate(offsets):
                hit = mask2 & (delta == off)
                buckets[hit] = i
                covered |= hit
            ok = bool(covered.all())
        # the same grid on every rank, or the general hierarchy everywhere
        v = torch.tensor([float(ok), nx, ny], dtype=torch.float64,
                         device=group.device)
        lo = all_reduce(v, group, "min").tolist()
        hi = all_reduce(v, group, "max").tolist()
        if lo[0] == 0.0 or lo != hi:
            return None
        levels = []
        nx_, ny_, n_ = nx, ny, n
        while (n_ > self.coarse_size and len(levels) < self.max_levels
               and max(nx_, ny_) > 1):
            lev = _StructuredLevel(nx_, ny_, n_, device)
            levels.append(lev)
            nx_, ny_, n_ = lev.nx_c, lev.ny_c, lev.nC
        if not levels:
            return None
        return {"kind": "structured", "plan": plan, "offsets": offsets,
                "buckets": index_tensor(buckets.T, device), "levels": levels}

    def _setup_dist_general(self, cols_np, plan, group, device):
        """This rank's greedy-aggregation hierarchy of its condensed block,
        padded with identity levels to the deepest rank's depth."""
        from ..ops.halo import all_reduce

        cols, mask, n = cols_np, plan.mask2, cols_np.shape[0]
        levels = []
        while n > self.coarse_size and len(levels) < self.max_levels:
            lev = _Level(cols, mask, device)
            if lev.nC >= n:
                break
            levels.append(lev)
            cols, mask, n = lev.cols_c_np, lev.mask_c_np, lev.nC
        depth = int(all_reduce(torch.tensor(len(levels), device=group.device),
                               group, "max"))
        if depth == 0:
            return None
        while len(levels) < depth:
            lev = _Level(cols, mask, device, agg=np.arange(n, dtype=np.int64))
            levels.append(lev)
            cols, mask, n = lev.cols_c_np, lev.mask_c_np, lev.nC
        return {"kind": "general", "plan": plan, "levels": levels,
                "mask2": torch.from_numpy(np.ascontiguousarray(
                    plan.mask2.T)).to(device)}

    def dist_hierarchy(self, A: ELLMatrix):
        """The shard-local hierarchy of a distributed matrix: (levels, the
        level matrices, the coarsest level's inverse, rhs), ``rhs`` the
        right-side half of the rank's condensation by its own plan
        (``ELLMatrix.eliminate``; the JAX package's ``_local_condense``).
        On the structured hierarchy every level matrix is a
        ``DIAMatrix``."""
        ds = self._dist_setup
        diag2, offv, rhs = A.eliminate(ds["plan"])
        if ds["kind"] == "structured":
            bkt, offsets = ds["buckets"], ds["offsets"]
            coef = torch.stack(
                [torch.where(bkt == i, offv, 0.0).sum(dim=0)
                 for i in range(len(offsets))],
                out=empty_coef(len(offsets), A.n, offv.dtype, offv.device))
            A2 = DIAMatrix(diag2, coef, offsets).prepare()
        else:
            mask2 = ds["mask2"]
            A2 = ELLMatrix(diag=diag2, off=torch.where(mask2, offv, 0.0),
                           cols=A.cols, mask=mask2)
        levels = ds["levels"]
        mats = [A2]
        for lev in levels:
            mats.append(lev.galerkin(mats[-1]).prepare())
        tail = mats[-1]
        dense = (tail.to_dense() if isinstance(tail, DIAMatrix)
                 else _dense_from_ell(tail, tail.diag.shape[0]))
        inv, info = torch.linalg.inv_ex(dense)
        check_info(info, "AMG coarsest-level inverse (shard-local)")
        if self.precision == "bf16":
            mats = [_to_bf16(m) for m in mats]
            inv = inv.to(torch.bfloat16)
        return levels, mats, inv, rhs

    def _precond_setup_dist(self, A: ELLMatrix):
        """The shard-local cycle of a distributed matrix as r -> z: fold the
        condensed rows into r, one cycle on the local hierarchy (halo
        couplings dropped), recover the condensed rows, zero the rows the
        rank does not own (``fvm_tpu/linear/amg.py:1007-1100``)."""
        if self._dist_setup is None:
            return A.diag_solve
        levels, mats, inv, rhs = self.dist_hierarchy(A)
        owned = torch.arange(A.n, device=A.diag.device) < (
            A.n if A.n_owned is None else A.n_owned)

        def M(r):
            r2, recover = rhs(r)
            z = recover(self._cycle0(levels, mats, inv, r2))
            return torch.where(owned if z.ndim == 1 else owned[:, None], z,
                               0.0)

        return M

    def _get_levels(self, A: ELLMatrix):
        """The hierarchy of A's structure.  The first solve on a given
        cols tensor copies (cols, mask) to the host once and finds (or
        builds) the hierarchy by its structure digest; later solves find it
        by the tensor's identity.  (Condensation keeps cols and mask, so a
        condensed matrix maps to the hierarchy of its mesh.)"""
        hit = self._levels_by_cols.get(id(A.cols))
        if hit is not None and hit[0] is A.cols:
            return hit[1]
        levels = self.setup_structure(A.cols.cpu().numpy().T,
                                      A.mask.cpu().numpy().T, A.cols.device)
        self._levels_by_cols[id(A.cols)] = (A.cols, levels)
        return levels

    # -- cycle --------------------------------------------------------------

    def _smooth(self, A, x, b, sweeps):
        for _ in range(sweeps):
            x = A.jacobi_step(x, b, self.omega)
        return x

    def _cycle(self, levels, mats, inv, lvl, b, ctype=None):
        """One cycle starting with x=0 at level lvl; returns x.

        V: one coarse visit.  W: two coarse visits, both W.  F: an F visit
        followed by a V correction (``fvm_tpu/linear/amg.py:1106-1128``)."""
        ctype = ctype or self.cycle_type
        A = mats[lvl]
        if lvl == len(levels):
            return inv @ b
        x = self._smooth(A, torch.zeros_like(b), b,
                         self.nu_pre * self.smoother_sweeps)
        rc = levels[lvl].restrict(A.residual(x, b))
        xc = self._cycle(levels, mats, inv, lvl + 1, rc, ctype)
        if ctype in ("W", "F") and lvl + 1 < len(levels):
            xc = xc + self._cycle(levels, mats, inv, lvl + 1,
                                  mats[lvl + 1].residual(xc, rc),
                                  "V" if ctype == "F" else "W")
        x = x + levels[lvl].prolong(xc)
        return self._smooth(A, x, b, self.nu_post * self.smoother_sweeps)

    def _cycle0(self, levels, mats, inv, r):
        """The top-level cycle, cast to bfloat16 and back at its edges
        under ``precision="bf16"``."""
        if self.precision == "bf16":
            z = self._cycle(levels, mats, inv, 0, r.to(torch.bfloat16))
            return z.to(r.dtype)
        return self._cycle(levels, mats, inv, 0, r)

    def _build_hierarchy(self, A: ELLMatrix):
        levels = self._get_levels(A)
        mats = [A.prepare()]
        for lev in levels:
            mats.append(lev.galerkin(mats[-1]).prepare())
        tail = mats[-1]
        if isinstance(tail, DIAMatrix):
            dense = tail.to_dense()
        else:
            dense = _dense_from_ell(tail, tail.diag.shape[0])
        # factor once per solve; every coarse solve is then a matmul
        inv, info = torch.linalg.inv_ex(dense)
        check_info(info, "AMG coarsest-level inverse")
        if self.precision == "bf16":
            mats = [_to_bf16(m) for m in mats]
            inv = inv.to(torch.bfloat16)
        return levels, mats, inv

    # -- public -------------------------------------------------------------

    def precond_setup(self, A: ELLMatrix):
        """Build the hierarchy ONCE for this matrix; returns r -> z (the
        shard-local cycle for a distributed matrix)."""
        if distributed(A):
            return self._precond_setup_dist(A)
        levels, mats, inv = self._build_hierarchy(A)
        return lambda r: self._cycle0(levels, mats, inv, r)

    def solve_fn(self, A: ELLMatrix, b, x0):
        if distributed(A):
            # the shard-local cycles are an additive-Schwarz
            # preconditioner, under which plain Richardson stalls with many
            # shards: a BiCGStab whose reductions all-reduce runs around
            # them (fvm_tpu/linear/amg.py:1204-1220)
            from .krylov import BiCGStab

            return BiCGStab(
                preconditioner=self,
                relative_tolerance=self.relativeTolerance,
                absolute_tolerance=self.absoluteTolerance,
                max_iterations=self.nMaxIterations,
            ).solve_fn(A, b, x0)
        from .krylov import _all_frozen

        A, b, recover = condensed(A, b)
        A = A.prepare()
        levels, mats, inv = self._build_hierarchy(A)
        rtol, atol, maxit = (
            self.relativeTolerance,
            self.absoluteTolerance,
            self.nMaxIterations,
        )
        r = A.residual(x0, b)
        r0n = norm(r)
        target = torch.clamp(rtol * r0n, min=atol)
        # divergence guard: a V-cycle need not contract on strongly
        # convective matrices; keep the best iterate and freeze on clear
        # divergence
        limit = 1e4 * (r0n + atol)
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        x, rn, bx, bnorm = x0, r0n, x0, r0n
        for trip in range(maxit):
            active = torch.isfinite(rn) & (rn < limit) & (rn > target)
            if _all_frozen(self, trip, active):
                break
            x_n = x + self._cycle0(levels, mats, inv, r)
            r_n = A.residual(x_n, b)
            rn_n = norm(r_n)
            better = active & torch.isfinite(rn_n) & (rn_n < bnorm)
            i = i + active.to(i.dtype)
            bx = torch.where(better, x_n, bx)
            bnorm = torch.where(better, rn_n, bnorm)
            x, r, rn = (torch.where(active, a, c) for a, c in
                        ((x_n, x), (r_n, r), (rn_n, rn)))
        return recover(bx), SolveStats(i, r0n, bnorm, bnorm <= target)


class DirectSolver(LinearSolver):
    """Dense direct solve (the reference's UMFPACK DirectSolver,
    DirectSolver.cpp:6-83), for small systems and tests.  The JAX package
    solves with its own Gaussian elimination (``linear/dense.gauss_solve``,
    outside any Pallas kernel); here it is ``torch.linalg.solve_ex``."""

    def solve_fn(self, A: ELLMatrix, b, x0):
        D = _dense_from_ell(A, A.diag.shape[0])
        x, info = torch.linalg.solve_ex(D, b)
        check_info(info, "DirectSolver")
        rn = norm(b - A.mv(x))
        r0 = norm(b - A.mv(x0))
        one = torch.ones((), dtype=torch.int64, device=b.device)
        return x, SolveStats(one, r0, rn, rn <= r0 * 1e-10 + 1e-30)
