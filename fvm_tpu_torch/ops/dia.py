"""DIA (diagonal-offset) form of the ELL operators.

Counterpart of ``fvm_tpu/ops/dia.py``.  With a locality-preserving cell
numbering almost every matrix entry has col - row drawn from a handful of
offsets (a structured quad mesh: {-ny, -1, +1, +ny}), so

    y = diag * x + sum_o coef_o * x[i + delta_o] + small fallback

The bulk term is the fused DIA stencil (``ops/dia_kernel.dia_stencil``:
the hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version
for a CPU tensor); the few entries with rare offsets stay a small
scatter-add outside the kernel, as in the JAX package.

Out-of-range semantics: the kernel and its plain version read x as 0
outside [0, n).  The JAX roll formula wraps around instead; the two agree
because ``analyze_offsets`` buckets only real couplings and structured
Galerkin zeroes the wrap couplings, so every out-of-range coefficient is 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import dia_kernel


def analyze_offsets(cols: np.ndarray, mask: np.ndarray, max_offsets: int = 16,
                    min_fraction: float = 0.005):
    """Choose DIA offsets for an ELL structure (host (n, K) tables).

    Returns (offsets tuple, bucket (n,K) int32 with -1 = fallback,
    fb_rows, fb_slots), or None if DIA doesn't pay.
    """
    n, K = cols.shape
    rows = np.arange(n)[:, None]
    delta = np.where(mask, cols - rows, np.iinfo(np.int32).max)
    vals, counts = np.unique(delta[mask], return_counts=True)
    order = np.argsort(counts)[::-1]
    vals, counts = vals[order], counts[order]
    total = counts.sum()
    keep = [
        int(v)
        for v, c in zip(vals[:max_offsets], counts[:max_offsets])
        if c >= min_fraction * total and v != 0
    ]
    if not keep:
        return None
    offsets = tuple(keep)
    bucket = np.full((n, K), -1, dtype=np.int32)
    for i, v in enumerate(offsets):
        bucket[delta == v] = i
    fb = mask & (bucket < 0)
    fb_frac = fb.sum() / max(total, 1)
    if fb_frac > 0.15:
        return None  # too unstructured
    fb_rows, fb_slots = np.nonzero(fb)
    return offsets, bucket, fb_rows.astype(np.int32), fb_slots.astype(np.int32)


def index_tensor(a, device):
    """Host index array -> int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


class CondensePlan:
    """Static row-elimination plan (boundary-ghost condensation).

    Rows with at most ONE off-diagonal coupling (boundary-condition ghost
    rows) are 2x2 relations eliminated exactly before the solve; after
    condensation the system is a pure tensor-product stencil (empty
    fallback) and the eliminated unknowns are recovered afterwards.
    Counterpart of the reference's CRMatrix::eliminateBoundaryEquations
    (CRMatrix.h:1064).
    """

    def __init__(self, cols: np.ndarray, mask: np.ndarray, device,
                 drop_beyond: int | None = None):
        n, K = cols.shape
        # drop_beyond: rows >= drop_beyond (a shard's halo and padding
        # cells) are outside the local domain: their rows and every
        # coupling into them leave the pattern WITHOUT folding (the
        # additive-Schwarz approximation of the shard-local AMG; never on
        # an exact solve; ``fvm_tpu/ops/dia.py:82-91``)
        if drop_beyond is not None:
            mask = mask.copy()
            mask[drop_beyond:] = False
            mask = mask & (cols < drop_beyond)
        valid = mask & (cols != np.arange(n)[:, None])
        deg = valid.sum(axis=1)
        cand = deg <= 1
        # partner of each candidate (or itself when degree 0)
        slot = np.where(cand, np.argmax(valid, axis=1), 0)
        part = np.where(cand & (deg == 1), cols[np.arange(n), slot],
                        np.arange(n))
        # drop candidates whose partner is itself a candidate (isolated
        # pairs) and those with an in-coupling from a row that is not
        # their partner (substitution would create fill-in)
        elim = cand & ~cand[part]
        for _ in range(2):
            ir, ik = np.nonzero(valid & elim[cols] & ~elim[:, None])
            tgt = cols[ir, ik]
            bad = part[tgt] != ir
            if not bad.any():
                break
            elim[tgt[bad]] = False
        self.ok = bool(elim.any())
        if not self.ok:
            self.mask2 = mask
            self.dia2 = DIAInfo.build(cols, mask, device, condense=False)
            return
        e = np.nonzero(elim)[0]
        self.elim_rows = e.astype(np.int32)
        self.elim_slot = np.where(deg[e] == 1, slot[e], -1).astype(np.int32)
        self.elim_part = part[e].astype(np.int32)
        lut = np.full(n, -1, dtype=np.int64)
        lut[e] = np.arange(len(e))
        ir, ik = np.nonzero(valid & elim[cols] & ~elim[:, None])
        self.in_rows = ir.astype(np.int32)
        self.in_slots = ik.astype(np.int32)
        self.in_elim = lut[cols[ir, ik]].astype(np.int32)
        mask2 = mask.copy()
        mask2[ir, ik] = False
        mask2[e] = False
        self.dia2 = DIAInfo.build(cols, mask2, device, condense=False)
        self.mask2 = mask2
        # device index tensors, built once per plan
        self.t = tuple(
            index_tensor(a, device) for a in (
                self.elim_rows, self.elim_slot, self.elim_part,
                self.in_rows, self.in_slots, self.in_elim,
            )
        )


class DIAInfo:
    """Static DIA metadata attached to a mesh or AMG level.

    Built from HOST (n, K) cols/mask tables; the device ``bucket`` is
    stored SLOT-LEADING (K, n) to match the ELL value layout."""

    def __init__(self, offsets, bucket, fb_rows, fb_slots, cols, device):
        self.offsets = offsets
        self.bucket = index_tensor(bucket.T, device)  # (K, n)
        self.fb_rows = index_tensor(fb_rows, device)
        self.fb_slots = index_tensor(fb_slots, device)
        self.fb_cols = index_tensor(np.asarray(cols)[fb_rows, fb_slots], device)
        self.cond_plan = None  # CondensePlan | None, set by build()

    @staticmethod
    def build(cols_np: np.ndarray, mask_np: np.ndarray, device,
              condense: bool = True):
        res = analyze_offsets(cols_np, mask_np)
        if res is None:
            return None
        offsets, bucket, fb_rows, fb_slots = res
        info = DIAInfo(offsets, bucket, fb_rows, fb_slots, cols_np, device)
        if condense and len(fb_rows):
            plan = CondensePlan(cols_np, mask_np, device)
            if plan.ok and plan.dia2 is not None:
                info.cond_plan = plan
        return info


def build_coef(dia: DIAInfo, off, mask):
    """Per-offset DIA coefficients from the slot-leading (K, n) ELL values.

    Returns (coef (D, n) in the kernel's layout, fb_vals (n_fb,)); one
    pass per assembled matrix instead of one per mv."""
    offv = torch.where(mask, off, 0.0)
    D, n = len(dia.offsets), off.shape[1]
    rows = [torch.where(dia.bucket == i, offv, 0.0).sum(dim=0)
            for i in range(D)]
    if dia_kernel.tracked(off):
        # ``out=`` takes no derivative: stack, then pad each row to the
        # layout's stride (a fresh, aligned storage) and view its n columns
        ld = dia_kernel.coef_ld(n)
        coef = F.pad(torch.stack(rows), (0, ld - n))[:, :n]
    else:
        coef = torch.stack(rows, out=dia_kernel.empty_coef(
            D, n, offv.dtype, offv.device))
    fb_vals = offv[dia.fb_slots, dia.fb_rows]
    return coef, fb_vals


def transpose_dia(offsets, diag, coef, fb_rows=None, fb_cols=None,
                  fb_vals=None):
    """A^T of a DIA operator: (offsets, diag, coef, fb_rows, fb_cols,
    fb_vals) with the offsets negated and sorted, the coefficient rows
    shifted and zero-filled in the kernel's layout
    (``dia_kernel.transpose_coef``) and the fallback entries' rows and
    columns swapped (still applied by ``apply_fallback``)."""
    t_offs, t_coef = dia_kernel.transpose_coef(offsets, coef)
    return t_offs, diag, t_coef, fb_cols, fb_rows, fb_vals


def fused_apply(offsets, diag, coef, x, b=None, omega=None, mode="mv",
                fb_rows=None, fb_cols=None, fb_vals=None):
    """Fused DIA op with precomputed per-offset coefficients.

    mode "mv": A x;  "residual": b - A x;  "jacobi": x + omega (b - A x)
    / diag.  The bulk op is ``dia_stencil`` (kernel on a CUDA tensor,
    plain version on a CPU tensor); the rare fallback entries are applied
    afterwards (``apply_fallback``).
    """
    y = dia_kernel.dia_stencil(offsets, mode, coef, diag, x, b=b,
                               omega=omega)
    if fb_rows is not None and fb_rows.shape[0]:
        y = apply_fallback(y, mode, diag, x, omega, fb_rows, fb_cols, fb_vals)
    return y


def apply_fallback(y, mode, diag, x, omega, fb_rows, fb_cols, fb_vals):
    """Add the fallback entries (offsets outside the DIA set) to a fused
    op's result ``y``: a small scatter-add (``index_add`` sums repeated
    rows), in the JAX package's order (``fvm_tpu/ops/dia.py:330-340``)."""
    contrib = (fb_vals * x[fb_cols] if x.ndim == 1
               else fb_vals[:, None] * x[fb_cols])
    if mode == "mv":
        return y.index_add(0, fb_rows, contrib)
    if mode == "residual":
        return y.index_add(0, fb_rows, -contrib)
    dfb = diag[fb_rows]
    corr = omega * contrib / (dfb if x.ndim == 1 else dfb[:, None])
    return y.index_add(0, fb_rows, -corr)


def dia_apply_coef(dia: DIAInfo, diag, coef, fb_vals, x, b=None, omega=None,
                   mode: str = "mv"):
    """fused_apply with the fallback tables taken from a DIAInfo."""
    return fused_apply(
        dia.offsets, diag, coef, x, b=b, omega=omega, mode=mode,
        fb_rows=dia.fb_rows, fb_cols=dia.fb_cols, fb_vals=fb_vals,
    )


class DIAMatrix:
    """DIA sparse matrix: diag (n,) + per-offset coefficients (D, n), and
    optional fallback entries ``fallback`` = (rows, cols, vals).

    Used for AMG coarse levels built by structured (index-pairing)
    coarsening (no fallback) and for the transpose of a DIA ``ELLMatrix``
    (``ELLMatrix.transposed``).  Same solver-facing interface as
    ELLMatrix."""

    def __init__(self, diag, coef, offsets, fallback=None):
        self.diag = diag
        self.coef = coef
        self.offsets = tuple(int(d) for d in offsets)
        self.fallback = fallback
        fb = (None, None, None) if fallback is None else fallback
        self._fb = dict(zip(("fb_rows", "fb_cols", "fb_vals"), fb))

    @property
    def n(self):
        return self.diag.shape[0]

    def prepare(self):
        """The kernel's operands: an aligned contiguous diag and the
        coefficients in the kernel's padded layout (``dia_kernel.pack_coef``;
        ``AMG`` builds its coarse levels in that layout, so this copies
        nothing there)."""
        diag_ok = dia_kernel.diag_ready(self.diag)
        coef_ok = dia_kernel.coef_packed(self.coef)
        if diag_ok and coef_ok:
            return self
        return DIAMatrix(
            self.diag if diag_ok else self.diag.clone(
                memory_format=torch.contiguous_format),
            self.coef if coef_ok else dia_kernel.pack_coef(self.coef),
            self.offsets, self.fallback)

    def dot(self, a, b):
        return torch.sum(a * b)

    def norm(self, x):
        return torch.sqrt(torch.sum(x * x))

    def mv(self, x):
        return fused_apply(self.offsets, self.diag, self.coef, x, mode="mv",
                           **self._fb)

    def residual(self, x, b):
        return fused_apply(self.offsets, self.diag, self.coef, x, b=b,
                           mode="residual", **self._fb)

    def diag_solve(self, r):
        return r / (self.diag if r.ndim == 1 else self.diag[:, None])

    def jacobi_step(self, x, b, omega=1.0):
        return fused_apply(self.offsets, self.diag, self.coef, x, b=b,
                           omega=omega, mode="jacobi", **self._fb)

    def to_dense(self):
        n = self.n
        D = torch.diag(self.diag)
        for i, d in enumerate(self.offsets):
            c = self.coef[i]
            if 0 <= d < n:
                D = D + torch.diag(c[: n - d], d)
            elif d < 0 and -d < n:
                D = D + torch.diag(c[-d:], d)
        if self.fallback is not None:
            rows, cols, vals = self.fallback
            D = D.index_put((rows, cols), vals, accumulate=True)
        return D
