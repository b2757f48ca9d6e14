"""ELL-format sparse matrix (counterpart of ``fvm_tpu/ops/ell.py``).

The reference's ``CRMatrix<Diag,OffDiag,X>`` (CRMatrix.h:87) as fixed-width
ELL slots aligned with the mesh's cell->face table, SLOT-LEADING:
``off[k, c]`` couples cell ``c`` to ``cols[k, c]``.  A matrix with DIA
structure (``dia``, from ``analyze_offsets``) runs its products through the
DIA form (``ops/dia``): ``prepare`` builds the per-offset coefficients and
the kernel operands once per assembled matrix, and ``mv``, ``residual``
and ``jacobi_step`` are the fused DIA stencil.  A matrix without it (the
deep levels of the greedy AMG, unstructured meshes) takes the gather-ELL
products: a gather of x through ``cols`` and a sum over the K slots, plain
PyTorch on every device, as the JAX package computes them in XLA outside
any Pallas kernel (``fvm_tpu/ops/ell.py:171-235``).

Solution vectors are ``(n,)`` or ``(n, m)``: m right-hand components share
one scalar coefficient matrix (u/v momentum).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .dia import DIAMatrix, build_coef, dia_apply_coef, index_tensor, transpose_dia
from .dia_kernel import diag_ready


@dataclass(eq=False)
class ELLMatrix:
    """A x = diag * x + sum_k off[k,:] * x[cols[k,:]] (masked)."""

    diag: torch.Tensor  # (n,)
    off: torch.Tensor  # (K, n) slot-leading
    cols: torch.Tensor  # (K, n) int64; padded slots point at own row
    mask: torch.Tensor  # (K, n) bool
    dia: object = None  # ops.dia.DIAInfo
    # per-offset DIA coefficients (D, n) in the kernel's padded layout
    # (``dia_kernel.empty_coef``), the role of the JAX dia_pk; and the
    # rare-offset fallback values.  Set by prepare()
    dia_coef: torch.Tensor | None = None
    dia_fb_vals: torch.Tensor | None = None
    # entries outside the slot table, (rows, cols, vals): a transpose's
    # entries whose mirror slot is absent (``transposed``), added by the
    # gather-ELL products
    scatter: tuple | None = None

    replace = dataclasses.replace

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    def prepare(self):
        """Precompute the DIA coefficients once per assembled matrix (a
        no-op without DIA structure)."""
        if self.dia_coef is not None or self.dia is None:
            return self
        coef, fb = build_coef(self.dia, self.off, self.mask)
        diag = self.diag
        if not diag_ready(diag):
            diag = diag.clone(memory_format=torch.contiguous_format)
        return self.replace(diag=diag, dia_coef=coef, dia_fb_vals=fb)

    def condense(self, b):
        """Eliminate boundary-ghost/padding rows exactly before the solve.

        Returns (A2, b2, recover): A2 has the condensed DIA structure
        (empty fallback), eliminated rows are identity with zero rhs, and
        recover(x2) back-substitutes their exact values (the reference's
        CRMatrix::eliminateBoundaryEquations, CRMatrix.h:1064)."""
        A2, rhs = self.condenser()
        return (A2,) + rhs(b)

    def condenser(self):
        """``condense`` in two halves: (A2, rhs) with rhs(b) -> (b2,
        recover).  The matrix half runs once; a preconditioner that applies
        the same condensed matrix to many right sides (``CoupledSIMPLE``)
        calls only ``rhs`` per application."""
        plan = None if self.dia is None else self.dia.cond_plan
        if plan is None:
            return self, (lambda b: (b, lambda x: x))
        er, es, ep, ir, ik, ie = plan.t
        offv = torch.where(self.mask, self.off, 0.0)
        vE = torch.where(es >= 0, offv[es.clamp(min=0), er], 0.0)
        dE = self.diag[er]
        vIn = offv[ik, ir]
        # index_add sums repeated rows (a row with several eliminated
        # neighbours); index assignment would drop all but one
        # (index_fill_ and a device zero, not index assignment of a Python
        # number, which copies it from the host: a CUDA graph can capture
        # this)
        diag2 = self.diag.index_add(0, ir, -vIn * vE[ie] / dE[ie])
        diag2.index_fill_(0, er, 1.0)
        # zero eliminated couplings in the VALUES too
        off2 = offv.clone()
        off2.index_put_((ik, ir), offv.new_zeros(()))
        off2.index_fill_(1, er, 0.0)
        A2 = self.replace(
            diag=diag2, off=off2, dia=plan.dia2,
            dia_coef=None, dia_fb_vals=None,
        ).prepare()

        def rhs(b):
            bE = b[er]
            if b.ndim == 1:
                b2 = b.index_add(0, ir, -vIn / dE[ie] * bE[ie])
            else:
                b2 = b.index_add(0, ir, -(vIn / dE[ie])[:, None] * bE[ie])
            b2.index_fill_(0, er, 0.0)

            def recover(x2):
                if x2.ndim == 1:
                    xE = (bE - vE * x2[ep]) / dE
                else:
                    xE = (bE - vE[:, None] * x2[ep]) / dE[:, None]
                x2 = x2.clone()
                x2[er] = xE
                return x2

            return b2, recover

        return A2, rhs

    def transposed(self):
        """A^T as an operator, uncondensed (the JAX package's
        ``TransposedOperator`` applies the uncondensed transpose).

        With DIA structure it is a ``DIAMatrix`` from ``transpose_dia``
        (offsets negated, coefficient rows shifted, fallback rows and
        columns swapped), so its products launch ``dia_stencil``.  Without
        it, a gather-ELL matrix on the same slot table: each entry moves to
        its mirror slot (the slot of its column's row that points back),
        and an entry whose mirror is absent (a Dirichlet or flux ghost
        row's cleared slot is still a slot; the extra slots of shell ghosts
        and periodic pairs may have none) goes to ``scatter``."""
        if self.dia is not None:
            A = self.prepare()
            d = A.dia
            offs, diag, coef, fr, fc, fv = transpose_dia(
                d.offsets, A.diag, A.dia_coef, d.fb_rows, d.fb_cols,
                A.dia_fb_vals)
            return DIAMatrix(diag, coef, offs, (fr, fc, fv))
        n = self.n
        cols = self.cols.cpu().numpy()
        mask = self.mask.cpu().numpy()
        sk, sc = np.nonzero(mask)
        tgt = cols[sk, sc]
        # slot keys (row, col) -> sorted; the mirror of (row c, col j) is
        # the slot keyed (j, c)
        keys = sc.astype(np.int64) * n + tgt
        order = np.argsort(keys, kind="stable")
        want = tgt.astype(np.int64) * n + sc
        pos = np.minimum(np.searchsorted(keys[order], want), len(keys) - 1)
        found = keys[order][pos] == want
        mk, mj = sk[order][pos], sc[order][pos]
        dev = self.off.device
        offv = torch.where(self.mask, self.off, 0.0)
        src = (index_tensor(sk[found], dev), index_tensor(sc[found], dev))
        dst = (index_tensor(mk[found], dev), index_tensor(mj[found], dev))
        # accumulate: two slots of one row pointing at one column share
        # the first mirror
        off_t = torch.zeros_like(offv).index_put(dst, offv[src],
                                                 accumulate=True)
        mask_t = torch.zeros_like(self.mask).index_put(
            dst, torch.ones((), dtype=torch.bool, device=dev))
        lone = ~found
        scatter = None
        if lone.any():
            scatter = (index_tensor(tgt[lone], dev), index_tensor(sc[lone], dev),
                       offv[index_tensor(sk[lone], dev),
                            index_tensor(sc[lone], dev)])
        return ELLMatrix(self.diag, off_t, self.cols, mask_t, scatter=scatter)

    def dot(self, a, b):
        return torch.sum(a * b)

    def norm(self, x):
        return torch.sqrt(torch.sum(x * x))

    def _gather_ax(self, x, mode):
        """A x by gather-ELL: diag x + sum_k off[k] x[cols[k]]."""
        key = (mode, self.n)
        gather_ell_ops[key] = gather_ell_ops.get(key, 0) + 1
        off = torch.where(self.mask, self.off, 0.0)
        if x.ndim == 1:
            y = self.diag * x + (off * x[self.cols]).sum(dim=0)
        else:
            y = (self.diag[:, None] * x
                 + (off[:, :, None] * x[self.cols]).sum(dim=0))
        if self.scatter is not None:
            rows, cols, vals = self.scatter
            y = y.index_add(0, rows, vals * x[cols] if x.ndim == 1
                            else vals[:, None] * x[cols])
        return y

    def mv(self, x):
        """Sparse matrix-vector product; x is (n,) or (n, m)."""
        A = self.prepare()
        if A.dia is None:
            return A._gather_ax(x, "mv")
        return dia_apply_coef(A.dia, A.diag, A.dia_coef, A.dia_fb_vals, x)

    def residual(self, x, b):
        """b - A x (one fused pass on the DIA route)."""
        A = self.prepare()
        if A.dia is None:
            return b - A._gather_ax(x, "residual")
        return dia_apply_coef(A.dia, A.diag, A.dia_coef, A.dia_fb_vals, x,
                              b=b, mode="residual")

    def diag_solve(self, r):
        return r / (self.diag if r.ndim == 1 else self.diag[:, None])

    def jacobi_step(self, x, b, omega=1.0):
        """Damped Jacobi: x + omega * D^-1 (b - A x) (one fused pass on the
        DIA route)."""
        A = self.prepare()
        if A.dia is None:
            return x + omega * A.diag_solve(b - A._gather_ax(x, "jacobi"))
        return dia_apply_coef(A.dia, A.diag, A.dia_coef, A.dia_fb_vals, x,
                              b=b, omega=omega, mode="jacobi")


# gather-ELL products by (mode, rows) since the last reset: each is several
# PyTorch launches (gather, products, slot sum, elementwise), counted once
gather_ell_ops: dict = {}
