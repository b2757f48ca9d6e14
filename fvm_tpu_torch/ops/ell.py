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

import torch

from .dia import build_coef, dia_apply_coef
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
            return self.diag * x + (off * x[self.cols]).sum(dim=0)
        return (self.diag[:, None] * x
                + (off[:, :, None] * x[self.cols]).sum(dim=0))

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
