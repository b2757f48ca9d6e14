"""Block-ELL sparse matrices: B x B coupling blocks per cell pair
(counterpart of ``fvm_tpu/ops/bell.py``).

The reference's CRMatrix with tensor diagonal/off-diagonal types
(CRMatrix.h:87 with Diag=DiagTensor/SquareTensor; MatrixOperation.h:9
SquareMatrix inverses).  Unknowns are (n, B) vectors.  The JAX package
computes the products as einsums outside any Pallas kernel, so they are
plain PyTorch here on every device.

Used by the implicitly coupled pressure-velocity systems
(``FlowModel.advanceCoupled`` and the Newton surrogate), by the structure
and plate models and, later, by battery.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..core.bcs import ghost_owner_cells


def small_inv(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of (..., B, B) blocks, B in 1..4 (the
    JAX package's formulas: adjugate over determinant up to 3, a 2 x 2
    Schur split for 4)."""
    B = M.shape[-1]
    if B == 1:
        return 1.0 / M
    if B == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    if B == 3:
        m = M
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        adj = torch.stack([torch.stack([c00, c10, c20], -1),
                           torch.stack([c01, c11, c21], -1),
                           torch.stack([c02, c12, c22], -1)], -2)
        return adj / det[..., None, None]
    if B == 4:
        # M = [[A, B], [C, D]], S = D - C A^-1 B; the (1,1) corner is the
        # velocity block, dominant in the systems assembled here, so the
        # pivot-free split is safe
        A = M[..., :2, :2]
        Bm = M[..., :2, 2:]
        C = M[..., 2:, :2]
        D = M[..., 2:, 2:]
        Ai = small_inv(A)
        Si = small_inv(D - C @ Ai @ Bm)
        AiB = Ai @ Bm
        CAi = C @ Ai
        top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], dim=-1)
        bot = torch.cat([-Si @ CAi, Si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    raise NotImplementedError(f"small_inv: B={B}")


def _bmv(blocks, x):
    """sum_j blocks[..., i, j] x[..., j] as one elementwise product and a
    sum (no batched 3 x 3 matmuls)."""
    return (blocks * x[..., None, :]).sum(dim=-1)


@dataclass(eq=False)
class BlockELLMatrix:
    """y_i = diag_i x_i + sum_k off[k, i] x[cols[k, i]]; x is (n, B).

    Slot-leading layout like ELLMatrix: the block planes are contiguous per
    slot.  ``off`` is stored with its masked slots zeroed (``assemble_block``
    builds it so), and ``mv`` masks them again as the JAX package does."""

    diag: torch.Tensor  # (n, B, B)
    off: torch.Tensor  # (K, n, B, B)
    cols: torch.Tensor  # (K, n)
    mask: torch.Tensor  # (K, n) bool

    replace = dataclasses.replace

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    @property
    def block(self) -> int:
        return self.diag.shape[-1]

    def prepare(self):
        return self

    def dot(self, a, b):
        return torch.sum(a * b)

    def norm(self, x):
        return torch.sqrt(torch.sum(x * x))

    def mv(self, x):
        off = torch.where(self.mask[:, :, None, None], self.off, 0.0)
        return _bmv(self.diag, x) + _bmv(off, x[self.cols]).sum(dim=0)

    def residual(self, x, b):
        return b - self.mv(x)

    @functools.cached_property
    def diag_inv(self):
        """The inverted diagonal blocks, computed once per matrix (an
        instance attribute, not a field: ``replace`` drops it)."""
        return small_inv(self.diag)

    def diag_solve(self, r):
        return _bmv(self.diag_inv, r)

    def jacobi_step(self, x, b, omega=1.0):
        return x + omega * self.diag_solve(b - self.mv(x))


def assemble_block(mesh, F, dF_dO, dF_dN, r_cell=None, diag_cell=None):
    """Block analogue of ``ops.assembly.assemble``
    (``fvm_tpu/ops/bell.py:149-190``).

    F: (nf, B) flux leaving the owner; dF_dO / dF_dN: (nf, B, B) Jacobian
    blocks.  Same conventions: A = -dr/dx, r_c = sources - sum_f s F_f."""
    f = mesh.cf_face
    own = mesh.cf_is_owner
    mask = mesh.cf_mask
    s = torch.where(own, 1.0, -1.0).to(F.dtype)

    dO = dF_dO[f]  # (K, nc, B, B)
    dN = dF_dN[f]
    s4 = s[:, :, None, None]
    m4 = mask[:, :, None, None]
    o4 = own[:, :, None, None]
    diag = torch.where(m4, s4 * torch.where(o4, dO, dN), 0.0).sum(dim=0)
    off = torch.where(m4, s4 * torch.where(o4, dN, dO), 0.0)
    if diag_cell is not None:
        diag = diag + diag_cell
    # dead rows -> identity blocks
    alive = mask.any(dim=0)
    B = F.shape[-1]
    eye = torch.eye(B, dtype=F.dtype, device=F.device)
    diag = torch.where(alive[:, None, None], diag, eye)

    r = residual_block(mesh, F, r_cell)
    return BlockELLMatrix(diag=diag, off=off, cols=mesh.cf_nbr,
                          mask=mask), r


def residual_block(mesh, F, r_cell=None):
    """The residual half of ``assemble_block`` alone: r_c = sources -
    sum_f s F_f, zero on dead rows.  A Jacobian-free product differentiates
    the residual only, so it skips the blocks."""
    mask = mesh.cf_mask
    s = torch.where(mesh.cf_is_owner, 1.0, -1.0).to(F.dtype)
    r = -torch.where(mask[:, :, None], s[:, :, None] * mesh.take_faces(F),
                     0.0).sum(dim=0)
    if r_cell is not None:
        r = r + r_cell
    return torch.where(mask.any(dim=0)[:, None], r, 0.0)


def _row_scale(scale, dtype, device):
    """The rows' scale as (rows, 1, 1) and (rows, 1) tensors, or 1."""
    if scale is None:
        return 1.0, 1.0
    s = torch.as_tensor(scale, dtype=dtype, device=device)
    s = torch.where(s > 0, s, 1.0)
    if s.ndim:
        return s[:, None, None], s[:, None]
    return s, s


def dirichlet_rows_block(mesh, A, r, gc: slice, value, x, valid=None,
                         scale=None):
    """Ghost block rows: scale I dx_g = scale (value - x_g).  ``A`` None:
    the residual rows alone (returns None for the matrix)."""
    B = r.shape[-1]
    eye = torch.eye(B, dtype=r.dtype, device=r.device)
    sM, sv = _row_scale(scale, r.dtype, r.device)
    resid = (value - x[gc]) * sv
    if valid is not None:
        resid = torch.where(valid[:, None], resid, 0.0)
    r = r.clone()
    r[gc] = resid
    if A is None:
        return None, r
    diag = A.diag.clone()
    diag[gc] = sM * eye
    off = A.off.clone()
    off[:, gc] = 0.0
    return A.replace(diag=diag, off=off), r


def transform_rows_block(mesh, A, r, gc: slice, T, x, valid=None,
                         scale=None, extra=None):
    """Ghost block rows enforcing x_g = T x_owner + extra (mirror or
    projection for symmetry, identity for extrapolation):
    s (dx_g - T dx_o) = s (T x_o + extra - x_g).  The surrogate rows carry
    the compact T coupling in slot 0 (the ghost's face); an exact Newton
    operator picks up d(extra)/dx as well.  ``A`` None: the residual rows
    alone."""
    B = r.shape[-1]
    eye = torch.eye(B, dtype=r.dtype, device=r.device)
    sM, sv = _row_scale(scale, r.dtype, r.device)
    n_int = mesh.n_interior_cells
    own = ghost_owner_cells(mesh)[gc.start - n_int: gc.stop - n_int]
    target = _bmv(T, x[own])
    if extra is not None:
        target = target + extra
    resid = (target - x[gc]) * sv
    if valid is not None:
        resid = torch.where(valid[:, None], resid, 0.0)
    r = r.clone()
    r[gc] = resid
    if A is None:
        return None, r
    diag = A.diag.clone()
    diag[gc] = sM * eye
    off = A.off.clone()
    off[:, gc] = 0.0
    off[0, gc] = -sM * T
    return A.replace(diag=diag, off=off), r
