"""Face-flux linearization and assembly (``fvm_tpu/ops/assembly.py``).

Every discretization accumulates three per-face arrays

    F       : flux of the conserved quantity leaving the owner cell
    dF_dO   : d F / d phi_owner
    dF_dN   : d F / d phi_neighbor

and ``assemble`` turns them into an ELL matrix + residual with gathers
over the cell->face table (the reference's PairWiseAssembler,
CRMatrix.h:117).  Conventions (defect correction, as in the reference's
LinearSystem):

    cell residual  r_c = S_c V_c - sum_f s_cf F_f          (want r -> 0)
    matrix         A = -dr/dx  (positive diagonal for diffusion)
    solve          A dx = r,   x <- x + dx
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ell import ELLMatrix


@dataclass
class FaceFlux:
    """Accumulated per-face flux linearization ((nf,) or (nf, m) for F)."""

    F: torch.Tensor
    dF_dO: torch.Tensor
    dF_dN: torch.Tensor

    def __add__(self, other: "FaceFlux") -> "FaceFlux":
        return FaceFlux(
            self.F + other.F,
            self.dF_dO + other.dF_dO,
            self.dF_dN + other.dF_dN,
        )

    @staticmethod
    def zeros(n_faces: int, m: int | None = None, dtype=torch.float64,
              device=None) -> "FaceFlux":
        """A zero flux: F (n_faces,) or (n_faces, m), scalar derivatives."""
        shape = (n_faces,) if m is None else (n_faces, m)
        return FaceFlux(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(n_faces, dtype=dtype, device=device),
            torch.zeros(n_faces, dtype=dtype, device=device),
        )


def assemble(mesh, flux: FaceFlux, r_cell=None, diag_cell=None):
    """Build (A, r) from per-face linearized fluxes + optional cell terms.

    Ghost-cell rows receive their face-balance contribution here and are
    overwritten by boundary-condition kernels afterwards (GenericBCS.h)."""
    own = mesh.cf_is_owner
    mask = mesh.cf_mask

    dO = mesh.take_faces(flux.dF_dO)
    dN = mesh.take_faces(flux.dF_dN)
    # A = -dr/dx; r_c includes -s_cf F_f with s = +1 for the owner side
    s = torch.where(own, 1.0, -1.0).to(dO.dtype)
    diag_contrib = torch.where(mask, s * torch.where(own, dO, dN), 0.0)
    off = torch.where(mask, s * torch.where(own, dN, dO), 0.0)

    diag = diag_contrib.sum(dim=0)
    if diag_cell is not None:
        diag = diag + diag_cell
    # rows with no valid face slot (the dummy cell) get an identity row
    alive = mask.any(dim=0)
    diag = torch.where(alive, diag, 1.0)

    Ff = mesh.take_faces(flux.F)  # (K, nc) or (K, nc, m)
    if Ff.ndim == 3:
        s_ = s[:, :, None]
        m_ = mask[:, :, None]
    else:
        s_, m_ = s, mask
    r = -(torch.where(m_, s_ * Ff, 0.0)).sum(dim=0)
    if r_cell is not None:
        r = r + r_cell
    r = torch.where(alive if r.ndim == 1 else alive[:, None], r, 0.0)

    A = ELLMatrix(diag=diag, off=off, cols=mesh.cf_nbr, mask=mask,
                  dia=mesh.dia, halo=mesh.halo, group=mesh.group,
                  n_owned=mesh.n_owned_cells_)
    return A, r


def identity_unowned_rows(mesh, A: ELLMatrix, r):
    """Halo/padding rows (cells >= n_owned) become identity equations
    (``fvm_tpu/ops/assembly.py:112-121``); a no-op on a single-device
    mesh, where every cell is owned."""
    if mesh.n_owned_cells >= mesh.n_cells:
        return A, r
    sl = slice(mesh.n_owned_cells, mesh.n_cells)
    diag = A.diag.clone()
    diag[sl] = 1.0
    off = A.off.clone()
    off[:, sl] = 0.0
    r = r.clone()
    r[sl] = 0.0
    return A.replace(diag=diag, off=off), r


def face_values(mesh, x, weight=0.5):
    """Linear two-point interpolation of a cell field to faces."""
    return weight * mesh.take_nbr(x) + (1.0 - weight) * mesh.take_owner(x)


def cells_to_faces_distance_weighted(mesh, x):
    """Interpolate using inverse-distance weights from cell centroids."""
    wo = mesh.face_wo.reshape((-1,) + (1,) * (x.ndim - 1))
    return wo * mesh.take_owner(x) + (1.0 - wo) * mesh.take_nbr(x)


def dirichlet_cells(A: ELLMatrix, r, mask, value, phi):
    """Pin a set of cells (immersed-boundary/solid regions) to a value.

    ``mask``: (nc,) bool; rows become scale*(dx = value - phi) with scale
    taken from the existing diagonal magnitude (GenericIBDiscretization.h).
    """
    s = torch.where(A.diag.abs() > 0, A.diag.abs(), 1.0)
    diag = torch.where(mask, s, A.diag)
    off = torch.where(mask[None, :], 0.0, A.off)
    if r.ndim == 1:
        r = torch.where(mask, s * (value - phi), r)
    elif torch.as_tensor(value).ndim == 2:
        r = torch.where(mask[:, None], s[:, None] * (value - phi), r)
    else:
        r = torch.where(mask[:, None], (s * (value - phi))[:, None], r)
    return A.replace(diag=diag, off=off), r


def ib_stencil_rows_implicit(A: ELLMatrix, r, ib_cells, fluid_idx, fw, ww,
                             value, phi, cols_ext, mask_ext, dia_ext=None,
                             valid=None):
    """IMPLICIT immersed-boundary interpolation rows
    (``fvm_tpu/ops/assembly.py:158-212``).

    The IB band's equation  phi_IB = (ww phi_wall + sum_j fw_j phi_fj) / W
    goes into the matrix: the stencil's fluid-cell couplings fill ``k``
    appended ELL slots (``cols_ext``/``mask_ext``, the widened structure
    built by ``set_immersed_boundary``, with its DIA form ``dia_ext``), so
    each outer update solves the band and the fluid together (the
    reference's GenericIBDiscretization.h; the lagged pinned rows are
    first order in the outer iteration).

    ``phi``/``value``: (n,) or (n, m).  ``valid``: optional (n_ib,) bool;
    False entries are padding and leave their rows untouched.  Returns the
    widened (A, r), its DIA coefficients to be rebuilt (``prepare``)."""
    n = A.off.shape[1]
    k = fluid_idx.shape[1]
    if valid is None:
        valid = torch.ones(ib_cells.shape, dtype=torch.bool,
                           device=ib_cells.device)
    s_full = torch.where(A.diag.abs() > 0, A.diag.abs(), 1.0)
    # the rows of the valid entries (a padding entry may share a row)
    band = torch.zeros(n, dtype=torch.int64, device=A.diag.device).index_add(
        0, ib_cells, valid.to(torch.int64)) > 0
    s = s_full[ib_cells]
    W = ww + fw.sum(dim=1)
    if phi.ndim == 1:
        interp = (ww * value[ib_cells]
                  + (fw * phi[fluid_idx]).sum(dim=1)) / W
        resid = torch.where(valid, s * (interp - phi[ib_cells]), 0.0)
        rs = torch.zeros_like(r).index_put((ib_cells,), resid)
        r = torch.where(band, rs, r)
    else:
        interp = (ww[:, None] * value[ib_cells]
                  + torch.einsum("ik,ikm->im", fw, phi[fluid_idx])
                  ) / W[:, None]
        resid = torch.where(valid[:, None],
                            s[:, None] * (interp - phi[ib_cells]), 0.0)
        rs = torch.zeros_like(r).index_put((ib_cells,), resid)
        r = torch.where(band[:, None], rs, r)
    diag = torch.where(band, s_full, A.diag)
    off0 = torch.where(band[None, :], 0.0, A.off)
    vals = torch.where(valid[:, None], -s[:, None] * fw / W[:, None], 0.0)
    off_ext = torch.zeros((k, n), dtype=A.off.dtype, device=A.off.device)
    off_ext.index_copy_(1, ib_cells, vals.T)
    A2 = A.replace(diag=diag, off=torch.cat([off0, off_ext], dim=0),
                   cols=cols_ext, mask=mask_ext, dia=dia_ext, dia_coef=None,
                   dia_fb_vals=None, scatter=None)
    return A2, r
