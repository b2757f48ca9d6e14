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
                  dia=mesh.dia)
    return A, r


def identity_unowned_rows(mesh, A: ELLMatrix, r):
    """Halo/padding rows (cells >= n_owned) become identity equations; a
    no-op on a single-device mesh, where every cell is owned."""
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
