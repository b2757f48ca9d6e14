"""Boundary-condition kernels (counterpart of ``fvm_tpu/core/bcs.py``).

The reference's GenericBCS (GenericBCS.h:77-360).  Every boundary face
owns a ghost cell whose row in the system is the boundary equation; BCs
act in two phases on static group slices:

1. patch the per-face flux linearization of the group (Neumann, symmetry);
2. patch the ghost-cell rows after assembly (Dirichlet identity rows,
   extrapolation rows, Robin sink terms).

Sign conventions follow ops.assembly: A dx = r with A = -dr/dx.  All
updates are functional: inputs are not modified.
"""

from __future__ import annotations

import torch

from ..ops.assembly import FaceFlux


def ghost_owner_cells(mesh):
    """(n_boundary_faces,) owner cell of each ghost cell."""
    return mesh.face_cell0[mesh.n_interior_faces:]


def extend_to_ghosts(mesh, x):
    """Copy owner-cell values into the ghost-cell slots (zero gradient)."""
    gh = slice(mesh.n_interior_cells,
               mesh.n_interior_cells + mesh.n_boundary_faces)
    x = x.clone()
    x[gh] = x[ghost_owner_cells(mesh)]
    return x


def _scale(scale):
    return 1.0 if scale is None else torch.where(scale > 0, scale, 1.0)


def set_flux_fixed(flux: FaceFlux, sl: slice, F_values) -> FaceFlux:
    """Replace the face flux on a group with a fixed (explicit) flux
    (applyNeumannBC, GenericBCS.h:129; symmetry is F = 0)."""
    F = flux.F.clone()
    F[sl] = F_values
    dO = flux.dF_dO.clone()
    dO[sl] = 0.0
    dN = flux.dF_dN.clone()
    dN[sl] = 0.0
    return FaceFlux(F=F, dF_dO=dO, dF_dN=dN)


def dirichlet_rows(mesh, A, r, gc: slice, value, phi, valid=None, scale=None):
    """Ghost equation: scale * dx_g = scale * (value - phi_g)
    (applyDirichletBC, GenericBCS.h:77).  ``scale`` is the face transport
    coefficient, which keeps the system well-conditioned for any material
    scale."""
    s = _scale(scale)
    diag = A.diag.clone()
    diag[gc] = s
    off = A.off.clone()
    off[:, gc] = 0.0
    resid = (value - phi[gc]) * s
    if valid is not None:
        resid = torch.where(valid, resid, 0.0)
    r = r.clone()
    r[gc] = resid
    return A.replace(diag=diag, off=off), r


def extrapolation_rows(mesh, A, r, gc: slice, phi, valid=None, scale=None):
    """Ghost equation: scale*(dx_g - dx_owner) = scale*(phi_owner - phi_g)
    (applyExtrapolationBC, GenericBCS.h:180).  Slot 0 of a ghost row is its
    single face, whose neighbor is the owner."""
    s = _scale(scale)
    diag = A.diag.clone()
    diag[gc] = s
    off = A.off.clone()
    off[:, gc] = 0.0
    off[0, gc] = -s if scale is not None else -1.0
    own = ghost_owner_cells(mesh)[gc.start - mesh.n_interior_cells:
                                  gc.stop - mesh.n_interior_cells]
    resid = (phi[own] - phi[gc]) * s
    if valid is not None:
        resid = torch.where(valid, resid, 0.0)
    r = r.clone()
    r[gc] = resid
    return A.replace(diag=diag, off=off), r


def robin_sink_rows(mesh, A, r, gc: slice, coeff, sink_residual):
    """Augment the natural ghost balance with an external exchange term
    (applyConvectionBC, GenericBCS.h:214): diag += coeff, r += sink."""
    diag = A.diag.clone()
    diag[gc] += coeff
    r = r.clone()
    r[gc] += sink_residual
    return A.replace(diag=diag), r
