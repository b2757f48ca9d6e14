"""Discretization kernels: diffusion, convection, transient, source.

Counterparts of ``fvm_tpu/ops/discretizations.py`` (the reference's
DiffusionDiscretization.h:31, ConvectionDiscretization.h,
TimeDerivativeDiscretization.h, SourceDiscretization.h).  Each produces a
``FaceFlux`` or cell-level (diag, residual) contributions.
"""

from __future__ import annotations

import torch

from .assembly import FaceFlux


def harmonic_face_gamma(mesh, gamma_cell):
    """Distance-weighted harmonic mean of a cell diffusivity at faces
    (DiffusionDiscretization.h:19 ``harmonicAverage``).

    Keeps the JAX package's double-where form go*gn / ((1-w)*gn + w*go):
    a reciprocal-of-clamp form overflows the tangent when a gamma is
    exactly zero, and the two must stay the same function."""
    go = mesh.take_owner(gamma_cell)
    gn = mesh.take_nbr(gamma_cell)
    w = 1.0 - mesh.face_wo
    den = (1.0 - w) * gn + w * go
    safe = den > torch.finfo(den.dtype).tiny
    return torch.where(safe, go * gn / torch.where(safe, den, 1.0), 0.0)


def diffusion_flux(mesh, phi, gamma_face, grad_phi=None) -> FaceFlux:
    """F = -gamma_f [ e_over_d (phi_N - phi_O) + grad_f . T ]  (per face).

    The second term is the deferred non-orthogonal correction with the
    face-averaged gradient; T = 0 on orthogonal meshes."""
    dO = gamma_face * mesh.face_e_over_d
    po = mesh.take_owner(phi)
    pn = mesh.take_nbr(phi)
    if phi.ndim == 1:
        F = -dO * (pn - po)
    else:
        F = -dO[:, None] * (pn - po)
    if grad_phi is not None:
        # grad_phi: (nc, dim) or (nc, m, dim)
        gf = 0.5 * (mesh.take_owner(grad_phi) + mesh.take_nbr(grad_phi))
        corr = torch.einsum("f...d,fd->f...", gf, mesh.face_t)
        if phi.ndim == 1:
            F = F - gamma_face * corr
        else:
            F = F - gamma_face[:, None] * corr
    return FaceFlux(F=F, dF_dO=dO, dF_dN=-dO)


def convection_flux(mesh, phi, mass_flux, scheme: str = "upwind") -> FaceFlux:
    """F = mdot * phi_face with implicit first-order upwind weighting.

    mass_flux (nf,) is the mass flow through each face along the face area
    vector (owner -> neighbor).  Central, SOU and limited schemes are not
    ported yet."""
    if scheme != "upwind":
        raise NotImplementedError(f"convection scheme {scheme!r} not ported")
    dO = mass_flux.clamp(min=0.0)
    dN = mass_flux.clamp(max=0.0)
    po = mesh.take_owner(phi)
    pn = mesh.take_nbr(phi)
    if phi.ndim == 1:
        F = dO * po + dN * pn
    else:
        F = dO[:, None] * po + dN[:, None] * pn
    return FaceFlux(F=F, dF_dO=dO, dF_dN=dN)


def transient_term(mesh, phi, phi_n1, dt: float, rho_cp=1.0, phi_n2=None):
    """BDF1/BDF2 time derivative as (diag_cell, r_cell) contributions:
    diag += rho*V/dt, r -= rho*V/dt * (phi - phi_n1)  [BDF1]."""
    V = mesh.cell_volume
    coeff = rho_cp * V / dt
    if phi_n2 is None:
        dphidt = phi - phi_n1
        diag = coeff
    else:
        dphidt = 1.5 * phi - 2.0 * phi_n1 + 0.5 * phi_n2
        diag = 1.5 * coeff
    if phi.ndim == 1:
        r = -coeff * dphidt
    else:
        r = -coeff[:, None] * dphidt
    return diag, r


def source_term(mesh, S, dS_dphi=None):
    """Volumetric source S (per volume): r += S*V; optional implicit part
    -dS/dphi*V on the diagonal (only when negative)."""
    V = mesh.cell_volume
    if isinstance(S, (int, float)):
        S = torch.full_like(V, float(S))
    r = (S * V) if S.ndim == 1 else S * V[:, None]
    if dS_dphi is None:
        diag = torch.zeros_like(V)
    else:
        diag = (-dS_dphi).clamp(min=0.0) * V
    return diag, r
