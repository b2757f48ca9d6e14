"""Discretization kernels: diffusion, convection, transient, source.

Counterparts of ``fvm_tpu/ops/discretizations.py`` (the reference's
DiffusionDiscretization.h:31, ConvectionDiscretization.h,
TimeDerivativeDiscretization.h, SourceDiscretization.h).  Each produces a
``FaceFlux`` or cell-level (diag, residual) contributions.
"""

from __future__ import annotations

import torch

from ..exceptions import ConfigError
from .assembly import FaceFlux
from .limiters import LIMITERS, limited_sou_correction


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


SCHEMES = ("upwind", "central", "sou") + tuple(LIMITERS)


def convection_flux(mesh, phi, mass_flux, scheme: str = "upwind",
                    grad_phi=None) -> FaceFlux:
    """F = mdot * phi_face with implicit upwind weighting.

    mass_flux (nf,) is the mass flow through each face along the face area
    vector (owner -> neighbor).  scheme: 'upwind' (first order, implicit),
    'central', 'sou' (deferred second-order upwind) or a limiter name
    ('vanLeer' | 'minmod' | 'superbee') for limited SOU; the deferred
    corrections need ``grad_phi`` and are skipped without it, as in the
    JAX package (ConvectionDiscretization.h, FluxLimiters.h:19-41)."""
    if scheme not in SCHEMES:
        raise ConfigError(f"unknown convection scheme {scheme!r}; "
                          f"known: {SCHEMES}")
    if scheme == "central":
        dO = 0.5 * mass_flux
        dN = 0.5 * mass_flux
    else:
        dO = mass_flux.clamp(min=0.0)
        dN = mass_flux.clamp(max=0.0)
    po = mesh.take_owner(phi)
    pn = mesh.take_nbr(phi)
    if phi.ndim == 1:
        F = dO * po + dN * pn
    else:
        F = dO[:, None] * po + dN[:, None] * pn
    if scheme in LIMITERS and grad_phi is not None:
        if phi.ndim == 1:
            F = F + limited_sou_correction(mesh, phi, mass_flux, grad_phi,
                                           scheme)
        else:
            F = torch.stack([
                F[:, m] + limited_sou_correction(
                    mesh, phi[:, m], mass_flux, grad_phi[:, m], scheme)
                for m in range(phi.shape[1])], dim=1)
    if scheme == "sou" and grad_phi is not None:
        # deferred correction: extrapolate from the upwind cell centroid
        up_is_owner = mass_flux >= 0
        go_, gn_ = mesh.take_owner(grad_phi), mesh.take_nbr(grad_phi)
        co_ = mesh.take_owner(mesh.cell_centroid)
        cn_ = mesh.take_nbr(mesh.cell_centroid)
        sel = up_is_owner.reshape((-1,) + (1,) * (grad_phi.ndim - 1))
        gup = torch.where(sel, go_, gn_)
        xup = torch.where(up_is_owner[:, None], co_, cn_)
        dx = mesh.face_centroid - xup
        corr = torch.einsum("f...d,fd->f...", gup, dx)
        if phi.ndim == 1:
            F = F + mass_flux * corr
        else:
            F = F + mass_flux[:, None] * corr
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
