"""Slope limiters for higher-order convection (``fvm_tpu/ops/limiters.py``).

The reference's limiter set (FluxLimiters.h:19-41 vanLeer/superbee/minmod,
Limiters.h), applied as limited second-order upwind: the deferred
correction of ConvectionDiscretization is scaled by psi(r), with r the
ratio of consecutive gradients.
"""

from __future__ import annotations

import torch


def van_leer(r):
    return (r + torch.abs(r)) / (1.0 + torch.abs(r))


def minmod(r):
    return torch.clamp(r, 0.0, 1.0)


def superbee(r):
    return torch.maximum(torch.clamp(2.0 * r, 0.0, 1.0),
                         torch.clamp(r, 0.0, 2.0))


LIMITERS = {"vanLeer": van_leer, "minmod": minmod, "superbee": superbee}


def limited_sou_correction(mesh, phi, mass_flux, grad_phi, limiter="vanLeer"):
    """Deferred limited-SOU face-flux correction (add to the upwind F).

    r = (2 grad_up . ds) / (phi_D - phi_U) - 1   (standard ratio),
    correction = 0.5 * psi(r) * mdot * (phi_D - phi_U).
    """
    psi = LIMITERS[limiter]
    up_is_owner = mass_flux >= 0
    po = mesh.take_owner(phi)
    pn = mesh.take_nbr(phi)
    phi_U = torch.where(up_is_owner, po, pn)
    phi_D = torch.where(up_is_owner, pn, po)
    go = mesh.take_owner(grad_phi)
    gn = mesh.take_nbr(grad_phi)
    g_up = torch.where(up_is_owner[:, None], go, gn)
    ds = torch.where(up_is_owner[:, None], mesh.face_ds, -mesh.face_ds)
    dphi = phi_D - phi_U
    denom = torch.where(torch.abs(dphi) > 1e-300, dphi,
                        torch.full_like(dphi, 1e-300))
    r = 2.0 * torch.einsum("fd,fd->f", g_up, ds) / denom - 1.0
    return 0.5 * psi(r) * mass_flux * dphi
