"""Double-shell interface rows: flux balance and jump closure
(counterpart of ``fvm_tpu/core/interfaces.py``).

The reference's shell-mesh interface linearizers (LinearizeInterfaceJump.h:
24, LinearizeSpeciesInterface.h:24, LinearizeDielectric.h).  Where the
reference inserts a shell mesh between the two bulk meshes,
``Mesh.make_interface`` turns each interface face into two boundary-like
faces with their own ghost cells, the shell unknowns phi_L and phi_R;
these functions overwrite the ghost rows with

  balance row (ghost_L):  F_L + w F_R = 0, flux conservation across the
      interface, F_side the face flux leaving the bulk owner into the
      interface (its assembled linearization dF_dO, dF_dN); ``w`` carries,
      e.g., the transference factor of the battery species closure;
  closure row (ghost_R), one of
      linear jump:  phi_R = A phi_L + B   (LinearizeInterfaceJump)
      flux closure: F_R = i(phi_L, phi_R) (Butler-Volmer-style, the
                    thermal contact resistance, the dielectric layer).

Slot layout (``mesh/device.build_device_mesh``): each shell-ghost row has
slot 0 -> its own bulk owner, slot 1 -> the partner ghost, slot 2 -> the
partner bulk owner.  All updates are functional: inputs are not modified.
"""

from __future__ import annotations

import torch


def interface_slices(mesh, name: str):
    """(fL, fR, gL, gR) slices of the named interface's faces and ghosts."""
    gl, gr = mesh.interface(name)
    return (mesh.group_faces(gl), mesh.group_faces(gr),
            mesh.ghost_cells_of_group(gl), mesh.ghost_cells_of_group(gr))


def _rows(A, r, gc, diag_val, off_vals, r_val):
    """The rows ``gc`` replaced: diagonal, the given slots (others 0), rhs."""
    diag = A.diag.clone()
    diag[gc] = diag_val
    off = A.off.clone()
    off[:, gc] = 0.0
    for k, v in off_vals.items():
        off[k, gc] = v
    r = r.clone()
    r[gc] = r_val
    return A.replace(diag=diag, off=off), r


def balance_rows(mesh, name, A, r, flux, weight_R=1.0, valid=None):
    """The ghost_L rows become the flux balance r = F_L + w F_R (A =
    -dr/dx, so the diagonal -dF_L/dphi_gL stays positive like a diffusion
    row).  ``valid`` False (padded group slots) makes identity rows."""
    fL, fR, gL, _ = interface_slices(mesh, name)
    v = (torch.ones(gL.stop - gL.start, dtype=torch.bool, device=r.device)
         if valid is None else valid)
    return _rows(
        A, r, gL, torch.where(v, -flux.dF_dN[fL], 1.0),
        {0: torch.where(v, -flux.dF_dO[fL], 0.0),
         1: torch.where(v, -weight_R * flux.dF_dN[fR], 0.0),
         2: torch.where(v, -weight_R * flux.dF_dO[fR], 0.0)},
        torch.where(v, flux.F[fL] + weight_R * flux.F[fR], 0.0))


def jump_rows(mesh, name, A, r, phi, A_coeff, B_coeff, scale=None,
              valid=None):
    """The ghost_R rows become phi_R = A_coeff phi_L + B_coeff, scaled by
    ``scale`` (typically gamma_R e/d of the R faces: unit rows would wreck
    the conditioning for small-diffusivity materials)."""
    _, _, gL, gR = interface_slices(mesh, name)
    s = 1.0 if scale is None else scale
    count = gR.stop - gR.start
    v = (torch.ones(count, dtype=torch.bool, device=r.device)
         if valid is None else valid)
    ones = torch.ones(count, dtype=r.dtype, device=r.device)
    return _rows(
        A, r, gR, torch.where(v, s * ones, 1.0),
        {1: torch.where(v, -s * A_coeff * ones, 0.0)},
        torch.where(v, s * (A_coeff * phi[gL] + B_coeff - phi[gR]), 0.0))


def flux_closure_rows(mesh, name, A, r, flux, i_star, dI_dL, dI_dR, urf=1.0,
                      valid=None):
    """The ghost_R rows become the closure F_R = i(phi_L, phi_R) in delta
    form: r = F_R - i_star, diag = dI_dR - dF_R/dphi_gR with the dI_dR part
    dropped where it would weaken the diagonal (the reference's guard,
    BatteryLinearizeSpeciesInterface.h:244-250), under-relaxed by ``urf``.
    ``i_star``, ``dI_dL``, ``dI_dR``: the closure flux and its derivatives
    per interface face, in the units of flux.F."""
    _, fR, _, gR = interface_slices(mesh, name)
    v = (torch.ones(gR.stop - gR.start, dtype=torch.bool, device=r.device)
         if valid is None else valid)
    base = -flux.dF_dN[fR]  # positive transport diagonal
    diag_val = (base + torch.where(dI_dR > 0.0, dI_dR, 0.0)) / urf
    return _rows(
        A, r, gR, torch.where(v, diag_val, 1.0),
        {0: torch.where(v, -flux.dF_dO[fR], 0.0),
         1: torch.where(v, dI_dL, 0.0)},
        torch.where(v, flux.F[fR] - i_star, 0.0))


def closure_flux(flux_fn, phiL, phiR):
    """(i, di/dphi_L, di/dphi_R) of an elementwise ``flux_fn`` per face:
    one forward-mode product (``torch.func.jvp``) per argument with a unit
    tangent, the exact derivatives the JAX package takes with
    ``jax.vmap(jax.grad(...))``.  Forward mode reads nothing back to the
    host, so a CUDA graph captures it."""
    one = torch.ones_like(phiL)
    i, dL = torch.func.jvp(lambda a: flux_fn(a, phiR), (phiL,), (one,))
    _, dR = torch.func.jvp(lambda b: flux_fn(phiL, b), (phiR,), (one,))
    return i, dL, dR


def apply_model_interfaces(mesh, interface_cfg, A, r, phi, flux, D_f):
    """Balance and closure rows for every interface of ``mesh``.

    ``interface_cfg`` maps an interface name to an options dict:
      type "jump" (default): {"A_coeff", "B_coeff"}, the linear jump
          phi_R = A phi_L + B (LinearizeInterfaceJump.h:140-142);
      type "flux": {"flux_fn": f}, the closure F_R = f(phi_L, phi_R) *
          face area, f an elementwise function of two tensors returning
          a tensor (the port's counterpart of the JAX package's jax.numpy
          callable): the per-area closure flux leaving the R bulk into the
          interface, its derivatives exact (``closure_flux``);
      common: {"weight_R": w}, the balance row's weight on the R flux;
          {"urf": u}, the closure diagonal's under-relaxation.
    ``D_f``: the per-face transport coefficient (scales the jump rows)."""
    for nm, _, _ in mesh.interfaces:
        cfg = interface_cfg.get(nm, {})
        fL, fR, gL, gR = interface_slices(mesh, nm)
        # zero-area dummy faces (padded group slots) keep identity rows
        valid = mesh.face_area_mag[fL] > 0
        A, r = balance_rows(mesh, nm, A, r, flux,
                            weight_R=cfg.get("weight_R", 1.0), valid=valid)
        if cfg.get("type", "jump") == "flux":
            area = mesh.face_area_mag[fR]
            i_a, dL_a, dR_a = closure_flux(cfg["flux_fn"], phi[gL], phi[gR])
            A, r = flux_closure_rows(
                mesh, nm, A, r, flux, i_a * area, dL_a * area, dR_a * area,
                urf=cfg.get("urf", 1.0), valid=valid)
        else:
            scale = D_f[fR] * mesh.face_e_over_d[fR]
            A, r = jump_rows(mesh, nm, A, r, phi, cfg.get("A_coeff", 1.0),
                             cfg.get("B_coeff", 0.0), scale, valid=valid)
    return A, r
