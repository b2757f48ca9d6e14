"""Carry a model's state and parameters in from host arrays.

A model's ``state`` and ``params`` are plain dicts of tensors.  This loader
takes the same dicts as numpy arrays (for example ``np.asarray`` of the
JAX package's model state) and puts each entry on the port model's device,
floating entries in the model mesh's dtype, after checking the key sets
and the shapes against the model's own (an initialised model defines
them).  The tests use it to start both packages from the same state.

``shard_state`` takes a row of a distributed state: the JAX package's
sharded models keep every state entry stacked ``(S, n, ...)`` over the
shards, and rank ``r`` of the port holds row ``r`` (the same padded local
layout); ``stack_states`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch


# the immersed-boundary parameters (``set_immersed_boundary``): a snapshot
# may carry them where the model has none yet; their leading size (the
# mesh's cells or faces, or None: the kinetic model's tables, sized by its
# immersed-boundary faces or ``pad_faces``) and their kind (floating, bool
# or integer)
IB_PARAMS = {"ib_mask": ("n_cells", "b"), "ib_value": ("n_cells", "f"),
             "ib_solid_mask": ("n_cells", "b"),
             "ib_solid_face": ("n_faces", "b"),
             "ib_face_sign": ("n_faces", "f"),
             "ib_pin": ("n_cells", "b"), "ib_solid_cell": (None, "i"),
             "ib_fluid_cell": (None, "i"), "ib_mdot_s": (None, "f"),
             "ib_Mw": (None, "f")}
_KINDS = {"f": ("floating", None), "b": ("bool", torch.bool),
          "i": ("integer", torch.int64)}


def _load(kind: str, have: dict, given: dict, mesh, optional=()) -> dict:
    extra = set(given) - set(have)
    if set(have) - set(given) or extra - set(optional):
        raise KeyError(
            f"{kind}: keys {sorted(given)} do not match the model's "
            f"{sorted(have)}"
        )
    out = {}
    for k, v in given.items():
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        ref = have.get(k)
        if ref is None:
            size, akind = IB_PARAMS[k]
            what, tdtype = _KINDS[akind]
            kind_ok = a.dtype.kind in ("iu" if akind == "i" else akind)
            if a.ndim == 0 or not kind_ok or (
                    size is not None and a.shape[0] != getattr(mesh, size)):
                where = ("" if size is None else
                         f" over the mesh's {getattr(mesh, size)} {size[2:]}")
                raise ValueError(
                    f"{kind}[{k!r}]: shape {a.shape} ({a.dtype}) is not a "
                    f"{what} array{where}")
            shape, is_float = a.shape, akind == "f"
        else:
            shape, is_float = tuple(ref.shape), ref.dtype.is_floating_point
            tdtype = ref.dtype
        if tuple(a.shape) != shape:
            raise ValueError(
                f"{kind}[{k!r}]: shape {a.shape} does not match the model's "
                f"{shape}"
            )
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        out[k] = t.to(device=mesh.device,
                      dtype=mesh.dtype if is_float else tdtype)
    return out


def load_model_state(model, state: dict, params: dict | None = None) -> None:
    """Replace ``model.state`` (and ``model.params`` when given) with host
    arrays converted to the model's device and dtype.  Call after
    ``model.init()``.  A JAX package model's
    ``fvm_tpu.models.fmg.snapshot_state`` (``momAp`` and ``massFlux``
    included) has the same keys as the port model's state and loads as
    it is; so do its params, the immersed-boundary ones (``IB_PARAMS``)
    included.  So does a ``KineticModel``'s state (f, and f_N1 when
    transient) and its params (tau, dO, dN, the integer ``periodic_src:*``
    and ``refl_idx:*`` tables, ``refl_w:*`` and, after
    ``set_immersed_boundary``, its ``ib_*`` tables); and a
    ``PhononModel``'s state (e, and e_N1 when transient) and its params
    (dO, dN, the integer ``refl_idx:*`` and ``refl_w:*`` tables).  New
    params rebuild the model's step (and its DSA hierarchy) and drop its
    captured graphs, which read the old ones.

    The structures models load the same way: ``StructureModel``'s
    deformation (n, dim), its time levels and plastic strain (n, dim, dim)
    and its params (mu, lam, rho, body, grad_coeff); ``PlateModel``'s u
    (n, 3), its time levels and its params (D, S, nu, rho_h, the pressure
    load q, grad_coeff).  The bases the tangents chain-rule through and
    the undegraded moduli stay those of the model's own VC.

    So do ``KeModel`` (k, eps, their time levels, the velocity and the
    mass flux; params with the bool ``wall_mask``) and ``BatteryModel``
    (c, phi and c_N1; params with the int ``mat``, the bool ``iface`` and
    the 0-d kinetic constants, each kept in the model's own type), and
    ``ElectricModel``'s transport state (charge, trapped and their time
    levels).  ``DielectricChargingModel`` is no ``Model``: its state is
    charge and chargeN1, (n_interior, nTrap + 1), and the accumulated
    space charge ``_rho_acc`` (the JAX package's attribute of that name);
    it has no params."""
    if not getattr(model, "_initialized", False):
        raise RuntimeError("load_model_state: call model.init() first")
    mesh = model.mesh
    new_state = _load("state", model.state, state, mesh)
    if params is None:
        model.state = new_state
        return
    new_params = _load("params", model.params, params, mesh,
                       optional=IB_PARAMS)
    model.state, model.params = new_state, new_params
    model._drop_compiled()


def shard_state(stacked: dict, rank: int, device=None) -> dict:
    """Rank ``rank``'s local tensors of a stacked ``(S, n, ...)`` state or
    params dict (numpy, e.g. ``np.asarray`` of a sharded JAX model's
    ``state``), on ``device`` (default: the CPU; ``load_model_state``
    moves them to the model's device and dtype)."""
    return {k: torch.from_numpy(np.array(np.asarray(v)[rank], order="C")).to(
        device or "cpu") for k, v in stacked.items()}


def stack_states(states) -> dict:
    """``shard_state``'s inverse: the ranks' local state dicts (tensors or
    arrays, in rank order) stacked ``(S, n, ...)`` as numpy."""
    def host(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    return {k: np.stack([host(s[k]) for s in states]) for k in states[0]}
