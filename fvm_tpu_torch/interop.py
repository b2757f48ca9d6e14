"""Carry a model's state and parameters in from host arrays.

A model's ``state`` and ``params`` are plain dicts of tensors.  This loader
takes the same dicts as numpy arrays (for example ``np.asarray`` of the
JAX package's model state) and puts each entry on the port model's device,
floating entries in the model mesh's dtype, after checking the key sets
and the shapes against the model's own (an initialised model defines
them).  The tests use it to start both packages from the same state.
"""

from __future__ import annotations

import numpy as np
import torch


# the immersed-boundary parameters (``set_immersed_boundary``): a snapshot
# may carry them where the model has none yet; their leading size is the
# mesh's cells or faces, and whether they are floating or bool
IB_PARAMS = {"ib_mask": ("n_cells", False), "ib_value": ("n_cells", True),
             "ib_solid_mask": ("n_cells", False),
             "ib_solid_face": ("n_faces", False),
             "ib_face_sign": ("n_faces", True)}


def _load(kind: str, have: dict, given: dict, mesh, optional=()) -> dict:
    extra = set(given) - set(have)
    if set(have) - set(given) or extra - set(optional):
        raise KeyError(
            f"{kind}: keys {sorted(given)} do not match the model's "
            f"{sorted(have)}"
        )
    out = {}
    for k, v in given.items():
        a = np.asarray(v)
        ref = have.get(k)
        if ref is None:
            size, floating = IB_PARAMS[k]
            if a.ndim == 0 or a.shape[0] != getattr(mesh, size) or (
                    a.dtype.kind == "f") != floating:
                raise ValueError(
                    f"{kind}[{k!r}]: shape {a.shape} ({a.dtype}) is not a "
                    f"{'floating' if floating else 'bool'} array over the "
                    f"mesh's {getattr(mesh, size)} {size[2:]}")
            shape, is_float = a.shape, floating
        else:
            shape, is_float = tuple(ref.shape), ref.dtype.is_floating_point
        if tuple(a.shape) != shape:
            raise ValueError(
                f"{kind}[{k!r}]: shape {a.shape} does not match the model's "
                f"{shape}"
            )
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        out[k] = t.to(device=mesh.device,
                      dtype=mesh.dtype if is_float else
                      (ref.dtype if ref is not None else torch.bool))
    return out


def load_model_state(model, state: dict, params: dict | None = None) -> None:
    """Replace ``model.state`` (and ``model.params`` when given) with host
    arrays converted to the model's device and dtype.  Call after
    ``model.init()``.  A JAX package model's
    ``fvm_tpu.models.fmg.snapshot_state`` (``momAp`` and ``massFlux``
    included) has the same keys as the port model's state and loads as
    it is; so do its params, the immersed-boundary ones (``IB_PARAMS``)
    included.  New params rebuild the model's step and drop its captured
    graphs, which read the old ones."""
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
