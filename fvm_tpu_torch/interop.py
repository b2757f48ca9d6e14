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


def _load(kind: str, have: dict, given: dict, dtype, device) -> dict:
    if set(given) != set(have):
        raise KeyError(
            f"{kind}: keys {sorted(given)} do not match the model's "
            f"{sorted(have)}"
        )
    out = {}
    for k, v in given.items():
        a = np.asarray(v)
        ref = have[k]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(
                f"{kind}[{k!r}]: shape {a.shape} does not match the model's "
                f"{tuple(ref.shape)}"
            )
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        out[k] = t.to(device=device,
                      dtype=dtype if ref.dtype.is_floating_point else ref.dtype)
    return out


def load_model_state(model, state: dict, params: dict | None = None) -> None:
    """Replace ``model.state`` (and ``model.params`` when given) with host
    arrays converted to the model's device and dtype.  Call after
    ``model.init()``.  A JAX package model's
    ``fvm_tpu.models.fmg.snapshot_state`` (``momAp`` and ``massFlux``
    included) has the same keys as the port model's state and loads as
    it is."""
    if not getattr(model, "_initialized", False):
        raise RuntimeError("load_model_state: call model.init() first")
    mesh = model.mesh
    new_state = _load("state", model.state, state, mesh.dtype, mesh.device)
    new_params = (model.params if params is None else
                  _load("params", model.params, params, mesh.dtype,
                        mesh.device))
    model.state, model.params = new_state, new_params
