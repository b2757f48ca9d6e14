"""Option / BC / VC dictionaries (counterpart of ``fvm_tpu/core/options.py``).

Every model exposes per-boundary BC dicts, a VC dict and a model-options
dict where each scalar entry can instead be a per-face/cell array (the
reference's ``FloatVal`` holds constant-or-Field).  ``resolve`` broadcasts
a constant or validates an array to the requested size, as a tensor on the
requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exceptions import ConfigError


class FloatVarDict(dict):
    """dict with attribute access and constant-or-array values."""

    _defaults: dict = {}

    def __init__(self, **overrides):
        super().__init__()
        # merge _defaults across the MRO (base first, derived overrides)
        for klass in reversed(type(self).__mro__):
            for k, v in vars(klass).get("_defaults", {}).items():
                self[k] = v
        self.update(overrides)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif isinstance(getattr(type(self), name, None), property):
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    # reference API parity (FloatVarDict.i getVar/setVar)
    def getVar(self, name):
        return self[name]

    def setVar(self, name, value):
        if name not in self and name not in type(self)._defaults:
            raise ConfigError(
                f"{type(self).__name__}: unknown option {name!r}; "
                f"known: {sorted(self.keys())}"
            )
        self[name] = value

    def resolve(self, name, size, dtype, device):
        """Entry as a tensor of shape (size,) (or (size, d) for a
        per-component array) on ``device``.  Floats take ``dtype``; bools
        and integer arrays keep theirs.  Arrays shorter than ``size`` are
        zero-padded (device meshes append ghost/padding cells)."""
        v = self[name]
        if callable(v):
            raise ConfigError(f"{name}: callables not supported; pass arrays")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        is_float = arr.dtype.kind == "f" or (
            isinstance(v, (int, float, list, tuple)) and not isinstance(v, bool)
        )
        if is_float:
            t = torch.as_tensor(arr.astype(np.float64)).to(device, dtype)
        else:
            t = torch.as_tensor(arr).to(device)
        if t.ndim == 0:
            return t.expand(size).clone()
        if t.shape[0] < size:
            pad = torch.zeros((size - t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=device)
            t = torch.cat([t, pad])
        elif t.shape[0] != size:
            raise ConfigError(
                f"{name}: array of shape {tuple(t.shape)} does not match "
                f"size {size}"
            )
        return t


class BoundaryCondition(FloatVarDict):
    """Per-face-group BC: a type tag + value entries."""

    _allowed_types: tuple = ()

    def __init__(self, bc_type=None, **overrides):
        super().__init__(**overrides)
        object.__setattr__(self, "_bc_type", bc_type)

    @property
    def bc_type(self):
        return self._bc_type

    @bc_type.setter
    def bc_type(self, value):
        if self._allowed_types and value not in self._allowed_types:
            raise ConfigError(
                f"{type(self).__name__}: unknown bc_type {value!r}; "
                f"allowed: {self._allowed_types}"
            )
        object.__setattr__(self, "_bc_type", value)

    # reference scripts write bc.bcType = "..."
    @property
    def bcType(self):
        return self._bc_type

    @bcType.setter
    def bcType(self, value):
        self.bc_type = value


class ModelOptions(FloatVarDict):
    """Model options (tolerances, transient switches, solvers...)."""

    _defaults = {
        # outer iterations per dispatch: > 1 runs the outer loop in chunks
        # of that many iterations with the convergence test on the device
        # and one host read-back per chunk; on a CUDA mesh each chunk is
        # one CUDA graph replay (models/chunk.py).  0/1: the classic
        # per-iteration loop
        "outerChunk": 0,
        # raise SolverError on a NaN/Inf outer residual (opt-in FPE trap)
        "trapNonfinite": False,
    }
