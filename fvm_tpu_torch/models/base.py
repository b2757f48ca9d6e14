"""Model base class (counterpart of ``fvm_tpu/models/base.py``).

The reference's ``Model`` (Model.h:13-26) plus the conventions all of
its models share: per-boundary BC maps keyed by group name and ident, a VC
dict, a ModelOptions dict, ``init()`` / ``advance(n)``.

All mutable state lives in ``self.state`` and ``self.params``, plain dicts
of tensors on the mesh's device (the JAX package's pytrees).  ``advance``
runs one linearize+solve step per outer iteration; with the option
``residualSync`` False (and ``verbose`` off) the residual norms stay
device tensors and no convergence check reads them back.
"""

from __future__ import annotations

import math

import torch

from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError, SolverError


class Model:
    name = "Model"

    def __init__(self, mesh):
        self.mesh = mesh
        self.state: dict = {}
        self.params: dict = {}
        self.options = self._make_options()
        # bc map keyed by both group name and ident (reference scripts use
        # ids, bc[zone.ident]; the generators use names)
        self.bc: dict = {}
        for g in mesh.boundary_groups():
            bc = self._make_bc()
            self.bc[g[1]] = bc
            self.bc[g[0]] = bc
        self._initialized = False

    # --- field helpers ----------------------------------------------------

    def _cell_field(self, vcdict, key, extend_ghosts=False):
        """Resolve a VC entry to an (nc,) cell tensor on the mesh's device."""
        from ..core import bcs as bck

        mesh = self.mesh
        arr = vcdict.resolve(key, mesh.n_cells, mesh.dtype, mesh.device)
        if extend_ghosts:
            arr = bck.extend_to_ghosts(mesh, arr)
        return arr

    def _full_cells(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_cells,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _full_faces(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_faces,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _resolve_bcvals(self):
        """BC value dict: ``"<group>:<key>"`` -> per-face tensor."""
        mesh = self.mesh
        vals = {}
        for g, bc in self._group_bcs():
            for key in bc:
                vals[f"{g[1]}:{key}"] = bc.resolve(key, g[4], mesh.dtype,
                                                   mesh.device)
            vals[f"{g[1]}:__valid"] = torch.ones(g[4], dtype=torch.bool,
                                                 device=mesh.device)
        return vals

    # --- subclass hooks ---------------------------------------------------

    def _make_options(self) -> ModelOptions:
        return ModelOptions()

    def _make_bc(self) -> BoundaryCondition:
        return BoundaryCondition()

    def init(self) -> None:
        raise NotImplementedError

    def advance(self, niter: int = 1):
        raise NotImplementedError

    # --- common helpers ---------------------------------------------------

    def _guard_residual(self, rnorm, it) -> None:
        """trapNonfinite option: raise SolverError on a NaN/Inf outer
        residual (the reference's SIGFPE -> CException, baseExt.i:25-30)."""
        if self.options.get("trapNonfinite") and not math.isfinite(rnorm):
            raise SolverError(
                f"{self.name}: non-finite residual {rnorm!r} at outer "
                f"iteration {it} (trapNonfinite)"
            )

    def _log_iteration(self, msg: str) -> None:
        """Per-iteration residual line, printed when verbose."""
        if self.options.get("verbose"):
            print(msg)

    def _group_bcs(self):
        """Yield (group_tuple, bc) for each boundary group."""
        for g in self.mesh.boundary_groups():
            bc = self.bc[g[1]]
            if bc.bc_type is None:
                raise ConfigError(
                    f"{self.name}: boundary group {g[1]!r} has no bc_type set"
                )
            yield g, bc

    def _residual_sync(self) -> bool:
        """Whether advance reads each outer residual back to the host."""
        opts = self.options
        return bool(opts.get("residualSync", True)) or bool(opts["verbose"])

    def updateTime(self):
        """Shift time levels (reference: <Model>_impl updateTime)."""
        raise NotImplementedError(f"{self.name} is not transient")


class ResidualHistory(list):
    """Convergence history; printable like the reference's per-iteration
    '<n>: <residual>' lines (ThermalModel_impl.h:443)."""
