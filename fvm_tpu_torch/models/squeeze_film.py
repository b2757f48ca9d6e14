"""SqueezeFilmModel: Reynolds-equation gas damping for MEMS gaps
(``fvm_tpu/models/squeeze_film.py``).

The squeeze-film damping of the reference's MEMS simulator (src/fvm/
scripts/MEMS/Simulator.py couples a thin-gap FlowModel under the moving
plate) as the isothermal incompressible Reynolds equation on the plate's
2D mesh, the lubrication limit for squeeze numbers << 1:

    div( h^3/(12 mu) grad p ) = dh/dt

with h the local gap, p the gauge damping pressure and dh/dt the plate's
approach rate.  Vented edges are Dirichlet p = 0, sealed edges Symmetry.
A ``GenericScalarModel`` whose diffusivity is the gap-cubed mobility and
whose source is -dh/dt.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from .base import as_tensor_like, single_device_model
from .scalar_generic import GenericScalarModel


class SqueezeFilmBC(BoundaryCondition):
    _allowed_types = ("Dirichlet", "SpecifiedFlux", "Symmetry", "Periodic")
    _defaults = {
        "specifiedPressure": 0.0,
        "specifiedFlowRate": 0.0,
    }


class SqueezeFilmVC(BoundaryCondition):
    _defaults = {
        "viscosity": 1.8e-5,
        "initialGap": 1.0,
        "initialPressure": 0.0,
    }


class SqueezeFilmModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 1e-6,
        "timeDiscretizationOrder": 1,
        "convective": False,
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-10,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


class SqueezeFilmModel(GenericScalarModel):
    name = "SqueezeFilmModel"
    var = "pressure"
    diffusivity_vc = "initialGap"  # a placeholder: D is rebuilt from h
    initial_vc = "initialPressure"
    bc_dirichlet = "specifiedPressure"
    bc_flux = "specifiedFlowRate"

    def __init__(self, mesh, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = SqueezeFilmVC()

    def _make_options(self):
        return SqueezeFilmModelOptions()

    def _make_bc(self):
        return SqueezeFilmBC()

    def _extra_params(self):
        h = self._cell_field(self.vc, "initialGap", extend_ghosts=True)
        self.params["mu"] = self._cell_field(self.vc, "viscosity",
                                             extend_ghosts=True)
        self.params["dhdt"] = self._full_cells(0.0)
        self._apply_gap(h)

    def _apply_gap(self, h):
        self.params["h"] = h
        self.params["D"] = h**3 / (12.0 * self.params["mu"])

    def _cells(self, v):
        """A scalar or an interior (or full) per-cell array, as an (nc,)
        tensor zero-padded to the mesh's cells."""
        nc = self.mesh.n_cells
        v = as_tensor_like(v if isinstance(v, torch.Tensor)
                           else np.asarray(v, dtype=np.float64),
                           self.params["h"])
        if v.ndim == 0:
            return v.expand(nc).clone()
        if v.shape[0] < nc:
            v = torch.nn.functional.pad(v, (0, nc - v.shape[0]))
        return v

    def set_gap(self, h, dhdt) -> None:
        """Replace the local gap and its rate (e.g. from a PlateModel's
        deflection and velocity) before the next solve: scalars or
        interior arrays."""
        self._apply_gap(bck.extend_to_ghosts(self.mesh, self._cells(h)))
        self.params["dhdt"] = self._cells(dhdt)

    def _source_terms(self, mesh, params, state, phi):
        # div(D grad p) - dh/dt = 0: the source is -dh/dt
        z = torch.zeros(mesh.n_cells, dtype=phi.dtype, device=phi.device)
        return z, -params["dhdt"] * mesh.cell_volume

    def getPressure(self) -> np.ndarray:
        return self.get_field()

    def getDampingForce(self) -> float:
        """The film's total reaction force on the plate: the integral of
        the damping pressure (positive resists closing, dh/dt < 0)."""
        n = self.mesh.n_interior_cells
        p = self.state[self.var]
        return float((p[:n] * self.mesh.cell_volume[:n]).sum())
