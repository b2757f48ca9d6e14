"""FractureModel: phase-field fracture evolution
(``fvm_tpu/models/fracture.py``).

The reference's FractureModel (FractureModel.h:19, FractureModel_impl.h:
diffusion of 'phasefieldvalue' with 'fractureConductivity', plus
SourceDiscretizationforFracture.h, r += V (1 + source) and diag += V
sourcecoef, the elastic-energy driving force; demos/homoCase/homoCase.py:
44-57), as a ``GenericScalarModel``.  The phase field d in [0, 1] marks
damage; the caller supplies the source fields (typically from a
StructureModel's strain energy).
"""

from __future__ import annotations

from ..core.options import BoundaryCondition, ModelOptions
from .base import as_tensor_like, single_device_model
from .scalar_generic import GenericScalarModel


class FractureBC(BoundaryCondition):
    _allowed_types = ("Dirichlet", "SpecifiedFlux", "Symmetry", "Periodic")
    _defaults = {
        "specifiedPhaseFieldValue": 1.0,
        "specifiedPhaseFieldFlux": 0.0,
    }


class FractureVC(BoundaryCondition):
    _defaults = {
        "fractureConductivity": 1.0,
        "initialPhaseFieldValue": 1.0,
        "fractureSource": 0.0,  # per-cell driving source
        "fractureSourceCoef": 0.0,  # implicit source coefficient
    }


class FractureModelOptions(ModelOptions):
    _defaults = {
        "transient": True,
        "timeStep": 1e-3,
        "timeDiscretizationOrder": 1,
        "convective": False,
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


class FractureModel(GenericScalarModel):
    name = "FractureModel"
    var = "phasefieldvalue"
    diffusivity_vc = "fractureConductivity"
    initial_vc = "initialPhaseFieldValue"
    bc_dirichlet = "specifiedPhaseFieldValue"
    bc_flux = "specifiedPhaseFieldFlux"

    def __init__(self, mesh, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = FractureVC()

    def _make_options(self):
        return FractureModelOptions()

    def _make_bc(self):
        return FractureBC()

    def _extra_params(self):
        self.params["source"] = self._cell_field(self.vc, "fractureSource")
        self.params["sourcecoef"] = self._cell_field(self.vc,
                                                     "fractureSourceCoef")

    def set_driving_source(self, source, sourcecoef):
        """Replace the elastic driving-force fields (per load step)."""
        self.params["source"] = as_tensor_like(source, self.params["source"])
        self.params["sourcecoef"] = as_tensor_like(
            sourcecoef, self.params["sourcecoef"])

    def _source_terms(self, mesh, params, state, phi):
        # SourceDiscretizationforFracture.h adds r += V (1 + source) and
        # diag += V sourcecoef; the residual keeps the consistent reaction
        # form -V coef phi so that the steady state k lap(d) + (1 + source)
        # - coef d = 0 is well posed (the same linearization)
        V = mesh.cell_volume
        r = V * (1.0 + params["source"] - params["sourcecoef"] * phi)
        return V * params["sourcecoef"], r

    def getPhaseFieldValue(self):
        return self.get_field()
