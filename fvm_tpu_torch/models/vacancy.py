"""VacancyModel: vacancy-concentration diffusion for electromigration
damage (``fvm_tpu/models/vacancy.py``).

The reference's VacancyModel (VacancyModel.h:19, VacancyModel_impl.h:252:
diffusion, convection, source and time-derivative discretizations over
'vacancyconcentration' with 'vacancyFlux' BCs), as a ``GenericScalarModel``.
"""

from __future__ import annotations

from ..core.options import BoundaryCondition, ModelOptions
from .scalar_generic import GenericScalarModel


class VacancyBC(BoundaryCondition):
    _allowed_types = ("Dirichlet", "SpecifiedFlux", "Symmetry", "Periodic")
    _defaults = {
        "specifiedConcentration": 0.0,
        "specifiedVacaFlux": 0.0,
    }


class VacancyVC(BoundaryCondition):
    _defaults = {
        "vacancyDiffusivity": 1.0,
        "initialVacancyConcentration": 0.0,
    }


class VacancyModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.1,
        "timeDiscretizationOrder": 1,
        "convective": False,
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


class VacancyModel(GenericScalarModel):
    name = "VacancyModel"
    var = "vacancyConcentration"
    diffusivity_vc = "vacancyDiffusivity"
    initial_vc = "initialVacancyConcentration"
    bc_dirichlet = "specifiedConcentration"
    bc_flux = "specifiedVacaFlux"

    def __init__(self, mesh):
        super().__init__(mesh)
        self.vc = VacancyVC()

    def _make_options(self):
        return VacancyModelOptions()

    def _make_bc(self):
        return VacancyBC()

    def getConcentration(self):
        return self.get_field()
