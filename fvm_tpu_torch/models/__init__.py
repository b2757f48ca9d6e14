from .base import Model, ResidualHistory
from .thermal import ThermalModel, ThermalBC, ThermalVC, ThermalModelOptions
from .flow import FlowModel, FlowBC, FlowVC, FlowModelOptions
from .electric import ElectricModel, ElectricBC, ElectricVC, ElectricModelOptions, EPS0
from .sensitivity import PCExpansion, TangentMixin, jfnk_adjoint
from .scalar_generic import GenericScalarModel
from .vacancy import VacancyModel, VacancyBC, VacancyVC, VacancyModelOptions
from .species import SpeciesModel, SpeciesBC, SpeciesVC, SpeciesModelOptions
