from .base import Model, ResidualHistory
from .thermal import ThermalModel, ThermalBC, ThermalVC, ThermalModelOptions
from .flow import FlowModel, FlowBC, FlowVC, FlowModelOptions
from .electric import ElectricModel, ElectricBC, ElectricVC, ElectricModelOptions, EPS0
from .sensitivity import PCExpansion, TangentMixin, jfnk_adjoint
from .scalar_generic import GenericScalarModel
from .vacancy import VacancyModel, VacancyBC, VacancyVC, VacancyModelOptions
from .species import SpeciesModel, SpeciesBC, SpeciesVC, SpeciesModelOptions
from .structure import StructureModel, StructureBC, StructureVC, StructureModelOptions
from .plate import PlateModel, PlateBC, PlateVC, PlateModelOptions
from .fracture import FractureModel, FractureBC, FractureVC
from .squeeze_film import SqueezeFilmModel, SqueezeFilmBC, SqueezeFilmVC
from .property_models import IdealGasDensityModel, RosselandModel, IdealGasVC, RosselandVC
from .shocktube import ShockTube
from .onedconduction import OneDConduction
from .motion import MovingMeshModel, StructureDeformationModel
from .contact import ContactModel, ContactVC
from .ke import KeModel, KeBC, KeVC, KeModelOptions
from .battery import BatteryModel, BatteryBC, BatteryVC, BatteryModelOptions, FARADAY, species_interface_flux
from .charging import DielectricChargingModel, DielectricChargingConstants, fermi, electron_supply
