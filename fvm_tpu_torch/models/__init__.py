from .base import Model, ResidualHistory
from .thermal import ThermalModel, ThermalBC, ThermalVC, ThermalModelOptions
from .flow import FlowModel, FlowBC, FlowVC, FlowModelOptions
