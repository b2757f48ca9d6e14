from .quadrature import Quadrature
from .esbgk import KineticModel, KineticBC, KineticVC
