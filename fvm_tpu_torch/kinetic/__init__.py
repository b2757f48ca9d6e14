from .quadrature import Quadrature
from .esbgk import KineticModel, KineticBC, KineticVC
from .phonon import PhononModel, PhononBC, PhononVC
