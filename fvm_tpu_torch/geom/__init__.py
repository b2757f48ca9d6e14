"""Geometry (``fvm_tpu/geom``): search structures, the immersed-boundary
manager, grid data, particle tracking and the material-point method."""

from .search import AABB, KSearchTree, Octree  # noqa: F401
from .ibm import IBManager, IBType, cell_mark_particles  # noqa: F401
from .grid_interp import Grid  # noqa: F401
from .particles import ParticleTracker  # noqa: F401
from .mpm import MPM, MPMCoupling, MPMSolver  # noqa: F401
