"""Geometry helpers (``fvm_tpu/geom``): so far the search structures."""

from .search import AABB, KSearchTree, Octree  # noqa: F401
