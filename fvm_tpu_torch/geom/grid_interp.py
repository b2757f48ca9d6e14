"""Interpolation of experimental grid data onto mesh points and faces
(counterpart of ``fvm_tpu/geom/grid_interp.py``; host scipy).

The reference's Grid component (Grid.h:25, ``computeInterpolatedVelocity``
:54): a measured field given on a rectilinear grid, interpolated onto
mesh faces to drive a simulation from experimental data.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import RegularGridInterpolator


class Grid:
    def __init__(self, axes, values):
        """``axes``: a tuple of 1-D coordinate arrays; ``values``: the
        field on the tensor grid, shape (*map(len, axes), n_components)."""
        self._interp = RegularGridInterpolator(
            tuple(np.asarray(a) for a in axes), np.asarray(values),
            bounds_error=False, fill_value=None)

    def computeInterpolatedVelocity(self, points) -> np.ndarray:
        """The stored field at arbitrary points (n, dim)."""
        return np.asarray(self._interp(np.asarray(points)))

    def interpolate_to_faces(self, dmesh, group_name=None) -> np.ndarray:
        """The field at a device mesh's face centroids (all faces, or one
        boundary group's)."""
        centers = dmesh.face_centroid.cpu().numpy()
        if group_name is not None:
            centers = centers[dmesh.group_faces(dmesh.group_by_name(
                group_name))]
        return self.computeInterpolatedVelocity(centers)
