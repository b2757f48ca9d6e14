"""Geometric search structures: k-NN trees and AABB intersection tests
(the port's own copy of ``fvm_tpu/geom/search.py``, host code: numpy and
scipy).

* KSearchTree (the reference's KSearchTree.h:12, CGAL orthogonal k-NN) ->
  scipy cKDTree;
* Octree (Octree.h:82-95: nearest node and radius queries over cell
  centroids) -> the same kd-tree with the reference's method names;
* AABB (AABB.h:29: segment / triangle intersections and orientation
  tests) -> vectorized numpy ray crossings and segment intersections.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


class KSearchTree:
    """k-nearest-neighbor search over a point set."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        self._tree = cKDTree(self.points)

    def findNeighbors(self, p, k: int) -> np.ndarray:
        """Indices of the k nearest points to p."""
        _, idx = self._tree.query(np.asarray(p), k=k)
        return np.atleast_1d(idx)

    def query_batch(self, pts, k: int):
        d, idx = self._tree.query(np.asarray(pts), k=k)
        return d, idx


class Octree(KSearchTree):
    """Reference-API octree over cell centroids (kd-tree backend)."""

    def getNode(self, p) -> int:
        """Nearest point index (reference: Octree::getNode)."""
        return int(self.findNeighbors(p, 1)[0])

    def getNodes(self, p, radius: float) -> np.ndarray:
        """All point indices within radius (reference radius query)."""
        return np.asarray(self._tree.query_ball_point(np.asarray(p), radius))


class AABB:
    """Intersection / orientation tests against a closed surface.

    2D: surface = segments (ns, 2, 2); 3D: triangles (ns, 3, 3).
    Vectorized brute force — import-time only, host side.
    """

    def __init__(self, vertices: np.ndarray, elements: np.ndarray):
        self.v = np.asarray(vertices, dtype=np.float64)
        self.e = np.asarray(elements, dtype=np.int64)
        self.dim = self.v.shape[1]

    # -- point classification (reference: AABB::findOrientedSide) ---------

    def is_inside(self, points: np.ndarray) -> np.ndarray:
        """Ray-crossing parity test; True for points inside the surface."""
        pts = np.asarray(points, dtype=np.float64)
        if self.dim == 2:
            return self._inside_2d(pts)
        # 3D: +x ray vs triangles (Moller-Trumbore, vectorized)
        p0 = self.v[self.e[:, 0]][None]  # (1, ns, 3)
        p1 = self.v[self.e[:, 1]][None]
        p2 = self.v[self.e[:, 2]][None]
        o = pts[:, None, :]
        d = np.array([1.0, 0.0, 0.0])
        e1 = p1 - p0
        e2 = p2 - p0
        h = np.cross(np.broadcast_to(d, e2.shape), e2)
        a = np.einsum("psd,psd->ps", e1, h)
        with np.errstate(divide="ignore", invalid="ignore"):
            f = 1.0 / a
            s = o - p0
            u = f * np.einsum("psd,psd->ps", s, h)
            q = np.cross(s, e1)
            v = f * q[..., 0]  # d . q with d = +x
            t = f * np.einsum("psd,psd->ps", e2, q)
        hit = (
            (np.abs(a) > 1e-14)
            & (u >= 0)
            & (u <= 1)
            & (v >= 0)
            & (u + v <= 1)
            & (t > 0)
        )
        return hit.sum(axis=1) % 2 == 1

    def _inside_2d(self, pts: np.ndarray) -> np.ndarray:
        """The 2D +x ray parity test over the (point, segment) pairs that
        straddle: a segment from ya to yb straddles the points with
        min(ya, yb) <= y < max(ya, yb) (no point when ya == yb), found by a
        binary search of the points sorted by y, so the work follows the
        pairs, not points x segments.  Each pair's crossing abscissa is the
        brute-force formula, so the result is the same bit for bit."""
        a = self.v[self.e[:, 0]]  # (ns, 2)
        b = self.v[self.e[:, 1]]
        y = pts[:, 1]
        order = np.argsort(y, kind="stable")
        ys = y[order]
        lo = np.searchsorted(ys, np.minimum(a[:, 1], b[:, 1]), side="left")
        hi = np.searchsorted(ys, np.maximum(a[:, 1], b[:, 1]), side="left")
        count = np.where(a[:, 1] == b[:, 1], 0, hi - lo)
        seg = np.repeat(np.arange(len(a)), count)
        start = np.repeat(lo - np.cumsum(count) + count, count)
        p = order[np.arange(len(seg)) + start]
        xa, ya = a[seg, 0], a[seg, 1]
        xb, yb = b[seg, 0], b[seg, 1]
        xi = xa + (y[p] - ya) * (xb - xa) / (yb - ya)
        crossings = np.bincount(p[xi > pts[p, 0]], minlength=len(pts))
        return crossings % 2 == 1

    def segment_intersections(self, p0s: np.ndarray, p1s: np.ndarray) -> np.ndarray:
        """Count surface crossings of each segment p0->p1 (2D only for now)."""
        if self.dim != 2:
            inside0 = self.is_inside(p0s)
            inside1 = self.is_inside(p1s)
            return (inside0 != inside1).astype(np.int64)
        a = self.v[self.e[:, 0]][None]  # (1, ns, 2)
        b = self.v[self.e[:, 1]][None]
        p = np.asarray(p0s)[:, None, :]
        r = (np.asarray(p1s) - np.asarray(p0s))[:, None, :]
        s = b - a
        rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
        qp = a - p
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / rxs
            u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / rxs
        # half-open in u so a crossing at a shared surface vertex counts once
        hit = (np.abs(rxs) > 1e-14) & (t >= 0) & (t <= 1) & (u >= 0) & (u < 1)
        return hit.sum(axis=1)
