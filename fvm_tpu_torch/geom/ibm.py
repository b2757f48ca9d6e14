"""Immersed-boundary manager: cell marking and interpolation stencils
(counterpart of ``fvm_tpu/geom/ibm.py``; host numpy on ``geom/search.py``).

The reference's IBManager (IBManager.h:57; ``update()`` :68 runs
markIntersections -> markIBTypePlus -> createIBFaces ->
createIBInterpolationStencil; GenericIBDiscretization.h consumes the
stencils):

  1. classify cell centroids against the immersed closed surface (AABB
     parity test, the reference's markIntersections and flood fill);
  2. IB cells are the fluid cells adjacent to solid cells;
  3. the result is a per-cell type array (FLUID / IB / SOLID) plus, for
     each IB cell, the nearest surface element, the interpolation
     stencil of the IB band and a Dirichlet mask for any model
     (``Model.set_immersed_boundary``).

Every table equals the JAX package's bit for bit (the same numpy and
scipy calls in the same order).
"""

from __future__ import annotations

import numpy as np

from .search import AABB, KSearchTree


class IBType:
    FLUID = 0
    IB = 1
    SOLID = 2


def _band(mesh, t):
    """Mark the fluid cells adjacent to a solid cell as IB (in place) and
    return the per-cell type over all cells (ghosts copy their owner)."""
    n_int = mesh.n_interior_cells
    owner = mesh.face_cells[: mesh.n_interior_faces, 0]
    nbr = mesh.face_cells[: mesh.n_interior_faces, 1]
    solid = t == IBType.SOLID
    adj = np.zeros(n_int, dtype=bool)
    m = (~solid[owner]) & solid[nbr]
    adj[owner[m]] = True
    m2 = (~solid[nbr]) & solid[owner]
    adj[nbr[m2]] = True
    t[adj & ~solid] = IBType.IB
    full = np.full(mesh.n_cells, IBType.FLUID, dtype=np.int32)
    full[:n_int] = t
    bfaces = np.arange(mesh.n_interior_faces, mesh.n_faces)
    full[n_int:] = full[mesh.face_cells[bfaces, 0]]
    return full


def cell_mark_particles(mesh, points, radius, geom=None):
    """Mark cells against a particle cloud (the reference's CellMark
    module, CellMark_impl.h, used by the MPM/fluid coupling).  A cell is
    SOLID when its centroid lies within ``radius`` of a particle; fluid
    cells adjacent to solid form the IB band.  Returns a per-cell ibType
    array (interior + ghosts)."""
    from ..mesh.metrics import compute_geometry

    geom = geom or compute_geometry(mesh)
    cc = geom.cell_centroid[: mesh.n_interior_cells]
    pts = np.asarray(points, dtype=float)
    if pts.ndim != 2 or len(pts) == 0:
        raise ValueError("cell_mark_particles: points must be (n, dim)")
    d, _ = KSearchTree(pts).query_batch(cc, 1)
    d = np.asarray(d).reshape(-1)
    t = np.where(d <= radius, IBType.SOLID, IBType.FLUID).astype(np.int32)
    return _band(mesh, t)


class IBManager:
    def __init__(self, mesh, geom=None):
        """``mesh``: a host Mesh; ``geom``: its MeshGeometry (computed if
        omitted)."""
        from ..mesh.metrics import compute_geometry

        self.mesh = mesh
        self.geom = geom or compute_geometry(mesh)
        self.ib_type = np.full(mesh.n_cells, IBType.FLUID, dtype=np.int32)
        self.surface = None

    def _surface_centroids(self):
        return self.surface.v[self.surface.e].mean(axis=1)

    def update(self, vertices: np.ndarray, elements: np.ndarray) -> np.ndarray:
        """(Re)mark the cells against an immersed closed surface; returns
        the per-cell ibType array (ghosts copy their owner).  (reference:
        IBManager::update, IBManager.h:68)"""
        mesh = self.mesh
        self.surface = AABB(vertices, elements)
        cc = self.geom.cell_centroid[: mesh.n_interior_cells]
        inside = self.surface.is_inside(cc)
        t = np.where(inside, IBType.SOLID, IBType.FLUID).astype(np.int32)
        self.ib_type = _band(mesh, t)
        # the nearest surface element of each IB cell (the stencil's seed)
        ib_cells = np.nonzero(t == IBType.IB)[0]
        self.ib_cells = ib_cells
        if len(ib_cells):
            tree = KSearchTree(self._surface_centroids())
            _, nearest = tree.query_batch(cc[ib_cells], 1)
            self.ib_nearest_element = np.atleast_1d(nearest)
        else:
            self.ib_nearest_element = np.array([], dtype=np.int64)
        return self.ib_type

    def interpolation_stencil(self, k_fluid: int = 4):
        """The IB band's interpolation stencils (reference: IBManager.h:83
        createIBInterpolationStencil + GenericIBDiscretization.h).  For
        each IB cell the nearest surface element's centroid (the wall
        sample) and up to ``k_fluid`` nearest FLUID cells, with
        inverse-distance weights.  Returns (ib_cells, fluid_idx (n_ib, k),
        fluid_w (n_ib, k), wall_w (n_ib,)); the models combine them as

            x_IB = (wall_w x_wall + sum fluid_w x[fluid_idx])
                   / (wall_w + sum fluid_w)

        (inverse distance is exact for the constant mode, which is what
        the pinning row needs; the reference solves a small least-squares
        problem per stencil)."""
        mesh = self.mesh
        if self.surface is None:
            raise ValueError("IBManager: call update() first")
        cc = self.geom.cell_centroid[: mesh.n_interior_cells]
        t = self.ib_type[: mesh.n_interior_cells]
        ib = self.ib_cells
        n_ib = len(ib)
        k = int(k_fluid)
        fluid_idx = np.zeros((n_ib, k), dtype=np.int64)
        fluid_w = np.zeros((n_ib, k))
        wall_pt = self._surface_centroids()[self.ib_nearest_element]
        wall_w = 1.0 / np.maximum(np.linalg.norm(cc[ib] - wall_pt, axis=1),
                                  1e-12)
        fluid_cells = np.nonzero(t == IBType.FLUID)[0]
        if len(fluid_cells) and n_ib:
            # one batched kd-tree query for the whole band (the reference
            # loops per IB cell, IBManager.h:83)
            kk = min(k, len(fluid_cells))
            d, j = KSearchTree(cc[fluid_cells]).query_batch(cc[ib], kk)
            d = np.asarray(d).reshape(n_ib, kk)
            j = np.asarray(j).reshape(n_ib, kk)
            fluid_idx[:, :kk] = fluid_cells[j]
            fluid_w[:, :kk] = 1.0 / np.maximum(d, 1e-12)
        self.wall_point = wall_pt
        return ib, fluid_idx, fluid_w, wall_w

    def ib_faces(self) -> np.ndarray:
        """Interior faces between the (fluid | IB) region and SOLID cells
        (reference: IBManager.h:82 createIBFaces): the integration surface
        of the IB force and flux integrals."""
        mesh = self.mesh
        owner = mesh.face_cells[: mesh.n_interior_faces, 0]
        nbr = mesh.face_cells[: mesh.n_interior_faces, 1]
        so = self.ib_type[owner] == IBType.SOLID
        sn = self.ib_type[nbr] == IBType.SOLID
        return np.nonzero(so ^ sn)[0]

    def dirichlet_mask(self, include_ib: bool = True) -> np.ndarray:
        """Per-cell mask of the cells to pin to the body value (solid
        always, the IB band optionally)."""
        m = self.ib_type == IBType.SOLID
        if include_ib:
            m = m | (self.ib_type == IBType.IB)
        return m
