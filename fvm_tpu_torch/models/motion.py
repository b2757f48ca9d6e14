"""Mesh motion and the solid-deformation mapping
(``fvm_tpu/models/motion.py``).

* MovingMeshModel (the reference's MovingMeshModel.h:22): node
  displacements smoothed from the boundary motion, new metrics, the swept
  volumes (``volChange`` :165, ``sweptVolDot``);
* StructureDeformationModel (StructureDeformationModel.h:21): cell
  displacements of a structure mapped to the nodes by inverse distance.

Topology is static: motion builds a NEW host ``Mesh`` with moved nodes and
a new ``DeviceMesh`` from it (``mesh.build_device_mesh``).  The node
smoothing is a Jacobi iteration over the node graph on the device; the
node weights of the deformation mapping are computed with tensor ops
(gathers and segment sums over the node -> cell graph), equal to the JAX
package's loop over nodes.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import resolve_device
from ..exceptions import ConfigError
from ..mesh.device import build_device_mesh
from ..mesh.mesh import Mesh
from ..mesh.metrics import compute_geometry


def _node_edges(mesh: Mesh) -> np.ndarray:
    """Unique node-node edges from the face -> node connectivity."""
    fn = mesh.face_nodes
    nxt = np.arange(fn.nnz, dtype=np.int64) + 1
    last = fn.row_ptr[1:] - 1
    nxt[last] = fn.row_ptr[:-1]
    edges = np.sort(np.stack([fn.col, fn.col[nxt]], axis=1), axis=1)
    return np.unique(edges, axis=0)


def _group_nodes(mesh: Mesh, g) -> np.ndarray:
    """The sorted unique nodes of a face group's faces."""
    fn = mesh.face_nodes
    return np.unique(fn.col[fn.row_ptr[g.offset]:
                            fn.row_ptr[g.offset + g.count]])


class MovingMeshModel:
    """Smooth interior node motion from prescribed boundary displacements.

    usage::
        mm = MovingMeshModel(mesh, device="cpu")
        mm.set_boundary_displacement('top', [0.0, 0.05])
        new_mesh, new_dmesh = mm.advance(50)
        vol_change = mm.volChange
    """

    name = "MovingMeshModel"

    def __init__(self, mesh: Mesh, device=None, dtype=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = dtype  # of the device meshes it builds
        self.edges = _node_edges(mesh)
        self._bnd_disp: dict[str, np.ndarray] = {}
        self._geom0 = compute_geometry(mesh)
        self._geomN1 = self._geom0
        self._sweptVolDot = None
        self._sweptVolDotN1 = None
        self.volChange = 0.0

    def set_boundary_displacement(self, group_name: str, disp) -> None:
        self._bnd_disp[group_name] = np.asarray(disp, dtype=np.float64)

    def _boundary_nodes(self):
        """(node ids, displacements) of every constrained boundary node;
        groups without a prescribed displacement are held fixed."""
        mesh = self.mesh
        ids, disps = [], []
        for g in mesh.boundary_groups:
            d = self._bnd_disp.get(g.name, np.zeros(mesh.dim))
            nodes = _group_nodes(mesh, g)
            ids.append(nodes)
            disps.append(np.tile(d, (len(nodes), 1)))
        return np.concatenate(ids), np.concatenate(disps)

    def smooth(self, niter: int) -> torch.Tensor:
        """The node displacements after ``niter`` Jacobi sweeps (each node
        the mean of its graph neighbours, the boundary nodes held at their
        prescribed values), float64 on the model's device."""
        mesh, dev = self.mesh, self.device
        bid, bdisp = self._boundary_nodes()
        n = mesh.n_nodes
        fixed = np.zeros(n, dtype=bool)
        disp0 = np.zeros((n, mesh.dim))
        fixed[bid] = True
        disp0[bid] = bdisp
        e0 = torch.from_numpy(self.edges[:, 0]).to(dev)
        e1 = torch.from_numpy(self.edges[:, 1]).to(dev)
        fixed_t = torch.from_numpy(fixed).to(dev)[:, None]
        target = torch.from_numpy(disp0).to(dev)
        ones = torch.ones(e0.shape[0], dtype=torch.float64, device=dev)
        cnt = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, e0, ones).index_add_(0, e1, ones)
        cnt = torch.clamp(cnt, min=1.0)[:, None]
        d = target
        for _ in range(niter):
            s = torch.zeros_like(d).index_add_(0, e0, d.index_select(0, e1))
            s = s.index_add_(0, e1, d.index_select(0, e0))
            d = torch.where(fixed_t, target, s / cnt)
        return d

    def advance(self, niter: int = 50, dt=None):
        """Jacobi-smooth the node displacements; returns (new Mesh, new
        DeviceMesh).  ``dt`` sets the swept-volume rates for the ALE grid
        fluxes (MovingMeshModel::advance)."""
        mesh = self.mesh
        disp = self.smooth(niter).cpu().numpy()
        new_mesh = self._rebuild(mesh.coords + disp)
        geom = compute_geometry(new_mesh)
        n_int = mesh.n_interior_cells
        self.volChange = float(geom.cell_volume[:n_int].sum()
                               - self._geom0.cell_volume[:n_int].sum())
        # swept-volume rate per face (MovingMeshModel.h:195-245):
        # (A_new + A_old)/2 . v_f with v_f the face's node-mean grid
        # velocity; the midpoint area makes each cell's sum equal
        # (V_new - V_old)/dt for translation and stretching (the discrete
        # geometric conservation law)
        dt = float(dt) if dt is not None else 1.0
        node_vel = disp / dt
        fn = mesh.face_nodes
        nf = mesh.n_faces
        fv = np.zeros((nf, mesh.dim))
        counts = fn.row_counts()
        np.add.at(fv, np.repeat(np.arange(nf), counts), node_vel[fn.col])
        fv /= counts.astype(float)[:, None]
        amid = 0.5 * (geom.face_area + self._geomN1.face_area)
        svd_prev = self._sweptVolDot
        self._sweptVolDot = np.einsum("fd,fd->f", amid, fv)
        self._sweptVolDotN1 = svd_prev
        self.mesh = new_mesh
        self._geomN1 = geom
        self._geom0 = geom
        self._bnd_disp = {}
        return new_mesh, build_device_mesh(new_mesh, geom, dtype=self.dtype,
                                           device=self.device)

    @property
    def sweptVolDot(self) -> np.ndarray:
        """Per-face swept volume rate of the last advance()."""
        if self._sweptVolDot is None:
            raise ConfigError("MovingMeshModel: no motion advanced yet")
        return self._sweptVolDot

    def grid_flux(self, rho=1.0) -> np.ndarray:
        """ALE grid mass flux per face, to subtract from the convective
        mdot (the reference's gridFlux, with the 1.5 / -0.5 BDF2
        extrapolation once a previous step exists)."""
        svd = self.sweptVolDot
        if self._sweptVolDotN1 is not None:
            svd = 1.5 * svd - 0.5 * self._sweptVolDotN1
        return rho * svd

    def _rebuild(self, new_coords) -> Mesh:
        """A new Mesh sharing the topology, with moved nodes (the cached
        connectivities do not depend on coordinates)."""
        m = copy.copy(self.mesh)
        m.coords = np.asarray(new_coords)
        return m


def node_cell_weights(mesh: Mesh, device, geom=None):
    """The inverse-distance node -> cell weights of
    ``StructureDeformationModel`` as flat tensors (node, cell, weight):
    each node's interior cells, weighted 1/max(|x_c - x_n|, 1e-300) and
    normalized per node by a segment sum (a node with no interior cell
    has no entry, and so a zero displacement)."""
    geom = compute_geometry(mesh) if geom is None else geom
    n2c = mesh.cell_nodes.transpose(mesh.n_nodes)
    node = torch.from_numpy(np.repeat(np.arange(mesh.n_nodes, dtype=np.int64),
                                      n2c.row_counts())).to(device)
    cell = torch.from_numpy(n2c.col).to(device)
    keep = cell < mesh.n_interior_cells
    node, cell = node[keep], cell[keep]
    cc = torch.from_numpy(geom.cell_centroid).to(device)
    xn = torch.from_numpy(mesh.coords).to(device)
    d = torch.linalg.vector_norm(cc.index_select(0, cell)
                                 - xn.index_select(0, node), dim=1)
    w = 1.0 / torch.clamp(d, min=1e-300)
    wsum = torch.zeros(mesh.n_nodes, dtype=w.dtype, device=device).index_add_(
        0, node, w)
    return node, cell, w / wsum.index_select(0, node)


class StructureDeformationModel:
    """Map cell-centred structure displacements to node coordinates
    (StructureDeformationModel.h:21 ``calculateNodeDisplacement`` and
    ``deformStructure``)."""

    name = "StructureDeformationModel"

    def __init__(self, mesh: Mesh, structure_model):
        self.mesh = mesh
        self.structure = structure_model
        self.device = structure_model.mesh.device
        self._node, self._cell, self._weights = node_cell_weights(
            mesh, self.device)

    def node_displacement(self) -> torch.Tensor:
        """(n_nodes, dim) node displacements on the structure's device."""
        w_cell = self.structure.state["deformation"].to(torch.float64)
        contrib = self._weights[:, None] * w_cell.index_select(0, self._cell)
        return torch.zeros((self.mesh.n_nodes, self.mesh.dim),
                           dtype=torch.float64, device=self.device
                           ).index_add_(0, self._node, contrib)

    def getNodeDisplacement(self) -> np.ndarray:
        return self.node_displacement().cpu().numpy()

    def deformStructure(self):
        """(new Mesh, new DeviceMesh) with the nodes displaced."""
        m = copy.copy(self.mesh)
        m.coords = self.mesh.coords + self.getNodeDisplacement()
        return m, build_device_mesh(m, device=self.device,
                                    dtype=self.structure.mesh.dtype)
