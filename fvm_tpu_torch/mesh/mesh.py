"""Host-side unstructured mesh (numpy).

Counterpart of ``fvm_tpu/mesh/mesh.py`` (the reference's ``Mesh``,
Mesh.h:49).  Same conventions, so device tables compare entry by entry:

* struct-of-arrays: faces are a flat (owner, neighbor) pair array plus a
  CSR face->node connectivity;
* cells: interior cells first (``n_interior_cells``), then one ghost cell
  per boundary face;
* faces: interior first, then boundary faces grouped by face group, so
  each group is a contiguous slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..exceptions import MeshError
from .connectivity import CRConnectivity


@dataclass
class FaceGroup:
    """Contiguous run of faces with a shared boundary tag (Mesh.h:28)."""

    ident: int
    name: str
    group_type: str
    offset: int
    count: int

    @property
    def faces(self) -> slice:
        return slice(self.offset, self.offset + self.count)


class Mesh:
    """Unstructured mesh (host side, numpy).

    Parameters
    ----------
    dim : 2 or 3
    coords : (n_nodes, dim) float64 node coordinates
    face_nodes : CRConnectivity faces -> nodes
    face_cells_raw : (n_faces, 2) int64; column 0 = owner cell, column 1 =
        neighbor cell or -1 for boundary faces.
    groups : list of (ident, name, group_type, face_indices)
    """

    def __init__(self, dim, coords, face_nodes, face_cells_raw, groups, mesh_id=0):
        if dim not in (2, 3):
            raise MeshError(f"dim must be 2 or 3, got {dim}")
        self.dim = int(dim)
        self.mesh_id = int(mesh_id)
        coords = np.asarray(coords, dtype=np.float64)
        if coords.shape[1] != dim:
            raise MeshError("coords second dim must equal mesh dim")
        face_cells_raw = np.asarray(face_cells_raw, dtype=np.int64)
        n_faces = face_nodes.count_from
        if face_cells_raw.shape != (n_faces, 2):
            raise MeshError("face_cells_raw must be (n_faces, 2)")

        self.n_interior_cells = int(face_cells_raw.max()) + 1

        # orient: owner always valid; boundary neighbor == -1
        fc = face_cells_raw.copy()
        swap = fc[:, 0] < 0
        fc[swap] = fc[swap][:, ::-1]
        if (fc[:, 0] < 0).any():
            raise MeshError("face with no adjacent cell")
        is_boundary = fc[:, 1] < 0

        # reorder faces: interior first, then each boundary group
        order_parts = []
        new_groups: list[FaceGroup] = []
        interior_faces = np.nonzero(~is_boundary)[0]
        order_parts.append(interior_faces)
        new_groups.append(
            FaceGroup(0, "interior", "interior", 0, len(interior_faces))
        )
        offset = len(interior_faces)
        for ident, name, gtype, fidx in groups:
            fidx = np.asarray(fidx, dtype=np.int64)
            bidx = fidx[is_boundary[fidx]]
            if gtype == "interior" or len(bidx) == 0:
                continue
            order_parts.append(bidx)
            new_groups.append(FaceGroup(int(ident), name, gtype, offset, len(bidx)))
            offset += len(bidx)
        order = np.concatenate(order_parts)
        if len(order) != n_faces:
            # faces that are boundary but in no declared group
            missing = np.setdiff1d(np.arange(n_faces), order)
            if len(missing):
                order = np.concatenate([order, missing])
                new_groups.append(
                    FaceGroup(-1, "unassigned", "wall", offset, len(missing))
                )
        self.face_groups = new_groups
        self.n_interior_faces = len(interior_faces)
        self.n_faces = n_faces

        fc = fc[order]
        self.face_nodes = face_nodes.subset(order)
        self.coords = coords
        self.n_nodes = coords.shape[0]

        # one ghost cell per boundary face
        n_bfaces = n_faces - self.n_interior_faces
        ghost_ids = self.n_interior_cells + np.arange(n_bfaces, dtype=np.int64)
        fc[self.n_interior_faces :, 1] = ghost_ids
        self.face_cells = fc  # (n_faces, 2): owner, neighbor (ghost for bdry)
        self.n_boundary_faces = n_bfaces
        self.n_cells = self.n_interior_cells + n_bfaces  # total incl. ghosts
        self._cell_faces = None
        self._cell_nodes = None

    @property
    def boundary_groups(self) -> list[FaceGroup]:
        return [g for g in self.face_groups if g.group_type != "interior"]

    @property
    def cell_faces(self) -> CRConnectivity:
        """Interior cells -> faces (ghost cells excluded; they have 1 face)."""
        if self._cell_faces is None:
            rows = np.concatenate([self.face_cells[:, 0],
                                   self.face_cells[:, 1]])
            cols = np.tile(np.arange(self.n_faces, dtype=np.int64), 2)
            keep = rows < self.n_interior_cells
            self._cell_faces = CRConnectivity.from_pairs(
                rows[keep], cols[keep], self.n_interior_cells, self.n_faces)
        return self._cell_faces

    @property
    def cell_nodes(self) -> CRConnectivity:
        """Interior cells -> nodes, each in first-seen order over the
        cell's faces."""
        if self._cell_nodes is None:
            self._cell_nodes = self.cell_faces.multiply(self.face_nodes,
                                                        drop_self=False)
        return self._cell_nodes

    def __repr__(self) -> str:
        return (
            f"Mesh(dim={self.dim}, cells={self.n_interior_cells}, "
            f"faces={self.n_faces} ({self.n_interior_faces} interior), "
            f"nodes={self.n_nodes}, groups={[g.name for g in self.face_groups]})"
        )
