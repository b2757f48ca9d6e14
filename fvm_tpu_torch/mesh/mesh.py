"""Host-side unstructured mesh (numpy).

Counterpart of ``fvm_tpu/mesh/mesh.py`` (the reference's ``Mesh``,
Mesh.h:49).  Same conventions, so device tables compare entry by entry:

* struct-of-arrays: faces are a flat (owner, neighbor) pair array plus a
  CSR face->node connectivity;
* cells: interior cells first (``n_interior_cells``), then one ghost cell
  per boundary face;
* faces: interior first, then boundary faces grouped by face group, so
  each group is a contiguous slice.

The mesh operations ``make_periodic``, ``make_interface`` (double-shell
interfaces), ``interface_faces_between``, ``cell_zone_mask``,
``cell_cells2`` and ``extract_boundary_mesh`` build the JAX package's
tables bit for bit; ``make_interface`` and the periodic face centroids
are vectorized (the JAX package loops over every face in Python).
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
        self._cell_cells = None
        self._cell_nodes = None
        # cell zones (material regions; FluentReader.cpp:182): a list of
        # (ident, name, zone_type, interior-cell ids); empty = one zone
        self.cell_zones: list[tuple[int, str, str, np.ndarray]] = []

    def cell_zone_mask(self, name) -> np.ndarray:
        """Boolean (n_interior_cells,) mask of the named cell zone."""
        for ident, zname, _, cells in self.cell_zones:
            if zname == name or ident == name:
                mask = np.zeros(self.n_interior_cells, dtype=bool)
                mask[cells] = True
                return mask
        raise MeshError(f"unknown cell zone {name!r}")

    @property
    def boundary_groups(self) -> list[FaceGroup]:
        return [g for g in self.face_groups if g.group_type != "interior"]

    def _group(self, name):
        for g in self.face_groups:
            if g.name == name:
                return g
        return None

    def _face_centroids(self, faces: np.ndarray) -> np.ndarray:
        """Node-mean centroid of each face, as the JAX package's per-face
        ``coords[nodes].mean(axis=0)``: rows of one length are averaged
        together (the same sums in the same order), others one by one."""
        fn = self.face_nodes
        counts = fn.row_counts()[faces]
        out = np.zeros((len(faces), self.dim))
        for k in np.unique(counts):
            sel = np.nonzero(counts == k)[0]
            idx = fn.row_ptr[faces[sel]][:, None] + np.arange(k)
            out[sel] = self.coords[fn.col[idx]].mean(axis=1)
        return out

    def make_periodic(self, name_a: str, name_b: str) -> None:
        """Pair two boundary face groups as periodic partners (Mesh.h:337
        PeriodicFacePairs, the ghost shift of MeshMetricsCalculator_impl.h:
        1975-2004).  Faces are matched by node-mean centroid modulo the mean
        group offset; ``build_device_mesh`` repositions each ghost at the
        wrapped partner owner, and models treat the groups with bc_type
        'Periodic' (an implicit wrap, ``core/bcs.periodic_rows``)."""
        ga, gb = self._group(name_a), self._group(name_b)
        if ga is None or gb is None:
            raise MeshError(
                f"make_periodic: unknown group {name_a!r}/{name_b!r}")
        if ga.count != gb.count:
            raise MeshError("make_periodic: group sizes differ")
        ca = self._face_centroids(np.arange(ga.offset, ga.offset + ga.count))
        cb = self._face_centroids(np.arange(gb.offset, gb.offset + gb.count))
        off = cb.mean(axis=0) - ca.mean(axis=0)
        d2 = ((ca[:, None, :] + off[None, None, :] - cb[None, :, :]) ** 2
              ).sum(-1)
        match = np.argmin(d2, axis=1)
        if len(set(match.tolist())) != ga.count:
            raise MeshError("make_periodic: face matching is not one-to-one")
        fa = np.arange(ga.offset, ga.offset + ga.count)
        fb = gb.offset + match
        if not hasattr(self, "periodic_pairs"):
            self.periodic_pairs = []
        self.periodic_pairs.extend(zip(fa.tolist(), fb.tolist()))

    def make_interface(self, name: str, faces, left_cells=None) -> "Mesh":
        """Split interior faces into a double-shell interface; returns a NEW
        mesh (the reference's createShell/createDoubleShell, Mesh.h:316-317).

        Each selected face becomes two boundary-like faces in the paired
        groups ``name:L`` (owner = the original owner) and ``name:R``
        (owner = the original neighbour, nodes in reverse order so the area
        points from it into its ghost), each with its own ghost cell: the
        two shell unknowns per face, whose rows ``core.interfaces`` writes.
        The i-th face of ``name:L`` pairs with the i-th of ``name:R``.
        ``left_cells`` ((n_interior_cells,) bool) orients the pairing: the
        L side of every face is the cell inside the mask.  Call it BEFORE
        ``make_periodic`` (face ids are renumbered)."""
        faces = np.unique(np.asarray(faces, dtype=np.int64))
        if len(faces) == 0:
            raise MeshError("make_interface: empty face selection")
        if (faces >= self.n_interior_faces).any() or (faces < 0).any():
            raise MeshError("make_interface: faces must be interior")
        nf = self.n_faces
        fc = self.face_cells.copy()
        # boundary neighbours back to -1 (ghosts are reconstructed)
        fc[self.n_interior_faces:, 1] = -1
        owners = fc[faces, 0].copy()
        nbrs = fc[faces, 1].copy()
        flip = np.zeros(len(faces), dtype=bool)
        if left_cells is not None:
            left_cells = np.asarray(left_cells, dtype=bool)
            if not (left_cells[owners] ^ left_cells[nbrs]).all():
                raise MeshError(
                    "make_interface: left_cells must contain exactly one "
                    "side of every selected face")
            flip = ~left_cells[owners]
            owners[flip], nbrs[flip] = nbrs[flip], fc[faces, 0][flip]
        # L faces: the original rows, oriented owner -> ghost
        fc[faces, 0] = owners
        fc[faces, 1] = -1
        # node rows: flipped L faces reversed, then the R faces appended as
        # reversed copies (winding from the other side)
        fn = self.face_nodes
        counts = fn.row_counts()
        rev = np.zeros(nf, dtype=bool)
        rev[faces[flip]] = True
        src_faces = np.concatenate([np.arange(nf), faces])
        src_rev = np.concatenate([rev, ~rev[faces]])
        new_counts = counts[src_faces]
        row_ptr = np.zeros(len(src_faces) + 1, dtype=np.int64)
        np.cumsum(new_counts, out=row_ptr[1:])
        j = np.arange(row_ptr[-1], dtype=np.int64) - np.repeat(
            row_ptr[:-1], new_counts)
        start = np.repeat(fn.row_ptr[src_faces], new_counts)
        k = np.repeat(new_counts, new_counts)
        pos = np.where(np.repeat(src_rev, new_counts), k - 1 - j, j)
        face_nodes = CRConnectivity(row_ptr, fn.col[start + pos],
                                    self.n_nodes)
        fcr = np.concatenate(
            [fc, np.stack([nbrs, np.full(len(faces), -1)], axis=1)], axis=0)
        groups = [
            (g.ident, g.name, g.group_type,
             np.arange(g.offset, g.offset + g.count))
            for g in self.face_groups
            if g.group_type != "interior"
        ]
        next_id = max((g.ident for g in self.face_groups), default=0) + 1
        groups.append((next_id, f"{name}:L", "interface", faces))
        groups.append((next_id + 1, f"{name}:R", "interface",
                       nf + np.arange(len(faces))))
        m = Mesh(self.dim, self.coords, face_nodes, fcr, groups,
                 mesh_id=self.mesh_id)
        m.interfaces = tuple(getattr(self, "interfaces", ())) + (
            (name, f"{name}:L", f"{name}:R"),)
        return m

    def interface_faces_between(self, mask_a, mask_b) -> np.ndarray:
        """Interior faces whose owner and neighbour lie in the two cell sets
        (e.g. material regions); masks are (n_interior_cells,) bools."""
        mask_a = np.asarray(mask_a, dtype=bool)
        mask_b = np.asarray(mask_b, dtype=bool)
        fi = self.face_cells[: self.n_interior_faces]
        o, n = fi[:, 0], fi[:, 1]
        hit = (mask_a[o] & mask_b[n]) | (mask_b[o] & mask_a[n])
        return np.nonzero(hit)[0]

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
    def cell_cells(self) -> CRConnectivity:
        """Interior cells -> adjacent cells (ghost neighbours included)."""
        if self._cell_cells is None:
            owner, nbr = self.face_cells[:, 0], self.face_cells[:, 1]
            rows = np.concatenate([owner, nbr])
            cols = np.concatenate([nbr, owner])
            keep = rows < self.n_interior_cells
            self._cell_cells = CRConnectivity.from_pairs(
                rows[keep], cols[keep], self.n_interior_cells, self.n_cells)
        return self._cell_cells

    @property
    def cell_cells2(self) -> CRConnectivity:
        """Interior cells -> 2-ring neighbourhood (neighbours of neighbours,
        self dropped, each row sorted; Mesh::getCellCells2, Mesh.h:176)."""
        cc = self.cell_cells
        rows, cols = [], []
        for i in range(self.n_interior_cells):
            ring1 = cc.row(i)
            two = set(ring1.tolist())
            for j in ring1:
                if j < self.n_interior_cells:
                    two.update(cc.row(int(j)).tolist())
            two.discard(i)
            rows.extend([i] * len(two))
            cols.extend(sorted(two))
        return CRConnectivity.from_pairs(
            np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64),
            self.n_interior_cells, self.n_cells)

    @property
    def cell_nodes(self) -> CRConnectivity:
        """Interior cells -> nodes, each in first-seen order over the
        cell's faces."""
        if self._cell_nodes is None:
            self._cell_nodes = self.cell_faces.multiply(self.face_nodes,
                                                        drop_self=False)
        return self._cell_nodes

    def extract_boundary_mesh(self, groups=None) -> "BoundaryMesh":
        """Standalone surface mesh of the boundary faces
        (Mesh::extractBoundaryMesh, Mesh.h:313).  ``groups``: the group
        names to extract (default every boundary group).  Nodes are
        compacted; the result maps back to this mesh (parent face, node and
        owner-cell ids)."""
        names = None if groups is None else set(groups)
        fids = []
        gslices: list[tuple[str, int, int]] = []
        for g in self.boundary_groups:
            if names is not None and g.name not in names:
                continue
            start = len(fids)
            fids.extend(range(g.offset, g.offset + g.count))
            gslices.append((g.name, start, g.count))
        if names is not None:
            missing = names - {n for n, _, _ in gslices}
            if missing:
                raise MeshError(
                    f"extract_boundary_mesh: unknown group(s) "
                    f"{sorted(missing)}")
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size == 0:
            raise MeshError("extract_boundary_mesh: no boundary faces")
        fn = self.face_nodes.subset(fids)
        used = np.unique(fn.col)
        remap = np.full(self.n_nodes, -1, dtype=np.int64)
        remap[used] = np.arange(used.size)
        return BoundaryMesh(
            dim=self.dim,
            coords=self.coords[used].copy(),
            face_nodes=CRConnectivity(fn.row_ptr, remap[fn.col], used.size),
            parent_faces=fids,
            parent_nodes=used,
            parent_cells=self.face_cells[fids, 0].copy(),
            groups=gslices,
            mesh_id=self.mesh_id,
        )

    def __repr__(self) -> str:
        return (
            f"Mesh(dim={self.dim}, cells={self.n_interior_cells}, "
            f"faces={self.n_faces} ({self.n_interior_faces} interior), "
            f"nodes={self.n_nodes}, groups={[g.name for g in self.face_groups]})"
        )


class BoundaryMesh:
    """Surface mesh extracted from a volume mesh's boundary (the Mesh*
    returned by Mesh::extractBoundaryMesh, Mesh.h:313).  ``parent_faces``,
    ``parent_nodes`` and ``parent_cells`` map back into the parent (face
    id, node id, owner interior-cell id); ``groups`` is a list of (name,
    offset, count) runs in extraction order."""

    def __init__(self, dim, coords, face_nodes, parent_faces, parent_nodes,
                 parent_cells, groups, mesh_id=0):
        self.dim = int(dim)
        self.coords = np.asarray(coords, dtype=np.float64)
        self.face_nodes = face_nodes
        self.parent_faces = np.asarray(parent_faces, dtype=np.int64)
        self.parent_nodes = np.asarray(parent_nodes, dtype=np.int64)
        self.parent_cells = np.asarray(parent_cells, dtype=np.int64)
        self.groups = list(groups)
        self.mesh_id = int(mesh_id)
        self.n_faces = self.parent_faces.size
        self.n_nodes = self.coords.shape[0]

    def group_slice(self, name: str) -> slice:
        for n, off, cnt in self.groups:
            if n == name:
                return slice(off, off + cnt)
        raise MeshError(f"BoundaryMesh: unknown group {name!r}")

    def face_geometry(self):
        """(centroid (n_faces, dim), area vector (n_faces, dim)) of the
        surface faces, oriented like the parent's boundary faces (a polygon
        fan, as the parent's metrics)."""
        xc = np.zeros((self.n_faces, self.dim))
        an = np.zeros((self.n_faces, self.dim))
        rp, col = self.face_nodes.row_ptr, self.face_nodes.col
        for f in range(self.n_faces):
            pts = self.coords[col[rp[f]:rp[f + 1]]]
            if self.dim == 2:
                a, b = pts[0], pts[1]
                xc[f] = 0.5 * (a + b)
                t = b - a
                an[f] = (t[1], -t[0])
            else:
                c0 = pts.mean(axis=0)
                area = np.zeros(3)
                cent = np.zeros(3)
                tot = 0.0
                for i in range(len(pts)):
                    p1, p2 = pts[i], pts[(i + 1) % len(pts)]
                    tri_a = 0.5 * np.cross(p1 - c0, p2 - c0)
                    w = np.linalg.norm(tri_a)
                    area += tri_a
                    cent += w * (c0 + p1 + p2) / 3.0
                    tot += w
                xc[f] = cent / max(tot, 1e-300)
                an[f] = area
        return xc, an

    def __repr__(self) -> str:
        return (f"BoundaryMesh(dim={self.dim}, faces={self.n_faces}, "
                f"nodes={self.n_nodes}, groups={[g[0] for g in self.groups]})")
