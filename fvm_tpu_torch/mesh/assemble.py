"""Mesh merge and split (counterpart of ``fvm_tpu/mesh/assemble.py``).

The reference's MeshAssembler and MeshDismantler (MeshAssembler.h:15,
MeshDismantler.h:16): ``merge_meshes`` fuses several meshes into one
(coincident boundary faces become interior faces, duplicate nodes are
unified) and ``extract_region`` cuts a sub-mesh out of a composite mesh
(per-material meshes).  Both run on host meshes (numpy) and build the JAX
package's tables bit for bit; the results feed ``build_device_mesh``.
"""

from __future__ import annotations

import numpy as np

from ..exceptions import MeshError
from .connectivity import CRConnectivity
from .mesh import Mesh


def _fuse_nodes(coords: np.ndarray, tol: float):
    """Map duplicate coordinates (within tol) to one id; returns
    (unique_coords, old->new index map)."""
    q = np.round(coords / max(tol, 1e-300)).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    return coords[first], inv


def merge_meshes(meshes, tol: float = 1e-9) -> Mesh:
    """Fuse meshes into ONE mesh (reference MeshAssembler.h:15).

    Boundary faces of different inputs whose node sets coincide become
    interior faces of the merged mesh; every other face group is carried
    over under its original name (identical names are concatenated).
    """
    if len(meshes) < 2:
        raise MeshError("merge_meshes: need at least two meshes")
    dim = meshes[0].dim
    if any(m.dim != dim for m in meshes):
        raise MeshError("merge_meshes: mixed dimensions")

    coords_all = np.concatenate([m.coords for m in meshes], axis=0)
    coords, nmap = _fuse_nodes(coords_all, tol)

    node_off = np.cumsum([0] + [m.n_nodes for m in meshes])
    cell_off = np.cumsum([0] + [m.n_interior_cells for m in meshes])

    face_rows = []  # node lists (fused ids)
    face_cells = []  # (owner, nbr/-1) in merged interior-cell ids
    face_tag = []  # (mesh_idx, group_name, group_type) or None for interior
    for mi, m in enumerate(meshes):
        fc = m.face_cells
        for g in m.face_groups:
            for f in range(g.offset, g.offset + g.count):
                nodes = nmap[m.face_nodes.row(f) + node_off[mi]]
                o = fc[f, 0] + cell_off[mi]
                if g.group_type == "interior":
                    face_rows.append(nodes)
                    face_cells.append((o, fc[f, 1] + cell_off[mi]))
                    face_tag.append(None)
                else:
                    face_rows.append(nodes)
                    face_cells.append((o, -1))
                    face_tag.append((mi, g.name, g.group_type))

    # pair up coincident boundary faces (same fused node set) -> interior
    nfaces = len(face_rows)
    keys = {}
    partner = np.full(nfaces, -1, dtype=np.int64)
    for i in range(nfaces):
        if face_tag[i] is None:
            continue
        k = tuple(sorted(face_rows[i].tolist()))
        if k in keys:
            j = keys.pop(k)
            partner[i] = j
            partner[j] = i
        else:
            keys[k] = i

    keep_rows = []
    keep_cells = []
    keep_tag = []
    done = np.zeros(nfaces, bool)
    for i in range(nfaces):
        if done[i]:
            continue
        j = partner[i]
        if j >= 0:
            # merged interface: one interior face, owner from i, nbr from j
            done[i] = done[j] = True
            keep_rows.append(face_rows[i])
            keep_cells.append((face_cells[i][0], face_cells[j][0]))
            keep_tag.append(None)
        else:
            done[i] = True
            keep_rows.append(face_rows[i])
            keep_cells.append(face_cells[i])
            keep_tag.append(face_tag[i])

    face_nodes = CRConnectivity.from_rows(keep_rows, len(coords))
    fcr = np.asarray(keep_cells, dtype=np.int64)

    groups = []
    names = {}
    next_id = 1
    for i, tag in enumerate(keep_tag):
        if tag is None:
            continue
        name = tag[1]
        if name not in names:
            names[name] = (next_id, tag[2], [])
            next_id += 1
        names[name][2].append(i)
    for name, (ident, gtype, fidx) in names.items():
        groups.append((ident, name, gtype, np.asarray(fidx, dtype=np.int64)))
    return Mesh(dim, coords, face_nodes, fcr, groups)


def extract_region(mesh: Mesh, cell_mask, cut_name: str = "cut") -> Mesh:
    """Cut the sub-mesh of cells where ``cell_mask`` is True (reference
    MeshDismantler.h:16, used to split composite meshes per material).

    Faces between kept and dropped cells become a new boundary group
    ``cut_name``; original boundary groups are carried (restricted to kept
    owners).  Returns a standalone Mesh with renumbered cells/nodes.
    """
    cell_mask = np.asarray(cell_mask, dtype=bool)
    if cell_mask.shape[0] != mesh.n_interior_cells:
        raise MeshError("extract_region: mask must cover interior cells")
    new_cell = np.full(mesh.n_interior_cells, -1, dtype=np.int64)
    new_cell[cell_mask] = np.arange(int(cell_mask.sum()))

    keep_faces = []
    fcr_rows = []
    tag = []  # group name/type or ("cut",)
    fc = mesh.face_cells
    n_int_f = mesh.n_interior_faces
    for g in mesh.face_groups:
        for f in range(g.offset, g.offset + g.count):
            o = fc[f, 0]
            nb = fc[f, 1] if f < n_int_f else -1
            o_in = cell_mask[o] if o < mesh.n_interior_cells else False
            n_in = nb >= 0 and cell_mask[nb]
            if not (o_in or n_in):
                continue
            keep_faces.append(f)
            if o_in and n_in:
                fcr_rows.append((new_cell[o], new_cell[nb]))
                tag.append(None)
            else:
                owner = new_cell[o] if o_in else new_cell[nb]
                fcr_rows.append((owner, -1))
                if g.group_type == "interior":
                    tag.append((cut_name, "wall"))
                else:
                    tag.append((g.name, g.group_type))

    keep_faces = np.asarray(keep_faces, dtype=np.int64)
    # renumber nodes
    used = np.unique(
        np.concatenate([mesh.face_nodes.row(f) for f in keep_faces])
    )
    node_map = np.full(mesh.n_nodes, -1, dtype=np.int64)
    node_map[used] = np.arange(len(used))
    rows = [node_map[mesh.face_nodes.row(f)] for f in keep_faces]
    face_nodes = CRConnectivity.from_rows(rows, len(used))
    fcr = np.asarray(fcr_rows, dtype=np.int64)

    groups = []
    names = {}
    next_id = 1
    for i, t in enumerate(tag):
        if t is None:
            continue
        if t[0] not in names:
            names[t[0]] = (next_id, t[1], [])
            next_id += 1
        names[t[0]][2].append(i)
    for name, (ident, gtype, fidx) in names.items():
        groups.append((ident, name, gtype, np.asarray(fidx, dtype=np.int64)))
    return Mesh(mesh.dim, mesh.coords[used], face_nodes, fcr, groups)
