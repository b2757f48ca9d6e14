"""Structured mesh generators (counterpart of ``fvm_tpu/mesh/generate.py``).

``quad_2d``, ``tri_2d``, ``hex_3d`` and ``extrude``, vectorized with
numpy: the JAX package's ``tri_2d`` and ``hex_3d`` append one Python list
per face (6.3M of them at 128^3), and its ``extrude`` loops per face and
per layer.  The face order, the node order within each face, the cell ids
and the groups are the JAX package's, so every table built from these
meshes matches ``fvm_tpu``'s entry by entry.
"""

from __future__ import annotations

import numpy as np

from .connectivity import CRConnectivity
from .mesh import Mesh


def _face_nodes(rows: np.ndarray, n_nodes: int) -> CRConnectivity:
    """CSR face->node table of faces with the same node count."""
    nf, per = rows.shape
    return CRConnectivity(np.arange(nf + 1, dtype=np.int64) * per,
                          rows.reshape(-1), n_nodes)


def _wall_groups(names, idx):
    return [(k + 1, name, "wall", np.asarray(idx[name], dtype=np.int64))
            for k, name in enumerate(names)]


def quad_2d(
    nx: int,
    ny: int,
    lx: float = 1.0,
    ly: float = 1.0,
    x0: float = 0.0,
    y0: float = 0.0,
    boundary_names=("left", "right", "bottom", "top"),
) -> Mesh:
    """Uniform quad mesh on [x0, x0+lx] x [y0, y0+ly], nx*ny cells.

    Boundary groups: left (ident 1), right (2), bottom (3), top (4), the
    4 wall zones of the reference's cavity cases (cav32.cas).  Cells are
    numbered y-fastest: cell (i, j) is i*ny + j.
    """
    xs = x0 + lx * np.arange(nx + 1) / nx
    ys = y0 + ly * np.arange(ny + 1) / ny
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):  # node index arrays
        return i * (ny + 1) + j

    def cid(i, j):
        return i * ny + j

    # vertical faces (normal +-x): i in [0, nx], j in [0, ny)
    iv, jv = np.meshgrid(np.arange(nx + 1), np.arange(ny), indexing="ij")
    iv, jv = iv.ravel(), jv.ravel()
    vn = np.stack([nid(iv, jv), nid(iv, jv + 1)], axis=1)
    vc0 = cid(np.maximum(iv - 1, 0), jv)
    vc1 = np.where(iv == nx, -1, cid(np.minimum(iv, nx - 1), jv))
    vc1 = np.where(iv == 0, -1, vc1)
    vfc = np.stack([np.where(iv == 0, cid(0, jv), vc0), vc1], axis=1)
    # interior vertical: owner cid(i-1,j), nbr cid(i,j)
    vfc[(iv > 0) & (iv < nx), 1] = cid(iv, jv)[(iv > 0) & (iv < nx)]

    # horizontal faces: i in [0, nx), j in [0, ny]
    ih, jh = np.meshgrid(np.arange(nx), np.arange(ny + 1), indexing="ij")
    ih, jh = ih.ravel(), jh.ravel()
    hn = np.stack([nid(ih, jh), nid(ih + 1, jh)], axis=1)
    hc0 = np.where(jh == 0, cid(ih, 0), cid(ih, np.maximum(jh - 1, 0)))
    hc1 = np.where((jh == 0) | (jh == ny), -1, cid(ih, np.minimum(jh, ny - 1)))
    hfc = np.stack([hc0, hc1], axis=1)

    nvert = len(iv)
    fn_all = np.concatenate([vn, hn], axis=0)
    fc = np.concatenate([vfc, hfc], axis=0)
    face_nodes = _face_nodes(fn_all, (nx + 1) * (ny + 1))
    groups_idx = {
        boundary_names[0]: np.nonzero(iv == 0)[0],
        boundary_names[1]: np.nonzero(iv == nx)[0],
        boundary_names[2]: nvert + np.nonzero(jh == 0)[0],
        boundary_names[3]: nvert + np.nonzero(jh == ny)[0],
    }
    return Mesh(2, coords, face_nodes, fc,
                _wall_groups(boundary_names, groups_idx))


def tri_2d(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> Mesh:
    """Triangulated uniform mesh: each quad split along its diagonal.

    Quad (i, j) holds triangle A (n00, n10, n11), id 2 (i ny + j), and
    triangle B (n00, n11, n01), id 2 (i ny + j) + 1.  Faces: the vertical
    edges (i outer, j inner), the horizontal edges, then the diagonals
    n00 -> n11."""
    xs = lx * np.arange(nx + 1) / nx
    ys = ly * np.arange(ny + 1) / ny
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    def ta(i, j):
        return 2 * (i * ny + j)

    def tb(i, j):
        return 2 * (i * ny + j) + 1

    def grid(a, b):
        i, j = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
        return i.ravel(), j.ravel()

    # vertical edges: owner A(i-1, j), neighbour B(i, j)
    iv, jv = grid(nx + 1, ny)
    vn = np.stack([nid(iv, jv), nid(iv, jv + 1)], axis=1)
    vfc = np.stack([np.where(iv == 0, tb(0, jv), ta(iv - 1, jv)),
                    np.where((iv == 0) | (iv == nx), -1, tb(iv, jv))], axis=1)
    # horizontal edges: owner B(i, j-1), neighbour A(i, j)
    ih, jh = grid(nx, ny + 1)
    hn = np.stack([nid(ih, jh), nid(ih + 1, jh)], axis=1)
    hfc = np.stack([np.where(jh == 0, ta(ih, 0), tb(ih, jh - 1)),
                    np.where((jh == 0) | (jh == ny), -1, ta(ih, jh))], axis=1)
    # diagonals: A(i, j) | B(i, j)
    idg, jdg = grid(nx, ny)
    dn = np.stack([nid(idg, jdg), nid(idg + 1, jdg + 1)], axis=1)
    dfc = np.stack([ta(idg, jdg), tb(idg, jdg)], axis=1)

    nv = len(iv)
    fc = np.concatenate([vfc, hfc, dfc], axis=0)
    face_nodes = _face_nodes(np.concatenate([vn, hn, dn], axis=0),
                             (nx + 1) * (ny + 1))
    gidx = {
        "left": np.nonzero(iv == 0)[0],
        "right": np.nonzero(iv == nx)[0],
        "bottom": nv + np.nonzero(jh == 0)[0],
        "top": nv + np.nonzero(jh == ny)[0],
    }
    return Mesh(2, coords, face_nodes, fc,
                _wall_groups(("left", "right", "bottom", "top"), gidx))


def hex_3d(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
) -> Mesh:
    """Uniform hex mesh; boundary groups xmin/xmax/ymin/ymax/zmin/zmax.

    Cell (i, j, k) is (i ny + j) nz + k (z fastest).  Faces: the x-normal
    planes (i, j, k loops, k fastest), the y-normal planes (j, i, k) and
    the z-normal planes (k, i, j), each with the JAX package's node order
    and the lower-index cell as owner."""
    xs = lx * np.arange(nx + 1) / nx
    ys = ly * np.arange(ny + 1) / ny
    zs = lz * np.arange(nz + 1) / nz
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    def cid(i, j, k):
        return (i * ny + j) * nz + k

    def grid(a, b, c):
        return [g.ravel() for g in np.meshgrid(
            np.arange(a), np.arange(b), np.arange(c), indexing="ij")]

    def cells(lo, hi, edge, n_edge):
        """(owner, neighbour) of a plane of faces: the cell below (lo)
        and above (hi) the face; the one inside on a boundary plane."""
        own = np.where(edge == 0, hi, lo)
        nbr = np.where((edge == 0) | (edge == n_edge), -1, hi)
        return np.stack([own, nbr], axis=1)

    # x-normal faces: i in [0, nx], j, k
    i, j, k = grid(nx + 1, ny, nz)
    xn = np.stack([nid(i, j, k), nid(i, j + 1, k), nid(i, j + 1, k + 1),
                   nid(i, j, k + 1)], axis=1)
    xfc = cells(cid(i - 1, j, k), cid(np.minimum(i, nx - 1), j, k), i, nx)
    xi = i
    # y-normal faces: j in [0, ny], i, k
    j, i, k = grid(ny + 1, nx, nz)
    yn = np.stack([nid(i, j, k), nid(i, j, k + 1), nid(i + 1, j, k + 1),
                   nid(i + 1, j, k)], axis=1)
    yfc = cells(cid(i, j - 1, k), cid(i, np.minimum(j, ny - 1), k), j, ny)
    yj = j
    # z-normal faces: k in [0, nz], i, j
    k, i, j = grid(nz + 1, nx, ny)
    zn = np.stack([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
                   nid(i, j + 1, k)], axis=1)
    zfc = cells(cid(i, j, k - 1), cid(i, j, np.minimum(k, nz - 1)), k, nz)
    zk = k

    nfx, nfy = len(xi), len(yj)
    fc = np.concatenate([xfc, yfc, zfc], axis=0)
    face_nodes = _face_nodes(np.concatenate([xn, yn, zn], axis=0),
                             (nx + 1) * (ny + 1) * (nz + 1))
    gidx = {
        "xmin": np.nonzero(xi == 0)[0],
        "xmax": np.nonzero(xi == nx)[0],
        "ymin": nfx + np.nonzero(yj == 0)[0],
        "ymax": nfx + np.nonzero(yj == ny)[0],
        "zmin": nfx + nfy + np.nonzero(zk == 0)[0],
        "zmax": nfx + nfy + np.nonzero(zk == nz)[0],
    }
    return Mesh(3, coords, face_nodes, fc,
                _wall_groups(("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"),
                             gidx))


def extrude(mesh2d: Mesh, nz: int, lz: float = 1.0, z0: float = 0.0) -> Mesh:
    """Extrude a 2D mesh into 3D along z (reference: Mesh::extrude,
    Mesh.h:314): each 2D cell becomes nz prisms or hexes, cell (c, k) is
    k n_cells2d + c.  Faces: each 2D face extruded into nz quads (face
    major, layer fastest), then the z-normal faces level by level (the
    cell's vertices counter-clockwise, ``_cell_poly_nodes``).  The 2D
    boundary groups become lateral groups, then 'zmin' and 'zmax'."""
    m = mesh2d
    if m.dim != 2:
        raise ValueError("extrude requires a 2D mesh")
    nn2, nc2, nf2 = m.n_nodes, m.n_interior_cells, m.n_faces
    zs = z0 + lz * np.arange(nz + 1) / nz
    coords = np.concatenate(
        [np.concatenate([m.coords, np.full((nn2, 1), z)], axis=1)
         for z in zs], axis=0)

    # lateral faces: f = f2 nz + k
    fn2 = m.face_nodes.col.reshape(nf2, 2)
    k = np.tile(np.arange(nz, dtype=np.int64), nf2)
    f2 = np.repeat(np.arange(nf2, dtype=np.int64), nz)
    n0, n1 = fn2[f2, 0], fn2[f2, 1]
    lat_rows = np.stack([k * nn2 + n0, k * nn2 + n1, (k + 1) * nn2 + n1,
                         (k + 1) * nn2 + n0], axis=1)
    c0, c1 = m.face_cells[f2, 0], m.face_cells[f2, 1]
    bnd = (c1 >= nc2) | (c1 < 0) | (f2 >= m.n_interior_faces)
    lat_fc = np.stack([k * nc2 + c0, np.where(bnd, -1, k * nc2 + c1)],
                      axis=1)
    names = [g.name for g in m.boundary_groups]
    label = np.full(nf2, -1, dtype=np.int64)
    for g in m.boundary_groups:
        label[g.faces] = names.index(g.name)
    lat_label = np.where(bnd, label[f2], -1)
    n_lat = nf2 * nz

    # z-normal faces: level k, cell c2 at n_lat + k nc2 + c2
    ptr, poly = _cell_poly_nodes(m)
    cnt = np.diff(ptr)
    z_cols = (np.arange(nz + 1, dtype=np.int64)[:, None] * nn2
              + poly[None, :]).reshape(-1)
    z_cnt = np.tile(cnt, nz + 1)
    kz = np.repeat(np.arange(nz + 1, dtype=np.int64), nc2)
    cz = np.tile(np.arange(nc2, dtype=np.int64), nz + 1)
    z_fc = np.stack([np.where(kz == 0, cz, np.minimum(kz, nz) * nc2 + cz
                              - nc2),
                     np.where((kz == 0) | (kz == nz), -1, kz * nc2 + cz)],
                    axis=1)

    row_ptr = np.zeros(n_lat + len(kz) + 1, dtype=np.int64)
    np.cumsum(np.concatenate([np.full(n_lat, 4, dtype=np.int64), z_cnt]),
              out=row_ptr[1:])
    face_nodes = CRConnectivity(
        row_ptr, np.concatenate([lat_rows.reshape(-1), z_cols]),
        coords.shape[0])
    fc = np.concatenate([lat_fc, z_fc], axis=0)
    groups = [(i + 1, name, "wall", np.nonzero(lat_label == i)[0])
              for i, name in enumerate(dict.fromkeys(names))]
    groups.append((len(groups) + 1, "zmin", "wall",
                   n_lat + np.arange(nc2, dtype=np.int64)))
    groups.append((len(groups) + 1, "zmax", "wall",
                   n_lat + nz * nc2 + np.arange(nc2, dtype=np.int64)))
    return Mesh(3, coords, face_nodes, fc, groups)


def _cell_poly_nodes(mesh2d: Mesh):
    """Counter-clockwise vertices of every 2D cell, as CSR (ptr, nodes):
    each cell's distinct nodes sorted by their angle about the nodes'
    mean, cells of one vertex count at a time."""
    cn = mesh2d.cell_nodes
    cnt = cn.row_counts()
    out = np.empty_like(cn.col)
    for k in np.unique(cnt):
        cells = np.nonzero(cnt == k)[0]
        idx = cn.row_ptr[cells][:, None] + np.arange(k)
        nodes = cn.col[idx]
        pts = mesh2d.coords[nodes]
        ctr = pts.mean(axis=1)
        ang = np.arctan2(pts[:, :, 1] - ctr[:, None, 1],
                         pts[:, :, 0] - ctr[:, None, 0])
        out[idx] = np.take_along_axis(nodes, np.argsort(ang, axis=1), axis=1)
    return cn.row_ptr, out
