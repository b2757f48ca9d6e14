"""Structured mesh generators (counterpart of ``fvm_tpu/mesh/generate.py``).

``quad_2d``, ``tri_2d`` and ``hex_3d``, vectorized with numpy: the JAX
package's ``tri_2d`` and ``hex_3d`` append one Python list per face (6.3M
of them at 128^3).  The face order, the node order within each face, the
cell ids and the groups are the JAX package's, so every table built from
these meshes matches ``fvm_tpu``'s entry by entry.  ``extrude`` (which
needs the 2D cell->node table) is not ported yet.
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
