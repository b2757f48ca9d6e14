"""Structured mesh generators (counterpart of ``fvm_tpu/mesh/generate.py``).

Only ``quad_2d`` is carried so far: it is the mesh of the lid-driven
cavity, the main path.  ``tri_2d``, ``hex_3d`` and ``extrude`` come later.
"""

from __future__ import annotations

import numpy as np

from .connectivity import CRConnectivity
from .mesh import Mesh


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
    face_nodes = CRConnectivity(
        np.arange(len(fn_all) + 1, dtype=np.int64) * 2,
        fn_all.ravel(),
        (nx + 1) * (ny + 1),
    )
    groups_idx = {
        boundary_names[0]: np.nonzero(iv == 0)[0],
        boundary_names[1]: np.nonzero(iv == nx)[0],
        boundary_names[2]: nvert + np.nonzero(jh == 0)[0],
        boundary_names[3]: nvert + np.nonzero(jh == ny)[0],
    }
    groups = [
        (k + 1, name, "wall", np.asarray(groups_idx[name], dtype=np.int64))
        for k, name in enumerate(boundary_names)
    ]
    return Mesh(2, coords, face_nodes, fc, groups)
