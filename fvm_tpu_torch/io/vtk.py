"""Legacy-VTK (ASCII) unstructured-grid writer (counterpart of
``fvm_tpu/io/vtk.py``; the reference's VTKWriter, VTKWriter.h:36): the
mesh as an UNSTRUCTURED_GRID with CELL_DATA fields for ParaView / VisIt.
The file is byte-identical to the JAX package's for the same mesh and
fields; the 2D cells' counter-clockwise node order is computed for all
cells of one node count at once."""

from __future__ import annotations

import numpy as np

from .persistence import host

_VTK_TYPES_2D = {3: 5, 4: 9}  # tri, quad
_VTK_TYPES_3D = {4: 10, 5: 14, 6: 13, 8: 12}  # tet, pyramid, wedge, hex


def _floats(fmt, rows) -> str:
    """``fmt`` % row for each row, one per line."""
    return "".join(fmt % tuple(r) for r in rows.tolist())


def write_vtk(path: str, mesh, cell_fields: dict | None = None,
              title="fvm_tpu"):
    """Write the host mesh and per-interior-cell fields (scalars or
    vectors; host arrays or device tensors)."""
    n_cells = mesh.n_interior_cells
    nodes = ordered_cell_nodes(mesh)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{title}\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {mesh.n_nodes} double\n")
        pts = np.zeros((mesh.n_nodes, 3))
        pts[:, : mesh.dim] = mesh.coords
        f.write(_floats("%.10g %.10g %.10g\n", pts))

        counts = mesh.cell_nodes.row_counts()[:n_cells]
        total = int(counts.sum()) + n_cells
        f.write(f"\nCELLS {n_cells} {total}\n")
        f.write("".join(f"{len(r)} " + " ".join(map(str, r)) + "\n"
                        for r in nodes))
        f.write(f"\nCELL_TYPES {n_cells}\n")
        types = _VTK_TYPES_2D if mesh.dim == 2 else _VTK_TYPES_3D
        other = 7 if mesh.dim == 2 else 42
        f.write("".join(f"{types.get(len(r), other)}\n" for r in nodes))

        if cell_fields:
            f.write(f"\nCELL_DATA {n_cells}\n")
            for name, arr in cell_fields.items():
                arr = host(arr)[:n_cells]
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    f.write("".join("%.10g\n" % v for v in arr.tolist()))
                else:
                    f.write(f"VECTORS {name} double\n")
                    rows = np.zeros((arr.shape[0], 3))
                    rows[:, : arr.shape[1]] = arr
                    f.write(_floats("%.10g %.10g %.10g\n", rows))


def ordered_cell_nodes(mesh) -> list:
    """Each interior cell's vertices (lists of node ids): 2D polygons
    counter-clockwise about their vertex mean (the cells of one node count
    at once), 3D hexes in VTK order where the split by z works, other
    cells as stored."""
    cn = mesh.cell_nodes
    n = mesh.n_interior_cells
    counts = cn.row_counts()[:n]
    out = [None] * n
    if mesh.dim == 2:
        for k in np.unique(counts):
            cells = np.nonzero(counts == k)[0]
            idx = cn.col[cn.row_ptr[cells][:, None] + np.arange(k)]
            srt = np.sort(idx, axis=1)
            uniq = np.all(srt[:, 1:] != srt[:, :-1], axis=1)
            if uniq.any():
                rows = idx[uniq]
                pts = mesh.coords[rows]  # (m, k, 2)
                ctr = pts.mean(axis=1)
                ang = np.arctan2(pts[:, :, 1] - ctr[:, 1:2],
                                 pts[:, :, 0] - ctr[:, 0:1])
                order = np.argsort(ang, axis=1)
                srt = np.take_along_axis(rows, order, axis=1).tolist()
                for c, r in zip(cells[uniq].tolist(), srt):
                    out[c] = r
            for c in cells[~uniq].tolist():
                out[c] = _one_2d(mesh, c)
    else:
        for c in range(n):
            out[c] = _order_3d(mesh, c, list(dict.fromkeys(
                cn.row(c).tolist())))
    return out


def _one_2d(mesh, c):
    """One 2D cell's vertices (duplicates dropped), counter-clockwise."""
    nodes = list(dict.fromkeys(mesh.cell_nodes.row(c).tolist()))
    pts = mesh.coords[nodes]
    ctr = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - ctr[1], pts[:, 0] - ctr[0])
    return [nodes[i] for i in np.argsort(ang)]


def _order_3d(mesh, c: int, nodes):
    """A hex's nodes in VTK order (bottom quad, top quad, each
    counter-clockwise, top aligned to bottom by nearest xy); others as
    given."""
    if len(nodes) != 8:
        return nodes
    pts = mesh.coords[nodes]
    ctr = pts.mean(axis=0)
    rel = pts - ctr
    zkey = rel[:, 2] > 0
    bottom = [n for n, z in zip(nodes, zkey) if not z]
    top = [n for n, z in zip(nodes, zkey) if z]
    if len(bottom) != 4 or len(top) != 4:
        return nodes

    def ccw(ns):
        p = mesh.coords[ns]
        cc = p.mean(axis=0)
        ang = np.arctan2(p[:, 1] - cc[1], p[:, 0] - cc[0])
        return [ns[i] for i in np.argsort(ang)]

    b = ccw(bottom)
    t = ccw(top)
    pb = mesh.coords[b][:, :2]
    pt = mesh.coords[t][:, :2]
    perm = [int(np.argmin(((pt - pb[i]) ** 2).sum(axis=1))) for i in range(4)]
    t = [t[i] for i in perm]
    return b + t
