"""Write a host mesh as a Fluent case (``.cas``): ASCII sections, or binary
ones with float32 or float64 reals, with cell zones.

The JAX package and the port read Fluent cases but write none; the tests
and ``chip_smoke.py`` make their cases with this writer from generated
meshes (the reference's meshes are absent).  Zone ids are hexadecimal in
the section headers and decimal in the name sections, as Fluent writes
them.  A mesh read back from the file has the written mesh's tables
(coordinates in float64 cases, face order and nodes, owner / neighbour,
the boundary groups and their idents where those ascend) and the given
cell zones.

    from scripts.fluent_case import write_fluent_case
    write_fluent_case("two_zone.cas", quad_2d(20, 20), "f64",
                      zones=[("left", "solid", 0, 200),
                             ("right", "solid", 200, 400)])
"""

from __future__ import annotations

import numpy as np

# the reader's zone type codes, inverted (fvm_tpu/io/fluent.py BC_TYPE_NAMES)
BC_TYPE_CODES = {"interior": 2, "wall": 3, "pressure-inlet": 4,
                 "pressure-outlet": 5, "symmetry": 7, "periodic-shadow": 8,
                 "pressure-far-field": 9, "velocity-inlet": 10,
                 "periodic": 12, "fan": 14, "port": 20, "outflow": 36,
                 "interface": 31}
# Fluent cell element types by (dim, nodes per cell)
CELL_TYPES = {(2, 3): 1, (2, 4): 3, (3, 4): 2, (3, 8): 4, (3, 5): 5,
              (3, 6): 6}
FORMATS = ("ascii", "f32", "f64")


def _section(idx, header, body=None):
    """One section: ``(idx (header)(body))``; ``body`` bytes are binary."""
    head = f"({idx} ({header})".encode()
    if body is None:
        return head + b")\n"
    if isinstance(body, bytes):
        return (head + b"(" + body + b")\nEnd of Binary Section "
                + str(idx).encode() + b")\n")
    return head + b"(\n" + body.encode() + b"\n))\n"


def write_fluent_case(path: str, mesh, fmt: str = "ascii", zones=None,
                      title: str = "fvm case writer") -> None:
    """Write ``mesh`` (a host ``Mesh``) to ``path`` in ``fmt`` ("ascii",
    "f32" or "f64": binary sections with float32 or float64 reals).

    ``zones``: cell zones as (name, type, first, last) over the interior
    cells, contiguous, in order and covering them all (Fluent declares a
    zone as a range of cells); default one zone "fluid"."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, got {fmt!r}")
    dim = mesh.dim
    nc, nf, nn = mesh.n_interior_cells, mesh.n_faces, mesh.n_nodes
    zones = zones or [("fluid", "fluid", 0, nc)]
    ends = [0] + [z[3] for z in zones]
    if [z[2] for z in zones] != ends[:-1] or ends[-1] != nc:
        raise ValueError("zones must be contiguous cell ranges covering "
                         "the interior cells in order")
    groups = [g for g in mesh.face_groups if g.group_type != "interior"]
    idents = [g.ident for g in groups]
    if not (all(i > 0 for i in idents) and idents == sorted(set(idents))):
        idents = list(range(1, len(groups) + 1))
    interior_id = max(idents, default=0) + 1
    zone_ids = [interior_id + 1 + k for k in range(len(zones))]

    binary = fmt != "ascii"
    real = {"f32": "<f4", "f64": "<f8"}.get(fmt)
    rsec = 3000 if fmt == "f64" else 2000
    out = [f'(0 "{title}")\n'.encode(), f"(2 {dim})\n".encode(),
           _section(10, f"0 1 {nn:x} 0 {dim}")]
    if binary:
        out.append(_section(rsec + 10, f"1 1 {nn:x} 1 {dim}",
                            np.ascontiguousarray(mesh.coords, real)
                            .tobytes()))
    else:
        out.append(_section(10, f"1 1 {nn:x} 1 {dim}", "\n".join(
            " ".join("%.17g" % v for v in row)
            for row in mesh.coords.tolist())))

    counts = mesh.cell_nodes.row_counts()[:nc]
    et = CELL_TYPES.get((dim, int(counts[0])), 0) \
        if (counts == counts[0]).all() else 0
    out.append(_section(12, f"0 1 {nc:x} 0"))
    for zid, (_, _, first, last) in zip(zone_ids, zones):
        out.append(_section(rsec + 12 if binary else 12,
                            f"{zid:x} {first + 1:x} {last:x} 1 {et:x}"))

    out.append(_section(13, f"0 1 {nf:x} 0"))
    fn = mesh.face_nodes
    fc = np.asarray(mesh.face_cells, np.int64) + 1
    fc[mesh.n_interior_faces:, 1] = 0  # the boundary neighbour
    spans = [(interior_id, "interior", 0, mesh.n_interior_faces)] + [
        (zid, g.group_type, g.offset, g.offset + g.count)
        for zid, g in zip(idents, groups)]
    for zid, gtype, a, b in spans:
        if a == b:
            continue
        fcount = fn.row_counts()[a:b]
        fixed = (fcount == fcount[0]).all() and int(fcount[0]) in (2, 3, 4)
        nodes = fn.col[fn.row_ptr[a]: fn.row_ptr[b]] + 1
        if fixed:
            rec = np.concatenate([nodes.reshape(b - a, -1), fc[a:b]], axis=1)
            ftype = int(fcount[0])
        else:
            rows, ptr = [], fn.row_ptr[a:b + 1] - fn.row_ptr[a]
            for i in range(b - a):
                rows.append(np.concatenate([[fcount[i]],
                                            nodes[ptr[i]: ptr[i + 1]],
                                            fc[a + i]]))
            rec = rows
            ftype = 0
        header = (f"{zid:x} {a + 1:x} {b:x} "
                  f"{BC_TYPE_CODES.get(gtype, 3):x} {ftype:x}")
        if binary:
            flat = rec.ravel() if fixed else np.concatenate(rec)
            out.append(_section(rsec + 13, header,
                                flat.astype("<i4").tobytes()))
        else:
            out.append(_section(13, header, "\n".join(
                " ".join(f"{v:x}" for v in row) for row in (
                    rec.tolist() if fixed else [r.tolist() for r in rec]))))

    out.append(_section(45, f"{interior_id} interior interior-faces"))
    for zid, g in zip(idents, groups):
        out.append(_section(45, f"{zid} {g.group_type} {g.name}"))
    for zid, (name, ztype, _, _) in zip(zone_ids, zones):
        out.append(_section(45, f"{zid} {ztype} {name}"))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def two_zone_split(mesh, x_split: float = 0.5):
    """Cell zones (left, right) of a mesh whose cells left of ``x_split``
    come first (``quad_2d`` numbers its cells x-major): for
    ``write_fluent_case``'s ``zones``."""
    from fvm_tpu_torch.mesh import compute_geometry

    xc = compute_geometry(mesh).cell_centroid[: mesh.n_interior_cells, 0]
    left = xc < x_split
    k = int(left.sum())
    if not left[:k].all():
        raise ValueError("the cells left of the split are not numbered "
                         "first")
    return [("left", "solid", 0, k), ("right", "solid", k,
                                      mesh.n_interior_cells)]
