"""Tecplot and Fluent-data exporters (counterpart of
``fvm_tpu/io/exporters.py``): Tecplot ASCII FE zones with cell-centred
variables (the reference's scripts/tecplotParallel.py) and ``.dat``
scalar sections (FluentDataExporter.h:14).  The files are byte-identical
to the JAX package's for the same mesh and fields."""

from __future__ import annotations

from .persistence import host
from .vtk import ordered_cell_nodes


def _lines(values) -> str:
    return "\n".join("%.10g" % v for v in values.tolist())


def write_tecplot(path: str, mesh, cell_fields: dict, title="fvm_tpu"):
    """Tecplot ASCII FE zone (FEQUADRILATERAL in 2D, FEBRICK in 3D) with
    cell-centred variables (host arrays or device tensors; vectors split
    into X, Y, Z components)."""
    n_cells = mesh.n_interior_cells
    names, arrays = [], []
    for name, arr in cell_fields.items():
        arr = host(arr)[:n_cells]
        if arr.ndim == 1:
            names.append(name)
            arrays.append(arr)
        else:
            for c in range(arr.shape[1]):
                names.append(f"{name}{'XYZ'[c]}")
                arrays.append(arr[:, c])
    coord_names = ["X", "Y", "Z"][: mesh.dim]
    zonetype = "FEQUADRILATERAL" if mesh.dim == 2 else "FEBRICK"
    nodes_per = 4 if mesh.dim == 2 else 8
    with open(path, "w") as f:
        f.write(f'TITLE = "{title}"\n')
        f.write("VARIABLES = "
                + ", ".join(f'"{v}"' for v in coord_names + names) + "\n")
        var_loc = ",".join(
            str(i) for i in range(mesh.dim + 1, mesh.dim + len(names) + 1))
        f.write(f"ZONE T=\"mesh\", N={mesh.n_nodes}, E={n_cells}, "
                f"DATAPACKING=BLOCK, ZONETYPE={zonetype}")
        if names:
            f.write(f", VARLOCATION=([{var_loc}]=CELLCENTERED)")
        f.write("\n")
        for c in range(mesh.dim):
            f.write(_lines(mesh.coords[:, c]) + "\n")
        for arr in arrays:
            f.write(_lines(arr) + "\n")
        for nodes in ordered_cell_nodes(mesh):
            if len(nodes) < nodes_per:  # degenerate (a tri in a quad zone)
                nodes = list(nodes) + [nodes[-1]] * (nodes_per - len(nodes))
            f.write(" ".join(str(n + 1) for n in nodes[:nodes_per]) + "\n")


def write_fluent_data(path: str, mesh, cell_fields: dict):
    """Minimal Fluent ``.dat``-style ASCII export: (300 ...) scalar sections
    (reference: FluentDataExporter.h:14 writeScalarField), vector fields
    one section per component (sub-id 10 x field + component)."""
    n_cells = mesh.n_interior_cells
    with open(path, "w") as f:
        f.write('(0 "fvm_tpu data export")\n')
        f.write(f"(33 (1 {n_cells} 1))\n")
        for vid, (name, arr) in enumerate(cell_fields.items(), start=1):
            arr = host(arr)[:n_cells]
            if arr.ndim > 1:
                for c in range(arr.shape[1]):
                    _write_section(f, 300, vid * 10 + c, arr[:, c])
            else:
                _write_section(f, 300, vid, arr)


def _write_section(f, sec, subid, values):
    f.write(f"({sec} ({subid} 1 1 0 0 1 {len(values)})(\n")
    f.write(_lines(values))
    f.write("\n))\n")
