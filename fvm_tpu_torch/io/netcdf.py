"""NetCDF mesh + field I/O (counterpart of ``fvm_tpu/io/netcdf.py``; the
reference's NcDataWriter, NcDataWriter.h:23, and NcDataReader), on scipy's
NetCDF3 backend.  The file is byte-identical to the JAX package's for the
same mesh and fields.

Layout (one file per call):
  dimensions: dim, n_nodes, n_faces, two, fn_ptr, fn_nnz, n_groups
              (and n_interior_cells with fields);
  variables:  coords (n_nodes, dim), face_nodes_ptr / _col, face_cells
              (the neighbour -1 on boundary faces), group_id / _offset /
              _count, one ``field_<name>`` per cell field;
  attributes: group_names, group_types, field_names (newline-joined).

The partitioned dumps of distributed runs raise ``ConfigError``: they are
ROADMAP queue 1 item 8b.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..exceptions import ConfigError
from ..mesh.connectivity import CRConnectivity
from ..mesh.mesh import Mesh
from .persistence import host


def write_netcdf(path: str, mesh: Mesh, fields: dict | None = None) -> None:
    """Write a host Mesh and optional per-interior-cell fields (host
    arrays or device tensors; reference NcDataWriter::recordData)."""
    f = netcdf_file(path, "w")
    try:
        f.createDimension("dim", mesh.dim)
        f.createDimension("n_nodes", mesh.coords.shape[0])
        f.createDimension("n_faces", mesh.n_faces)
        f.createDimension("two", 2)
        fn = mesh.face_nodes
        f.createDimension("fn_ptr", len(fn.row_ptr))
        f.createDimension("fn_nnz", fn.nnz)
        f.createDimension("n_groups", len(mesh.face_groups))

        v = f.createVariable("coords", "d", ("n_nodes", "dim"))
        v[:] = np.asarray(mesh.coords, dtype=np.float64)
        v = f.createVariable("face_nodes_ptr", "i", ("fn_ptr",))
        v[:] = np.asarray(fn.row_ptr, dtype=np.int32)
        v = f.createVariable("face_nodes_col", "i", ("fn_nnz",))
        v[:] = np.asarray(fn.col, dtype=np.int32)
        # raw owner / neighbour with -1 on boundary faces (pre-ghost form)
        fc = np.asarray(mesh.face_cells[:, :2], dtype=np.int32).copy()
        fc[fc[:, 1] >= mesh.n_interior_cells, 1] = -1
        v = f.createVariable("face_cells", "i", ("n_faces", "two"))
        v[:] = fc
        for arr, name in (
                (np.asarray([g.ident for g in mesh.face_groups]), "group_id"),
                (np.asarray([g.offset for g in mesh.face_groups]),
                 "group_offset"),
                (np.asarray([g.count for g in mesh.face_groups]),
                 "group_count")):
            v = f.createVariable(name, "i", ("n_groups",))
            v[:] = arr.astype(np.int32)
        f.group_names = "\n".join(g.name for g in mesh.face_groups)
        f.group_types = "\n".join(g.group_type for g in mesh.face_groups)

        if fields:
            f.createDimension("n_interior_cells", mesh.n_interior_cells)
            f.field_names = "\n".join(fields.keys())
            for k, arr in fields.items():
                a = np.asarray(host(arr), dtype=np.float64)
                a = a[: mesh.n_interior_cells]
                if a.ndim == 1:
                    v = f.createVariable(f"field_{k}", "d",
                                         ("n_interior_cells",))
                else:
                    dname = f"field_{k}_w"
                    f.createDimension(dname, a.shape[1])
                    v = f.createVariable(f"field_{k}", "d",
                                         ("n_interior_cells", dname))
                v[:] = a
        else:
            f.field_names = ""
    finally:
        f.close()


def read_netcdf(path: str):
    """Read back (Mesh, fields dict) (reference: NcDataReader)."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        coords = np.array(f.variables["coords"][:], dtype=float)
        dim = coords.shape[1]
        ptr = np.array(f.variables["face_nodes_ptr"][:], dtype=np.int64)
        col = np.array(f.variables["face_nodes_col"][:], dtype=np.int64)
        fc = np.array(f.variables["face_cells"][:], dtype=np.int64)
        names = f.group_names.decode().split("\n")
        types = f.group_types.decode().split("\n")
        gid = np.array(f.variables["group_id"][:])
        goff = np.array(f.variables["group_offset"][:])
        gcnt = np.array(f.variables["group_count"][:])
        groups = [(int(gid[i]), names[i], types[i],
                   np.arange(int(goff[i]), int(goff[i]) + int(gcnt[i])))
                  for i in range(len(gid))]
        mesh = Mesh(dim, coords, CRConnectivity(ptr, col,
                                                int(coords.shape[0])),
                    fc, groups)
        fields = {}
        fnames = f.field_names.decode()
        if fnames:
            for k in fnames.split("\n"):
                fields[k] = np.array(f.variables[f"field_{k}"][:],
                                     dtype=float)
        return mesh, fields
    finally:
        f.close()


def _distributed(name):
    def raise_item8(*args, **kwargs):
        raise ConfigError(
            f"{name}: the partitioned dumps of distributed runs are not "
            "ported yet (ROADMAP queue 1 item 8b)")

    raise_item8.__name__ = name
    raise_item8.__doc__ = ("Raises ConfigError: a distributed path (ROADMAP "
                           "queue 1 item 8b).")
    return raise_item8


write_netcdf_partitioned = _distributed("write_netcdf_partitioned")
read_netcdf_partitioned = _distributed("read_netcdf_partitioned")
restore_partitioned = _distributed("restore_partitioned")
save_dist_state = _distributed("save_dist_state")
load_dist_state = _distributed("load_dist_state")
