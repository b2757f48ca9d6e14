"""Device-resident mesh: torch tensors on one device plus static metadata.

Counterpart of ``fvm_tpu/mesh/device.py`` (the reference's Mesh/GeomFields
pair, Mesh.h:49, GeomFields.h:16-54).  The numbering is the JAX package's,
so assembled matrices compare entry by entry:

* cells: interior cells [0, n_interior), then one ghost cell per boundary
  face, then (plane-major layout) one dummy cell;
* interior faces in PLANE-MAJOR order (face j*n_int_cells + c is the j-th
  face owned by cell c; holes are invalid dummy faces);
* cell->face tables SLOT-LEADING (K, n): ``cf_face``, ``cf_is_owner``,
  ``cf_mask``, ``cf_nbr``.

Periodic pairs (``Mesh.make_periodic``) reposition each paired ghost at
its wrapped partner owner and give the ghost row one extra ELL slot
coupling it to that owner; double-shell interfaces (``Mesh.make_interface``)
give each shell-ghost row two extra slots, [partner ghost, partner owner]
at slots 1 and 2, which ``core.interfaces`` relies on.  Both as the JAX
package builds them (``fvm_tpu/mesh/device.py:280-294, 440-556``).

The JAX package's shift-gather fabric (``MeshGathers``,
``PlaneMajorGathers``, ``ShiftGather``, ``dia_gather_slots``) exists
because the TPU has no hardware gather; a GPU has one, so ``take_owner``,
``take_nbr`` and ``take_faces`` are plain indexing here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import as_dtype, resolve_device
from .mesh import Mesh
from .metrics import MeshGeometry, compute_geometry


class HostMeshData:
    """Host numpy copies of the tables that init-time host computations
    need (LS gradient coefficients, AMG setup), kept from the build so
    nothing is read back from the device."""

    __slots__ = ("cell_centroid", "cf_nbr", "cf_mask")

    def __init__(self, cell_centroid, cf_nbr, cf_mask):
        self.cell_centroid = cell_centroid
        self.cf_nbr = cf_nbr
        self.cf_mask = cf_mask



def gather_rows(x, idx):
    """``x[idx]`` along the first dimension, as ``index_select``: the same
    values, and a reverse-mode derivative that adds with ``index_add``.
    Advanced indexing's derivative sorts its indices first and then, on a
    CUDA tensor, adds the rows of a repeated index one after another; half
    of a quad mesh's device faces are padding that points at one padding
    cell, and such a derivative took up to 311 ms per gather on the
    1024^2 cavity (NVIDIA H100, PERF.md)."""
    out = torch.index_select(x, 0, idx.reshape(-1))
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))

@dataclass(eq=False)
class DeviceMesh:
    dim: int
    n_cells: int  # interior + ghost (+ dummy)
    n_interior_cells: int
    n_faces: int
    n_interior_faces: int
    max_faces_per_cell: int
    groups: tuple  # ((ident, name, type, offset, count), ...)
    device: torch.device

    face_cell0: torch.Tensor  # (nf,) owner, int64
    face_cell1: torch.Tensor  # (nf,) neighbor (ghost for boundary faces)
    cf_face: torch.Tensor  # (K, nc) face id per slot (pad: 0)
    cf_is_owner: torch.Tensor  # (K, nc) bool
    cf_mask: torch.Tensor  # (K, nc) bool: slot valid
    cf_nbr: torch.Tensor  # (K, nc) neighbor cell across slot face (pad: self)

    face_area: torch.Tensor  # (nf, dim) owner -> neighbor
    face_area_mag: torch.Tensor  # (nf,)
    face_centroid: torch.Tensor  # (nf, dim)
    cell_centroid: torch.Tensor  # (nc, dim)
    cell_volume: torch.Tensor  # (nc,)

    face_ds: torch.Tensor  # (nf, dim) x_N - x_O
    face_dsmag: torch.Tensor  # (nf,)
    face_e_over_d: torch.Tensor  # (nf,) |A|^2 / (A . ds)
    face_t: torch.Tensor  # (nf, dim) limited non-orthogonal remainder
    face_wo: torch.Tensor  # (nf,) inverse-distance owner weight

    dia: object = None  # ops.dia.DIAInfo | None
    host: HostMeshData | None = None
    # True when every interior face's non-orthogonal remainder vanishes
    orthogonal: bool = False
    # periodic pairs: each paired ghost cell and the partner owner cell
    # whose value it mirrors (int64 (np,) tensors), or None
    periodic_ghost: torch.Tensor | None = None
    periodic_src: torch.Tensor | None = None
    # double-shell interfaces: ((name, left group name, right group name),
    # ...); the i-th face of the L group pairs with the i-th of the R group
    interfaces: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return self.cell_volume.dtype

    def take_owner(self, x):
        return gather_rows(x, self.face_cell0)

    def take_nbr(self, x):
        return gather_rows(x, self.face_cell1)

    def take_faces(self, F):
        """F[cf_face] -> (K, nc, ...)."""
        return gather_rows(F, self.cf_face)

    def take_cells(self, x):
        """x[cf_nbr] -> (K, nc, ...); padded slots return x[row]."""
        return gather_rows(x, self.cf_nbr)

    @property
    def n_owned_cells(self) -> int:
        return self.n_cells

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_interior_faces

    @property
    def interior_faces(self) -> slice:
        return slice(0, self.n_interior_faces)

    def group_by_name(self, name: str):
        for g in self.groups:
            if g[1] == name:
                return g
        raise KeyError(name)

    def boundary_groups(self):
        return [g for g in self.groups if g[2] != "interior"]

    def group_faces(self, g) -> slice:
        return slice(g[3], g[3] + g[4])

    def ghost_cells_of_group(self, g) -> slice:
        """Ghost-cell slice for a boundary group (cells are face-ordered)."""
        start = self.n_interior_cells + (g[3] - self.n_interior_faces)
        return slice(start, start + g[4])

    def host_cf(self):
        """(cf_nbr, cf_mask) as HOST numpy ROW-LEADING (n, K) arrays."""
        return self.host.cf_nbr, self.host.cf_mask

    def interface(self, name: str):
        """(left group, right group) tuples of a double-shell interface."""
        for nm, ln, rn in self.interfaces:
            if nm == name:
                return self.group_by_name(ln), self.group_by_name(rn)
        raise KeyError(name)


def _cf_tables(owner, nbr, face_valid, n_cells, K):
    """Cell->face ELL tables, host (n, K): each face in its owner's row and
    (when distinct) its neighbor's row, in stable [owner-block | nbr-block]
    order (``fvm_tpu/mesh/device.py:257-277``, bit-identical to the JAX
    package's native fill)."""
    nf = len(owner)
    counts = np.bincount(owner[face_valid], minlength=n_cells) + np.bincount(
        nbr[face_valid & (nbr != owner)], minlength=n_cells
    )
    rows = np.concatenate([owner, nbr])
    cols = np.tile(np.arange(nf, dtype=np.int64), 2)
    keep = np.ones(len(rows), dtype=bool)
    keep[nf:] = nbr != owner
    keep &= np.tile(face_valid, 2)
    rows, cols = rows[keep], cols[keep]
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    cf_face = np.zeros((n_cells, K), dtype=np.int64)
    cf_mask = np.zeros((n_cells, K), dtype=bool)
    ptr = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    slot = np.arange(len(rows)) - ptr[rows]
    cf_face[rows, slot] = cols
    cf_mask[rows, slot] = True
    cf_is_owner = owner[cf_face] == np.arange(n_cells)[:, None]
    cf_nbr = np.where(cf_is_owner, nbr[cf_face], owner[cf_face])
    cf_nbr = np.where(cf_mask, cf_nbr, np.arange(n_cells)[:, None])
    return cf_face, cf_mask, cf_is_owner, cf_nbr


def assemble_device_mesh(
    dim: int,
    face_cells: np.ndarray,  # (nf, 2); boundary nbr = ghost id
    groups: tuple,  # ((ident, name, type, offset, count), ...)
    n_interior_cells: int,
    n_interior_faces: int,
    n_cells: int,
    face_area: np.ndarray,
    face_area_mag: np.ndarray,
    face_centroid: np.ndarray,
    cell_centroid: np.ndarray,
    cell_volume: np.ndarray,
    dtype=None,
    device=None,
    face_valid: np.ndarray | None = None,
    extra_adj: tuple | None = None,
    interfaces: tuple = (),
) -> DeviceMesh:
    """Low-level device-mesh assembler from flat host arrays.

    ``extra_adj`` (rows, cols): couplings that are no face (the periodic
    and shell-ghost rows), spliced into the free tail slots of their rows
    in the given order."""
    from ..ops.dia import DIAInfo

    dev = resolve_device(device)
    dtype = as_dtype(dtype)
    nf = face_cells.shape[0]
    owner = face_cells[:, 0]
    nbr = face_cells[:, 1]
    if face_valid is None:
        face_valid = np.ones(nf, bool)

    counts = np.bincount(owner[face_valid], minlength=n_cells) + np.bincount(
        nbr[face_valid & (nbr != owner)], minlength=n_cells
    )
    extra_need = np.zeros(n_cells, dtype=np.int64)
    if extra_adj is not None:
        extra_need = np.bincount(extra_adj[0], minlength=n_cells)
    K = int((counts + extra_need).max()) if len(counts) else 1
    cf_face, cf_mask, cf_is_owner, cf_nbr = _cf_tables(
        owner, nbr, face_valid, n_cells, K
    )
    if extra_adj is not None:
        # the relative order within a row is kept, so the interface rows
        # find [partner ghost, partner owner] at slots 1 and 2
        erows = np.asarray(extra_adj[0], dtype=np.int64)
        ecols = np.asarray(extra_adj[1], dtype=np.int64)
        order2 = np.argsort(erows, kind="stable")
        er, ec = erows[order2], ecols[order2]
        ptr2 = np.zeros(n_cells + 1, dtype=np.int64)
        np.cumsum(extra_need, out=ptr2[1:])
        slot2 = np.arange(len(er)) - ptr2[er] + counts[er]
        cf_mask[er, slot2] = True
        cf_nbr[er, slot2] = ec
        # geometry gathers for these slots read the row's own face; the
        # assembled values are overwritten by the BC and interface rows
        cf_face[er, slot2] = cf_face[er, 0]
        cf_is_owner[er, slot2] = cf_is_owner[er, 0]
    host_data = HostMeshData(
        np.asarray(cell_centroid, dtype=np.float64),
        np.asarray(cf_nbr, dtype=np.int32),
        np.asarray(cf_mask, dtype=bool),
    )
    dia = DIAInfo.build(cf_nbr, cf_mask, dev)

    ds = cell_centroid[nbr] - cell_centroid[owner]
    dsmag = np.linalg.norm(ds, axis=1)
    a_dot_ds = np.einsum("fd,fd->f", face_area, ds)
    amag2 = face_area_mag**2
    e_over_d = amag2 / np.where(a_dot_ds != 0, a_dot_ds, 1.0)
    t_vec = face_area - e_over_d[:, None] * ds
    # limited non-orthogonal correction (lambda = 0.8), as in the JAX
    # package: unlimited corrections diverge on severely skewed cells
    tmag_ = np.linalg.norm(t_vec, axis=1)
    implicit_scale = np.abs(e_over_d) * dsmag
    cap = np.minimum(1.0, 0.8 * implicit_scale / np.maximum(tmag_, 1e-300))
    t_vec = t_vec * cap[:, None]
    # no deferred correction on boundary faces (the ghost sits AT the face)
    bmask = np.zeros(nf, dtype=bool)
    bmask[n_interior_faces:] = True
    t_vec = np.where(bmask[:, None], 0.0, t_vec)
    do_ = np.linalg.norm(face_centroid - cell_centroid[owner], axis=1)
    dn_ = np.linalg.norm(face_centroid - cell_centroid[nbr], axis=1)
    face_wo = dn_ / np.maximum(do_ + dn_, 1e-300)
    tmag = np.abs(t_vec[:n_interior_faces]).max() if n_interior_faces else 0.0
    scale = np.abs(face_area_mag).max() if nf else 1.0
    orthogonal = bool(tmag <= 1e-12 * max(scale, 1e-300))

    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def f(x):  # convert in numpy first, like the JAX package
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np_dtype)).to(dev)

    def i(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)

    def b(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=bool)).to(dev)

    return DeviceMesh(
        dim=dim,
        n_cells=n_cells,
        n_interior_cells=n_interior_cells,
        n_faces=nf,
        n_interior_faces=n_interior_faces,
        max_faces_per_cell=K,
        groups=tuple(groups),
        device=dev,
        face_cell0=i(owner),
        face_cell1=i(nbr),
        cf_face=i(cf_face.T),
        cf_is_owner=b(cf_is_owner.T),
        cf_mask=b(cf_mask.T),
        cf_nbr=i(cf_nbr.T),
        face_area=f(face_area),
        face_area_mag=f(face_area_mag),
        face_centroid=f(face_centroid),
        cell_centroid=f(cell_centroid),
        cell_volume=f(cell_volume),
        face_ds=f(ds),
        face_dsmag=f(dsmag),
        face_e_over_d=f(e_over_d),
        face_t=f(t_vec),
        face_wo=f(face_wo),
        dia=dia,
        host=host_data,
        orthogonal=orthogonal,
        interfaces=tuple(interfaces),
    )


def build_device_mesh(
    mesh: Mesh,
    geom: MeshGeometry | None = None,
    dtype=None,
    device=None,
) -> DeviceMesh:
    """Bake a host Mesh (+geometry) into the device layout on ``device``
    (default ``"cuda"``; raises when no GPU is present unless the caller
    passes ``device="cpu"``).

    Interior faces are renumbered into PLANE-MAJOR order (the
    face owned by cell c at its j-th owned rank lives at id j*n_int_cells
    + c; padding holes are zero-area dummy faces attached to one extra
    dummy cell), exactly as ``fvm_tpu.mesh.build_device_mesh`` does.
    """
    dev = resolve_device(device)
    if geom is None:
        geom = compute_geometry(mesh)
    groups = [
        (g.ident, g.name, g.group_type, g.offset, g.count)
        for g in mesh.face_groups
    ]
    fc = mesh.face_cells
    fa = geom.face_area
    fam = geom.face_area_mag
    fcn = geom.face_centroid
    ccn = geom.cell_centroid
    cv = geom.cell_volume
    n_int_c = mesh.n_interior_cells
    n_int_f = mesh.n_interior_faces
    nc = mesh.n_cells
    nf = mesh.n_faces
    face_valid = None

    periodic_ghost = periodic_src = None
    pairs = getattr(mesh, "periodic_pairs", None)
    if pairs:
        # each periodic ghost sits at the wrapped partner-owner location,
        # so face_ds, e_over_d, the LS stencils and the interpolation
        # weights wrap
        ccn = ccn.copy()
        pf = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        fa_, fb_ = pf[:, 0], pf[:, 1]
        ga_, gb_ = fc[fa_, 1], fc[fb_, 1]
        oa_, ob_ = fc[fa_, 0], fc[fb_, 0]
        # in pair order, as the JAX package's loop (a later pair that
        # shares a ghost overwrites an earlier one)
        for i in range(len(pf)):
            ccn[ga_[i]] = ccn[ob_[i]] + (fcn[fa_[i]] - fcn[fb_[i]])
            ccn[gb_[i]] = ccn[oa_[i]] + (fcn[fb_[i]] - fcn[fa_[i]])
        periodic_ghost = np.stack([ga_, gb_], axis=1).reshape(-1)
        periodic_src = np.stack([ob_, oa_], axis=1).reshape(-1)

    if n_int_c > 0:
        # global slot stride = max faces per interior cell
        counts_all = np.bincount(
            np.concatenate([fc[:, 0], fc[fc[:, 1] < n_int_c, 1]]),
            minlength=n_int_c,
        )
        K = int(counts_all[:n_int_c].max())
        own_int = fc[:n_int_f, 0]
        # rank of each interior face within its owner (stable)
        order = np.argsort(own_int, kind="stable")
        ranks = np.empty(n_int_f, dtype=np.int64)
        seq = np.arange(n_int_f)
        starts = np.searchsorted(own_int[order], np.arange(n_int_c))
        ranks[order] = seq - starts[own_int[order]]
        new_pos_int = ranks * n_int_c + own_int  # plane-major
        n_int_f_new = n_int_c * K
        nf_new = n_int_f_new + (nf - n_int_f)
        dummy_cell = nc  # one extra trash cell

        def scat(a, fill=0.0):
            out = np.full((nf_new,) + a.shape[1:], fill, dtype=a.dtype)
            out[new_pos_int] = a[:n_int_f]
            out[n_int_f_new:] = a[n_int_f:]
            return out

        fc2 = np.full((nf_new, 2), dummy_cell, dtype=fc.dtype)
        fc2[new_pos_int] = fc[:n_int_f]
        fc2[n_int_f_new:] = fc[n_int_f:]
        face_valid = np.zeros(nf_new, dtype=bool)
        face_valid[new_pos_int] = True
        face_valid[n_int_f_new:] = True
        fa = scat(fa)
        fam = scat(fam)
        fcn = scat(fcn)
        fc = fc2
        ccn = np.concatenate([ccn, np.zeros((1, mesh.dim))], axis=0)
        cv = np.concatenate([cv, np.zeros(1)])
        shift = n_int_f_new - n_int_f
        groups = [
            (g[0], g[1], g[2], g[3] + (shift if g[2] != "interior" else 0),
             g[4] if g[2] != "interior" else n_int_f_new)
            for g in groups
        ]
        n_int_f = n_int_f_new
        nc = nc + 1
        nf = nf_new

    iface_meta = tuple(getattr(mesh, "interfaces", ()))
    extra_rows: list = []
    extra_cols: list = []
    if periodic_ghost is not None:
        # implicit periodic rows: slot 1 of each periodic ghost couples it
        # to the wrapped partner owner (core.bcs.periodic_rows)
        extra_rows.append(periodic_ghost)
        extra_cols.append(periodic_src)
    if iface_meta:
        # shell-ghost couplings in the final face numbering, per row in the
        # order [partner ghost, partner owner]
        by_name = {g[1]: g for g in groups}
        for _, ln, rn in iface_meta:
            gL, gR = by_name[ln], by_name[rn]
            fL = np.arange(gL[3], gL[3] + gL[4])
            fR = np.arange(gR[3], gR[3] + gR[4])
            ghL = n_int_c + (fL - n_int_f)
            ghR = n_int_c + (fR - n_int_f)
            extra_rows += [ghL, ghR, ghL, ghR]
            extra_cols += [ghR, ghL, fc[fR, 0], fc[fL, 0]]
    extra_adj = None
    if extra_rows:
        extra_adj = (np.concatenate(extra_rows), np.concatenate(extra_cols))

    dm = assemble_device_mesh(
        mesh.dim, fc, tuple(groups), n_int_c, n_int_f, nc,
        fa, fam, fcn, ccn, cv,
        dtype=dtype, device=dev, face_valid=face_valid,
        extra_adj=extra_adj, interfaces=iface_meta,
    )
    if periodic_ghost is not None:
        dm.periodic_ghost = torch.from_numpy(periodic_ghost).to(dev)
        dm.periodic_src = torch.from_numpy(periodic_src).to(dev)
    return dm
