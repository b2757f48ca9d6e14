"""Mesh geometry metrics (counterpart of ``fvm_tpu/mesh/metrics.py``).

Face areas/centroids and cell volumes/centroids, vectorized numpy at
import time (the reference's MeshMetricsCalculator_impl.h:60-394).
Conventions: face area vectors point owner -> neighbor (outward on
boundary faces); a ghost cell sits at its boundary face centroid with zero
volume.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mesh import Mesh


@dataclass
class MeshGeometry:
    """All geometry arrays for one mesh (host-side numpy, float64)."""

    face_area: np.ndarray  # (n_faces, dim) oriented owner -> neighbor
    face_area_mag: np.ndarray  # (n_faces,)
    face_centroid: np.ndarray  # (n_faces, dim)
    cell_centroid: np.ndarray  # (n_cells_total, dim) incl. ghost cells
    cell_volume: np.ndarray  # (n_cells_total,) ghost cells = 0


def _face_subelements(mesh: Mesh):
    """Faces as flat sub-elements: (face_id, area_vec, centroid) per
    sub-element, the area oriented by the stored node order (fixed up
    later).  2D faces are segments; a 3D polygon face is a fan of
    triangles about its node mean (exact for the divergence-theorem
    volume integrals of non-planar faces too).  At 128^3 the fan is 25.4M
    triangles: each (n, 3) float64 temporary is 0.6 GB."""
    fn = mesh.face_nodes
    coords = mesh.coords
    counts = fn.row_counts()
    if mesh.dim == 2:
        if not (counts == 2).all():
            raise ValueError("2D faces must have exactly 2 nodes")
        n0 = coords[fn.col[fn.row_ptr[:-1]]]
        n1 = coords[fn.col[fn.row_ptr[:-1] + 1]]
        d = n1 - n0
        area = np.stack([d[:, 1], -d[:, 0]], axis=1)
        centroid = 0.5 * (n0 + n1)
        face_id = np.arange(mesh.n_faces, dtype=np.int64)
        return face_id, area, centroid

    face_of_entry = np.repeat(np.arange(mesh.n_faces, dtype=np.int64), counts)
    mean = np.zeros((mesh.n_faces, 3))
    for c in range(3):
        mean[:, c] = np.bincount(
            face_of_entry, weights=coords[fn.col, c], minlength=mesh.n_faces
        )
    mean /= counts[:, None]
    # triangle (mean, node_i, node_i+1) per edge, the last node wrapping
    # back to the first
    next_entry = np.arange(fn.nnz, dtype=np.int64) + 1
    next_entry[fn.row_ptr[1:] - 1] = fn.row_ptr[:-1]
    a = coords[fn.col]
    b = coords[fn.col[next_entry]]
    apex = mean[face_of_entry]
    del mean, next_entry
    area = 0.5 * np.cross(a - apex, b - apex)
    centroid = (apex + a + b) / 3.0
    return face_of_entry, area, centroid


def compute_geometry(mesh: Mesh) -> MeshGeometry:
    nf, nc, dim = mesh.n_faces, mesh.n_cells, mesh.dim
    n_int = mesh.n_interior_cells
    owner = mesh.face_cells[:, 0]
    nbr = mesh.face_cells[:, 1]

    sub_face, sub_area, sub_cent = _face_subelements(mesh)

    face_area = np.zeros((nf, dim))
    for c in range(dim):
        face_area[:, c] = np.bincount(sub_face, weights=sub_area[:, c], minlength=nf)
    sub_mag = np.linalg.norm(sub_area, axis=1)
    wsum = np.bincount(sub_face, weights=sub_mag, minlength=nf)
    face_centroid = np.zeros((nf, dim))
    for c in range(dim):
        face_centroid[:, c] = np.bincount(
            sub_face, weights=sub_mag * sub_cent[:, c], minlength=nf
        )
    # degenerate (zero-area) faces fall back to sub-centroid mean
    safe = np.where(wsum > 0, wsum, 1.0)
    face_centroid /= safe[:, None]
    nsub = np.bincount(sub_face, minlength=nf)
    fallback = np.zeros_like(face_centroid)
    for c in range(dim):
        fallback[:, c] = np.bincount(sub_face, weights=sub_cent[:, c], minlength=nf)
    fallback /= np.maximum(nsub, 1)[:, None]
    face_centroid = np.where((wsum > 0)[:, None], face_centroid, fallback)

    # approximate cell centers (mean of adjacent face centroids) to orient
    approx = np.zeros((n_int, dim))
    cnt = np.bincount(owner[owner < n_int], minlength=n_int) + np.bincount(
        nbr[nbr < n_int], minlength=n_int
    )
    for c in range(dim):
        approx[:, c] = np.bincount(
            owner[owner < n_int], weights=face_centroid[owner < n_int, c], minlength=n_int
        ) + np.bincount(
            nbr[nbr < n_int], weights=face_centroid[nbr < n_int, c], minlength=n_int
        )
    approx /= cnt[:, None]

    # orient: area points owner -> neighbor (outward on boundary)
    is_int = nbr < n_int
    target = np.where(is_int[:, None], approx[np.minimum(nbr, n_int - 1)], face_centroid)
    sign = np.sign(np.einsum("fd,fd->f", face_area, target - approx[owner]))
    sign = np.where(sign == 0, 1.0, sign)
    face_area *= sign[:, None]
    sub_sign = sign[sub_face]
    sub_area = sub_area * sub_sign[:, None]

    # cell volumes & centroids by sub-element pyramid decomposition from
    # the approximate center
    sub_owner = owner[sub_face]
    sub_nbr = nbr[sub_face]
    cell_volume = np.zeros(nc)
    cell_centroid = np.zeros((nc, dim))

    for cells, s in ((sub_owner, 1.0), (sub_nbr, -1.0)):
        mask = cells < n_int
        cs = cells[mask]
        ref = approx[cs]
        av = s * sub_area[mask]
        xc = sub_cent[mask]
        vpyr = np.einsum("td,td->t", xc - ref, av) / dim
        cpyr = ref + (dim / (dim + 1.0)) * (xc - ref)
        cell_volume[:n_int] += np.bincount(cs, weights=vpyr, minlength=n_int)
        for c in range(dim):
            cell_centroid[:n_int, c] += np.bincount(
                cs, weights=vpyr * cpyr[:, c], minlength=n_int
            )

    cell_centroid[:n_int] /= cell_volume[:n_int, None]

    # ghost cells: centroid at the boundary face, zero volume
    bslice = slice(mesh.n_interior_faces, nf)
    cell_centroid[n_int:] = face_centroid[bslice]
    cell_volume[n_int:] = 0.0

    return MeshGeometry(
        face_area=face_area,
        face_area_mag=np.linalg.norm(face_area, axis=1),
        face_centroid=face_centroid,
        cell_centroid=cell_centroid,
        cell_volume=cell_volume,
    )
