"""Parity of the port's host mesh, device mesh and DIA analysis with fvm_tpu.

The same ``quad_2d`` meshes go through both packages; every table must be
bit-identical: the host mesh and geometry, the device cell->face tables
(the JAX package fills them in its native host library, the port with the
numpy fill that module documents as identical), the face geometry, the
DIA offsets and buckets, and the boundary-condensation plan.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.ops.gradients import ls_gradient_coefficients as j_ls
from fvm_tpu_torch.ops.gradients import ls_gradient_coefficients as t_ls

SIZES = [(8, 6), (32, 32)]


def _eq(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def meshes(request):
    nx, ny = request.param
    jm = jfvm.mesh.generate.quad_2d(nx, ny)
    tm = tfvm.mesh.generate.quad_2d(nx, ny)
    jd = jfvm.mesh.build_device_mesh(jm, dtype=jnp.float64)
    td = tfvm.mesh.build_device_mesh(tm, dtype="float64", device="cpu")
    return jm, tm, jd, td


def test_host_mesh_and_geometry_identical(meshes):
    jm, tm, _, _ = meshes
    for attr in ("dim", "n_interior_cells", "n_interior_faces", "n_faces",
                 "n_cells", "n_nodes", "n_boundary_faces"):
        assert getattr(jm, attr) == getattr(tm, attr), attr
    _eq(jm.coords, tm.coords)
    _eq(jm.face_cells, tm.face_cells)
    _eq(jm.face_nodes.row_ptr, tm.face_nodes.row_ptr)
    _eq(jm.face_nodes.col, tm.face_nodes.col)
    assert [(g.ident, g.name, g.group_type, g.offset, g.count)
            for g in jm.face_groups] == [
        (g.ident, g.name, g.group_type, g.offset, g.count)
        for g in tm.face_groups]
    jg = jfvm.mesh.compute_geometry(jm)
    tg = tfvm.mesh.compute_geometry(tm)
    for f in ("face_area", "face_area_mag", "face_centroid", "cell_centroid",
              "cell_volume"):
        _eq(getattr(jg, f), getattr(tg, f))


def test_device_tables_identical(meshes):
    _, _, jd, td = meshes
    for attr in ("dim", "n_cells", "n_interior_cells", "n_faces",
                 "n_interior_faces", "max_faces_per_cell", "groups",
                 "orthogonal"):
        assert getattr(jd, attr) == getattr(td, attr), attr
    for f in ("face_cell0", "face_cell1", "cf_face", "cf_nbr", "cf_mask",
              "cf_is_owner"):
        _eq(getattr(jd, f), getattr(td, f))
    for f in ("face_area", "face_area_mag", "face_centroid", "cell_centroid",
              "cell_volume", "face_ds", "face_dsmag", "face_e_over_d",
              "face_t", "face_wo"):
        _eq(getattr(jd, f), getattr(td, f))
    jn, jmask = jd.host_cf()
    tn, tmask = td.host_cf()
    _eq(jn, tn)
    _eq(jmask, tmask)
    assert td.cf_face.device.type == "cpu"


def test_dia_info_and_condense_plan_identical(meshes):
    _, _, jd, td = meshes
    jdia, tdia = jd.dia, td.dia
    assert jdia.offsets == tdia.offsets
    for f in ("bucket", "fb_rows", "fb_slots", "fb_cols"):
        _eq(getattr(jdia, f), getattr(tdia, f))
    jp, tp = jdia.cond_plan, tdia.cond_plan
    assert (jp is None) == (tp is None)
    assert jp is not None  # quad meshes have boundary ghosts to condense
    for f in ("elim_rows", "elim_slot", "elim_part", "in_rows", "in_slots",
              "in_elim", "mask2"):
        _eq(getattr(jp, f), getattr(tp, f))
    assert jp.dia2.offsets == tp.dia2.offsets
    for f in ("bucket", "fb_rows", "fb_slots", "fb_cols"):
        _eq(getattr(jp.dia2, f), getattr(tp.dia2, f))


def test_ls_gradient_coefficients_identical(meshes):
    _, _, jd, td = meshes
    _eq(j_ls(jd), t_ls(td))
