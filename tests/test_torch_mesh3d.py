"""The port's ``hex_3d`` and ``tri_2d`` meshes, 3D metrics and device
tables against fvm_tpu.

The same meshes go through both packages (the port's generators are
vectorized, the JAX package's loop over faces).  Every host and device
table must be identical: face cells, face nodes, groups, the cell->face
tables and the DIA offsets, buckets and fallback; the geometry (3D: a
triangle fan about each face's node mean) must agree to 1e-14 relative.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.ops.gradients import ls_gradient_coefficients as j_ls
from fvm_tpu_torch.ops.gradients import ls_gradient_coefficients as t_ls

GEOM_RTOL = 1e-14
MESHES = [("hex_3d", (4, 3, 2)), ("hex_3d", (5, 4, 3)), ("tri_2d", (7, 5)),
          ("tri_2d", (16, 16))]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _close(t, j):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t, j, rtol=GEOM_RTOL, atol=GEOM_RTOL * scale)


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{g}{'x'.join(map(str, a))}" for g, a in MESHES])
def meshes(request):
    gen, args = request.param
    jm = getattr(jfvm.mesh.generate, gen)(*args)
    tm = getattr(tfvm.mesh.generate, gen)(*args)
    jd = jfvm.mesh.build_device_mesh(jm, dtype=jnp.float64)
    td = tfvm.mesh.build_device_mesh(tm, dtype="float64", device="cpu")
    return jm, tm, jd, td


def test_host_mesh_identical(meshes):
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


def test_geometry_matches(meshes):
    jm, tm, _, _ = meshes
    jg = jfvm.mesh.compute_geometry(jm)
    tg = tfvm.mesh.compute_geometry(tm)
    for f in ("face_area", "face_area_mag", "face_centroid", "cell_centroid",
              "cell_volume"):
        _close(getattr(tg, f), getattr(jg, f))
    # a closed mesh: the interior volumes fill the unit box / square
    assert abs(tg.cell_volume.sum() - 1.0) < 1e-12


def test_device_tables_identical(meshes):
    _, _, jd, td = meshes
    for attr in ("dim", "n_cells", "n_interior_cells", "n_faces",
                 "n_interior_faces", "max_faces_per_cell", "groups",
                 "orthogonal"):
        assert getattr(jd, attr) == getattr(td, attr), attr
    assert td.max_faces_per_cell == (6 if td.dim == 3 else 3)
    for f in ("face_cell0", "face_cell1", "cf_face", "cf_nbr", "cf_mask",
              "cf_is_owner"):
        _eq(getattr(jd, f), getattr(td, f))
    for f in ("face_area", "face_area_mag", "face_centroid", "cell_centroid",
              "cell_volume", "face_ds", "face_dsmag", "face_e_over_d",
              "face_t", "face_wo"):
        _close(getattr(td, f), getattr(jd, f))
    # the non-orthogonal remainder is non-zero exactly on the triangles
    t_max = float(td.face_t.abs().max())
    assert (t_max > 1e-3) == (td.dim == 2) and td.orthogonal == (td.dim == 3)


def test_dia_and_condensation_identical(meshes):
    _, _, jd, td = meshes
    assert (jd.dia is None) == (td.dia is None)
    if td.dia is None:
        return
    assert jd.dia.offsets == td.dia.offsets
    for f in ("bucket", "fb_rows", "fb_slots", "fb_cols"):
        _eq(getattr(jd.dia, f), getattr(td.dia, f))
    jp, tp = jd.dia.cond_plan, td.dia.cond_plan
    assert (jp is None) == (tp is None)
    if tp is not None:
        for f in ("elim_rows", "elim_slot", "elim_part", "in_rows",
                  "in_slots", "in_elim", "mask2"):
            _eq(getattr(jp, f), getattr(tp, f))
        assert jp.dia2.offsets == tp.dia2.offsets
        _eq(jp.dia2.fb_rows, tp.dia2.fb_rows)


def test_ls_gradient_coefficients_match(meshes):
    _, _, jd, td = meshes
    _close(t_ls(td), j_ls(jd))


@pytest.mark.parametrize("n,offsets", [(8, {1, 8, 64}), (24, {1, 24, 576})])
def test_hex_fine_level_is_dia_with_six_offsets(n, offsets):
    """The condensed fine level of hex_3d(n^3) is a 7-point stencil: DIA
    offsets +-1, +-n, +-n^2 and no fallback entries, as in fvm_tpu."""
    td = tfvm.mesh.build_device_mesh(tfvm.mesh.generate.hex_3d(n, n, n),
                                     dtype="float64", device="cpu")
    jd = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.hex_3d(n, n, n),
                                     dtype=jnp.float64)
    fine = td.dia.cond_plan.dia2
    assert sorted(fine.offsets) == sorted(
        [d for o in offsets for d in (o, -o)])
    assert fine.fb_rows.shape[0] == 0
    assert jd.dia.cond_plan.dia2.offsets == fine.offsets
