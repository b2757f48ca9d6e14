"""The mesh extras against fvm_tpu, table for table (numpy, CPU).

* ``Mesh.make_interface`` (with and without ``left_cells``, sides flipped,
  2D and 3D, twice on one mesh), ``make_periodic`` (2D and 3D, after an
  interface), ``interface_faces_between``, ``cell_zone_mask``,
  ``cell_cells``/``cell_cells2`` and ``extract_boundary_mesh`` (with
  ``BoundaryMesh.face_geometry``): coordinates, face->node rows (winding
  included), face->cell tables, groups and their order, ``periodic_pairs``
  and ``interfaces`` bit for bit; the errors of ``tests/test_boundary_mesh
  .py``.
* ``mesh/assemble.py``: ``merge_meshes`` and ``extract_region`` bit for
  bit.
* ``build_device_mesh`` of meshes with periodic pairs and interfaces: the
  repositioned ghosts, every cf table (the extra slots: slot 1 of each
  periodic ghost, [partner ghost, partner owner] in the shell-ghost rows),
  the face geometry, ``periodic_ghost``/``periodic_src``, the DIA analysis
  (offsets, fallback rows and the condensed structure), and which AMG
  levels come out structured or greedy.
"""

import numpy as np
import pytest

import fvm_tpu as jfvm
from fvm_tpu.linear import AMG as JAMG
from fvm_tpu.mesh import assemble as jasm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.mesh.metrics import compute_geometry as jgeometry
from fvm_tpu_torch.exceptions import MeshError
from fvm_tpu_torch.linear import AMG as TAMG
from fvm_tpu_torch.mesh import (assemble as tasm, build_device_mesh,
                                compute_geometry)
from fvm_tpu_torch.mesh import generate as tgen


def _same_cr(a, b):
    assert a.count_to == b.count_to
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col, b.col)


def _groups(m):
    return [(g.ident, g.name, g.group_type, g.offset, g.count)
            for g in m.face_groups]


def _same_mesh(t, j):
    assert (t.dim, t.n_interior_cells, t.n_faces, t.n_interior_faces,
            t.n_cells) == (j.dim, j.n_interior_cells, j.n_faces,
                           j.n_interior_faces, j.n_cells)
    assert np.array_equal(t.coords, j.coords)
    _same_cr(t.face_nodes, j.face_nodes)
    assert np.array_equal(t.face_cells, j.face_cells)
    assert _groups(t) == _groups(j)
    assert getattr(t, "interfaces", ()) == getattr(j, "interfaces", ())
    assert getattr(t, "periodic_pairs", None) == getattr(
        j, "periodic_pairs", None)


def _pair(kind, *args):
    return getattr(tgen, kind)(*args), getattr(jgen, kind)(*args)


def _split(m, x=1.0, axis=0, flip=False):
    """(faces between the cells below and above ``x`` on ``axis``, the
    left-cell mask; ``flip`` makes the upper side "left")."""
    xc = jgeometry(m).cell_centroid[: m.n_interior_cells, axis]
    left = xc < x
    if flip:
        left = ~left
    return m.interface_faces_between(left, ~left), left


@pytest.mark.parametrize("kind,args,x,axis", [
    ("quad_2d", (16, 4, 2.0, 1.0), 1.0, 0),
    ("quad_2d", (5, 6), 0.5, 1),
    ("hex_3d", (4, 3, 2), 0.5, 0),
])
@pytest.mark.parametrize("orient", ["none", "left", "flipped"])
def test_make_interface_equals_fvm_tpu(kind, args, x, axis, orient):
    t, j = _pair(kind, *args)
    faces, left = _split(j, x, axis, flip=orient == "flipped")
    tfaces, _ = _split(t, x, axis, flip=orient == "flipped")
    assert np.array_equal(tfaces, faces) and len(faces)
    lc = None if orient == "none" else left
    t2 = t.make_interface("mid", faces, left_cells=lc)
    j2 = j.make_interface("mid", faces, left_cells=lc)
    _same_mesh(t2, j2)
    # a second interface on the new mesh
    faces2 = np.nonzero(j2.face_cells[: j2.n_interior_faces, 0] % 3 == 0)[0]
    _same_mesh(t2.make_interface("b", faces2[:4]),
               j2.make_interface("b", faces2[:4]))


def test_make_interface_errors():
    t = tgen.quad_2d(4, 4)
    with pytest.raises(MeshError):
        t.make_interface("x", [])
    with pytest.raises(MeshError):
        t.make_interface("x", [t.n_interior_faces])
    faces = np.arange(3)
    with pytest.raises(MeshError):
        t.make_interface("x", faces,
                         left_cells=np.zeros(t.n_interior_cells, bool))


@pytest.mark.parametrize("kind,args,ga,gb", [
    ("quad_2d", (8, 12), "left", "right"),
    ("quad_2d", (16, 4, 2.0, 1.0), "bottom", "top"),
    ("hex_3d", (3, 4, 2), "xmin", "xmax"),
    ("hex_3d", (3, 4, 2), "zmin", "zmax"),
])
def test_make_periodic_equals_fvm_tpu(kind, args, ga, gb):
    t, j = _pair(kind, *args)
    t.make_periodic(ga, gb)
    j.make_periodic(ga, gb)
    _same_mesh(t, j)
    with pytest.raises(MeshError):
        t.make_periodic(ga, "nope")


def test_make_periodic_size_mismatch():
    t = tgen.quad_2d(4, 6)
    with pytest.raises(MeshError, match="sizes"):
        t.make_periodic("left", "top")


def _plate(pkg, nx=16, ny=4):
    """The two-material plate's host mesh: interface then periodic."""
    m = getattr(pkg, "quad_2d")(nx, ny, 2.0, 1.0)
    faces, left = _split(m)
    m = m.make_interface("tc", faces, left_cells=left)
    m.make_periodic("bottom", "top")
    return m


def test_interface_then_periodic_equals_fvm_tpu():
    _same_mesh(_plate(tgen), _plate(jgen))


def test_cell_zones_and_two_rings():
    t, j = _pair("quad_2d", 5, 4)
    for m in (t, j):
        m.cell_zones = [(7, "solid", "solid", np.array([0, 3, 4])),
                        (8, "fluid", "fluid", np.arange(5, 20))]
    for key in ("solid", 8):
        assert np.array_equal(t.cell_zone_mask(key), j.cell_zone_mask(key))
    with pytest.raises(MeshError):
        t.cell_zone_mask("none")
    _same_cr(t.cell_cells, j.cell_cells)
    _same_cr(t.cell_cells2, j.cell_cells2)
    t3, j3 = _pair("hex_3d", 3, 2, 2)
    _same_cr(t3.cell_cells2, j3.cell_cells2)


@pytest.mark.parametrize("kind,args,groups", [
    ("quad_2d", (8, 6), None),
    ("hex_3d", (4, 3, 2), ["zmax"]),
    ("hex_3d", (4, 3, 2), ["xmin", "ymax"]),
])
def test_extract_boundary_mesh_equals_fvm_tpu(kind, args, groups):
    t, j = _pair(kind, *args)
    bt, bj = t.extract_boundary_mesh(groups), j.extract_boundary_mesh(groups)
    for name in ("coords", "parent_faces", "parent_nodes", "parent_cells"):
        assert np.array_equal(getattr(bt, name), getattr(bj, name))
    _same_cr(bt.face_nodes, bj.face_nodes)
    assert bt.groups == bj.groups and (bt.n_faces, bt.n_nodes) == (
        bj.n_faces, bj.n_nodes)
    for a, b in zip(bt.face_geometry(), bj.face_geometry()):
        assert np.array_equal(a, b)
    name = bt.groups[0][0]
    assert bt.group_slice(name) == bj.group_slice(name)
    # the parent's metrics on those faces (tests/test_boundary_mesh.py)
    xc, an = bt.face_geometry()
    geom = compute_geometry(t)
    assert np.allclose(xc, geom.face_centroid[bt.parent_faces])
    assert np.allclose(np.abs(an), np.abs(geom.face_area[bt.parent_faces]),
                       atol=1e-12)
    with pytest.raises(MeshError):
        t.extract_boundary_mesh(groups=["nope"])
    with pytest.raises(MeshError):
        bt.group_slice("nope")


def test_merge_and_extract_region_equal_fvm_tpu():
    t1, j1 = _pair("quad_2d", 4, 3)
    t2, j2 = _pair("quad_2d", 4, 3)
    for m in (t2, j2):
        m.coords = m.coords + np.array([1.0, 0.0])
    tm, jm = tasm.merge_meshes([t1, t2]), jasm.merge_meshes([j1, j2])
    _same_mesh(tm, jm)
    assert tm.n_interior_cells == 24
    with pytest.raises(MeshError):
        tasm.merge_meshes([t1])
    mask = jgeometry(jm).cell_centroid[: jm.n_interior_cells, 0] < 0.9
    _same_mesh(tasm.extract_region(tm, mask, "cut"),
               jasm.extract_region(jm, mask, "cut"))
    h = jgen.hex_3d(3, 3, 2)
    th = tgen.hex_3d(3, 3, 2)
    mask = np.arange(h.n_interior_cells) % 2 == 0
    _same_mesh(tasm.extract_region(th, mask), jasm.extract_region(h, mask))
    with pytest.raises(MeshError):
        tasm.extract_region(th, mask[:-1])


DEVICE_FIELDS = ("face_cell0", "face_cell1", "cf_face", "cf_is_owner",
                 "cf_mask", "cf_nbr", "face_area", "face_area_mag",
                 "face_centroid", "cell_centroid", "cell_volume", "face_ds",
                 "face_dsmag", "face_e_over_d", "face_t", "face_wo")


def _device_pair(build):
    tmesh, jmesh = build(tgen), build(jgen)
    _same_mesh(tmesh, jmesh)
    import jax.numpy as jnp

    return (build_device_mesh(tmesh, dtype="float64", device="cpu"),
            jfvm.mesh.build_device_mesh(jmesh, dtype=jnp.float64))


def _periodic_3d(pkg):
    m = pkg.hex_3d(4, 3, 2)
    m.make_periodic("xmin", "xmax")
    return m


def _interface_3d(pkg):
    m = pkg.hex_3d(4, 3, 2)
    faces, left = _split(m, 0.5, 0)
    return m.make_interface("mid", faces, left_cells=left)


@pytest.mark.parametrize("build", [
    _plate,
    lambda pkg: _plate(pkg, 32, 16),
    _periodic_3d,
    _interface_3d,
], ids=["plate16x4", "plate32x16", "periodic3d", "interface3d"])
def test_device_tables_equal_fvm_tpu(build):
    tdm, jdm = _device_pair(build)
    assert (tdm.n_cells, tdm.n_faces, tdm.n_interior_faces,
            tdm.max_faces_per_cell, tdm.groups, tdm.interfaces,
            tdm.orthogonal) == (
        jdm.n_cells, jdm.n_faces, jdm.n_interior_faces,
        jdm.max_faces_per_cell, jdm.groups, jdm.interfaces, jdm.orthogonal)
    for name in DEVICE_FIELDS:
        assert np.array_equal(getattr(tdm, name).numpy(),
                              np.asarray(getattr(jdm, name))), name
    if jdm.periodic_ghost is None:
        assert tdm.periodic_ghost is None
    else:
        assert np.array_equal(tdm.periodic_ghost.numpy(),
                              np.asarray(jdm.periodic_ghost))
        assert np.array_equal(tdm.periodic_src.numpy(),
                              np.asarray(jdm.periodic_src))
    assert (tdm.dia is None) == (jdm.dia is None)
    if jdm.dia is not None:
        assert tdm.dia.offsets == jdm.dia.offsets
        assert np.array_equal(tdm.dia.fb_rows.numpy(),
                              np.asarray(jdm.dia.fb_rows))
        assert np.array_equal(tdm.dia.fb_slots.numpy(),
                              np.asarray(jdm.dia.fb_slots))
        tp, jp = tdm.dia.cond_plan, jdm.dia.cond_plan
        assert (tp is None) == (jp is None)
        if jp is not None:
            assert np.array_equal(tp.mask2, jp.mask2)
            assert tp.dia2.offsets == jp.dia2.offsets
    for nm, ln, rn in jdm.interfaces:
        assert tdm.interface(nm) == jdm.interface(nm)
    assert tdm.interior_faces == jdm.interior_faces
    # the AMG hierarchy: structured or greedy, level by level
    tl = TAMG().setup_structure(*tdm.host_cf(), "cpu")
    jl = JAMG().setup_structure(*jdm.host_cf())
    assert [(type(a).__name__, a.nC) for a in tl] == [
        (type(b).__name__, b.nC) for b in jl]
