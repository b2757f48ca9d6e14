"""The mesh I/O (``fvm_tpu_torch.io``) against fvm_tpu's (CPU).

* the Fluent reader: cases written by ``scripts/fluent_case.py`` (ASCII,
  binary float32 and float64 sections; one and two cell zones; 2D quads,
  2D triangles, 3D hexes and a prism mesh whose face sections mix
  triangles and quadrilaterals) read by both packages: coordinates, face
  nodes, owner / neighbour, the face groups and the cell zones bit for
  bit, and equal to the written mesh's (float32 cases: its coordinates
  rounded to float32); ``read_fluent_meshes`` per zone the same;
* the writers: ``write_vtk``, ``write_tecplot``, ``write_fluent_data``,
  ``write_netcdf`` and ``write_matrix_market`` give byte-identical files
  for the same mesh and fields (a device tensor among them);
  ``read_netcdf`` reads both back to the same tables and fields;
* ``read_matrix_market``: the same products as fvm_tpu's reader of the same
  file (1e-15 of the largest entry; the port's gather-ELL sums in slot
  order), symmetric storage included;
* ``FlowModel.dumpContinuityMatrix`` on the 16^2 cavity at fvm_tpu's state
  (loaded with ``interop.load_model_state``): byte-identical files;
* ``Persistence``: a checkpoint written by fvm_tpu's restored into the
  port's thermal model, then stepped beside fvm_tpu's: 1e-12.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu.io as jio
import fvm_tpu.io.matrixmarket as jmm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
import fvm_tpu_torch.io as tio
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from scripts.fluent_case import two_zone_split, write_fluent_case  # noqa: E402

MESHES = {
    "quad": lambda g: g.quad_2d(6, 4),
    "tri": lambda g: g.tri_2d(4, 3),
    "hex": lambda g: g.hex_3d(3, 3, 2),
    "prism": lambda g: g.extrude(g.tri_2d(3, 2), 2, lz=0.5),
}


def tables(m):
    return ([m.coords, m.face_nodes.row_ptr, m.face_nodes.col, m.face_cells],
            [(g.ident, g.name, g.group_type, g.offset, g.count)
             for g in m.face_groups],
            [(z[0], z[1], z[2], z[3].tolist()) for z in m.cell_zones],
            m.n_interior_cells)


def same_tables(a, b, coords=True, zones=True):
    (xa, ga, za, na), (xb, gb, zb, nb) = tables(a), tables(b)
    for u, v in zip(xa if coords else xa[1:], xb if coords else xb[1:]):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    assert ga == gb and na == nb and (za == zb or not zones)


@pytest.mark.parametrize("fmt", ["ascii", "f32", "f64"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_fluent_reader_bit_identical(tmp_path, kind, fmt):
    mesh = MESHES[kind](tgen)
    nc = mesh.n_interior_cells
    for zones in (None, [("a", "fluid", 0, nc // 2),
                         ("b", "solid", nc // 2, nc)]):
        path = str(tmp_path / f"{kind}.cas")
        write_fluent_case(path, mesh, fmt, zones=zones)
        j, t = jio.read_fluent_mesh(path), tio.read_fluent_mesh(path)
        same_tables(t, j)
        same_tables(t, mesh, coords=fmt != "f32", zones=False)
        want = mesh.coords.astype(np.float32) if fmt == "f32" else \
            mesh.coords
        assert np.array_equal(t.coords, want)
        assert [z[1] for z in t.cell_zones] == (
            ["fluid"] if zones is None else ["a", "b"])
        if zones:
            js, ts = jio.read_fluent_meshes(path), tio.read_fluent_meshes(path)
            assert len(ts) == len(js) == 2
            for a, b in zip(ts, js):
                same_tables(a, b)
                assert (a.mesh_id, a.zone_name, a.zone_type) == (
                    b.mesh_id, b.zone_name, b.zone_type)


def test_fluent_reader_two_zone_split(tmp_path):
    """The phonon slice's route: quad_2d(20, 20) split at x = 0.5."""
    mesh = tgen.quad_2d(20, 20)
    zones = two_zone_split(mesh)
    assert zones == [("left", "solid", 0, 200), ("right", "solid", 200, 400)]
    path = str(tmp_path / "split.cas")
    write_fluent_case(path, mesh, "f64", zones=zones)
    t = tio.read_fluent_mesh(path)
    same_tables(t, jio.read_fluent_mesh(path))
    left = t.cell_zone_mask("left")
    assert left.sum() == 200 and not left[200:].any()
    assert len(t.interface_faces_between(left, ~left)) == 20


def fields(mesh, rng):
    n = mesh.n_interior_cells
    return {"T": 300.0 + rng.standard_normal(n),
            "velocity": rng.standard_normal((n, mesh.dim)),
            "phi": np.arange(n, dtype=float) / 7.0}


@pytest.mark.parametrize("kind", ["quad", "tri", "hex"])
def test_writers_byte_identical(tmp_path, kind):
    jm, tm = MESHES[kind](jgen), MESHES[kind](tgen)
    f = fields(tm, np.random.default_rng(1))
    ft = dict(f, T=torch.from_numpy(f["T"]))  # a tensor: copied to the host

    def same(name, jwrite, twrite):
        pj, pt = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
        jwrite(str(pj))
        twrite(str(pt))
        assert pj.read_bytes() == pt.read_bytes(), name

    same("vtk", lambda p: jio.write_vtk(p, jm, f),
         lambda p: tio.write_vtk(p, tm, ft))
    same("vtk_bare", lambda p: jio.write_vtk(p, jm),
         lambda p: tio.write_vtk(p, tm))
    same("plt", lambda p: jio.write_tecplot(p, jm, f),
         lambda p: tio.write_tecplot(p, tm, ft))
    same("dat", lambda p: jio.write_fluent_data(p, jm, f),
         lambda p: tio.write_fluent_data(p, tm, ft))
    same("nc", lambda p: jio.write_netcdf(p, jm, f),
         lambda p: tio.write_netcdf(p, tm, ft))
    same("nc_bare", lambda p: jio.write_netcdf(p, jm),
         lambda p: tio.write_netcdf(p, tm))
    mj, fj = jio.read_netcdf(str(tmp_path / "j_nc"))
    mt, ft2 = tio.read_netcdf(str(tmp_path / "t_nc"))
    same_tables(mt, mj)
    same_tables(mt, tm, zones=False)
    assert list(ft2) == list(f)
    for k in f:
        assert np.array_equal(ft2[k], fj[k]) and np.array_equal(ft2[k], f[k])


@pytest.fixture(scope="module")
def cavity():
    """fvm_tpu's 16^2 lid-driven cavity after 5 SIMPLE outers, and the
    port's with that state."""
    def make(Flow, dm):
        f = Flow(dm)
        f.options["verbose"] = False
        f.vc["viscosity"] = 0.01
        for side in ("left", "right", "bottom", "top"):
            f.bc[side].bc_type = "NoSlipWall"
        f.bc["top"]["specifiedXVelocity"] = 1.0
        f.init()
        return f

    jf = make(JFlow, jfvm.mesh.build_device_mesh(jgen.quad_2d(16, 16),
                                                 dtype=jnp.float64))
    tf = make(TFlow, build_device_mesh(tgen.quad_2d(16, 16), dtype="float64",
                                       device="cpu"))
    jf.advance(5)
    load_model_state(tf, {k: np.asarray(v) for k, v in jf.state.items()})
    return jf, tf


def test_continuity_matrix_and_matrix_market(tmp_path, cavity):
    jf, tf = cavity
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jf.dumpContinuityMatrix(pj)
    tf.dumpContinuityMatrix(pt)
    for suffix in (".mtx", "_rhs.mtx"):
        assert Path(pj + suffix).read_bytes() == Path(pt + suffix).read_bytes()
    Aj, bj = jmm.read_matrix_market(pj + ".mtx", pj + "_rhs.mtx")
    At, bt = tio.read_matrix_market(pt + ".mtx", pt + "_rhs.mtx",
                                    device="cpu")
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    for a, b in ((At.diag, Aj.diag), (At.off, Aj.off), (At.cols, Aj.cols),
                 (At.mask, Aj.mask)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(2).standard_normal(At.n)
    close(At.mv(torch.from_numpy(x)).numpy(), np.asarray(Aj.mv(jnp.asarray(x))),
          1e-15)
    # written back by both packages' writers: the same file again
    tio.write_matrix_market(pt + "2.mtx", At, bt)
    jmm.write_matrix_market(pj + "2.mtx", Aj, bj)
    for suffix in ("2.mtx", "2_rhs.mtx"):
        assert Path(pj + suffix).read_bytes() == \
            Path(pt + suffix).read_bytes() == \
            Path(pt + suffix.replace("2", "")).read_bytes()


def test_matrix_market_symmetric_storage(tmp_path):
    path = tmp_path / "sym.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "% a comment\n4 4 6\n1 1 4.0\n2 1 -1.0\n2 2 4.0\n"
                    "3 2 -1.5\n3 3 4.0\n4 4 2.0\n")
    Aj, _ = jmm.read_matrix_market(str(path))
    At, b = tio.read_matrix_market(str(path), device="cpu")
    assert b is None
    for a, c in ((At.diag, Aj.diag), (At.off, Aj.off), (At.cols, Aj.cols),
                 (At.mask, Aj.mask)):
        assert np.array_equal(a.numpy(), np.asarray(c))
    x = np.arange(1.0, 5.0)
    assert np.array_equal(At.mv(torch.from_numpy(x)).numpy(),
                          [4.0 - 2.0, -1.0 + 8.0 - 4.5, -3.0 + 12.0, 8.0])


def _thermal(T, dm):
    t = T(dm)
    t.options["verbose"] = False
    t.options["transient"] = True
    t.options["timeStep"] = 0.1
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    return t


def test_persistence_from_fvm_tpu(tmp_path):
    jt = _thermal(JThermal, jfvm.mesh.build_device_mesh(
        jgen.quad_2d(8, 8), dtype=jnp.float64))
    tt_ = _thermal(TThermal, build_device_mesh(
        tgen.quad_2d(8, 8), dtype="float64", device="cpu"))
    jt.advance(3)
    jt.updateTime()
    path = str(tmp_path / "ckpt.npz")
    p = jio.Persistence(path, mode="w")
    p.save_model("thermal", jt)
    p.save_mesh(jgen.quad_2d(8, 8))
    p.save_array("marker", np.arange(3.0))
    p.close()
    r = tio.Persistence(path)
    assert sorted(r.keys()) == sorted(jio.Persistence(path).keys())
    assert np.array_equal(r.load_array("marker"), np.arange(3.0))
    r.restore_model("thermal", tt_)
    for k, v in jt.state.items():
        assert np.array_equal(tt_.state[k].numpy(), np.asarray(v))
    hj, ht = jt.advance(3), tt_.advance(3)
    for k, v in jt.state.items():
        close(tt_.state[k].numpy(), np.asarray(v), 1e-12)
    close([r_[1] for r_ in ht], [r_[1] for r_ in hj], 1e-12)
    # and back: the port's checkpoint restores into fvm_tpu's model
    w = tio.Persistence(str(tmp_path / "back.npz"), mode="w")
    w.save_model("thermal", tt_)
    w.close()
    jio.Persistence(str(tmp_path / "back.npz")).restore_model("thermal", jt)
    for k, v in tt_.state.items():
        assert np.array_equal(np.asarray(jt.state[k]), v.numpy())
