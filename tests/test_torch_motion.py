"""Mesh motion and the deformation mapping against fvm_tpu (float64, CPU).

* ``MovingMeshModel``: the node displacements, the moved mesh's geometry,
  ``volChange``, ``sweptVolDot`` and ``grid_flux`` (two motions, so the
  BDF2 extrapolation) to 1e-12 of the largest entry, and the discrete
  geometric conservation law (the swept volumes against the area change)
  to 1e-11 (``tests/test_motion_contact.py:74``);
* ``StructureDeformationModel``: the node -> cell inverse-distance weights
  (tensor ops) against the JAX package's loop over nodes to 1e-14, the
  node displacements of a structure state and the deformed mesh;
* ``cases.fsi_beam`` (flow, structure, mesh motion) against the loop of
  ``demos/fsi_beam.py`` run by fvm_tpu at n 8 with 40 flow outers: the
  wall pressure, deflection and volume change to 1e-8.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.mesh.metrics import compute_geometry as jgeom
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models import MovingMeshModel as JMoving
from fvm_tpu.models import StructureDeformationModel as JDeform
from fvm_tpu.models import StructureModel as JStructure
from fvm_tpu_torch.cases import fsi_beam
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh, compute_geometry
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import MovingMeshModel as TMoving
from fvm_tpu_torch.models import StructureDeformationModel as TDeform
from fvm_tpu_torch.models import StructureModel as TStructure
from fvm_tpu_torch.models.motion import node_cell_weights
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

RTOL = 1e-12


@pytest.mark.parametrize("group,disp", [("top", [0.0, 0.1]),
                                        ("right", [0.3, 0.05])])
def test_moving_mesh_matches(group, disp):
    jm, tm = JMoving(jgen.quad_2d(8, 6)), TMoving(tgen.quad_2d(8, 6),
                                                  device="cpu")
    np.testing.assert_array_equal(tm.edges, jm.edges)
    dt = 0.25
    for step, scale in enumerate((1.0, 0.5)):
        jm.set_boundary_displacement(group, np.asarray(disp) * scale)
        tm.set_boundary_displacement(group, np.asarray(disp) * scale)
        jmesh, _ = jm.advance(120, dt=dt)
        tmesh, tdm = tm.advance(120, dt=dt)
        close(tmesh.coords, jmesh.coords, RTOL)
        close(compute_geometry(tmesh).cell_volume, jgeom(jmesh).cell_volume,
              RTOL)
        assert tm.volChange == pytest.approx(jm.volChange, rel=1e-10,
                                             abs=1e-14)
        close(tm.sweptVolDot, jm.sweptVolDot, RTOL)
        close(tm.grid_flux(2.0), jm.grid_flux(2.0), RTOL)
        assert tdm.n_interior_cells == tmesh.n_interior_cells


def test_swept_volume_gcl():
    mesh = tgen.quad_2d(8, 6)
    mm = TMoving(mesh, device="cpu")
    V0 = compute_geometry(mesh).cell_volume[: mesh.n_interior_cells].copy()
    mm.set_boundary_displacement("right", [0.3, 0.0])
    new_mesh, _ = mm.advance(200, dt=0.25)
    V1 = compute_geometry(new_mesh).cell_volume[: mesh.n_interior_cells]
    fc = mesh.face_cells
    dVdt = np.zeros(mesh.n_cells)
    np.add.at(dVdt, fc[:, 0], mm.sweptVolDot)
    np.add.at(dVdt, fc[:, 1], -mm.sweptVolDot)
    np.testing.assert_allclose(dVdt[: mesh.n_interior_cells],
                               (V1 - V0) / 0.25, atol=1e-11)


def test_node_weights_match_the_loop():
    """The tensor-op weights against fvm_tpu's per-node lists, entry by
    entry, on a tri mesh (uneven node valences) and a quad mesh."""
    for jmesh, tmesh in ((jgen.quad_2d(10, 4), tgen.quad_2d(10, 4)),
                         (jgen.tri_2d(6, 5), tgen.tri_2d(6, 5))):
        # fvm_tpu's loop (StructureDeformationModel.__init__) reads no
        # model
        jd = JDeform(jmesh, None)
        node, cell, w = node_cell_weights(tmesh, "cpu")
        node, cell, w = node.numpy(), cell.numpy(), w.numpy()
        for nd in range(jmesh.n_nodes):
            sel = node == nd
            if jd._weights[nd].tolist() == [0.0]:
                assert not sel.any()
                continue
            np.testing.assert_array_equal(cell[sel], jd._rows[nd])
            np.testing.assert_allclose(w[sel], jd._weights[nd], rtol=1e-14,
                                       atol=0)


def test_deformation_mapping_matches():
    jmesh, tmesh = jgen.quad_2d(10, 4), tgen.quad_2d(10, 4)
    jdm = jfvm.mesh.build_device_mesh(jmesh, dtype=jnp.float64)
    tdm = build_device_mesh(tmesh, dtype="float64", device="cpu")
    js, ts = JStructure(jdm), TStructure(tdm)
    for s in (js, ts):
        s.options["verbose"] = False
        s.bc["left"].bc_type = "Symmetry"
        s.bc["right"].bc_type = "SpecifiedTraction"
        s.bc["bottom"].bc_type = "Symmetry"
        s.bc["top"].bc_type = "ZeroTraction"
        s.init()
    st = {"deformation": 1e-2 * np.random.default_rng(2).standard_normal(
        np.asarray(js.state["deformation"]).shape)}
    js.state = {"deformation": jnp.asarray(st["deformation"])}
    load_model_state(ts, st)
    jd, td = JDeform(jmesh, js), TDeform(tmesh, ts)
    close(td.getNodeDisplacement(), jd.getNodeDisplacement(), RTOL)
    (jm2, _), (tm2, tdm2) = jd.deformStructure(), td.deformStructure()
    close(tm2.coords, jm2.coords, RTOL)
    close(compute_geometry(tm2).cell_volume, jgeom(jm2).cell_volume, RTOL)
    assert tdm2.device.type == "cpu"


def demo_fsi(n, iters, outers):
    """``demos/fsi_beam.py``'s loop on fvm_tpu, the same numbers as
    ``cases.fsi_beam`` returns."""
    mesh = jgen.quad_2d(n, n // 2, lx=2.0, ly=1.0)
    wall, rows = 0.0, []
    for _ in range(iters):
        dmesh = jfvm.mesh.build_device_mesh(mesh, dtype=jnp.float64)
        flow = JFlow(dmesh)
        flow.options["verbose"] = False
        flow.vc["viscosity"] = 0.05
        flow.bc["left"].bc_type = "VelocityBoundary"
        flow.bc["left"]["specifiedXVelocity"] = 1.0
        flow.bc["right"].bc_type = "PressureBoundary"
        flow.bc["bottom"].bc_type = "NoSlipWall"
        flow.bc["top"].bc_type = "NoSlipWall"
        flow.init()
        flow.advance(outers)
        sl = dmesh.group_faces(dmesh.group_by_name("top"))
        p_f = np.asarray(flow.state["pressure"])[
            np.asarray(dmesh.face_cell0)[sl]]
        sdm = jfvm.mesh.build_device_mesh(
            jgen.quad_2d(n, 2, lx=2.0, ly=0.05, y0=1.0), dtype=jnp.float64)
        solid = JStructure(sdm)
        solid.options["verbose"] = False
        solid.vc["youngsModulus"] = 5e3
        solid.vc["poissonsRatio"] = 0.3
        solid.bc["left"].bc_type = "SpecifiedDeformation"
        solid.bc["right"].bc_type = "SpecifiedDeformation"
        solid.bc["top"].bc_type = "ZeroTraction"
        solid.bc["bottom"].bc_type = "SpecifiedTraction"
        solid.bc["bottom"]["specifiedYTraction"] = -p_f.mean()
        solid.init()
        solid.advance(6)
        wy = solid.getDeformation()[:, 1].reshape(n, 2).mean(axis=1)
        dmove = 0.5 * (float(wy.mean()) - wall)
        wall += dmove
        mm = JMoving(mesh)
        mm.set_boundary_displacement("top", [0.0, dmove])
        mesh, _ = mm.advance(150)
        rows.append({"p_mean": float(p_f.mean()), "w_mean": float(wy.mean()),
                     "wall_offset": wall, "vol_change": mm.volChange})
    return rows


def test_fsi_beam_matches_the_demo_loop():
    want = demo_fsi(8, 2, 40)
    got = fsi_beam(8, device="cpu", iters=2, flow_outers=40)
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-8, abs=1e-14), k
    assert got[-1]["vol_change"] != 0.0
