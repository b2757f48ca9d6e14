"""The port's models on the general meshes against fvm_tpu (float64).

* The coupled 3D cavity (``cases.coupled_cavity_3d``: three velocity
  components, greedy AMG, gather-ELL coarse levels) at 8^3 for 5 outer
  steps: momentum, continuity and thermal histories to 1e-8 relative and
  the fields to 1e-10, against the JAX package's models run the same way.
* Thermal on ``hex_3d(6, 6, 6)``: the linear profile at rtol 1e-7 (as in
  ``tests/test_thermal.py:160-172``) and the history against fvm_tpu.
* Thermal and flow on ``tri_2d``: the non-orthogonal correction
  (``face_t`` non-zero) and the LS gradients on triangles, histories
  against fvm_tpu.
* The 2D cavity keeps its structured hierarchy (the greedy path is taken
  only where ``detect_grid`` fails).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.cases import coupled_cavity, coupled_cavity_3d, coupled_step
from fvm_tpu_torch.linear.amg import _Level, _StructuredLevel
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

HIST_RTOL = 1e-8
FIELD_RTOL = 1e-10
WALLS_3D = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")


def _close(t, j, rtol):
    t, j = t.cpu().numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def _jax_cavity_3d(n):
    """The JAX package's models in the configuration of
    ``coupled_cavity_3d``."""
    dmesh = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.hex_3d(n, n, n),
                                        dtype=jnp.float64)
    flow = JFlow(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for w in WALLS_3D:
        flow.bc[w].bc_type = "NoSlipWall"
    flow.bc["zmax"]["specifiedXVelocity"] = 1.0
    flow.options["pressureLinearSolver"] = JAMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    flow.options["momentumLinearSolver"] = JBiCGStab(
        relative_tolerance=1e-2, max_iterations=10)
    flow.init()
    thermal = JThermal(dmesh)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = JAMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    for w in WALLS_3D:
        thermal.bc[w].bc_type = "Symmetry"
    thermal.bc["xmin"].bc_type = "SpecifiedTemperature"
    thermal.bc["xmin"]["specifiedTemperature"] = 400.0
    thermal.bc["xmax"].bc_type = "SpecifiedTemperature"
    thermal.bc["xmax"]["specifiedTemperature"] = 300.0
    thermal.init()
    return flow, thermal


def test_coupled_cavity_3d_matches_jax():
    n, steps = 8, 5
    jf, jt = _jax_cavity_3d(n)
    tf, tt = coupled_cavity_3d(n, device="cpu", dtype="float64")
    assert tf.state["velocity"].shape == (tf.mesh.n_cells, 3)
    levels = tf.options["pressureLinearSolver"].setup_structure(
        *tf.mesh.host_cf(), "cpu")
    assert levels and all(isinstance(lev, _Level) for lev in levels)
    j_hist, t_hist = [], []
    for _ in range(steps):
        hf = jf.advance(1)
        jt.state["massFlux"] = jf.state["massFlux"]
        ht = jt.advance(1)
        j_hist.append([float(hf[-1][1]), float(hf[-1][2]), float(ht[-1][1])])
        t_hist.append([float(v) for v in coupled_step(tf, tt)])
    np.testing.assert_allclose(t_hist, j_hist, rtol=HIST_RTOL)
    for k in ("velocity", "pressure", "massFlux"):
        _close(tf.state[k], jf.state[k], FIELD_RTOL)
    _close(tt.state["T"], jt.state["T"], FIELD_RTOL)
    # the lid drives the flow: +x velocity under the lid, -x below
    V = tf.getVelocity()
    z = tf.mesh.cell_centroid[: tf.mesh.n_interior_cells, 2].numpy()
    assert V[z > 0.9, 0].mean() > 0 > V[z < 0.5, 0].mean()


def _thermal(mesh_j, mesh_t, walls, hot, cold, th, tc):
    models = (JThermal(jfvm.mesh.build_device_mesh(mesh_j,
                                                   dtype=jnp.float64)),
              TThermal(tfvm.mesh.build_device_mesh(mesh_t, dtype="float64",
                                                   device="cpu")))
    for m in models:
        m.options["verbose"] = False
        for w in walls:
            m.bc[w].bc_type = "Symmetry"
        m.bc[hot].bc_type = "SpecifiedTemperature"
        m.bc[hot]["specifiedTemperature"] = th
        m.bc[cold].bc_type = "SpecifiedTemperature"
        m.bc[cold]["specifiedTemperature"] = tc
        m.init()
    return models


def _hist(m, outers):
    return np.array([[float(h[1])] for h in m.advance(outers)])


def test_thermal_hex_linear_profile_and_history():
    jm, tm = _thermal(jfvm.mesh.generate.hex_3d(6, 6, 6),
                      tfvm.mesh.generate.hex_3d(6, 6, 6), WALLS_3D,
                      "xmin", "xmax", 350.0, 250.0)
    th, jh = _hist(tm, 5), _hist(jm, 5)
    assert th.shape == jh.shape
    # past the first outer the residual sits at round-off: compare it to
    # 1e-8 of the first
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL,
                               atol=HIST_RTOL * float(jh[0, 0]))
    T = tm.getTemperature()
    x = tm.mesh.cell_centroid[: tm.mesh.n_interior_cells, 0].numpy()
    np.testing.assert_allclose(T, 350.0 - 100.0 * x, rtol=1e-7)
    _close(tm.state["T"], jm.state["T"], FIELD_RTOL)


def test_thermal_tri_nonorthogonal_history():
    jm, tm = _thermal(jfvm.mesh.generate.tri_2d(16, 16),
                      tfvm.mesh.generate.tri_2d(16, 16),
                      ("left", "right", "bottom", "top"), "left", "right",
                      1.0, 0.0)
    assert not tm.mesh.orthogonal and "grad_coeff" in tm.params
    th, jh = _hist(tm, 30), _hist(jm, 30)
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL,
                               atol=HIST_RTOL * float(jh[0, 0]))
    _close(tm.state["T"], jm.state["T"], FIELD_RTOL)
    x = tm.mesh.cell_centroid[: tm.mesh.n_interior_cells, 0].numpy()
    np.testing.assert_allclose(tm.getTemperature(), 1.0 - x, atol=5e-3)


def test_flow_tri_channel_history():
    """Pressure-driven channel on triangles (as
    ``tests/test_flow.py:238-262``): the non-orthogonal momentum and
    pressure paths, default solvers, 6 outers."""
    models = []
    for pkg, Flow, kw in ((jfvm, JFlow, {"dtype": jnp.float64}),
                          (tfvm, TFlow, {"dtype": "float64",
                                         "device": "cpu"})):
        m = Flow(pkg.mesh.build_device_mesh(
            pkg.mesh.generate.tri_2d(12, 6, lx=2.0, ly=1.0), **kw))
        m.options["verbose"] = False
        m.vc["viscosity"] = 0.1
        m.bc["left"].bc_type = "PressureBoundary"
        m.bc["left"]["specifiedPressure"] = 1.0
        m.bc["right"].bc_type = "PressureBoundary"
        m.bc["bottom"].bc_type = "NoSlipWall"
        m.bc["top"].bc_type = "NoSlipWall"
        m.init()
        models.append(m)
    jm, tm = models
    th = [[float(v) for v in h[1:]] for h in tm.advance(6)]
    jh = [[float(v) for v in h[1:]] for h in jm.advance(6)]
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL)
    for k in ("velocity", "pressure", "massFlux"):
        _close(tm.state[k], jm.state[k], FIELD_RTOL)


@pytest.mark.parametrize("make,n,kind", [
    (coupled_cavity, 32, _StructuredLevel),
    (coupled_cavity_3d, 12, _Level)], ids=["2d", "3d"])
def test_cavity_hierarchy_kind(make, n, kind):
    """The 2D cavity keeps its structured (index-pairing) levels; the 3D
    cavity's row graph is no tensor-product grid and takes greedy ones."""
    flow, thermal = make(n, device="cpu", dtype="float64")
    for amg in (flow.options["pressureLinearSolver"],
                thermal.options["linearSolver"]):
        levels = amg.setup_structure(*flow.mesh.host_cf(), "cpu")
        assert levels and all(isinstance(lev, kind) for lev in levels)
