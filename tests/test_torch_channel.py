"""The heated channel (``bench.py:729-813``) against fvm_tpu (float64, CPU).

* The thermal ``ZeroGradient`` outflow: the analytic check of
  ``tests/test_thermal.py:243`` (uniform axial flow with a source heats the
  stream linearly; the exact discrete upwind solution, rtol 1e-7) through
  both packages, and the two fields to the same 1e-7 (each outer's
  BiCGStab-AMG solve stops at 1e-10 of its residual, and on this
  convection-dominated system the two packages' fields differ by 8.3e-9).
* The channel at ``quad_2d(48, 16)`` with bench's settings (the slab of
  cells below y = 0.25 held by the immersed boundary, ``ZeroGradient``
  outflow): ``cases.heated_channel`` against the JAX package's models
  built as ``bench.py`` builds them.  60 flow outers, the mass-flux
  handoff and 8 thermal outers, histories to 1e-8.  At these settings
  the JAX package's own histories move by 9.9e-13 (flow) and 9.5e-10
  (thermal) under a 1e-15 change of the viscosity
  (``scripts/roundoff_sensitivity.py --cases channel``, CPU).
* ``cases.channel_to_tol`` at that size: bench's time-to-tolerance run
  (chunked flow to 5e-4, handoff, chunked thermal to 1e-5) converges, and
  its flow history equals the eager loop's.
* The homoCase stand-in (``cases.homocase_standin``, hex_3d for the absent
  homoCase-10000.cas) at 8^3: its history against the JAX package's
  ThermalModel with bench's settings to 1e-8 (the JAX package's own moves
  by 1.2e-11 under a 1e-15 change of the zmax temperature:
  ``scripts/roundoff_sensitivity.py --cases homocase``), and
  ``cases.homocase_run``
  (one chunk with zero tolerances) reaching the linear profile.
* The suite's entry points raise ``DeviceError`` without a GPU unless
  the caller passes ``device="cpu"``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.mesh.metrics import compute_geometry as jgeometry
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch import cases
from fvm_tpu_torch.exceptions import DeviceError
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import ThermalModel as TThermal
from test_torch_newton import one_thread  # noqa: F401

NX, NY = 48, 16
FLOW_OUTERS, THERMAL_OUTERS = 60, 8
HIST_RTOL = 1e-8


def _close(a, b, rtol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


def test_zero_gradient_outflow_matches_the_discrete_solution():
    nx, ny, lx = 24, 4, 3.0
    dx = lx / nx
    u, S, Tin = 2.0, 8.0, 300.0
    jdm = jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(nx, ny, lx=lx, ly=1.0), dtype=jnp.float64)
    tdm = build_device_mesh(quad_2d(nx, ny, lx=lx, ly=1.0), dtype="float64",
                            device="cpu")
    temps = []
    for t in (JThermal(jdm), TThermal(tdm)):
        t.options["verbose"] = False
        t.options["convective"] = True
        t.vc["thermalConductivity"] = 1e-12  # convection-dominated
        t.vc["heatSource"] = S
        t.bc["left"].bc_type = "SpecifiedTemperature"
        t.bc["left"]["specifiedTemperature"] = Tin
        t.bc["right"].bc_type = "ZeroGradient"
        t.bc["top"].bc_type = "Symmetry"
        t.bc["bottom"].bc_type = "Symmetry"
        t.init()
        fa = np.asarray(t.mesh.face_area)
        mdot = u * fa[:, 0]
        t.state["massFlux"] = (jnp.asarray(mdot) if isinstance(t, JThermal)
                               else torch.from_numpy(mdot))
        t.advance(4)
        temps.append(np.asarray(t.getTemperature()))
    xc = tdm.cell_centroid[: tdm.n_interior_cells, 0].numpy()
    exact = Tin + S * dx * (np.round(xc / dx - 0.5) + 1) / u
    np.testing.assert_allclose(temps[1], exact, rtol=1e-7)
    np.testing.assert_allclose(temps[1], temps[0], rtol=1e-7)


def _jax_channel():
    """The JAX package's heated channel, built as ``bench.py:729-784``
    builds it, at NX x NY in float64."""
    mesh = jfvm.mesh.generate.quad_2d(NX, NY, lx=3.0, ly=1.0)
    yc = jgeometry(mesh).cell_centroid[: mesh.n_interior_cells, 1]
    solid = yc < 0.25
    dm = jfvm.mesh.build_device_mesh(mesh, dtype=jnp.float64)
    flow = JFlow(dm)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    flow.options["pressureLinearSolver"] = JAMG(
        coarse_size=128, relative_tolerance=1e-3, max_iterations=6)
    flow.options["momentumLinearSolver"] = JBiCGStab(
        relative_tolerance=1e-2, max_iterations=10)
    flow.bc["left"].bc_type = "VelocityBoundary"
    flow.bc["left"]["specifiedXVelocity"] = np.where(yc[:NY] >= 0.25, 1.0,
                                                     0.0)
    flow.bc["right"].bc_type = "PressureBoundary"
    flow.bc["top"].bc_type = "NoSlipWall"
    flow.bc["bottom"].bc_type = "NoSlipWall"
    flow.init()
    flow.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    thermal = JThermal(dm)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = JAMG(
        coarse_size=128, relative_tolerance=1e-3, max_iterations=6)
    thermal.vc["thermalConductivity"] = np.where(solid, 20.0, 1.0)
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "SpecifiedTemperature"
    thermal.bc["bottom"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "ZeroGradient"
    thermal.bc["top"].bc_type = "Symmetry"
    thermal.init()
    return flow, thermal


def test_channel_histories_match_fvm_tpu():
    jf, jt = _jax_channel()
    tf, tt = cases.heated_channel(device="cpu", dtype="float64", nx=NX,
                                  ny=NY)
    for k in ("ib_mask", "ib_value", "ib_solid_mask", "ib_solid_face",
              "ib_face_sign"):
        assert np.array_equal(tf.params[k].numpy(), np.asarray(jf.params[k]))
    np.testing.assert_array_equal(tt.params["k_cell"].numpy(),
                                  np.asarray(jt.params["k_cell"]))
    hj, ht = jf.advance(FLOW_OUTERS), tf.advance(FLOW_OUTERS)
    _close([h[1:] for h in ht], [h[1:] for h in hj], HIST_RTOL)
    _close(tf.getVelocity(), jf.getVelocity(), 1e-10)
    # the handoff, then the advected thermal field
    jt.state["massFlux"] = jf.state["massFlux"]
    tt.state["massFlux"] = tf.state["massFlux"]
    _close(tt.state["massFlux"].numpy(), np.asarray(jt.state["massFlux"]),
           1e-10)
    hj, ht = jt.advance(THERMAL_OUTERS), tt.advance(THERMAL_OUTERS)
    _close([h[1] for h in ht], [h[1] for h in hj], HIST_RTOL)
    _close(tt.getTemperature(), jt.getTemperature(), 1e-10)
    _close(tt.getHeatFluxIntegral("bottom"), jt.getHeatFluxIntegral("bottom"),
           1e-10)
    _close(tf.getIBForceIntegral(), jf.getIBForceIntegral(), 1e-10)


def test_channel_to_tolerance_converges():
    flow, thermal = cases.heated_channel(device="cpu", dtype="float64",
                                         nx=NX, ny=NY)
    r = cases.channel_to_tol(flow, thermal)
    hf, ht = r.pop("histories")
    assert r["metric"] == "heated_channel_time_to_tol" and r["converged"]
    assert r["mom_rel"] < 5e-4 and r["thermal_rel"] < 1e-5
    assert r["outer_steps"] == len(hf) + len(ht) < 6000
    # the chunked flow run equals the eager loop from the same state
    eager, _ = cases.heated_channel(device="cpu", dtype="float64", nx=NX,
                                    ny=NY)
    he = eager.advance(len(hf))
    _close([h[1:] for h in hf], [h[1:] for h in he], 1e-12)
    # mass is conserved through the channel: what enters leaves
    inflow = -flow.getMassFluxIntegral("left")
    assert abs(flow.getMassFluxIntegral("right") - inflow) < 1e-3 * inflow


def test_homocase_standin_matches_fvm_tpu():
    n = 8
    jt = JThermal(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.hex_3d(n, n, n), dtype=jnp.float64))
    jt.options["verbose"] = False
    jt.options["linearSolver"] = JAMG(coarse_size=64,
                                      relative_tolerance=1e-3,
                                      max_iterations=20)
    jt.bc["zmax"].bc_type = "SpecifiedTemperature"
    jt.bc["zmax"]["specifiedTemperature"] = 400.0
    jt.bc["zmin"].bc_type = "SpecifiedTemperature"
    jt.bc["zmin"]["specifiedTemperature"] = 300.0
    for g in ("xmin", "xmax", "ymin", "ymax"):
        jt.bc[g].bc_type = "Symmetry"
    jt.init()
    tt = cases.homocase_standin(n, device="cpu", dtype="float64")
    hj, ht = jt.advance(3), tt.advance(3)
    _close([h[1] for h in ht], [h[1] for h in hj], HIST_RTOL)
    r = cases.homocase_run(tt, iters=4)
    assert r["converged"] and r["metric"] == "homocase_thermal_cells_per_sec"
    z = tt.mesh.cell_centroid[: n ** 3, 2].numpy()
    np.testing.assert_allclose(tt.getTemperature(), 300.0 + 100.0 * z,
                               rtol=1e-10)


@pytest.mark.parametrize("entry", [
    lambda: cases.heated_channel(nx=8, ny=4),
    lambda: cases.homocase_standin(4),
    lambda: cases.electrostatics_standin(mesh=quad_2d(4, 4)),
])
def test_suite_entry_points_need_a_gpu_or_the_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        entry()
