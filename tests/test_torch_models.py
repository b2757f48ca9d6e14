"""The port's main path as a whole: models, goldens, coupling, device rules.

* The port reproduces the JAX package's pinned float64 residual histories
  ``cavity/AMG/np1`` (30 SIMPLE outers) and ``thermal/AMG/np1`` from
  ``tests/goldens/histories.json`` at 1e-8, in the exact configurations of
  ``tests/test_golden_histories.py:86-143`` (read as JSON: that module is
  slow-marked).
* The coupled flow+thermal step of ``bench.py:main()`` at 16^2: both
  packages start from the JAX package's state (carried over through
  ``fvm_tpu_torch.interop``) and run 3 coupled outers; fields agree to
  1e-10 and histories to 1e-8.
* With no GPU and no ``device="cpu"`` the port raises instead of running
  on the CPU; ``fvm_tpu_torch`` imports no jax, flax or fvm_tpu module.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.cases import coupled_cavity, coupled_step
from fvm_tpu_torch.exceptions import DeviceError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import AMG as TAMG
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "histories.json")
HIST_RTOL = 1e-8  # BASELINE.md parity tolerance, test_golden_histories RTOL
FIELD_RTOL = 1e-10


def _goldens():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def _cpu_mesh(n):
    return tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(n, n),
                                       dtype="float64", device="cpu")


def test_cavity_amg_golden_history():
    m = TFlow(_cpu_mesh(32))
    m.options["verbose"] = False
    m.vc["density"] = 1.0
    m.vc["viscosity"] = 0.1
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.options["pressureLinearSolver"] = TAMG(
        coarse_size=16, relative_tolerance=1e-3, max_iterations=30)
    m.init()
    hist = [[h[1], h[2]] for h in m.advance(30)]
    ref = _goldens()["cavity/AMG/np1"]
    assert len(hist) == len(ref) == 30
    np.testing.assert_allclose(hist, ref, rtol=HIST_RTOL, atol=1e-12)


def test_thermal_amg_golden_history():
    t = TThermal(_cpu_mesh(32))
    t.options["verbose"] = False
    s = TAMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=30)
    s.relativeTolerance = 5e-2
    s.nMaxIterations = min(s.nMaxIterations, 8)
    t.options["linearSolver"] = s
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    hist = [[h[1]] for h in t.advance(10)]
    ref = _goldens()["thermal/AMG/np1"]
    assert len(hist) == len(ref)
    np.testing.assert_allclose(hist, ref, rtol=HIST_RTOL, atol=1e-12)


def _jax_coupled_cavity(n):
    """The JAX package's models in the bench.py:main() configuration."""
    dmesh = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(n, n),
                                        dtype=jnp.float64)
    flow = JFlow(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc["top"]["specifiedXVelocity"] = 1.0
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
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "SpecifiedTemperature"
    thermal.bc["right"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "Symmetry"
    thermal.bc["top"].bc_type = "Symmetry"
    thermal.init()
    return flow, thermal


def _jax_coupled_step(flow, thermal):
    hf = flow.advance(1)
    thermal.state["massFlux"] = flow.state["massFlux"]
    ht = thermal.advance(1)
    return [hf[-1][1], hf[-1][2], ht[-1][1]]


def _close(t, j, rtol):
    t, j = t.cpu().numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def test_coupled_step_from_jax_state_matches():
    n = 16
    jf, jt = _jax_coupled_cavity(n)
    for _ in range(2):
        _jax_coupled_step(jf, jt)
    tf, tt = coupled_cavity(n, device="cpu", dtype="float64")
    for jm, tm in ((jf, tf), (jt, tt)):
        load_model_state(
            tm, {k: np.asarray(v) for k, v in jm.state.items()},
            {k: np.asarray(v) for k, v in jm.params.items()})
    assert sorted(tf.state) == ["massFlux", "momAp", "pressure", "velocity"]
    assert tt.state["T"].dtype == torch.float64
    j_hist, t_hist = [], []
    for _ in range(3):
        j_hist.append([float(v) for v in _jax_coupled_step(jf, jt)])
        t_hist.append([float(v) for v in coupled_step(tf, tt)])
    np.testing.assert_allclose(t_hist, j_hist, rtol=HIST_RTOL)
    _close(tf.state["velocity"], jf.state["velocity"], FIELD_RTOL)
    _close(tf.state["pressure"], jf.state["pressure"], FIELD_RTOL)
    _close(tf.state["massFlux"], jf.state["massFlux"], FIELD_RTOL)
    _close(tt.state["T"], jt.state["T"], FIELD_RTOL)
    np.testing.assert_allclose(tf.getVelocity(), np.asarray(jf.getVelocity()),
                               rtol=FIELD_RTOL, atol=FIELD_RTOL)


def _configure_flow(m, variant):
    m.options["verbose"] = False
    m.vc["viscosity"] = 0.01
    if variant == "channel":
        m.bc["left"].bc_type = "VelocityBoundary"
        m.bc["left"]["specifiedXVelocity"] = 1.0
        m.bc["right"].bc_type = "PressureBoundary"
        m.bc["top"].bc_type = "Symmetry"
        m.bc["bottom"].bc_type = "NoSlipWall"
    else:
        for side in ("left", "right", "bottom", "top"):
            m.bc[side].bc_type = "NoSlipWall"
        m.bc["top"]["specifiedXVelocity"] = 1.0
    if variant == "simplec-piso":
        m.options["algorithm"] = "SIMPLEC"
        m.options["pressureURF"] = 0.8
        m.options["nPressureCorrectors"] = 2
    elif variant == "green-gauss":
        m.options["nonOrthogonalCorrection"] = False
    elif variant == "transient":
        m.options["transient"] = True
        m.options["timeStep"] = 0.05
        m.options["timeDiscretizationOrder"] = 2


def _run(m, steps, outers):
    """``steps`` time steps of ``outers`` outer iterations (one step and no
    time shift when steady); the residual history."""
    transient = m.options["transient"]
    hist = []
    for _ in range(steps):
        hist += [[float(v) for v in h[1:]] for h in m.advance(outers)]
        if transient:
            m.updateTime()
    return hist


@pytest.mark.parametrize(
    "variant", ["simplec-piso", "channel", "green-gauss", "transient"])
def test_flow_variants_match_jax(variant):
    """SIMPLEC with two pressure correctors, velocity/pressure/symmetry
    boundaries, the Green-Gauss gradient and BDF2 time stepping, with the
    default solvers (BiCGStab; BiCGStab + AMG for the pressure)."""
    n = 16
    jm = JFlow(jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(n, n),
                                           dtype=jnp.float64))
    tm = TFlow(_cpu_mesh(n))
    for m in (jm, tm):
        _configure_flow(m, variant)
        m.init()
    steps, outers = (2, 2) if variant == "transient" else (1, 4)
    np.testing.assert_allclose(_run(tm, steps, outers),
                               _run(jm, steps, outers), rtol=HIST_RTOL)
    for k in ("velocity", "pressure", "massFlux", "momAp"):
        _close(tm.state[k], jm.state[k], FIELD_RTOL)


def test_thermal_transient_sources_and_bcs_match_jax():
    """BDF2 with a heat source, conductivity contrast and the specified
    flux / convective / symmetry / temperature boundaries, with the
    default solver (BiCGStab + AMG)."""
    n = 16
    models = (JThermal(jfvm.mesh.build_device_mesh(
                  jfvm.mesh.generate.quad_2d(n, n), dtype=jnp.float64)),
              TThermal(_cpu_mesh(n)))
    k = np.where(np.arange(n * n) < n * n // 2, 1.0, 5.0)
    for m in models:
        m.options["verbose"] = False
        m.options["transient"] = True
        m.options["timeStep"] = 0.01
        m.options["timeDiscretizationOrder"] = 2
        m.vc["heatSource"] = 100.0
        m.vc["thermalConductivity"] = k
        m.bc["left"].bc_type = "SpecifiedTemperature"
        m.bc["left"]["specifiedTemperature"] = 400.0
        m.bc["right"].bc_type = "SpecifiedHeatFlux"
        m.bc["right"]["specifiedHeatFlux"] = -50.0
        m.bc["bottom"].bc_type = "Symmetry"
        m.bc["top"].bc_type = "Convective"
        m.bc["top"]["heatTransferCoefficient"] = 10.0
        m.bc["top"]["farFieldTemperature"] = 350.0
        m.init()
    jm, tm = models
    # one outer per time step: the problem is linear and the default solver
    # converges it in one; a second outer would only read its round-off
    np.testing.assert_allclose(_run(tm, 3, 1), _run(jm, 3, 1), rtol=HIST_RTOL)
    for key in ("T", "T_N1", "T_N2"):
        _close(tm.state[key], jm.state[key], FIELD_RTOL)


def test_interop_checks_keys_and_shapes():
    tf, _ = coupled_cavity(8, device="cpu", dtype="float64")
    state = {k: v.numpy() for k, v in tf.state.items()}
    with pytest.raises(KeyError):
        load_model_state(tf, dict(state, extra=np.zeros(3)))
    with pytest.raises(ValueError):
        load_model_state(tf, dict(state, pressure=np.zeros(3)))


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = tfvm.mesh.generate.quad_2d(4, 4)
    with pytest.raises(DeviceError, match="device='cpu'"):
        tfvm.mesh.build_device_mesh(mesh)
    with pytest.raises(DeviceError):
        coupled_cavity(4)
    # asking for the CPU explicitly still works
    assert tfvm.mesh.build_device_mesh(mesh, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_and_no_fvm_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fvm_tpu_torch\n"
        "for m in pkgutil.walk_packages(fvm_tpu_torch.__path__, "
        "'fvm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fvm_tpu'))\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(len(sys.modules), bad, '_hostlib' in maps)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) > 0
    assert out[1:] == ["[]", "False"]
