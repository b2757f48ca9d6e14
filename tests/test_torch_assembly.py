"""Assembled systems of the port against fvm_tpu, entry by entry.

A 32^2 lid-driven cavity (float64) is advanced two outer steps by the JAX
package; the port takes that state through ``fvm_tpu_torch.interop``, and
both packages then run one more flow step and one convective thermal step
with solvers that record every system they are handed.  The momentum,
continuity and thermal systems (diag, off, r) and their boundary-condensed
forms (A2, b2 and the DIA coefficients) must agree to 1e-13 relative.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import AMG as TAMG, BiCGStab as TBiCGStab
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

N = 32
RTOL = 1e-13


def _recording(solver):
    """Make ``solver`` record each (A, b) it is asked to solve."""
    solver.systems = []
    inner = solver.solve_fn

    def solve_fn(A, b, x0):
        solver.systems.append((A, b))
        return inner(A, b, x0)

    solver.solve_fn = solve_fn
    return solver


def _setup(dmesh, Flow, Thermal, AMG, BiCGStab):
    flow = Flow(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc["top"]["specifiedXVelocity"] = 1.0
    flow.options["momentumLinearSolver"] = _recording(
        BiCGStab(relative_tolerance=1e-2, max_iterations=10))
    flow.options["pressureLinearSolver"] = _recording(
        AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
    thermal = Thermal(dmesh)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = _recording(
        AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "SpecifiedHeatFlux"
    thermal.bc["right"]["specifiedHeatFlux"] = -50.0
    thermal.bc["bottom"].bc_type = "Symmetry"
    thermal.bc["top"].bc_type = "Convective"
    thermal.bc["top"]["heatTransferCoefficient"] = 10.0
    thermal.bc["top"]["farFieldTemperature"] = 350.0
    return flow, thermal


@pytest.fixture(scope="module")
def systems():
    jd = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(N, N),
                                     dtype=jnp.float64)
    td = tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(N, N),
                                     dtype="float64", device="cpu")
    jf, jt = _setup(jd, JFlow, JThermal, JAMG, JBiCGStab)
    tf, tt = _setup(td, TFlow, TThermal, TAMG, TBiCGStab)
    for m in (jf, jt, tf, tt):
        m.init()
    # a state with flow in it: two coupled JAX steps
    for _ in range(2):
        jf.advance(1)
        jt.state["massFlux"] = jf.state["massFlux"]
        jt.advance(1)
    for jm, tm in ((jf, tf), (jt, tt)):
        load_model_state(
            tm, {k: np.asarray(v) for k, v in jm.state.items()},
            {k: np.asarray(v) for k, v in jm.params.items()})
    out = {}
    for name, jm, tm, key in (("flow", jf, tf, None),
                              ("thermal", jt, tt, "linearSolver")):
        for m in (jm, tm):
            for k in ("momentumLinearSolver", "pressureLinearSolver",
                      "linearSolver"):
                if k in m.options:
                    m.options[k].systems.clear()
        # one eager step each (the JAX package's un-jitted step)
        jm._step_raw(jm.mesh, jm.params, jm.state, jm._resolve_bcvals())
        tm._step(tm.mesh, tm.params, tm.state, tm._resolve_bcvals())
        if name == "flow":
            out["momentum"] = (jm.options["momentumLinearSolver"].systems[0],
                               tm.options["momentumLinearSolver"].systems[0])
            out["continuity"] = (
                jm.options["pressureLinearSolver"].systems[0],
                tm.options["pressureLinearSolver"].systems[0])
        else:
            out["thermal"] = (jm.options[key].systems[0],
                              tm.options[key].systems[0])
    return out


def _close(t, j):
    j = np.asarray(j)
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("which", ["momentum", "continuity", "thermal"])
def test_assembled_system_matches(systems, which):
    (jA, jb), (tA, tb) = systems[which]
    _close(tA.diag, jA.diag)
    _close(torch.where(tA.mask, tA.off, 0.0), jnp.where(jA.mask, jA.off, 0.0))
    _close(tA.cols, jA.cols)
    _close(tA.mask, jA.mask)
    _close(tb, jb)
    if which == "momentum":
        assert tuple(tb.shape) == (tA.n, 2)


@pytest.mark.parametrize("which", ["momentum", "continuity", "thermal"])
def test_condensed_system_matches(systems, which):
    (jA, jb), (tA, tb) = systems[which]
    jA2, jb2, jrec = jA.condense(jb)
    tA2, tb2, trec = tA.condense(tb)
    _close(tA2.diag, jA2.diag)
    _close(tA2.off, jA2.off)
    _close(tb2, jb2)
    assert tA2.dia.offsets == jA2.dia.offsets
    _close(tA2.dia_coef, jA2.dia_coef)
    assert tA2.dia_fb_vals.shape[0] == jA2.dia_fb_vals.shape[0] == 0
    # the back-substitution of the eliminated rows, on the same x2
    rng = np.random.default_rng(0)
    x2 = rng.normal(size=tuple(tb.shape))
    _close(trec(torch.from_numpy(x2)), jrec(jnp.asarray(x2)))


@pytest.mark.parametrize("which", ["momentum", "thermal"])
def test_dirichlet_cells_matches(systems, which):
    """Pinned cells (the immersed-body rows) on the recorded systems."""
    from fvm_tpu.ops.assembly import dirichlet_cells as j_pin
    from fvm_tpu_torch.ops.assembly import dirichlet_cells as t_pin

    (jA, jb), (tA, tb) = systems[which]
    rng = np.random.default_rng(5)
    mask = rng.random(tA.n) < 0.1
    phi = rng.normal(size=tuple(tb.shape))
    value = rng.normal(size=tuple(tb.shape))
    jA2, jr2 = j_pin(jA, jb, jnp.asarray(mask), jnp.asarray(value),
                     jnp.asarray(phi))
    tA2, tr2 = t_pin(tA, tb, torch.from_numpy(mask), torch.from_numpy(value),
                     torch.from_numpy(phi))
    _close(tA2.diag, jA2.diag)
    _close(tA2.off, jA2.off)
    _close(tr2, jr2)
