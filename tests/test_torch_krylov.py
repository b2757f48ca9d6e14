"""The port's CG and GMRES against fvm_tpu (float64, CPU).

* The systems of the first outer step of a 32^2 lid-driven cavity and of a
  two-wall thermal case go through CG and GMRES in both packages: equal
  iteration counts and solutions to 1e-10 relative.  The cases are the
  well-conditioned ones: AMG-preconditioned CG on the symmetric pressure
  and thermal systems, GMRES on the nonsymmetric multi-RHS momentum
  system (plain and Jacobi-preconditioned) and AMG-preconditioned GMRES
  on the pressure and thermal systems.
* The golden history ``cavity/CG/np1`` (30 SIMPLE outers, the pressure
  solved by Jacobi-preconditioned CG) from ``tests/goldens/histories.json``
  in the configuration of ``tests/test_golden_histories.py:63-68, 86-112``
  at 1e-8 relative (the suite's tolerance).  The weakly preconditioned
  CG keeps this history to ~3e-13 in the port, so no looser comparison
  is needed.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu.linear as jlin
import fvm_tpu_torch as tfvm
import fvm_tpu_torch.linear as tlin
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "histories.json")
N = 32
SOL_RTOL = 1e-10
HIST_RTOL = 1e-8


def _recording(solver):
    """Make ``solver`` record each (A, b) it is asked to solve."""
    solver.systems = []
    inner = solver.solve_fn

    def solve_fn(A, b, x0):
        solver.systems.append((A, b))
        return inner(A, b, x0)

    solver.solve_fn = solve_fn
    return solver


def _models(dmesh, Flow, Thermal, L):
    flow = Flow(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc["top"]["specifiedXVelocity"] = 1.0
    flow.options["momentumLinearSolver"] = _recording(
        L.BiCGStab(relative_tolerance=1e-2, max_iterations=10))
    flow.options["pressureLinearSolver"] = _recording(
        L.AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
    thermal = Thermal(dmesh)
    thermal.options["verbose"] = False
    thermal.options["linearSolver"] = _recording(
        L.AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "SpecifiedTemperature"
    thermal.bc["right"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "Symmetry"
    thermal.bc["top"].bc_type = "Symmetry"
    for m in (flow, thermal):
        m.init()
    return flow, thermal


@pytest.fixture(scope="module")
def systems():
    jd = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(N, N),
                                     dtype=jnp.float64)
    td = tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(N, N),
                                     dtype="float64", device="cpu")
    jf, jt = _models(jd, JFlow, JThermal, jlin)
    tf, tt = _models(td, TFlow, TThermal, tlin)
    for jm, tm in ((jf, tf), (jt, tt)):
        jm._step_raw(jm.mesh, jm.params, jm.state, jm._resolve_bcvals())
        tm._step(tm.mesh, tm.params, tm.state, tm._resolve_bcvals())
    out = {}
    for name, key, jm, tm in (
            ("momentum", "momentumLinearSolver", jf, tf),
            ("pressure", "pressureLinearSolver", jf, tf),
            ("thermal", "linearSolver", jt, tt)):
        out[name] = (jm.options[key].systems[0], tm.options[key].systems[0])
    return out


SOLVERS = {
    "cg+amg": lambda L: L.CG(preconditioner=L.AMG(coarse_size=16),
                             relative_tolerance=1e-9, max_iterations=100),
    "gmres": lambda L: L.GMRES(restart=20, relative_tolerance=1e-9,
                               max_iterations=200),
    "gmres+jacobi": lambda L: L.GMRES(
        preconditioner=L.JacobiSolver(sweeps=3), restart=15,
        relative_tolerance=1e-9, max_iterations=120),
    "gmres+amg": lambda L: L.GMRES(preconditioner=L.AMG(coarse_size=16),
                                   restart=8, relative_tolerance=1e-9,
                                   max_iterations=40),
}
CASES = [("pressure", "cg+amg"), ("thermal", "cg+amg"),
         ("momentum", "gmres"), ("momentum", "gmres+jacobi"),
         ("pressure", "gmres+amg"), ("thermal", "gmres+amg")]


@pytest.mark.parametrize("system,solver", CASES)
def test_solution_and_iterations_match(systems, system, solver):
    (jA, jb), (tA, tb) = systems[system]
    xj, sj = SOLVERS[solver](jlin).solve_fn(jA, jb, jnp.zeros_like(jb))
    xt, st = SOLVERS[solver](tlin).solve_fn(tA, tb, torch.zeros_like(tb))
    assert bool(st.converged) and bool(sj.converged)
    assert int(st.iterations) == int(sj.iterations)
    xj = np.asarray(xj)
    scale = float(np.abs(xj).max())
    np.testing.assert_allclose(xt.numpy(), xj, rtol=SOL_RTOL,
                               atol=SOL_RTOL * scale)
    np.testing.assert_allclose(float(st.residual), float(sj.residual),
                               rtol=1e-6)


def test_gmres_restarts_and_frozen_trips(systems):
    """A restart length below the iterations needed (several cycles, the
    last one ending early) keeps the JAX package's count and iterate."""
    (jA, jb), (tA, tb) = systems["momentum"]
    mk = lambda L: L.GMRES(restart=8, relative_tolerance=1e-8,
                           max_iterations=70)
    xj, sj = mk(jlin).solve_fn(jA, jb, jnp.zeros_like(jb))
    xt, st = mk(tlin).solve_fn(tA, tb, torch.zeros_like(tb))
    assert int(st.iterations) == int(sj.iterations) > 8
    assert int(st.iterations) % 8 != 0
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=SOL_RTOL,
                               atol=SOL_RTOL * float(np.abs(xj).max()))


def test_cavity_cg_golden_history():
    m = TFlow(tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(32, 32),
                                          dtype="float64", device="cpu"))
    m.options["verbose"] = False
    m.vc["density"] = 1.0
    m.vc["viscosity"] = 0.1
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.options["pressureLinearSolver"] = tlin.CG(
        preconditioner=tlin.JacobiSolver(sweeps=3), relative_tolerance=1e-3,
        max_iterations=200)
    m.init()
    hist = [[h[1], h[2]] for h in m.advance(30)]
    with open(GOLDEN_PATH) as f:
        ref = json.load(f)["cavity/CG/np1"]
    assert len(hist) == len(ref) == 30
    np.testing.assert_allclose(hist, ref, rtol=HIST_RTOL, atol=1e-12)
