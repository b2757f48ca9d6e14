"""The flow's sensitivities against fvm_tpu (float64, CPU).

bench's lid-driven cavity (viscosity 0.01, no-slip walls, lid u = 1) with
its inner solves tightened to 1e-12 (pressure ``AMG`` 400 cycles, momentum
``BiCGStab`` 200 iterations): fvm_tpu converges it (100 SIMPLE outers),
the port loads that state, and each of ``solve_tangent``,
``solve_tangent_force``, ``solve_adjoint`` and ``solve_adjoint_force``
must agree with fvm_tpu's at the same ``niter`` to 1e-8 relative to the
largest entry, on ``quad_2d(12, 12)`` (DIA: every transposed solve
launches the kernel on a card).  At bench's loose
inner solves the histories are chaotic in round-off (ROADMAP queue 3), so
they are not compared.  ``cases.cavity_sensitivities`` holds the truncated
duality (an adjoint of n sweeps against a tangent of n + 1 iterations) to
1e-9: exact up to the solves' tolerances.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models.fmg import snapshot_state
from fvm_tpu_torch import cases
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import AMG as TAMG, BiCGStab as TBiCGStab
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import FlowModel as TFlow
from test_torch_newton import one_thread  # noqa: F401

RTOL = 1e-8
NITER = 4
LID = "top:specifiedXVelocity"


def close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _cavity(cls, dm, amg, bicgstab):
    f = cls(dm)
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.options["pressureLinearSolver"] = amg(
        coarse_size=16, relative_tolerance=1e-12, max_iterations=400)
    f.options["momentumLinearSolver"] = bicgstab(relative_tolerance=1e-12,
                                                 max_iterations=200)
    f.init()
    return f


@pytest.fixture(scope="module")
def pair():
    n = 12
    jf = _cavity(JFlow, jfvm.mesh.build_device_mesh(
        jgen.quad_2d(n, n), dtype=jnp.float64), JAMG, JBiCGStab)
    tf = _cavity(TFlow, build_device_mesh(
        tgen.quad_2d(n, n), dtype="float64", device="cpu"), TAMG, TBiCGStab)
    jf.advance(100)
    load_model_state(tf, snapshot_state(jf))
    return jf, tf


def test_tangent_matches(pair):
    jf, tf = pair
    rng = np.random.default_rng(0)
    n = tf.mesh.n_interior_cells
    dmu = 0.01 * rng.standard_normal(n)
    args = ({"mu": dmu}, {LID: 0.5})
    dj = jf.solve_tangent(*args, niter=NITER)
    dt = tf.solve_tangent(*args, niter=NITER)
    for k in ("velocity", "pressure"):
        close(dt[k], dj[k])


def test_tangent_force_matches(pair):
    jf, tf = pair
    close(tf.solve_tangent_force("top", {"mu": 1.0}, niter=NITER),
          jf.solve_tangent_force("top", {"mu": 1.0}, niter=NITER))


def test_adjoint_force_matches(pair):
    """The drag's gradient with respect to the viscosity field, the
    density field and the lid velocity on every face."""
    jf, tf = pair
    args = ("top", [0.6, 0.8], ("mu", "rho"), (LID,))
    gj = jf.solve_adjoint_force(*args, niter=NITER)
    gt = tf.solve_adjoint_force(*args, niter=NITER)
    assert sorted(gt) == sorted(gj)
    for k in gj:
        close(gt[k], gj[k])


def test_adjoint_of_a_state_functional_matches(pair):
    jf, tf = pair
    gj = jf.solve_adjoint(
        lambda V, p: jnp.sum(V * V) + jnp.mean(p), ("mu",), (LID,),
        niter=NITER)
    gt = tf.solve_adjoint(lambda V, p: (V * V).sum() + p.mean(), ("mu",),
                          (LID,), niter=NITER)
    for k in gj:
        close(gt[k], gj[k])


def test_truncated_duality(pair):
    """<grad mu, 1> of an adjoint of n sweeps equals the x-force tangent of
    n + 1 iterations: the adjoint is its exact transpose."""
    _, tf = pair
    out = cases.cavity_sensitivities(tf, niter=NITER)
    assert out["gap"] < 1e-9
    assert np.isfinite(out["adjoint"][LID]).all()


def test_bench_cavity_tightened_runs_the_sensitivities():
    """``cases.coupled_cavity``'s flow, tightened by
    ``cases.tighten_cavity``, from a few SIMPLE outers: the same duality."""
    flow, _ = cases.coupled_cavity(12, device="cpu", dtype="float64")
    flow.advance(20)
    cases.tighten_cavity(flow)
    assert flow.options["pressureLinearSolver"].relativeTolerance == 1e-12
    out = cases.cavity_sensitivities(flow, niter=3)
    assert out["gap"] < 1e-9 and out["tangent_s"] > 0
    assert torch.isfinite(torch.as_tensor(out["adjoint"]["mu"])).all()
