"""The ES-BGK kinetic model's outer steps and sensitivities against fvm_tpu
(float64, CPU).

fvm_tpu's own kinetic histories move with round-off
(``python3 -m scripts.roundoff_sensitivity --cases kinetic``): under a
1e-15 change of one input the interior distribution after ONE COMET
outer moves by 5.0e-10 of its largest entry at the default inner solve
(BiCGStab 60 trips to 1e-8) on the small BGK Couette, by 1.6e-4 on the
demo's ES-BGK Couette, by 3.5e-4 on the thick case, and the later
residuals by up to 3.3 relative (ROADMAP queue 3).  So the comparisons
here are one outer from the same state, with the inner solve at 1e-12
(200 trips) on the COMET path: there fvm_tpu's own spread on this file's
Couette is 1.9e-14 (BGK) and 5.4e-15 (ES-BGK) of the largest entry after
one outer, 6.3e-13 and 2.4e-12 after two, 2.0e-16 on the Picard path
(Jacobi(2)-preconditioned BiCGStab on the plain operator) and 1.3e-12 on
the immersed plate; the port is held to 1e-12 after one outer.  The first
outer's residual norm is a function of the state alone, a difference of
O(1) terms 1e-4 below them: 1e-10.

* one outer of each path from the same state: the ES-BGK Couette on
  quad_2d(3, 6) with Q(6, 6, 4) (COMET and Picard), the damping layout
  (transient, PressureInlet, moving diffuse beam) on quad_2d(6, 2) over
  3 x 1 (COMET);
* ``solve_tangent`` in tau at fvm_tpu's converged BGK Couette (loaded with
  ``interop.load_model_state``) against fvm_tpu's to 1e-7 of the largest
  entry (both tangent solves stop at 1e-10 of their first residual),
  ``solve_tangent_moments`` against the moments'
  derivative of fvm_tpu's tangent, and the port's adjoint in tau and in
  the wall velocity against its tangents (duality) to 1e-7;
* the immersed boundary (moving plate, ``pad_faces``): one COMET and one
  Picard outer against fvm_tpu's, ``getIBForceIntegral`` on the same
  state to 1e-13, and a second ``set_immersed_boundary`` with the same
  padding keeping the step;
* ``outerChunk`` on the CPU (the chunk runs eagerly in the frozen form):
  the same history and state as the per-iteration loop, bit for bit on
  the Picard path.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fvm_tpu_torch.interop import load_model_state
from test_torch_kinetic import couette, pair, tt
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

OUTER_TOL = 1e-12
# the first residual is a difference of O(1) terms 1e-4 below them
RNORM_TOL = 1e-10
SENS_TOL = 1e-7


def tight(m):
    m.options["innerTolerance"] = 1e-12
    m.options["innerIterations"] = 200


def damping(m):
    m.options["collisionModel"] = "ESBGK"
    m.options["transient"] = True
    m.options["timeStep"] = 0.5e-2
    m.vc["relaxationTime"] = 0.2
    m.bc["top"].bc_type = "DiffuseWall"
    m.bc["top"]["specifiedYVelocity"] = -0.0297 * 0.2
    m.bc["bottom"].bc_type = "DiffuseWall"
    m.bc["left"].bc_type = "Symmetry"
    m.bc["right"].bc_type = "PressureInlet"
    m.bc["right"]["specifiedPressure"] = 1.0


CASES = {
    "couette-ESBGK-COMET": ((3, 6), {}, lambda m: (
        couette(m), tight(m),
        m.options.__setitem__("collisionModel", "ESBGK"))),
    "couette-ESBGK-sweep": ((3, 6), {}, lambda m: (
        couette(m), m.options.__setitem__("collisionModel", "ESBGK"),
        m.options.__setitem__("solver", "sweep"))),
    "damping-COMET": ((6, 2), {"lx": 3.0}, lambda m: (damping(m), tight(m))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_outer_from_the_same_state(case):
    (nx, ny), kw, configure = CASES[case]
    jm, tm = pair(nx, ny, configure, **kw)
    f0 = np.asarray(jm.state["f"])
    assert np.array_equal(f0, tm.state["f"].numpy())
    hj, ht = jm.advance(1), tm.advance(1)
    close(ht[0][1], hj[0][1], RNORM_TOL)
    fj = np.asarray(jm.state["f"])
    close(tm.state["f"].numpy(), fj, OUTER_TOL)
    assert np.abs(fj - f0).max() > 1e3 * OUTER_TOL * np.abs(fj).max()


@pytest.fixture(scope="module")
def converged():
    """fvm_tpu's Couette on quad_2d(3, 6), converged (to its relative
    tolerance, within 12 outers), and the port's model with its state
    loaded."""
    jm, tm = pair(3, 6, couette)
    jm.advance(12)
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()})
    return jm, tm


def test_tangent_against_fvm_tpu_and_duality(converged):
    jm, tm = converged
    ni = tm.mesh.n_interior_cells
    dtau = np.random.default_rng(3).standard_normal(ni)
    bc = {"top:specifiedXVelocity": 1.0}
    dj = jm.solve_tangent(param_tangents={"tau": dtau})
    dt_ = tm.solve_tangent(param_tangents={"tau": dtau})
    close(dt_, dj, SENS_TOL)
    f0j = jm.state["f"][:ni]
    _, dmj = jax.jvp(jm.moments, (f0j,), (jnp.asarray(dj),))
    for a, b in zip(dmj, tm.solve_tangent_moments(
            param_tangents={"tau": dtau})):
        close(b, np.asarray(a), SENS_TOL)
    dtb = tm.solve_tangent(bc_tangents=bc)
    # the port's adjoint of a nonlinear momentum functional against its
    # tangents
    q = tm.quadrature
    wcx = torch.from_numpy(q.w * q.c[:, 0])
    g = tm.solve_adjoint(lambda ff: torch.sum((ff @ wcx) ** 2),
                         param_keys=("tau",), bc_keys=tuple(bc))
    assert g["tau"].shape == (ni,)
    f0 = tm.state["f"][:ni]

    def dJ(df):
        return float(torch.func.jvp(lambda ff: torch.sum((ff @ wcx) ** 2),
                                    (f0,), (tt(df),))[1])

    for lhs, rhs in ((float(np.dot(g["tau"], dtau)), dJ(dt_)),
                     (float(np.sum(g["top:specifiedXVelocity"])), dJ(dtb))):
        assert abs(rhs) > 1e-8
        assert abs(lhs - rhs) <= SENS_TOL * abs(rhs)


def moving_plate(m):
    m.options["solver"] = "COMET"
    m.vc["relaxationTime"] = 0.2
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "DiffuseWall"


@pytest.mark.parametrize("solver", ["COMET", "sweep"])
def test_immersed_boundary(solver):
    def conf(m):
        moving_plate(m)
        m.options["solver"] = solver
        tight(m)

    jm, tm = pair(8, 8, conf)
    cc = tm.mesh.cell_centroid.numpy()[:64]
    solid = (np.abs(cc[:, 0] - 0.5) < 0.25) & (np.abs(cc[:, 1] - 0.5) < 0.1)
    for m in (jm, tm):
        m.set_immersed_boundary(solid, wall_velocity=(0.2, 0.0, 0.0),
                                pad_faces=40)
    for k in ("ib_pin", "ib_solid_cell", "ib_fluid_cell", "ib_mdot_s"):
        assert np.array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]))
    close(tm.params["ib_Mw"].numpy(), np.asarray(jm.params["ib_Mw"]), 1e-15)
    close(tm.state["f"].numpy(), np.asarray(jm.state["f"]), 1e-15)
    hj, ht = jm.advance(1), tm.advance(1)
    close(ht[0][1], hj[0][1], RNORM_TOL)
    close(tm.state["f"].numpy(), np.asarray(jm.state["f"]), OUTER_TOL)
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()})
    close(tm.getIBForceIntegral(), jm.getIBForceIntegral(), 1e-13)
    # the body moves: new tables of the same shapes, the same step
    step = tm._step
    tm.set_immersed_boundary(np.roll(solid, 8), wall_velocity=(-0.2, 0.0),
                             pad_faces=40)
    assert tm._step is step
    assert np.isfinite(tm.advance(1)[0][1])


def test_outer_chunk_equals_the_loop():
    runs = []
    for chunk in (0, 3):
        def conf(m, chunk=chunk):
            couette(m)
            m.options["solver"] = "sweep"
            m.options["outerChunk"] = chunk
            m.options["relativeTolerance"] = 1e-30

        (m,) = pair(3, 6, conf, packages=("torch",))
        h = m.advance(6)
        runs.append(([r[1] for r in h], m.state["f"]))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 6
    assert torch.equal(runs[0][1], runs[1][1])
