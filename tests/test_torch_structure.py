"""StructureModel against fvm_tpu (float64, CPU).

Both packages build the same case from the same numpy inputs (states and
directions from a seed; ``interop.load_model_state`` carries fvm_tpu's
state and params across).  Tolerances, relative to the largest entry of
fvm_tpu's result:

* the assembled residual and block surrogate at one state: 1e-13;
* J v against ``jax.jvp`` of fvm_tpu's residual, both CPU Jacobian
  products of the port (``newton_operator`` "forward", ``torch.func.jvp``,
  and "reverse"): 1e-12;
* the deformation after ``advance`` with the inner solves at 1e-12: 1e-8
  (``scripts/roundoff_sensitivity.py --cases structures``: a 1e-15 change
  of the load moves fvm_tpu's own cantilever deformation by 1.8e-14 with
  its default inner solve (1e-6) and by 1.5e-15 with 1e-12 inner solves,
  but its converged outer residuals by up to 0.83 and 0.12: histories are
  compared by their length only);
* stress, strain, von Mises stress, the energy density and the boundary
  force integral at fvm_tpu's converged state: 1e-12;
* three creep steps (each followed by a re-advance) and the stiffness
  degradation: 1e-8;
* the tangent and the adjoint in Young's modulus: 1e-8, and the adjoint
  against the tangent (duality): 1e-8.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import StructureModel as JStructure
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import BiCGStab as TBiCGStab
from fvm_tpu_torch.linear import JacobiSolver as TJacobi
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import StructureModel as TStructure
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

SYS_RTOL = 1e-13
JV_RTOL = 1e-12
RTOL = 1e-8
POST_RTOL = 1e-12


def pair(nx, ny, lx=1.0, ly=1.0):
    """The same quad mesh as device meshes of both packages."""
    return (jfvm.mesh.build_device_mesh(jgen.quad_2d(nx, ny, lx=lx, ly=ly),
                                        dtype=jnp.float64),
            build_device_mesh(tgen.quad_2d(nx, ny, lx=lx, ly=ly),
                              dtype="float64", device="cpu"))


def tight(m, jax_side):
    """Inner BiCGStab(Jacobi(3)) at 1e-12 (the port's with an early exit
    every 10 trips, as its default JFNK solvers: the same result)."""
    bic, jac = (JBiCGStab, JJacobi) if jax_side else (TBiCGStab, TJacobi)
    s = bic(preconditioner=jac(sweeps=3), relative_tolerance=1e-12,
            max_iterations=1000)
    if not jax_side:
        s.exit_every = 10
    m.options["linearSolver"] = s


def host(d):
    return {k: np.asarray(v) for k, v in d.items()}


def jit_system(jm, var):
    """fvm_tpu's (A, r) at its state, jitted (one compile instead of its
    eager op-by-op dispatch)."""
    bc = jm._resolve_bcvals()
    return jax.jit(lambda w: jm._system(jm.mesh, jm.params, jm.state, bc,
                                        w))(jm.state[var])


def jit_jvp(jm, var, v):
    """``jax.jvp`` of fvm_tpu's residual at its state along v, jitted."""
    bc = jm._resolve_bcvals()

    def r(w):
        return jm._system(jm.mesh, jm.params, jm.state, bc, w)[1]

    return jax.jit(lambda w, t: jax.jvp(r, (w,), (t,)))(
        jm.state[var], jnp.asarray(v))


def configure(m, case, dm):
    """The BC and VC sets of the cases.  "mixed": every BC type but the
    force (a per-face deformation, traction, symmetry, free surface) with
    a body force; "force": a total force, transient with creep."""
    m.options["verbose"] = False
    m.vc["youngsModulus"] = 200.0
    m.vc["poissonsRatio"] = 0.3
    if case == "mixed":
        m.vc["bodyForceY"] = -3.0
        g = dm.group_by_name("left")
        fy = np.asarray(dm.face_centroid)[dm.group_faces(g), 1]
        m.bc["left"].bc_type = "SpecifiedDeformation"
        m.bc["left"]["specifiedXDeformation"] = 0.01 * fy
        m.bc["right"].bc_type = "SpecifiedTraction"
        m.bc["right"]["specifiedXTraction"] = 4.0
        m.bc["right"]["specifiedYTraction"] = -1.5
        m.bc["bottom"].bc_type = "Symmetry"
        m.bc["top"].bc_type = "ZeroTraction"
    else:
        m.options["transient"] = True
        m.options["timeStep"] = 0.05
        m.options["creep"] = True
        m.vc["density"] = 7.0
        m.bc["left"].bc_type = "SpecifiedDeformation"
        m.bc["right"].bc_type = "SpecifiedForce"
        m.bc["right"]["specifiedXForce"] = 2.0
        m.bc["right"]["specifiedYForce"] = 0.5
        m.bc["bottom"].bc_type = "ZeroTraction"
        m.bc["top"].bc_type = "Symmetry"


def models(case, nx=10, ny=4, seed=0):
    """(fvm_tpu model, port model) of ``case`` at a random state from
    ``seed`` (the port's loaded from fvm_tpu's)."""
    jdm, tdm = pair(nx, ny)
    jm, tm = JStructure(jdm), TStructure(tdm)
    configure(jm, case, jdm)
    configure(tm, case, jdm)
    jm.init()
    tm.init()
    rng = np.random.default_rng(seed)
    st = host(jm.state)
    for k in st:
        st[k] = 1e-2 * rng.standard_normal(st[k].shape)
    jm.state = {k: jnp.asarray(v) for k, v in st.items()}
    load_model_state(tm, st, host(jm.params))
    return jm, tm


@pytest.mark.parametrize("case", ["mixed", "force"])
def test_system_matches(case):
    """The residual and the block surrogate at a random state."""
    jm, tm = models(case)
    jA, jr = jit_system(jm, "deformation")
    tA, tr = tm._system(tm.mesh, tm.params, tm.state, tm._resolve_bcvals(),
                        tm.state["deformation"])
    close(tr.numpy(), np.asarray(jr), SYS_RTOL)
    close(tA.diag.numpy(), np.asarray(jA.diag), SYS_RTOL)
    mask = np.asarray(jA.mask)[:, :, None, None]
    close(np.where(mask, tA.off.numpy(), 0.0),
          np.where(mask, np.asarray(jA.off), 0.0), SYS_RTOL)
    # the residual-only path is the same residual
    _, tr2 = tm._system(tm.mesh, tm.params, tm.state, tm._resolve_bcvals(),
                        tm.state["deformation"], matrix=False)
    assert torch.equal(tr, tr2)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
@pytest.mark.parametrize("case", ["mixed", "force"])
def test_jacobian_product_matches_jax_jvp(case, mode):
    jm, tm = models(case)
    v = np.random.default_rng(7).standard_normal(
        np.asarray(jm.state["deformation"]).shape)
    tb = tm._resolve_bcvals()
    _, jv = jit_jvp(jm, "deformation", v)
    tA, _ = tm._system(tm.mesh, tm.params, tm.state, tb,
                       tm.state["deformation"])
    op = tm._jfnk_operator(tm.mesh, tm.params, tm.state, tb,
                           tm.state["deformation"], tA, mode)
    close(op.mv(torch.as_tensor(v)).numpy(), -np.asarray(jv), JV_RTOL)


def column(pkg_gen, build, cls, nx=4, ny=16):
    """The gravity column of ``tests/test_structure.py:64`` (body force,
    symmetry walls, free top) with tight inner solves."""
    dm = build(pkg_gen.quad_2d(nx, ny))
    m = cls(dm)
    m.options["verbose"] = False
    m.vc["youngsModulus"] = 1000.0
    m.vc["poissonsRatio"] = 0.25
    m.vc["bodyForceY"] = -10.0
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "ZeroTraction"
    m.bc["left"].bc_type = "Symmetry"
    m.bc["right"].bc_type = "SpecifiedTraction"
    m.bc["right"]["specifiedYTraction"] = 0.7
    tight(m, cls is JStructure)
    m.init()
    return m


def column_pair():
    jm = column(jgen, lambda m: jfvm.mesh.build_device_mesh(
        m, dtype=jnp.float64), JStructure)
    tm = column(tgen, lambda m: build_device_mesh(m, dtype="float64",
                                                  device="cpu"), TStructure)
    return jm, tm


def test_advance_and_postprocessing_match():
    """The deformation after ``advance`` (JFNK, inner solves at 1e-12),
    then stress, strain, von Mises stress, energy density and the reaction
    force at fvm_tpu's converged state."""
    jm, tm = column_pair()
    hj, ht = jm.advance(5), tm.advance(5)
    assert len(hj) == len(ht)
    assert ht[-1][1] / ht[0][1] < 1e-10
    close(tm.getDeformation(), jm.getDeformation(), RTOL)
    load_model_state(tm, host(jm.state))
    for name in ("getDeformation", "getStress", "getStrain", "getVMStress",
                 "getElasticEnergyDensity"):
        close(getattr(tm, name)(), getattr(jm, name)(), POST_RTOL)
    for g in ("bottom", "right"):
        close(tm.getBoundaryForceIntegral(g), jm.getBoundaryForceIntegral(g),
              POST_RTOL)


def shear_box(pkg_gen, build, cls):
    """The creep shear-relaxation box of ``tests/test_structure.py:95``."""
    dm = build(pkg_gen.quad_2d(6, 6))
    m = cls(dm)
    m.options["verbose"] = False
    m.options["creep"] = True
    m.options["creepConstant"] = 0.05
    m.options["creepExponent"] = 1.5
    m.options["yieldStress"] = 1.0
    m.vc["youngsModulus"] = 1.0
    m.vc["poissonsRatio"] = 0.25
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "SpecifiedDeformation"
    tight(m, cls is JStructure)
    m.init()
    for s in ("left", "right", "bottom", "top"):
        g = dm.group_by_name(s)
        f = np.asarray(dm.face_centroid)[dm.group_faces(g)]
        m.bc[s]["specifiedXDeformation"] = 0.1 * f[:, 1] + 0.02 * f[:, 0]
        m.bc[s]["specifiedYDeformation"] = 0.03 * f[:, 0] ** 2
    return m


def test_creep_and_degradation_match():
    """Three ``advanceCreep`` steps (Norton, exponent 1.5), each followed
    by a re-advance; then a random stiffness degradation."""
    jm = shear_box(jgen, lambda m: jfvm.mesh.build_device_mesh(
        m, dtype=jnp.float64), JStructure)
    tm = shear_box(tgen, lambda m: build_device_mesh(
        m, dtype="float64", device="cpu"), TStructure)
    jm.advance(4)
    tm.advance(4)
    for _ in range(3):
        jm.advanceCreep(0.1)
        tm.advanceCreep(0.1)
        jm.advance(3)
        tm.advance(3)
    close(tm.getPlasticStrain(), jm.getPlasticStrain(), RTOL)
    close(tm.getVMStress(), jm.getVMStress(), RTOL)
    close(tm.getStress(), jm.getStress(), RTOL)
    g = np.random.default_rng(3).uniform(0.2, 1.0, jm.mesh.n_interior_cells)
    jm.set_stiffness_degradation(g)
    tm.set_stiffness_degradation(g)
    close(tm.params["mu"].numpy(), np.asarray(jm.params["mu"]), 1e-15)
    jm.advance(4)
    tm.advance(4)
    close(tm.getDeformation(), jm.getDeformation(), RTOL)
    close(tm.getElasticEnergyDensity(), jm.getElasticEnergyDensity(), RTOL)


def cantilever(pkg_gen, build, cls, nx=20, ny=4):
    """The beam of ``demos/cantilever_uq.py`` (coarser) with nu 0.2."""
    dm = build(pkg_gen.quad_2d(nx, ny, lx=1.0, ly=0.1))
    m = cls(dm)
    m.options["verbose"] = False
    m.vc["youngsModulus"] = 1e9
    m.vc["poissonsRatio"] = 0.2
    m.bc["left"].bc_type = "SpecifiedDeformation"
    m.bc["right"].bc_type = "SpecifiedTraction"
    m.bc["right"]["specifiedYTraction"] = -1e4
    m.bc["top"].bc_type = "ZeroTraction"
    m.bc["bottom"].bc_type = "ZeroTraction"
    tight(m, cls is JStructure)
    m.init()
    m.advance(6)
    return m


def test_tangent_adjoint_and_duality_match():
    jm = cantilever(jgen, lambda m: jfvm.mesh.build_device_mesh(
        m, dtype=jnp.float64), JStructure)
    tm = cantilever(tgen, lambda m: build_device_mesh(
        m, dtype="float64", device="cpu"), TStructure)
    close(tm.getDeformation(), jm.getDeformation(), RTOL)
    n = jm.mesh.n_interior_cells
    dE = np.random.default_rng(5).uniform(0.5, 1.5, n) * 1e7
    tans = {"youngsModulus": dE, "poissonsRatio": 0.01}
    bt = {"right:specifiedYTraction": 1e3}
    dj = jm.solve_tangent(dict(tans), dict(bt))
    dt = tm.solve_tangent(dict(tans), dict(bt))
    close(dt, dj, RTOL)
    tip = np.nonzero(np.asarray(jm.mesh.cell_centroid)[:n, 0] > 0.97)[0]
    gj = jm.solve_adjoint(lambda w: jnp.mean(w[tip, 1]),
                          ["youngsModulus", "mu"],
                          ["right:specifiedYTraction"])
    tip_t = torch.as_tensor(tip)
    gt = tm.solve_adjoint(lambda w: w[tip_t, 1].mean(),
                          ["youngsModulus", "mu"],
                          ["right:specifiedYTraction"])
    for k in gj:
        close(gt[k], gj[k], RTOL)
    # duality: <dJ/dE, dE> against the tangent's tip in the same direction
    d_tan = tm.solve_tangent({"youngsModulus": dE})[tip, 1].mean()
    d_adj = float(np.dot(gt["youngsModulus"], dE))
    assert abs(d_adj - d_tan) <= RTOL * abs(d_tan)


def test_partition_raises():
    _, tdm = pair(4, 4)
    with pytest.raises(ConfigError, match="item 8"):
        TStructure(tdm, partition=object())
