"""PlateModel against fvm_tpu (float64, CPU).

The plates of ``tests/test_plate.py``: the clamped square (8 x 8, here
transient with a per-face specified deformation on one side) and the
clamped-free strip (30 x 4: Clamped, Free, Symmetry).  Tolerances,
relative to the largest entry of fvm_tpu's result: the residual and block
surrogate at a random state (seeded; ``interop.load_model_state`` carries
fvm_tpu's state and params) 1e-13; J v against ``jax.jvp`` (both CPU
``newton_operator`` modes) 1e-12; the deflection and rotations after
``advance`` with inner solves at 1e-12, the tangent and adjoint in ym and
thickness, and their duality 1e-8 (``scripts/roundoff_sensitivity.py
--cases structures``: a 1e-15 change of the load moves fvm_tpu's own strip
deflection by 2.9e-14 (default inner solve) and 4.7e-14 (1e-12)).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import PlateModel as JPlate
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import PlateModel as TPlate
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close
from test_torch_structure import (JV_RTOL, RTOL, SYS_RTOL, host,
                                  jit_jvp, jit_system, tight)


def configure(m, case, dm):
    m.options["verbose"] = False
    if case == "square":
        m.vc["ym"] = 2e11
        m.vc["nu"] = 0.3
        m.vc["thickness"] = 0.01
        m.vc["pressure"] = 1e4
        m.vc["density"] = 7800.0
        m.options["transient"] = True
        m.options["timeStep"] = 1e-3
        for s in ("left", "right", "bottom"):
            m.bc[s].bc_type = "Clamped"
        g = dm.group_by_name("top")
        fx = np.asarray(dm.face_centroid)[dm.group_faces(g), 0]
        m.bc["top"].bc_type = "SpecifiedDeformation"
        m.bc["top"]["specifiedZDeformation"] = 1e-4 * fx * (1 - fx)
        m.bc["top"]["specifiedXRotation"] = 1e-3
    else:
        m.vc["ym"] = 1e9
        m.vc["nu"] = 0.25
        m.vc["thickness"] = 0.02
        m.vc["pressure"] = 100.0
        m.bc["left"].bc_type = "Clamped"
        m.bc["right"].bc_type = "Free"
        m.bc["bottom"].bc_type = "Symmetry"
        m.bc["top"].bc_type = "Symmetry"


SIZES = {"square": (8, 8, 1.0, 1.0), "strip": (30, 4, 1.0, 0.2)}


def pair(case):
    nx, ny, lx, ly = SIZES[case]
    return (jfvm.mesh.build_device_mesh(jgen.quad_2d(nx, ny, lx=lx, ly=ly),
                                        dtype=jnp.float64),
            build_device_mesh(tgen.quad_2d(nx, ny, lx=lx, ly=ly),
                              dtype="float64", device="cpu"))


def models(case, seed=0, solver=False):
    jdm, tdm = pair(case)
    jm, tm = JPlate(jdm), TPlate(tdm)
    for m in (jm, tm):
        configure(m, case, jdm)
        if solver:
            tight(m, m is jm)
        m.init()
    if seed is not None:
        rng = np.random.default_rng(seed)
        st = host(jm.state)
        for k in st:
            st[k] = 1e-3 * rng.standard_normal(st[k].shape)
        jm.state = {k: jnp.asarray(v) for k, v in st.items()}
        load_model_state(tm, st, host(jm.params))
    return jm, tm


@pytest.mark.parametrize("case", ["square", "strip"])
def test_system_matches(case):
    jm, tm = models(case)
    jA, jr = jit_system(jm, "u")
    tA, tr = tm._system(tm.mesh, tm.params, tm.state, tm._resolve_bcvals(),
                        tm.state["u"])
    close(tr.numpy(), np.asarray(jr), SYS_RTOL)
    close(tA.diag.numpy(), np.asarray(jA.diag), SYS_RTOL)
    mask = np.asarray(jA.mask)[:, :, None, None]
    close(np.where(mask, tA.off.numpy(), 0.0),
          np.where(mask, np.asarray(jA.off), 0.0), SYS_RTOL)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
@pytest.mark.parametrize("case", ["square", "strip"])
def test_jacobian_product_matches_jax_jvp(case, mode):
    jm, tm = models(case)
    v = np.random.default_rng(9).standard_normal(
        np.asarray(jm.state["u"]).shape)
    tb = tm._resolve_bcvals()
    _, jv = jit_jvp(jm, "u", v)
    tA, _ = tm._system(tm.mesh, tm.params, tm.state, tb, tm.state["u"])
    op = tm._jfnk_operator(tm.mesh, tm.params, tm.state, tb, tm.state["u"],
                           tA, mode)
    close(op.mv(torch.as_tensor(v)).numpy(), -np.asarray(jv), JV_RTOL)


def test_transient_steps_match():
    """Two transient steps of the square (advance, updateTime), from rest,
    with a new load by ``set_pressure`` before the second."""
    jm, tm = models("square", seed=None, solver=True)
    for step in range(2):
        jm.advance(3)
        tm.advance(3)
        jm.updateTime()
        tm.updateTime()
        q = np.full(jm.mesh.n_cells, 2e4 * (step + 2))
        jm.set_pressure(q)
        tm.set_pressure(q)
    close(tm.getDeflection(), jm.getDeflection(), RTOL)
    close(tm.getRotations(), jm.getRotations(), RTOL)


def test_strip_tangent_adjoint_and_duality_match():
    jm, tm = models("strip", seed=None, solver=True)
    hj, ht = jm.advance(6), tm.advance(6)
    assert len(hj) == len(ht)
    close(tm.getDeflection(), jm.getDeflection(), RTOL)
    close(tm.getRotations(), jm.getRotations(), RTOL)
    n = jm.mesh.n_interior_cells
    rng = np.random.default_rng(11)
    dE = rng.uniform(0.5, 1.5, n) * 1e7
    tans = {"ym": dE, "thickness": 1e-4, "q": rng.standard_normal(n)}
    dj = jm.solve_tangent(dict(tans), {"left:specifiedZDeformation": 1e-3})
    dt = tm.solve_tangent(dict(tans), {"left:specifiedZDeformation": 1e-3})
    close(dt, dj, RTOL)
    keys = ["ym", "thickness", "nu_vc", "q"]
    gj = jm.solve_adjoint(lambda u: jnp.sum(u[:, 2] ** 2), keys,
                          ["left:specifiedZDeformation"])
    gt = tm.solve_adjoint(lambda u: (u[:, 2] ** 2).sum(), keys,
                          ["left:specifiedZDeformation"])
    for k in gj:
        close(gt[k], gj[k], RTOL)
    # duality: <dJ/dym, dE> against the tangent of J in the same direction
    w = tm.getDeflection()
    d_tan = float(np.dot(2.0 * w, tm.solve_tangent({"ym": dE})[:, 2]))
    d_adj = float(np.dot(gt["ym"], dE))
    assert abs(d_adj - d_tan) <= RTOL * abs(d_tan)


def test_dimension_and_partition_raise():
    from fvm_tpu_torch.mesh.generate import hex_3d

    with pytest.raises(ConfigError, match="2D"):
        TPlate(build_device_mesh(hex_3d(2, 2, 2), device="cpu"))
    _, tdm = pair("strip")
    with pytest.raises(ConfigError, match="item 8"):
        TPlate(tdm, partition=object())
