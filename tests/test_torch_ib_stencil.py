"""The stencil form of the immersed boundary against fvm_tpu (float64, CPU):
the thermal and electric rows (the flow cylinder's are in
``test_torch_ib_flow.py``).

* The widened thermal system after ``_apply_ib`` (``_linearize``, the
  JAX side under ``jax.jit``) at a seeded temperature field, entry by entry at 1e-14 of the
  largest, with its widened slot tables and its condensed form.  The
  widened pattern's DIA form at 24^2 has fallback entries (the stencil's
  couplings off its offsets), so this case and the solves below take the
  DIA route with the fallback's scatter-add, not gather-ELL.
* The thermal implicit stencil of ``tests/test_ibm.py:232``: converged in
  2 outers (``h[-1] < 1e-8 h[0]``), T equal to fvm_tpu's at 1e-10; the
  lagged form (5 outers) and the electric stencil of
  ``tests/test_ibm.py:265`` (3 outers), 1e-10, with the JAX tests'
  assertions on the port.
* Setting a stencil after an ``outerChunk`` advance drops the step and
  the runners; the distributed stencil raises ``ConfigError`` (item 8).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.geom import IBManager as JIB
from fvm_tpu.models import ThermalModel as JThermal
from fvm_tpu.models.electric import ElectricModel as JElectric
from fvm_tpu.models.fmg import snapshot_state
from fvm_tpu_torch import cases
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.geom import IBManager
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import ElectricModel, ThermalModel
from test_torch_newton import one_thread  # noqa: F401

N = 24
RTOL = 1e-14
SOLVE_RTOL = 1e-10
WALLS = ("left", "right", "bottom", "top")


def _close(t, j, rtol):
    j = np.asarray(j)
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def _ibms():
    verts, elems = cases.circle_polygon(cases.HOT_SEGMENTS, cases.HOT_RADIUS)
    ji = JIB(jfvm.mesh.generate.quad_2d(N, N))
    ji.update(verts, elems)
    ti = IBManager(quad_2d(N, N))
    ti.update(verts, elems)
    return (ji, ji.interpolation_stencil()), (ti, ti.interpolation_stencil())


def _walls(m, kind, key, value):
    m.options["verbose"] = False
    for s in WALLS:
        m.bc[s].bc_type = kind
        m.bc[s][key] = value
    return m


def _pair(JCls, TCls, kind, key, value, body, implicit=True):
    """(JAX model, port model) on quad_2d(N, N), initialised, with the
    hot 32-gon's stencil set."""
    (ji, jst), (ti, tst) = _ibms()
    jm = _walls(JCls(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(N, N), dtype=jnp.float64)), kind, key,
        value)
    tm = _walls(TCls(build_device_mesh(quad_2d(N, N), dtype="float64",
                                       device="cpu")), kind, key, value)
    jm.init()
    tm.init()
    for m, ib, st in ((jm, ji, jst), (tm, ti, tst)):
        m.set_immersed_boundary(ib.dirichlet_mask(include_ib=False), body,
                                stencil=st, implicit=implicit)
    return jm, tm, tst


def _thermal_pair(implicit=True):
    return _pair(JThermal, ThermalModel, "SpecifiedTemperature",
                 "specifiedTemperature", cases.HOT_T[0], cases.HOT_T[1],
                 implicit)


def systems_close(jsys, tsys, jcond=None, rtol=RTOL):
    """The widened systems (and their condensed forms, ``jcond`` the JAX
    side's if computed already) entry by entry."""
    (jA, jb), (tA, tb) = jsys, tsys
    assert tA.off.shape == jA.off.shape
    _close(tA.diag, jA.diag, rtol)
    _close(torch.where(tA.mask, tA.off, 0.0), jnp.where(jA.mask, jA.off, 0.0),
           rtol)
    assert np.array_equal(tA.cols.numpy(), np.asarray(jA.cols))
    assert np.array_equal(tA.mask.numpy(), np.asarray(jA.mask))
    _close(tb, jb, rtol)
    jA2, jb2 = jcond or jA.condense(jb)[:2]
    tA2, tb2, _ = tA.condense(tb)
    _close(tA2.diag, jA2.diag, rtol)
    _close(torch.where(tA2.mask, tA2.off, 0.0),
           jnp.where(jA2.mask, jA2.off, 0.0), rtol)
    _close(tb2, jb2, rtol)


def test_widened_thermal_system_matches():
    jm, tm, _ = _thermal_pair()
    # a seeded temperature field, in both (near convergence the residual
    # is round-off of its summands)
    T = 300.0 + 50.0 * np.random.default_rng(4).random(tm.mesh.n_cells)
    jm.state = dict(jm.state, T=jnp.asarray(T))
    load_model_state(tm, snapshot_state(jm))

    @jax.jit
    def jsystem(params, state, bcvals):
        A, r = jm._linearize(jm.mesh, params, state, bcvals)
        A2, r2, _ = A.condense(r)
        return A, r, A2, r2

    jA, jb, jA2, jb2 = jsystem(jm.params, jm.state, jm._resolve_bcvals())
    tA, tb = tm._linearize(tm.mesh, tm.params, tm.state,
                           tm._resolve_bcvals())
    K = tm.mesh.cf_nbr.shape[0]
    assert tA.off.shape[0] == K + 4 and tA.dia is not None
    assert tA.dia.fb_rows.shape[0] > 0  # DIA with fallback entries
    systems_close((jA, jb), (tA, tb), (jA2, jb2))


def test_thermal_implicit_stencil_matches_fvm_tpu():
    jm, tm, st = _thermal_pair()
    hj, ht = jm.advance(2), tm.advance(2)
    assert ht[-1][1] < 1e-8 * ht[0][1]
    _close([h[1] for h in ht[:1]], [h[1] for h in hj[:1]], SOLVE_RTOL)
    _close(tm.getTemperature(), jm.getTemperature(), SOLVE_RTOL)
    # the JAX test's band checks on the port
    ib, fluid_idx, fluid_w, wall_w = st
    T = np.zeros(tm.mesh.n_cells)
    T[: tm.mesh.n_interior_cells] = tm.getTemperature()
    assert (T[ib] > 300.0).all() and (T[ib] < 350.0 + 1e-9).all()
    assert T[ib].mean() > T[fluid_idx].mean()


def test_lagged_stencil_matches_fvm_tpu():
    jm, tm, _ = _thermal_pair(implicit=False)
    assert tm._ib_ext is None
    hj, ht = jm.advance(5), tm.advance(5)
    _close([h[1] for h in ht], [h[1] for h in hj], SOLVE_RTOL)
    _close(tm.getTemperature(), jm.getTemperature(), SOLVE_RTOL)
    assert ht[1][1] > 1e-6 * ht[0][1]  # the lagged rows are not done in 2


def test_electric_stencil_matches_fvm_tpu():
    jm, tm, st = _pair(JElectric, ElectricModel, "SpecifiedPotential",
                       "specifiedPotential", 0.0, 10.0)
    hj, ht = jm.advance(3), tm.advance(3)
    assert ht[-1][1] < 1e-8 * ht[0][1]
    _close(tm.getPotential(), jm.getPotential(), SOLVE_RTOL)
    ib, fluid_idx, fluid_w, wall_w = st
    phi = np.zeros(tm.mesh.n_cells)
    phi[: tm.mesh.n_interior_cells] = tm.getPotential()
    expect = (wall_w * 10.0 + (fluid_w * phi[fluid_idx]).sum(1)) / (
        wall_w + fluid_w.sum(1))
    np.testing.assert_allclose(phi[ib], expect, atol=1e-8)


def test_stencil_after_an_outer_chunk_takes_effect():
    _, tm, st = _thermal_pair()
    chunked = _walls(ThermalModel(tm.mesh), "SpecifiedTemperature",
                     "specifiedTemperature", 300.0)
    chunked.options["outerChunk"] = 2
    chunked.init()
    chunked.advance(2)
    assert ("chunk", 2) in chunked._runners
    step = chunked._step
    chunked.set_immersed_boundary(tm.params["ib_mask"].numpy(), 350.0,
                                  stencil=st)
    assert chunked._runners == {} and chunked._step is not step
    hc, he = chunked.advance(2), tm.advance(2)
    _close([h[1] for h in hc], [h[1] for h in he], 1e-12)


def test_distributed_stencil_raises():
    _, tm, st = _thermal_pair()
    tm.partition = object()  # the distributed branch (a Partition's model)
    with pytest.raises(ConfigError, match="item 8"):
        tm.set_immersed_boundary(np.zeros(N * N, bool), 350.0, stencil=st)
