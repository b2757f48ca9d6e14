"""The immersed boundary (mask form) and the flux integrals against fvm_tpu.

* ``set_immersed_boundary`` on the 20^2 immersed-block cavity of
  ``tests/test_ibm.py:337``: ``ib_mask``, ``ib_value``, ``ib_solid_mask``,
  ``ib_solid_face`` and ``ib_face_sign`` equal the JAX package's bit for
  bit; a thermal and an electric pin likewise.
* The port's counterpart of ``test_ib_flow_block_force_balance``: at steady
  state the IB force equals minus the boundary force (2% of its scale, as
  there).
* The four flow integrals (``getIBForceIntegral``,
  ``getPressureIntegralonIBFaces``, ``getMassFluxIntegral``,
  ``getMomentumFluxIntegral``) and ``ThermalModel.getHeatFluxIntegral`` on
  a state and params loaded from the JAX package (``interop``): 1e-12.
* SIMPLE histories with the IB against fvm_tpu: 40 outers to 1e-8.  The
  JAX package's own history moves by 1.7e-14 under a 1e-15 change of the
  viscosity (``scripts/roundoff_sensitivity.py --cases ib``, CPU).
* The IB set after an ``outerChunk`` advance takes effect: the step and
  the runners (and on the card their graphs) are dropped, and the chunked
  history equals the eager one.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu.models.fmg import snapshot_state
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal
from test_torch_newton import one_thread  # noqa: F401

N, MU = 20, 0.1
HIST_RTOL = 1e-8
INTEGRAL_RTOL = 1e-12
IB_KEYS = ("ib_mask", "ib_value", "ib_solid_mask", "ib_solid_face",
           "ib_face_sign")
WALLS = ("left", "right", "bottom", "top")


def _solid(cc):
    return ((cc[:, 0] > 0.3) & (cc[:, 0] < 0.7)
            & (cc[:, 1] > 0.4) & (cc[:, 1] < 0.6))


def _setup_flow(m):
    m.options["verbose"] = False
    m.vc["viscosity"] = MU
    for s in WALLS:
        m.bc[s].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.init()
    return m


def _port_flow(**opts):
    m = TFlow(build_device_mesh(quad_2d(N, N), dtype="float64",
                                device="cpu"))
    m.options.update(opts)
    return _setup_flow(m)


def _jax_flow():
    return _setup_flow(JFlow(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(N, N), dtype=jnp.float64)))


def _block(m):
    return _solid(m.mesh.cell_centroid[: m.mesh.n_interior_cells].cpu()
                  .numpy())


def _fast(m):
    """Eager solves that stop once converged (the frozen form's results;
    read back every 5 trips)."""
    for key in ("momentumLinearSolver", "pressureLinearSolver"):
        m.options[key].exit_every = 5
    return m


def test_ib_parameters_equal_fvm_tpu_bit_for_bit():
    jm, tm = _jax_flow(), _port_flow()
    solid = _block(tm)
    jm.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    tm.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    for k in IB_KEYS:
        a, b = np.asarray(jm.params[k]), tm.params[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # scalar and per-cell values of the thermal pin
    for value in (350.0, np.linspace(300.0, 400.0, N * N)):
        jt = JThermal(jm.mesh)
        tt = TThermal(tm.mesh)
        for t in (jt, tt):
            t.options["verbose"] = False
            for s in WALLS:
                t.bc[s].bc_type = "Symmetry"
            t.init()
            t.set_immersed_boundary(solid, value)
        for k in ("ib_mask", "ib_value"):
            assert np.array_equal(np.asarray(jt.params[k]),
                                  tt.params[k].numpy()), k


def test_ib_needs_init_and_the_mask_form():
    m = TFlow(build_device_mesh(quad_2d(4, 4), dtype="float64",
                                device="cpu"))
    with pytest.raises(ConfigError):
        m.set_immersed_boundary(np.zeros(16, bool), [0.0, 0.0])
    _setup_flow(m)
    # the stencil form is taken as well (tests/test_torch_ib_stencil.py
    # holds it against fvm_tpu)
    m.set_immersed_boundary(np.zeros(16, bool), [0.0, 0.0],
                            stencil=([0], [[1]], [[1.0]], [1.0]))
    assert m.params["ibs_cells"].tolist() == [0] and m._ib_ext is not None
    with pytest.raises(ConfigError):
        m.getIBForceIntegral()


def test_ib_flow_block_force_balance():
    """Immersed block in a lid-driven cavity: at steady state the sum of
    (pressure + viscous) momentum flux over the domain boundary and over
    the IB faces vanishes, so the IB force equals minus the boundary
    force sum (``tests/test_ibm.py:337``)."""
    m = _fast(_port_flow())
    solid = _block(m)
    m.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    _fast(m)
    hist = m.advance(400)
    assert hist[-1][1] < 1e-5 * max(hist[0][1], 1e-30)
    F_ib = m.getIBForceIntegral()
    F_bdry = sum(m.getMomentumFluxIntegral(g) for g in WALLS)
    scale = np.abs(F_bdry).max()
    np.testing.assert_allclose(F_ib, -F_bdry, atol=2e-2 * scale)


def _close(a, b, rtol, scale=None):
    """Agreement to ``rtol`` of the largest entry (or of ``scale``: a wall's
    mass flux integral is round-off about 0)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    scale = float(np.abs(b).max()) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def test_integrals_on_a_loaded_state_match_fvm_tpu():
    jm = _jax_flow()
    solid = _block(_port_flow())
    jm.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    jm.advance(15)
    tm = _port_flow()
    load_model_state(tm, snapshot_state(jm),
                     {k: np.asarray(v) for k, v in jm.params.items()})
    for k in IB_KEYS:
        assert np.array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]))
    _close(tm.getIBForceIntegral(), jm.getIBForceIntegral(), INTEGRAL_RTOL)
    _close(tm.getPressureIntegralonIBFaces(),
           jm.getPressureIntegralonIBFaces(), INTEGRAL_RTOL)
    mdot = float(np.abs(np.asarray(jm.state["massFlux"])).max())
    for g in WALLS:
        _close(tm.getMomentumFluxIntegral(g), jm.getMomentumFluxIntegral(g),
               INTEGRAL_RTOL)
        _close(tm.getMassFluxIntegral(g), jm.getMassFluxIntegral(g),
               INTEGRAL_RTOL, scale=mdot)

    # heat flux: a temperature field from fvm_tpu, every BC branch
    types = {"left": "SpecifiedTemperature", "right": "SpecifiedHeatFlux",
             "bottom": "Symmetry", "top": "SpecifiedTemperature"}
    models = []
    for cls, mesh in ((JThermal, jm.mesh), (TThermal, tm.mesh)):
        t = cls(mesh)
        t.options["verbose"] = False
        t.vc["thermalConductivity"] = np.where(solid, 20.0, 1.0)
        for g, kind in types.items():
            t.bc[g].bc_type = kind
        t.bc["left"]["specifiedTemperature"] = 400.0
        t.bc["right"]["specifiedHeatFlux"] = np.linspace(-5.0, 8.0, N)
        t.init()
        models.append(t)
    jt, tt = models
    jt.set_immersed_boundary(solid, 330.0)
    jt.advance(3)
    load_model_state(tt, snapshot_state(jt),
                     {k: np.asarray(v) for k, v in jt.params.items()})
    for g in WALLS:
        _close(tt.getHeatFluxIntegral(g), jt.getHeatFluxIntegral(g),
               INTEGRAL_RTOL)


def test_ib_histories_match_fvm_tpu():
    jm, tm = _jax_flow(), _port_flow()
    solid = _block(tm)
    for m in (jm, tm):
        m.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    hj, ht = jm.advance(40), tm.advance(40)
    _close([h[1:] for h in ht], [h[1:] for h in hj], HIST_RTOL)
    _close(tm.getVelocity(), jm.getVelocity(), 1e-10)


def test_ib_set_after_an_outer_chunk_takes_effect():
    """An ``outerChunk`` advance builds the chunk runner (on the card, a
    captured graph of the step without the IB rows); setting the IB drops
    it and the step, so the next chunked advance runs the IB rows: its
    history equals the eager loop's with the IB and differs from the run
    without it."""
    chunked = _port_flow(outerChunk=4)
    eager, plain = _port_flow(), _port_flow(outerChunk=4)
    for m in (chunked, eager, plain):
        m.advance(8)
    assert ("chunk", 4) in chunked._runners
    step = chunked._step
    solid = _block(chunked)
    for m in (chunked, eager):
        m.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    assert chunked._runners == {} and chunked._step is not step
    hc, he, hp = chunked.advance(8), eager.advance(8), plain.advance(8)
    _close([h[1:] for h in hc], [h[1:] for h in he], 1e-12)
    assert abs(hc[-1][1] - hp[-1][1]) > 1e-3 * hp[-1][1]
