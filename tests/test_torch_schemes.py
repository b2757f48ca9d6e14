"""The port's convection schemes, limiters and L1 momentum norm against
fvm_tpu (float64, CPU).

* ``convection_flux`` for every scheme (upwind, central, sou, vanLeer,
  minmod, superbee) and the three limiters, on the same mesh with the same
  field, mass flux and gradient (made from a seed with numpy), on every
  face with an area: 1e-13 relative to the largest value (a few roundings
  of a face sum).
* Thermal convective histories with ``sou`` and each limiter in the setup
  of ``tests/test_thermal.py:217`` (quad_2d(40, 2), transient, uniform +x
  mass flux; 5 time steps of 2 outers) and, where the limiters act (the
  JAX package computes the gradient they need only off orthogonal meshes
  or for ``sou``), on ``tri_2d(8, 8)``: histories to 1e-8 relative with
  1e-12 absolute (the golden-history tolerances: a linear problem's second
  outer residual sits at the round-off floor, ~2e-13) and temperatures to
  1e-10.
* The flow cavity with ``sou`` and ``central`` and with
  ``residualNorm="L1"``: histories to 1e-8, velocities to 1e-10.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.ops import discretizations as jdisc, limiters as jlim
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.ops import discretizations as tdisc, limiters as tlim
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

OP_RTOL = 1e-13
HIST_RTOL = 1e-8
HIST_ATOL = 1e-12  # as tests/test_golden_histories.py: round-off floors
FIELD_RTOL = 1e-10
SCHEMES = ("upwind", "central", "sou", "vanLeer", "minmod", "superbee")


def _meshes(kind):
    gen = "quad_2d" if kind == "quad" else "tri_2d"
    args = (9, 7) if kind == "quad" else (6, 5)
    jm = jfvm.mesh.build_device_mesh(
        getattr(jfvm.mesh.generate, gen)(*args), dtype=jnp.float64)
    tm = tfvm.mesh.build_device_mesh(
        getattr(tfvm.mesh.generate, gen)(*args), dtype="float64",
        device="cpu")
    return jm, tm


def _close(t, j, rtol):
    t, j = np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t), \
        np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * float(np.abs(j).max()))


@pytest.mark.parametrize("kind", ["quad", "tri"])
@pytest.mark.parametrize("m", [1, 2])
def test_convection_flux_every_scheme(kind, m):
    jm, tm = _meshes(kind)
    rng = np.random.default_rng(5 + m)
    nc, nf, dim = tm.n_cells, tm.n_faces, tm.dim
    shape = (nc,) if m == 1 else (nc, m)
    phi = rng.standard_normal(shape)
    grad = rng.standard_normal(shape + (dim,))
    mdot = rng.standard_normal(nf)
    # the JAX package's plane-major gathers return other values on the
    # zero-area padding faces, which every model masks; compare the rest
    real = tm.face_area_mag > 0
    for scheme in SCHEMES:
        j = jdisc.convection_flux(jm, jnp.asarray(phi), jnp.asarray(mdot),
                                  scheme, jnp.asarray(grad))
        t = tdisc.convection_flux(tm, torch.from_numpy(phi),
                                  torch.from_numpy(mdot), scheme,
                                  torch.from_numpy(grad))
        for a, b in ((t.F, j.F), (t.dF_dO, j.dF_dO), (t.dF_dN, j.dF_dN)):
            _close(a[real], np.asarray(b)[real.numpy()], OP_RTOL)


@pytest.mark.parametrize("name", sorted(tlim.LIMITERS))
def test_limiters(name):
    r = np.concatenate([np.linspace(-5.0, 5.0, 1001),
                        np.random.default_rng(1).standard_normal(200) * 3])
    _close(tlim.LIMITERS[name](torch.from_numpy(r)),
           jlim.LIMITERS[name](jnp.asarray(r)), OP_RTOL)
    jm, tm = _meshes("tri")
    rng = np.random.default_rng(2)
    phi = rng.standard_normal(tm.n_cells)
    grad = rng.standard_normal((tm.n_cells, tm.dim))
    mdot = rng.standard_normal(tm.n_faces)
    real = tm.face_area_mag > 0
    _close(tlim.limited_sou_correction(tm, torch.from_numpy(phi),
                                       torch.from_numpy(mdot),
                                       torch.from_numpy(grad), name)[real],
           np.asarray(jlim.limited_sou_correction(
               jm, jnp.asarray(phi), jnp.asarray(mdot), jnp.asarray(grad),
               name))[real.numpy()], OP_RTOL)


def _thermal(pkg, Thermal, kind, scheme):
    if kind == "quad":
        mesh = pkg.mesh.generate.quad_2d(40, 2)
    else:
        mesh = pkg.mesh.generate.tri_2d(8, 8)
    kw = {"device": "cpu", "dtype": "float64"} if pkg is tfvm else {
        "dtype": jnp.float64}
    m = Thermal(pkg.mesh.build_device_mesh(mesh, **kw))
    m.options["verbose"] = False
    m.options["convective"] = True
    m.options["convectionScheme"] = scheme
    m.options["transient"] = True
    m.options["timeStep"] = 0.01
    m.vc["thermalConductivity"] = 1e-8 if kind == "quad" else 1e-3
    m.vc["initialTemperature"] = 300.0
    m.bc["left"].bc_type = "SpecifiedTemperature"
    m.bc["left"]["specifiedTemperature"] = 400.0
    m.bc["right"].bc_type = "SpecifiedTemperature"
    m.bc["right"]["specifiedTemperature"] = 300.0
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    # uniform +x mass flux
    area = np.asarray(m.mesh.face_area.cpu() if pkg is tfvm
                      else m.mesh.face_area)
    md = area @ np.array([1.0, 0.0])
    m.state["massFlux"] = (torch.from_numpy(md) if pkg is tfvm
                           else jnp.asarray(md))
    hist = []
    for _ in range(5):
        hist += [float(h[1]) for h in m.advance(2)]
        m.updateTime()
    return hist, m.getTemperature()


@pytest.mark.parametrize("kind,scheme", [
    ("quad", "sou"), ("quad", "vanLeer"), ("quad", "minmod"),
    ("quad", "superbee"), ("tri", "sou"), ("tri", "vanLeer"),
    ("tri", "minmod"), ("tri", "superbee")])
def test_thermal_convective_history(kind, scheme):
    hj, Tj = _thermal(jfvm, JThermal, kind, scheme)
    ht, Tt = _thermal(tfvm, TThermal, kind, scheme)
    np.testing.assert_allclose(ht, hj, rtol=HIST_RTOL, atol=HIST_ATOL)
    _close(np.asarray(Tt), np.asarray(Tj), FIELD_RTOL)


def _cavity(pkg, Flow, **opts):
    kw = {"device": "cpu", "dtype": "float64"} if pkg is tfvm else {
        "dtype": jnp.float64}
    m = Flow(pkg.mesh.build_device_mesh(pkg.mesh.generate.quad_2d(16, 16),
                                        **kw))
    m.options["verbose"] = False
    m.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        m.bc[side].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    for k, v in opts.items():
        m.options[k] = v
    m.init()
    hist = [[float(v) for v in h[1:]] for h in m.advance(10)]
    return hist, m.getVelocity()


@pytest.mark.parametrize("opts", [
    {"convectionScheme": "sou"}, {"convectionScheme": "central"},
    {"residualNorm": "L1"}], ids=["sou", "central", "L1"])
def test_flow_cavity_options(opts):
    hj, vj = _cavity(jfvm, JFlow, **opts)
    ht, vt = _cavity(tfvm, TFlow, **opts)
    assert len(ht) == len(hj) == 10
    np.testing.assert_allclose(ht, hj, rtol=HIST_RTOL)
    _close(np.asarray(vt), np.asarray(vj), FIELD_RTOL)
