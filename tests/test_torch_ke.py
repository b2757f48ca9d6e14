"""KeModel against fvm_tpu (float64, CPU).

The three cases of ``tests/test_ke.py`` run by both packages from the same
inputs: decaying homogeneous turbulence on quad_2d(4, 4) against the exact
ODE decay (2%, as the JAX test) and fvm_tpu's k to 1e-8; uniform shear on
quad_2d(4, 4) (production from the LS gradient of the velocity): k, eps
and mu_t to 1e-8; the wall functions on quad_2d(4, 16) (a Wall group, a
SpecifiedKE group, eps pinned in the wall cells to 1e-4 of the log-law
value as the JAX test, and to 1e-8 of fvm_tpu's), ``getWallViscosity``
to 1e-8.  Then (A, r) of both equations at a random state with a random
velocity and mass flux: 1e-12; fvm_tpu's state and params loaded with
``interop.load_model_state`` and stepped on: 1e-8; and the
``outerChunk`` advance against the per-iteration loop: 1e-12.

The inner solves are BiCGStab(Jacobi(3), 1e-8, 100) in both packages
(the port's stops early every 10 trips: the same result); both run the
same trips from the same start, so their results differ by round-off.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models.ke import KeModel as JKe
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import KeModel as TKe
from fvm_tpu_torch.models.ke import C2, CMU, KAPPA
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

RTOL = 1e-8
SYS_RTOL = 1e-12


def _model(cls, dm, dt, k0, e0, bcs, vc=None):
    m = cls(dm)
    m.options["verbose"] = False
    m.options["transient"] = True
    m.options["timeStep"] = dt
    m.vc["initialK"] = k0
    m.vc["initialE"] = e0
    for key, v in (vc or {}).items():
        m.vc[key] = v
    for g, (t, vals) in bcs.items():
        m.bc[g].bc_type = t
        for key, v in vals.items():
            m.bc[g][key] = v
    m.init()
    return m


def pair(shape, *args, **kw):
    jdm = jfvm.mesh.build_device_mesh(jgen.quad_2d(*shape), dtype=jnp.float64)
    tdm = build_device_mesh(tgen.quad_2d(*shape), dtype="float64",
                            device="cpu")
    return _model(JKe, jdm, *args, **kw), _model(TKe, tdm, *args, **kw)


SYM = {g: ("Symmetry", {}) for g in ("left", "right", "bottom", "top")}
WALL = {"bottom": ("Wall", {}),
        "top": ("SpecifiedKE", {"specifiedK": 0.1, "specifiedE": 0.3}),
        "left": ("Symmetry", {}), "right": ("Symmetry", {})}


def run(m, steps, inner):
    hist = []
    for _ in range(steps):
        hist += [h[1] for h in m.advance(inner)]
        m.updateTime()
    return hist


def shear(m, scale):
    """u = (scale y, 0) on every cell of both packages' models."""
    cc = np.asarray(m.mesh.cell_centroid)
    V = np.stack([scale * cc[:, 1], np.zeros(len(cc))], axis=1)
    m.set_flow_state(velocity=V if isinstance(m, TKe) else jnp.asarray(V))


def test_decaying_turbulence_matches_exact_and_fvm_tpu():
    dt, k0, e0, steps = 0.002, 1.0, 2.0, 50
    jm, tm = pair((4, 4), dt, k0, e0, SYM)
    hj, ht = run(jm, steps, 4), run(tm, steps, 4)
    t = steps * dt
    k_exact = k0 * (1 + (C2 - 1) * (e0 / k0) * t) ** (-1 / (C2 - 1))
    k = tm.getK()
    np.testing.assert_allclose(k, k_exact, rtol=2e-2)
    assert k.std() < 1e-8 * k.mean()
    close(k, jm.getK(), RTOL)
    close(tm.getEpsilon(), jm.getEpsilon(), RTOL)
    assert len(ht) == len(hj)


def test_shear_production_matches_fvm_tpu():
    jm, tm = pair((4, 4), 0.002, 1.0, 2.0, SYM)
    shear(jm, 1.0), shear(tm, 1.0)
    run(jm, 20, 3), run(tm, 20, 3)
    close(tm.getK(), jm.getK(), RTOL)
    close(tm.getEpsilon(), jm.getEpsilon(), RTOL)
    close(tm.getTurbulentViscosity(), jm.getTurbulentViscosity(), RTOL)
    _, plain = pair((4, 4), 0.002, 1.0, 2.0, SYM)
    run(plain, 20, 3)
    assert tm.getK().mean() > plain.getK().mean()
    assert tm.getTurbulentViscosity().min() > 0


def test_wall_functions_match_fvm_tpu():
    jm, tm = pair((4, 16), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-4})
    assert np.array_equal(tm.params["wall_mask"].numpy(),
                          np.asarray(jm.params["wall_mask"]))
    close(tm.params["wall_dist"].numpy(), np.asarray(jm.params["wall_dist"]),
          1e-15)
    shear(jm, 2.0), shear(tm, 2.0)
    run(jm, 10, 3), run(tm, 10, 3)
    k, e = tm.getK(), tm.getEpsilon()
    assert (k > 0).all() and (e > 0).all()
    n = tm.mesh.n_interior_cells
    wall = tm.params["wall_mask"].numpy()[:n]
    y = tm.params["wall_dist"].numpy()[:n]
    np.testing.assert_allclose(e[wall], CMU**0.75 * k[wall] ** 1.5
                               / (KAPPA * y[wall]), rtol=1e-4)
    close(k, jm.getK(), RTOL)
    close(e, jm.getEpsilon(), RTOL)
    muw = tm.getWallViscosity("bottom")
    assert (muw > 0).all()
    close(muw, jm.getWallViscosity("bottom"), RTOL)


@pytest.mark.parametrize("which", ["k", "eps"])
def test_linearize_equals_fvm_tpu(which):
    """(A, r) of each equation at a random state, velocity and mass flux
    (upwind convection, production, the wall pin and a SpecifiedKE
    group)."""
    jm, tm = pair((6, 9), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-3})
    rng = np.random.default_rng(4)
    nc, nf = tm.mesh.n_cells, tm.mesh.n_faces
    st = {"k": rng.uniform(0.05, 0.2, nc), "eps": rng.uniform(0.1, 0.5, nc),
          "velocity": rng.normal(size=(nc, 2)),
          "massFlux": 0.1 * rng.normal(size=nf)}
    st["k_N1"], st["eps_N1"] = st["k"] * 0.9, st["eps"] * 1.1
    for key, v in st.items():
        jm.state[key] = jnp.asarray(v)
        tm.state[key] = torch.from_numpy(v.copy())
    # fvm_tpu's terms jitted (one compile instead of its op-by-op dispatch)
    Pj, mj = jax.jit(lambda st: jm._production(jm.mesh, jm.params, st))(
        jm.state)
    Pt, mt = tm._production(tm.mesh, tm.params, tm.state)
    close(Pt.numpy(), np.asarray(Pj), SYS_RTOL)
    bc = jm._resolve_bcvals()
    A1, r1 = jax.jit(lambda st: jm._linearize_scalar(
        jm.mesh, jm.params, st, bc, which, mj, Pj))(jm.state)
    A2, r2 = tm._linearize_scalar(tm.mesh, tm.params, tm.state,
                                  tm._resolve_bcvals(), which, mt, Pt)
    for a, b in ((A1.diag, A2.diag), (A1.off, A2.off), (r1, r2)):
        close(b.numpy(), np.asarray(a), SYS_RTOL)


def test_loaded_state_continues_like_fvm_tpu():
    """fvm_tpu's state and params (the bool ``wall_mask`` among them)
    loaded into a fresh port model: the next time step equal to 1e-8."""
    jm, _ = pair((4, 16), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-4})
    shear(jm, 2.0)
    run(jm, 2, 3)
    _, fresh = pair((4, 16), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-4})
    load_model_state(fresh, {k: np.asarray(v) for k, v in jm.state.items()},
                     {k: np.asarray(v) for k, v in jm.params.items()})
    assert fresh.params["wall_mask"].dtype == torch.bool
    run(jm, 1, 3), run(fresh, 1, 3)
    close(fresh.getK(), jm.getK(), RTOL)
    close(fresh.getEpsilon(), jm.getEpsilon(), RTOL)


def test_outer_chunk_equals_the_loop():
    _, eager = pair((4, 16), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-4})
    _, chunked = pair((4, 16), 0.01, 0.1, 0.3, WALL, vc={"viscosity": 1e-4})
    chunked.options["outerChunk"] = 2
    for m in (eager, chunked):
        shear(m, 2.0)
    he, hc = run(eager, 3, 3), run(chunked, 3, 3)
    np.testing.assert_allclose(hc, he, rtol=SYS_RTOL)
    close(chunked.getK(), eager.getK(), SYS_RTOL)
    close(chunked.getEpsilon(), eager.getEpsilon(), SYS_RTOL)
