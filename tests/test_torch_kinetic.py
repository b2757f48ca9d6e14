"""The ES-BGK kinetic model's pieces against fvm_tpu (float64, CPU).

The same seeded inputs go through ``fvm_tpu.kinetic`` and
``fvm_tpu_torch.kinetic``:

* the quadrature's ordinates and weights (tensor and spherical), the S_N
  directions and the reflection tables (axis-aligned and 30-degree
  normals, plain and flux-balanced) bit for bit: host numpy in both;
* the discrete Maxwellian and its moments, the BGK and ES-BGK equilibria,
  ``_refresh_ghosts`` for each of the ten BC types (three layouts), the
  operator's product (plain, with the rank-5 coupling and pinned rows),
  the collision Jacobian U, the Woodbury application and its transpose
  (and the unrolled 5 x 5 Gauss-Jordan), each to 1e-13 of the largest
  entry on one seeded state (the packages' rounding differs in the order
  of sums); the DSA application is in
  ``test_torch_kinetic_thick.py``;
* ``moments``, ``stress``, ``heat_flux``, ``getMomentumFluxIntegral`` and
  ``conservation_error`` on fvm_tpu's state loaded with
  ``interop.load_model_state``, to 1e-13;
* the interop round trip (state and params, the immersed boundary's
  tables included) bit for bit, and the ``ConfigError`` raises.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.kinetic import KineticModel as JKinetic, Quadrature as JQuad
from fvm_tpu.kinetic import esbgk as jesbgk
from fvm_tpu.kinetic import quadrature as jquad
from fvm_tpu.kinetic.phonon import sn_directions as jsn
from fvm_tpu.mesh import generate as jgen
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.kinetic import KineticModel as TKinetic, Quadrature as TQuad
from fvm_tpu_torch.kinetic import esbgk as tesbgk
from fvm_tpu_torch.kinetic import quadrature as tquad
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

TOL = 1e-13
QUAD = (6, 6, 4)


PACKAGES = {
    "jax": (jgen, lambda m: jfvm.mesh.build_device_mesh(m, dtype=jnp.float64),
            JKinetic, JQuad),
    "torch": (tgen, lambda m: build_device_mesh(m, dtype="float64",
                                                device="cpu"), TKinetic,
              TQuad)}


def pair(nx, ny, configure, quad=QUAD, periodic=None, init=True,
         packages=("jax", "torch"), **kw):
    """The same KineticModel in both packages (or those of ``packages``),
    ``configure``d (options, VC and BCs) and initialised."""
    models = []
    for name in packages:
        gen, build, K, Q = PACKAGES[name]
        mesh = gen.quad_2d(nx, ny, **kw)
        if periodic:
            mesh.make_periodic(*periodic)
        m = K(build(mesh), Q(*quad))
        m.options["verbose"] = False
        configure(m)
        if init:
            m.init()
        models.append(m)
    return models


def seeded_f(m, seed=0, noise=0.05):
    """A distribution over every cell: a Maxwellian of seeded density,
    velocity and temperature, times seeded noise (numpy)."""
    rng = np.random.default_rng(seed)
    nc = m.mesh.n_cells
    rho = rng.uniform(0.8, 1.2, nc)
    u = np.zeros((nc, 3))
    u[:, :2] = rng.uniform(-0.2, 0.2, (nc, 2))
    T = rng.uniform(0.9, 1.1, nc)
    c = np.asarray(m.quadrature.c)
    du = c[None] - u[:, None]
    f = rho[:, None] / (2 * np.pi * T[:, None]) ** 1.5 * np.exp(
        -(du * du).sum(-1) / (2 * T[:, None]))
    return f * (1.0 + noise * rng.standard_normal(f.shape))


def tt(a):
    return torch.from_numpy(np.array(a))


# --- the quadrature --------------------------------------------------------


def test_quadrature_and_reflection_tables_bit_identical():
    for args in ((8, 8, 4), (10, 10, 10), (6, 6, 6)):
        a, b = JQuad(*args), TQuad(*args)
        assert np.array_equal(a.c, b.c) and np.array_equal(a.w, b.w)
    a, b = JQuad.spherical(4, 4, 8), TQuad.spherical(4, 4, 8)
    assert np.array_equal(a.c, b.c) and np.array_equal(a.w, b.w)
    for n in ((4, 8), (6, 12)):
        assert all(np.array_equal(x, y) for x, y in
                   zip(jsn(*n), tquad.sn_directions(*n)))
    q = JQuad(10, 10, 8)
    th = np.pi / 6
    normals = np.array([[0.0, 1.0, 0.0], [np.sin(th), np.cos(th), 0.0],
                        [-1.0, 0.0, 0.0], [np.sin(th), np.cos(th), 0.0]])
    for weights in (None, q.w):
        ja = jquad.reflection_tables(q.c, normals, weights=weights)
        ta = tquad.reflection_tables(q.c, normals, weights=weights)
        assert ta[0].dtype == np.int32 and ta[1].dtype == np.float64
        assert np.array_equal(ja[0], ta[0]) and np.array_equal(ja[1], ta[1])
    # the axis normal's table is the mirror permutation
    assert (ta[1][0].max(axis=1) == 1.0).all()


def test_maxwellian_and_moments():
    q, tq = JQuad(*QUAD), TQuad(*QUAD)
    rng = np.random.default_rng(1)
    rho = rng.uniform(0.5, 1.5, 7)
    u = rng.uniform(-0.3, 0.3, (7, 3))
    T = rng.uniform(0.7, 1.3, 7)
    fj = np.asarray(q.maxwellian(jnp.asarray(rho), jnp.asarray(u),
                                 jnp.asarray(T)))
    ft = tq.maxwellian(tt(rho), tt(u), tt(T)).numpy()
    close(ft, fj, TOL)
    for a, b in zip(q.moments(jnp.asarray(fj)), tq.moments(tt(fj))):
        close(b.numpy(), np.asarray(a), TOL)


# --- the model's closures on one seeded state -----------------------------


def couette(m):
    m.vc["relaxationTime"] = 0.2
    for s, uw in (("top", 0.3), ("bottom", -0.3)):
        m.bc[s].bc_type = "DiffuseWall"
        m.bc[s]["specifiedXVelocity"] = uw
    m.bc["left"].bc_type = "Symmetry"
    m.bc["right"].bc_type = "Symmetry"


def layout_walls(m):
    m.bc["left"].bc_type = "DiffuseWall"
    m.bc["left"]["specifiedTemperature"] = 1.2
    m.bc["left"]["specifiedYVelocity"] = 0.1
    m.bc["right"].bc_type = "FarField"
    m.bc["right"]["specifiedDensity"] = 0.9
    m.bc["right"]["specifiedXVelocity"] = -0.1
    m.bc["bottom"].bc_type = "SpecularWall"
    m.bc["top"].bc_type = "RealWall"
    m.bc["top"]["accommodationCoefficient"] = 0.6
    m.bc["top"]["specifiedXVelocity"] = 0.2


def layout_ports(m):
    m.bc["left"].bc_type = "PressureInlet"
    m.bc["left"]["specifiedPressure"] = 1.2
    m.bc["right"].bc_type = "PressureOutlet"
    m.bc["right"]["specifiedPressure"] = 0.8
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Inlet"
    m.bc["top"]["specifiedYVelocity"] = -0.2
    m.bc["top"]["specifiedMassFlowRate"] = 0.15


def layout_periodic(m):
    m.bc["left"].bc_type = "Periodic"
    m.bc["right"].bc_type = "Periodic"
    m.bc["bottom"].bc_type = "ZeroGradient"
    m.bc["top"].bc_type = "DiffuseWall"
    m.bc["top"]["specifiedXVelocity"] = 0.3


LAYOUTS = {"walls": (layout_walls, None), "ports": (layout_ports, None),
           "periodic": (layout_periodic, ("left", "right"))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_refresh_ghosts_per_bc_type(layout):
    configure, periodic = LAYOUTS[layout]
    jm, tm = pair(4, 3, configure, periodic=periodic)
    for k in jm.params:
        a, b = np.asarray(jm.params[k]), tm.params[k].numpy()
        if k.startswith(("refl_idx", "periodic_src")):
            assert np.array_equal(a, b), k
        else:
            close(b, a, 1e-15)
    f = seeded_f(jm, 2)
    gj = np.asarray(jm._refresh_ghosts(jm.mesh, jm.params, jnp.asarray(f),
                                       jm._resolve_bcvals()))
    gt = tm._refresh_ghosts(tm.mesh, tm.params, tt(f),
                            tm._resolve_bcvals()).numpy()
    close(gt, gj, TOL)
    # every ghost row was written (no group left at its owner copy but the
    # zero-gradient one)
    assert not np.array_equal(gj, f)


@pytest.mark.parametrize("collision", ["BGK", "ESBGK"])
def test_equilibrium(collision):
    def conf(m):
        couette(m)
        m.options["collisionModel"] = collision

    jm, tm = pair(3, 4, conf)
    f = seeded_f(jm, 3)
    close(tm._equilibrium(tt(f)).numpy(),
          np.asarray(jm._equilibrium(jnp.asarray(f))), TOL)
    m = f @ np.asarray(jesbgk._psi_weights(jm.quadrature, jnp.float64))
    close(tesbgk._psi_weights(tm.quadrature, tt(f)).numpy(),
          np.asarray(jesbgk._psi_weights(jm.quadrature, jnp.float64)), 0.0)
    import jax

    Uj = np.asarray(jax.vmap(jax.jacfwd(jm._feq_of_moments))(jnp.asarray(m)))
    Ut = tm._collision_jacobian(tt(m)).numpy()
    close(Ut, Uj, TOL)


def test_operator_woodbury_and_transpose():
    jm, tm = pair(3, 4, couette)
    f = seeded_f(jm, 4)
    v = np.random.default_rng(5).standard_normal(f.shape)
    nc, N = f.shape
    pin = np.zeros((nc, 1), bool)
    pin[[1, 5]] = True
    Vt = np.asarray(jesbgk._psi_weights(jm.quadrature, jnp.float64))
    rng = np.random.default_rng(6)
    U = rng.standard_normal((nc, N, 5)) * 0.01
    kappa = rng.uniform(0.0, 1.0, (nc, 1))
    dE = rng.uniform(1.0, 2.0, (nc, 1))
    for lowrank, p in ((None, None), ((kappa, U, Vt), None),
                       ((kappa, U, Vt), pin)):
        jop = jesbgk._KineticOperator(
            jm.mesh, jm.params["dO"], jm.params["dN"], jnp.asarray(dE),
            lowrank=None if lowrank is None else tuple(
                jnp.asarray(a) for a in lowrank),
            pin=None if p is None else jnp.asarray(p))
        top = tesbgk._KineticOperator(
            tm.mesh, tm.params["dO"], tm.params["dN"], tt(dE),
            lowrank=None if lowrank is None else tuple(tt(a)
                                                       for a in lowrank),
            pin=None if p is None else tt(p))
        close(top.diag.numpy(), np.asarray(jop.diag), TOL)
        close(top.mv(tt(v)).numpy(), np.asarray(jop.mv(jnp.asarray(v))), TOL)
        close(top.jacobi_step(tt(f), tt(v), 0.7).numpy(),
              np.asarray(jop.jacobi_step(jnp.asarray(f), jnp.asarray(v),
                                         0.7)), TOL)
        if lowrank is None:
            continue
        jw, tw = jesbgk._WoodburyPrecond(jop), tesbgk._WoodburyPrecond(top)
        close(tw.precond_setup(top)(tt(v)).numpy(),
              np.asarray(jw.precond_setup(jop)(jnp.asarray(v))), TOL)
        MT = tw.precond_setup_T(top)
        close(MT(tt(v)).numpy(),
              np.asarray(jw.precond_setup_T(jop)(jnp.asarray(v))), TOL)
        # the transpose is exact: <M^T a, b> = <a, M b>
        a = tt(rng.standard_normal(f.shape))
        lhs = float(torch.sum(MT(a) * tt(v)))
        rhs = float(torch.sum(a * tw.precond_setup(top)(tt(v))))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_small_solve_matches_gauss_jordan():
    from fvm_tpu.linear.dense import batched_small_solve as jsolve

    rng = np.random.default_rng(7)
    A = np.eye(5) + 0.1 * rng.standard_normal((9, 5, 5))
    b = rng.standard_normal((9, 5))
    close(tesbgk.batched_small_solve(tt(A), tt(b)).numpy(),
          np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b))), 1e-15)


# --- post-processing on fvm_tpu's state ------------------------------------


def test_postprocessing_on_loaded_state():
    def conf(m):
        layout_walls(m)
        m.options["collisionModel"] = "ESBGK"

    jm, tm = pair(4, 3, conf)
    f = seeded_f(jm, 10)
    jm.state["f"] = jnp.asarray(f)
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()},
                     {k: np.asarray(v) for k, v in jm.params.items()})
    for a, b in zip(jm.moments(), tm.moments()):
        close(b.numpy(), np.asarray(a), TOL)
    close(tm.stress().numpy(), np.asarray(jm.stress()), TOL)
    close(tm.heat_flux().numpy(), np.asarray(jm.heat_flux()), TOL)
    for g in ("left", "right", "bottom", "top"):
        close(tm.getMomentumFluxIntegral(g), jm.getMomentumFluxIntegral(g),
              TOL)
    # the collision term's moments are differences of O(1) moments: held
    # to 1e-14 absolute
    np.testing.assert_allclose(tm.conservation_error(),
                               jm.conservation_error(), rtol=0, atol=1e-14)


# --- interop and configuration errors --------------------------------------


def test_interop_round_trip():
    def conf(m):
        layout_periodic(m)
        m.options["transient"] = True

    jm, tm = pair(8, 4, conf, periodic=("left", "right"))
    solid = np.zeros(32, bool)
    solid[[10, 11, 18, 19]] = True
    jm.set_immersed_boundary(solid, wall_velocity=(0.1, 0.0),
                             pad_faces=12)
    state = {k: np.asarray(v) for k, v in jm.state.items()}
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    assert {"f", "f_N1"} <= set(state) and "ib_mdot_s" in params
    load_model_state(tm, state, params)
    for k, v in params.items():
        assert np.array_equal(tm.params[k].cpu().numpy(), v), k
    for k, v in state.items():
        assert np.array_equal(tm.state[k].numpy(), v), k
    assert tm.params["ib_solid_cell"].dtype == torch.int64
    # and back into a fresh port model
    (tm2,) = pair(8, 4, conf, periodic=("left", "right"),
                  packages=("torch",))
    load_model_state(tm2, tm.getPersistenceData(),
                     {k: v.cpu().numpy() for k, v in tm.params.items()})
    for k, v in tm.params.items():
        assert torch.equal(tm2.params[k], v), k
    # the port's own IB tables equal fvm_tpu's (the wall Maxwellian is
    # evaluated by each package's exp: 1e-15)
    (tm3,) = pair(8, 4, conf, periodic=("left", "right"),
                  packages=("torch",))
    tm3.set_immersed_boundary(solid, wall_velocity=(0.1, 0.0),
                              pad_faces=12)
    for k in ("ib_pin", "ib_solid_cell", "ib_fluid_cell", "ib_mdot_s"):
        assert np.array_equal(tm3.params[k].numpy(), params[k]), k
    close(tm3.params["ib_Mw"].numpy(), params["ib_Mw"], 1e-15)
    # an immersed-boundary table the model has not got yet is checked for
    # its kind
    (tm4,) = pair(8, 4, conf, periodic=("left", "right"),
                  packages=("torch",))
    with pytest.raises(ValueError, match="integer"):
        load_model_state(tm4, state, dict(params, ib_solid_cell=np.zeros(
            12, np.float64)))


def test_config_errors():
    dm = build_device_mesh(tgen.quad_2d(4, 4), dtype="float64", device="cpu")
    for kw in ({"partition": object()}, {"ordinate_shards": 2}):
        with pytest.raises(ConfigError, match="queue 1 item 8"):
            TKinetic(dm, TQuad(*QUAD), **kw)
    with pytest.raises(ConfigError, match="float64"):
        TKinetic(build_device_mesh(tgen.quad_2d(4, 4), dtype="float32",
                                   device="cpu"))
    m = TKinetic(dm, TQuad(*QUAD))
    couette(m)
    with pytest.raises(ConfigError):
        m.advance(1)
    with pytest.raises(ConfigError):
        m.set_immersed_boundary(np.ones(16, bool))
    m.options["verbose"] = False
    m.init()
    with pytest.raises(ConfigError):
        m.updateTime()
    with pytest.raises(ConfigError):
        m.getIBForceIntegral()
    with pytest.raises(ConfigError, match="no IB faces"):
        m.set_immersed_boundary(np.zeros(16, bool))
    with pytest.raises(ConfigError, match="pad_faces"):
        m.set_immersed_boundary(np.arange(16) < 8, pad_faces=2)
    with pytest.raises(ConfigError, match="unknown param"):
        m.solve_tangent(param_tangents={"nope": 1.0})
    m.set_immersed_boundary(np.arange(16) == 5)
    with pytest.raises(ConfigError, match="immersed boundary"):
        m.solve_adjoint(lambda f: f.sum())
    m.options["solver"] = "sweep"
    with pytest.raises(ConfigError, match="COMET"):
        m.solve_tangent(param_tangents={"tau": 1.0})
