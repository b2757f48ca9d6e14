"""The phonon BTE's pieces against fvm_tpu (float64, CPU).

The same seeded inputs go through ``fvm_tpu.kinetic.phonon`` and
``fvm_tpu_torch.kinetic.phonon``:

* ``rta_scattering_matrix`` and ``detailed_balance_correct`` bit for bit
  (host numpy in both), and the model's tables: the face speeds dO / dN,
  the reflection tables, tau per direction and band;
* on one seeded energy density, each to 1e-13 of the largest entry (the
  packages sum in other orders): ``_e0_of_T``, ``temperature``,
  ``_refresh_ghosts`` for each BC type (Reflecting at refl 0.3), gray,
  two-band and per-cell; ``_interface_ghosts`` with the DMM split, a
  one-sided t_LR, a one-sided t_RL and both; the operator's product
  (plain and with the rank-1 coupling), the Woodbury application and its
  transpose, the DSA application (two condensed AMG V-cycles) and its
  transpose;
* ``heat_flux``, ``getTemperature`` and ``getHeatFluxIntegral`` over the
  walls and the interface on fvm_tpu's state loaded with
  ``interop.load_model_state``, to 1e-13;
* the interop round trip (state and params) bit for bit, and the
  ``ConfigError`` raises of the distributed paths and the checks.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu.mesh.metrics as jmetrics
from fvm_tpu.kinetic import esbgk as jesbgk
from fvm_tpu.kinetic import phonon as jphonon
from fvm_tpu.kinetic.dsa import DSAPrecond as JDSA
from fvm_tpu.mesh import generate as jgen
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.kinetic import PhononModel as TPhonon
from fvm_tpu_torch.kinetic import esbgk as tesbgk
from fvm_tpu_torch.kinetic import phonon as tphonon
from fvm_tpu_torch.kinetic.dsa import DSAPrecond as TDSA
from fvm_tpu_torch.mesh import build_device_mesh, compute_geometry
from fvm_tpu_torch.mesh import generate as tgen
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

TOL = 1e-13
BANDS = [(0.6, 3.0, 0.02), (0.4, 1.0, 0.2)]
WALLS = ("Symmetry", "Adiabatic", "Reflecting")

PACKAGES = {
    "jax": (jgen, jmetrics.compute_geometry,
            lambda m: jfvm.mesh.build_device_mesh(m, dtype=jnp.float64),
            jphonon.PhononModel),
    "torch": (tgen, compute_geometry,
              lambda m: build_device_mesh(m, dtype="float64", device="cpu"),
              TPhonon)}


def slab(m, wall="Symmetry", tau=0.1, dsa=False):
    """Isothermal 310 / 290 left and right, ``wall`` top and bottom; the
    DSA off unless asked for (fvm_tpu builds its hierarchy in ``init``)."""
    m.options["verbose"] = False
    m.options["coarseAcceleration"] = dsa
    if tau is not None:
        m.vc["relaxationTime"] = tau
    m.bc["left"].bc_type = "Isothermal"
    m.bc["left"]["specifiedTemperature"] = 310.0
    m.bc["right"].bc_type = "Isothermal"
    m.bc["right"]["specifiedTemperature"] = 290.0
    for g in ("top", "bottom"):
        m.bc[g].bc_type = wall
        if wall == "Reflecting":
            m.bc[g]["specifiedReflection"] = 0.3


def pair(nx, ny, configure, dirs=(2, 4), bands=None, interface=None,
         packages=("jax", "torch"), **kw):
    """The same PhononModel in both packages on quad_2d(nx, ny, **kw),
    ``configure``d and initialised.  ``bands``: as the model takes them,
    or a callable of the left-cell mask (per-cell materials).
    ``interface``: the interface's options; the mesh is then split at the
    middle of x by a double-shell interface ``mid``."""
    models = []
    for name in packages:
        gen, geom, build, P = PACKAGES[name]
        mesh = gen.quad_2d(nx, ny, **kw)
        xc = geom(mesh).cell_centroid[: mesh.n_interior_cells, 0]
        left = xc < 0.5 * kw.get("lx", 1.0)
        if interface is not None:
            mesh = mesh.make_interface(
                "mid", mesh.interface_faces_between(left, ~left),
                left_cells=left)
        m = P(build(mesh), *dirs,
              bands=bands(left) if callable(bands) else bands)
        configure(m)
        if interface:
            m.interface["mid"] = dict(interface)
        m.init()
        models.append(m)
    return models


def two_materials(left):
    """Per-cell (C, vg) of two materials and a per-band tau."""
    return [(np.where(left, 0.6, 1.8), np.where(left, 3.0, 2.0), 0.05),
            (np.where(left, 0.4, 0.2), 1.0, 0.2)]


def seeded_e(m, seed=0, noise=0.05):
    """Directional energies over every cell: the equilibrium of a seeded
    temperature field times seeded noise (numpy)."""
    rng = np.random.default_rng(seed)
    C = np.asarray(m._band_arrays()[0])
    T = rng.uniform(295.0, 315.0, m.mesh.n_cells)
    Cc = C if C.ndim > 1 else np.broadcast_to(C, (m.mesh.n_cells, m.B))
    e0 = (T[:, None] - 300.0) * Cc / (4 * np.pi)
    e = np.tile(e0[:, None, :], (1, m.D, 1)).reshape(m.mesh.n_cells, -1)
    return e * (1.0 + noise * rng.standard_normal(e.shape)) \
        + noise * rng.standard_normal(e.shape)


def tt(a):
    return torch.from_numpy(np.array(a))


def jit(fn, *args):
    """fvm_tpu's side run as one compiled program (eager JAX compiles
    every operation of a new shape on its own), as numpy."""
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def jax_lowrank(jm, op, rate):
    """fvm_tpu's COMET step's (kappa, U, Vt) (``phonon.py:745-767``)."""
    D, B = jm.D, jm.B
    C = jm._band_arrays()[0]
    mesh = jm.mesh
    V = mesh.cell_volume[:, None]
    Vt = jnp.repeat(jnp.asarray(jm.w), B)[:, None]
    alive = op.interior[:, 0] & op.owned[:, 0]
    if C.ndim > 1:
        Cc = jnp.asarray(C)
        U = (jnp.tile(Cc[:, None, :], (1, D, 1)).reshape(mesh.n_cells, D * B)
             / (4.0 * np.pi * Cc.sum(axis=-1)[:, None]))[:, :, None]
    else:
        u = jnp.tile(jnp.asarray(C)[None, :], (D, 1)).reshape(-1) / (
            4.0 * np.pi * float(C.sum()))
        U = jnp.broadcast_to(u[None, :, None], (mesh.n_cells, D * B, 1))
    U = jnp.where(alive[:, None, None], U, 0.0)
    kappa = jnp.where(alive[:, None], V * rate, 0.0)
    return kappa, U, Vt


def rates(jm):
    tau = np.asarray(jm._tau_db)
    return 1.0 / (tau if tau.ndim == 2 else tau[None, :])


# --- the host helpers and the tables ---------------------------------------


def test_scattering_helpers_bit_identical():
    rng = np.random.default_rng(5)
    for tau, D, B in ((0.1, 8, 1), ([0.05, 0.2], 8, 2), (0.3, 32, 1)):
        assert np.array_equal(jphonon.rta_scattering_matrix(tau, D, B),
                              tphonon.rta_scattering_matrix(tau, D, B))
    for D, B in ((8, 1), (8, 2), (32, 1)):
        M = rng.random((D * B, D * B))
        w = rng.random(D)
        a = jphonon.detailed_balance_correct(M, w, B)
        b = tphonon.detailed_balance_correct(M, w, B)
        assert np.array_equal(a, b)
        assert np.abs(np.repeat(w, B) @ b).max() < 1e-13 * np.abs(M).max()


@pytest.mark.parametrize("bands", [None, BANDS, two_materials],
                         ids=["gray", "two-band", "per-cell"])
def test_tables_bit_identical(bands):
    jm, tm = pair(6, 4, lambda m: slab(m, "Reflecting"), bands=bands)
    assert tm.D == jm.D and tm.B == jm.B
    for k, v in jm.params.items():
        if k.startswith("refl_idx"):
            assert np.array_equal(tm.params[k].numpy(), np.asarray(v))
        else:
            close(tm.params[k].numpy(), np.asarray(v), 1e-15)
    assert sorted(tm.params) == sorted(jm.params)
    close(tm._tau_db.numpy(), np.asarray(jm._tau_db), 1e-15)
    close(tm.state["e"].numpy(), np.asarray(jm.state["e"]), 1e-15)


# --- the closures on one seeded state ----------------------------------------


@pytest.mark.parametrize("bands", [None, BANDS, two_materials],
                         ids=["gray", "two-band", "per-cell"])
@pytest.mark.parametrize("wall", WALLS)
def test_refresh_ghosts_and_temperature(wall, bands):
    jm, tm = pair(6, 4, lambda m: slab(m, wall), bands=bands)
    e = seeded_e(jm, 1)
    T = np.random.default_rng(2).uniform(290.0, 320.0, jm.mesh.n_cells)
    close(tm._e0_of_T(tt(T)).numpy(), jit(jm._e0_of_T, T), TOL)
    close(tm.temperature(tt(e)).numpy(), jit(jm.temperature, e), TOL)
    bj = jm._resolve_bcvals()
    gj = jit(lambda x: jm._refresh_ghosts(jm.mesh, jm.params, x, bj), e)
    gt = tm._refresh_ghosts(tm.mesh, tm.params, tt(e), tm._resolve_bcvals())
    close(gt.numpy(), gj, TOL)


@pytest.mark.parametrize("interface", [
    {}, {"t_LR": 0.6}, {"t_RL": [0.3, 0.5]}, {"t_LR": 0.7, "t_RL": 0.2}],
    ids=["dmm", "t_LR", "t_RL", "both"])
@pytest.mark.parametrize("bands", [BANDS, two_materials],
                         ids=["two-band", "per-cell"])
def test_interface_ghosts(interface, bands):
    jm, tm = pair(8, 3, slab, bands=bands, interface=interface, lx=2.0)
    for a, b in zip(jm._ifc["mid"], tm._ifc["mid"]):
        close(b.numpy(), np.asarray(a), 1e-15)
    e = seeded_e(jm, 3)
    gj = jit(lambda x: jm._interface_ghosts(jm.mesh, jm.params, x, "mid"), e)
    gt = tm._interface_ghosts(tm.mesh, tm.params, tt(e), "mid")
    close(gt.numpy(), gj, TOL)
    bj = jm._resolve_bcvals()
    gj = jit(lambda x: jm._refresh_ghosts(jm.mesh, jm.params, x, bj), e)
    gt = tm._refresh_ghosts(tm.mesh, tm.params, tt(e), tm._resolve_bcvals())
    close(gt.numpy(), gj, TOL)


@pytest.mark.parametrize("bands", [None, two_materials],
                         ids=["gray", "per-cell"])
def test_operator_woodbury_and_transpose(bands):
    jm, tm = pair(6, 4, slab, bands=bands)
    e = seeded_e(jm, 4)
    r = np.random.default_rng(5).standard_normal(e.shape)
    V = np.asarray(jm.mesh.cell_volume)[:, None]
    rate = rates(jm)

    def jax_side(e, r):
        op = jesbgk._KineticOperator(jm.mesh, jm.params["dO"],
                                     jm.params["dN"], V * rate)
        lr = jesbgk._KineticOperator(
            jm.mesh, jm.params["dO"], jm.params["dN"], V * rate,
            lowrank=jax_lowrank(jm, op, jnp.asarray(rate)))
        pc = jesbgk._WoodburyPrecond(lr)
        return (op.mv(e), lr.mv(e), pc.precond_setup(lr)(r),
                pc.precond_setup_T(lr)(r))

    want = [np.asarray(a) for a in jax.jit(jax_side)(jnp.asarray(e),
                                                      jnp.asarray(r))]
    top = tesbgk._KineticOperator(tm.mesh, tm.params["dO"], tm.params["dN"],
                                  tt(V * rate))
    # the coupled product: the port's (kappa, U, Vt) are those of its
    # Woodbury preconditioner, which spends them
    op_lr = top.with_lowrank(tuple(
        tt(np.asarray(a)) for a in jax_lowrank(
            jm, jesbgk._KineticOperator(jm.mesh, jm.params["dO"],
                                        jm.params["dN"], V * rate),
            jnp.asarray(rate))))
    tpc = tm._woodbury(top, tt(V), tt(rate))
    got = [top.mv(tt(e)), op_lr.mv(tt(e)), tpc.precond_setup(top)(tt(r)),
           tpc.precond_setup_T(top)(tt(r))]
    for a, b in zip(got, want):
        close(a.numpy(), b, TOL)


def test_dsa_application_and_transpose():
    """The DSA composition of the thick slab at quad_2d(32, 4) (a
    hierarchy with coarse levels), primal and transposed."""
    def thick(m):
        slab(m, tau=0.01, dsa=True)

    jm, tm = pair(32, 4, thick, dirs=(4, 8))
    e = seeded_e(jm, 6)
    r = np.random.default_rng(7).standard_normal(e.shape)
    jdsa, tdsa = jm._build_dsa(), tm._dsa_tuple()
    for a, b in zip(jdsa[1:], tdsa[1:]):
        close(b.numpy(), np.asarray(a), 1e-15)
    assert len(tdsa[0].amg.setup_structure(*tm.mesh.host_cf(),
                                           tm.mesh.device)) >= 2
    rT = r @ np.repeat(jm.w, jm.B)
    close(tdsa[0](tt(rT)).numpy(), jit(jdsa[0], rT), TOL)
    V = np.asarray(jm.mesh.cell_volume)[:, None]
    rate = rates(jm)
    jop = jesbgk._KineticOperator(jm.mesh, jm.params["dO"], jm.params["dN"],
                                  jnp.asarray(V * rate))
    top = tesbgk._KineticOperator(tm.mesh, tm.params["dO"], tm.params["dN"],
                                  tt(V * rate))
    jlr = jesbgk._KineticOperator(
        jm.mesh, jm.params["dO"], jm.params["dN"], jnp.asarray(V * rate),
        lowrank=jax_lowrank(jm, jop, jnp.asarray(rate)))
    jpc = JDSA(jesbgk._WoodburyPrecond(jlr), *jdsa)
    tpc = TDSA(tm._woodbury(top, tt(V), tt(rate)), *tdsa)
    close(tpc.precond_setup(top)(tt(r)).numpy(),
          jit(jpc.precond_setup(jlr), r), TOL)
    close(tpc.precond_setup_T(top)(tt(r)).numpy(),
          jit(jpc.precond_setup_T(jlr), r), TOL)


# --- post-processing on a loaded state -----------------------------------------


@pytest.mark.parametrize("bands", [BANDS, two_materials],
                         ids=["two-band", "per-cell"])
def test_postprocessing_on_loaded_state(bands):
    jm, tm = pair(8, 3, lambda m: slab(m, "Reflecting"), bands=bands,
                  interface={}, lx=2.0)
    e = seeded_e(jm, 8)
    jm.state["e"] = jnp.asarray(e)
    load_model_state(tm, {"e": e})
    close(tm.getTemperature(), np.asarray(jm.getTemperature()), TOL)
    close(tm.heat_flux(), np.asarray(jm.heat_flux()), TOL)
    q = [jm.getHeatFluxIntegral(g) for g in
         ("left", "right", "top", "bottom", "mid:L", "mid:R")]
    for g, want in zip(("left", "right", "top", "bottom", "mid:L", "mid:R"),
                       q):
        close(tm.getHeatFluxIntegral(g), want, TOL, scale=max(map(abs, q)))


def test_interop_round_trip():
    def conf(m):
        slab(m, "Reflecting")
        m.options["transient"] = True

    jm, tm = pair(6, 4, conf, bands=BANDS)
    e = seeded_e(jm, 9)
    state = {"e": e, "e_N1": 0.5 * e}
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    step = tm._step
    load_model_state(tm, state, params)
    for k, v in state.items():
        assert np.array_equal(tm.state[k].numpy(), v)
    for k, v in params.items():
        assert np.array_equal(tm.params[k].numpy(), v)
        assert tm.params[k].dtype == (torch.int64 if k.startswith("refl_idx")
                                      else torch.float64)
    assert tm._step is not step  # new params rebuild the step
    out = tm.getPersistenceData()
    assert set(out) == {"e", "e_N1"} and np.array_equal(out["e"], e)


def test_config_errors():
    dm = build_device_mesh(tgen.quad_2d(4, 3), dtype="float64", device="cpu")
    for kw in ({"partition": object()}, {"ordinate_shards": 2}):
        with pytest.raises(ConfigError, match="item 8"):
            TPhonon(dm, 2, 4, **kw)
    with pytest.raises(ConfigError, match="float64"):
        TPhonon(build_device_mesh(tgen.quad_2d(4, 3), dtype="float32",
                                  device="cpu"), 2, 4)
    D = 8
    M = tphonon.rta_scattering_matrix(0.1, D)
    for bad, opts, match in ((np.eye(D + 1), {}, "must be"),
                             (M, {"solver": "sweep"}, "COMET"),
                             (M - 20 * np.eye(D), {}, "positive")):
        m = TPhonon(dm, 2, 4, scattering_matrix=bad)
        slab(m)
        for k, v in opts.items():
            m.options[k] = v
        with pytest.raises(ConfigError, match=match):
            m.init()
    (m,) = pair(4, 3, slab, packages=("torch",), bands=two_materials)
    m.advance(1)
    with pytest.raises(ConfigError, match="per-cell"):
        m.solve_tangent(param_tangents={"tau": 1.0})
    for what in ("solve_tangent", "solve_adjoint"):
        (m,) = pair(4, 3, lambda m: (slab(m), m.options.__setitem__(
            "solver", "sweep")), packages=("torch",))
        with pytest.raises(ConfigError, match="COMET"):
            (m.solve_tangent() if what == "solve_tangent"
             else m.solve_adjoint(lambda e: e.sum()))
    with pytest.raises(ConfigError, match="transient"):
        m.updateTime()
    from fvm_tpu_torch.io import netcdf

    for fn in (netcdf.write_netcdf_partitioned, netcdf.read_netcdf_partitioned,
               netcdf.restore_partitioned, netcdf.save_dist_state,
               netcdf.load_dist_state):
        with pytest.raises(ConfigError, match="item 8"):
            fn("x.nc", None)
