"""BatteryModel against fvm_tpu (float64, CPU): the steady cases.

The cases of ``tests/test_battery.py:36-250`` but the distributed one, run
by both packages from the same inputs, with the JAX test's own checks on
the port's results; the transient ones are in
``test_torch_battery_transient.py``, which shares this file's helpers:

* the 1D sandwich cell (quad_2d(30, 2), 0.05 V over the OCV): the terminal
  current against the series-resistance model (5%), its conservation, the
  potential profile, the heat balance I * 0.05 (5%), the heat fed to the
  port's ThermalModel;
* the double-shell cell (quad_2d(16, 4) split by ``make_interface``): the
  steady potential against the exact profile (1e-12 absolute), the heat
  balance I (V_term - U0) (1e-9).

Against fvm_tpu: potentials, concentrations, currents and heat sources to
1e-8 of the largest entry, both Newton loops stopping at the same outer
iteration, and the first outer residual to 1e-12.  The later residuals
are not compared: fvm_tpu's own move by up to 0.69 relative under a
1e-15 change of the applied potential or current (0.095-0.69 with the
default inner solve, 3.5e-7-4.8e-3 with one at 1e-12), while its
converged unknowns move by at most 7.1e-18 of their largest entry
(``scripts/roundoff_sensitivity.py --cases battery``): the inner
BiCGStab(Jacobi(3), 1e-8, 300) on these nearly singular Jacobians
amplifies rounding from its tenth trip.  The port's products are
reverse-mode on the CPU (exact, another rounding).  The
residual at a random state to 1e-12; J v against ``jax.jvp`` to 1e-12;
``species_interface_flux`` to 1e-14; the adjoint (inner solves at
1e-12 in both) to 1e-8, and the port's tangent against its adjoint
(duality) to 1e-8; fvm_tpu's converged state and params loaded with
``interop.load_model_state``: heat source and current to 1e-8, a Newton
step from there stays at the solution.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.mesh.metrics import compute_geometry as jgeometry
from fvm_tpu.models.battery import (BatteryModel as JBattery,
                                    species_interface_flux as jflux)
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import BiCGStab as TBiCGStab
from fvm_tpu_torch.linear import JacobiSolver as TJacobi
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import (FARADAY, BatteryModel as TBattery,
                                  ThermalModel, species_interface_flux)
from fvm_tpu_torch.models.battery import RGAS
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

RTOL = 1e-8
SYS_RTOL = 1e-12


def _sandwich(cls, dm, V_applied, transient=False):
    m = cls(dm)
    m.options["verbose"] = False
    if transient:
        m.options["transient"] = True
        m.options["timeStep"] = 5.0
    x = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
    m.set_material_regions(np.where(x < 1 / 3, 0, np.where(x < 2 / 3, 1, 2)))
    m.vc["openCircuitVoltage"] = (0.1, 0.0, 3.8)
    m.vc["conductivity"] = (100.0, 1.0, 100.0)
    m.vc["exchangeCurrentDensity"] = 10.0
    m.bc["left"].bc_type = "SpecifiedPotential"
    m.bc["left"]["specifiedPotential"] = 0.0
    m.bc["right"].bc_type = "SpecifiedPotential"
    m.bc["right"]["specifiedPotential"] = V_applied
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def sandwich(nx=30, V_applied=3.75, transient=False):
    jdm = jfvm.mesh.build_device_mesh(jgen.quad_2d(nx, 2), dtype=jnp.float64)
    tdm = build_device_mesh(tgen.quad_2d(nx, 2), dtype="float64",
                            device="cpu")
    return (_sandwich(JBattery, jdm, V_applied, transient),
            _sandwich(TBattery, tdm, V_applied, transient))


def _shell(cls, gen, build, geometry, transient, I=5.0, sig_e=1.0,
           sig_s=10.0, dt=20.0):
    m = gen.quad_2d(16, 4, lx=2.0, ly=1.0)
    left = geometry(m).cell_centroid[: m.n_interior_cells, 0] < 1.0
    m2 = m.make_interface("sep", m.interface_faces_between(left, ~left),
                          left_cells=left)
    b = cls(build(m2))
    b.options["verbose"] = False
    if transient:
        b.options["transient"] = True
        b.options["timeStep"] = dt
    xc2 = geometry(m2).cell_centroid[: m2.n_interior_cells, 0]
    b.set_material_regions(np.where(xc2 < 1.0, 1, 2))
    b.vc["conductivity"] = (100.0, sig_e, sig_s)
    b.vc["diffusivity"] = (1e-2, 1e-2, 1e-2)
    b.bc["left"].bc_type = "SpecifiedPotential"
    b.bc["left"]["specifiedPotential"] = 0.0
    b.bc["right"].bc_type = "SpecifiedCurrent"
    b.bc["right"]["specifiedCurrent"] = I
    b.bc["top"].bc_type = "Symmetry"
    b.bc["bottom"].bc_type = "Symmetry"
    b.init()
    return b, np.asarray(xc2)


def shell(transient=False, **kw):
    from fvm_tpu_torch.mesh import compute_geometry

    jb = _shell(JBattery, jgen,
                lambda m: jfvm.mesh.build_device_mesh(m, dtype=jnp.float64),
                jgeometry, transient, **kw)
    tb = _shell(TBattery, tgen,
                lambda m: build_device_mesh(m, dtype="float64",
                                            device="cpu"),
                compute_geometry, transient, **kw)
    return jb, tb


@pytest.fixture(scope="module")
def steady_shell():
    """Both packages' steady double-shell cell, advanced together."""
    (jb, _), (tb, xc2) = shell()
    return jb, tb, xc2, same_run(jb, tb, 30)


def same_run(jm, tm, niter):
    hj, ht = jm.advance(niter), tm.advance(niter)
    assert len(ht) == len(hj)
    assert ht[0][1] == pytest.approx(hj[0][1], rel=SYS_RTOL)
    close(tm.getPotential(), jm.getPotential(), RTOL)
    close(tm.getConcentration(), jm.getConcentration(), RTOL)
    return ht


def tight(m, jax_side):
    bic, jac = (JBiCGStab, JJacobi) if jax_side else (TBiCGStab, TJacobi)
    s = bic(preconditioner=jac(sweeps=3), relative_tolerance=1e-12,
            max_iterations=600)
    if not jax_side:
        s.exit_every = 10
    m.options["linearSolver"] = s
    if not jax_side:
        m._drop_compiled()


def test_sandwich_current_profile_and_heat():
    jm, tm = sandwich()
    hist = same_run(jm, tm, 25)
    assert hist[-1][1] / hist[0][1] < 1e-6
    i_in, i_out = tm.getCurrentIntegral("right"), tm.getCurrentIntegral("left")
    assert i_in + i_out == pytest.approx(0.0, abs=1e-6 * abs(i_in))
    assert i_in == pytest.approx(jm.getCurrentIntegral("right"), rel=RTOL)
    R_ct = RGAS * 300.0 / (FARADAY * 10.0)
    R_ohm = (1 / 3) / 100.0 + (1 / 3) / 1.0 + (1 / 3) / 100.0
    assert abs(i_in) == pytest.approx(0.05 / (R_ohm + 2 * R_ct), rel=0.05)
    phi = tm.getPotential().reshape(30, 2).mean(axis=1)
    x = np.linspace(1 / 60, 1 - 1 / 60, 30)
    assert np.ptp(phi[x < 0.3]) < 0.002 and np.ptp(phi[x > 0.7]) < 0.002
    assert phi[15] < phi[-1] - 3.0
    q = tm.get_heat_source()
    close(q, jm.get_heat_source(), RTOL)
    V = tm.mesh.cell_volume[: tm.mesh.n_interior_cells].numpy()
    assert float((q * V).sum()) == pytest.approx(abs(i_in) * 0.05, rel=0.05)
    assert (q >= -1e-12).all()
    # the heat warms a ThermalModel on the same mesh
    t = ThermalModel(tm.mesh)
    t.options["verbose"] = False
    t.vc["heatSource"] = q * 1e3
    t.vc["initialTemperature"] = 300.0
    for s in ("left", "right"):
        t.bc[s].bc_type = "SpecifiedTemperature"
        t.bc[s]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    t.advance(5)
    T = t.getTemperature()
    assert T.max() > 300.0 + 1e-3 and T.min() >= 300.0 - 1e-9


def test_double_shell_steady_exact_and_heat(steady_shell):
    sig_e, sig_s, I = 1.0, 10.0, 5.0
    jb, tb, xc2, hist = steady_shell
    assert hist[-1][1] / hist[0][1] < 1e-10 and len(hist) <= 6
    ce0 = cs0 = 1000.0
    j0 = FARADAY * 6.33e-10 * np.sqrt(ce0) * np.sqrt(26390.0 - cs0) \
        * np.sqrt(cs0)
    fRT = FARADAY / (RGAS * 300.0)
    eta = 2.0 / fRT * np.arcsinh(I / (2 * j0))
    exact = np.where(xc2 < 1.0, I / sig_e * xc2,
                     I / sig_e + 3.8 + eta + I / sig_s * (xc2 - 1.0))
    np.testing.assert_allclose(tb.getPotential(), exact, atol=1e-12)
    assert tb.getCurrentIntegral("right") == pytest.approx(I)
    assert tb.getCurrentIntegral("left") == pytest.approx(-I, rel=1e-10)
    q = tb.get_heat_source()
    close(q, jb.get_heat_source(), RTOL)
    Q_total = float((q * 2.0 / 64.0).sum())
    V_term = float(tb.getPotential().max())
    assert Q_total == pytest.approx(I * V_term - I * 3.8, rel=1e-9)


def test_loaded_state_and_params(steady_shell):
    """fvm_tpu's converged state and params (the int ``mat``, the bool
    ``iface`` and the 0-d kinetic constants among them) loaded into a fresh
    port model: the same heat source and current, and a Newton step from
    there stays at the solution."""
    jb = steady_shell[0]
    (_, _), (fresh, _) = shell()
    load_model_state(fresh, {k: np.asarray(v) for k, v in jb.state.items()},
                     {k: np.asarray(v) for k, v in jb.params.items()})
    assert fresh.params["mat"].dtype == torch.int32
    assert fresh.params["iface"].dtype == torch.bool
    close(fresh.get_heat_source(), jb.get_heat_source(), RTOL)
    assert fresh.getCurrentIntegral("left") == pytest.approx(
        jb.getCurrentIntegral("left"), rel=RTOL)
    h = fresh.advance(1)
    assert h[0][1] <= 1e-9 * 5.0


@pytest.mark.parametrize("transient", [False, True])
def test_residual_and_jv_equal_fvm_tpu(transient):
    """R and J v at a random state near the start (shell cell), J v in
    both CPU product modes of the port."""
    from fvm_tpu_torch.linear.base import newton_operator

    (jb, _), (tb, _) = shell(transient=transient)
    rng = np.random.default_rng(7)
    n = tb.mesh.n_cells
    u0 = np.asarray(tb._unknowns(tb.state))
    u = u0 + 0.01 * rng.normal(size=u0.shape)
    v = rng.normal(size=u0.shape)
    bj, bt = jb._resolve_bcvals(), tb._resolve_bcvals()

    def rj(uu):
        return jb._system(jb.mesh, jb.params, jb.state, bj, uu)[1]

    r_ref, jv_ref = jax.jit(lambda a, b: jax.jvp(rj, (a,), (b,)))(
        jnp.asarray(u), jnp.asarray(v))
    ut = torch.from_numpy(u.copy())
    r = tb._system(tb.mesh, tb.params, tb.state, bt, ut)[1]
    close(r.numpy(), np.asarray(r_ref), SYS_RTOL)
    for mode in ("forward", "reverse"):
        mv = newton_operator(
            lambda uu: tb._system(tb.mesh, tb.params, tb.state, bt, uu)[1],
            ut, mode)
        close(-mv(torch.from_numpy(v)).numpy(), np.asarray(jv_ref), SYS_RTOL)
    assert n == u0.shape[0]


def test_species_interface_flux_equals_fvm_tpu():
    rng = np.random.default_rng(2)
    ce = rng.uniform(0.0, 2000.0, 40)
    cs = rng.uniform(-10.0, 27000.0, 40)
    for eta in (0.02, np.linspace(-0.1, 0.1, 40)):
        ref = np.asarray(jflux(eta)(jnp.asarray(ce), jnp.asarray(cs)))
        got = species_interface_flux(eta)(torch.from_numpy(ce),
                                          torch.from_numpy(cs)).numpy()
        close(got, ref, 1e-14)


def check_tangent_adjoint(jb, tb, xc2, transient):
    """The adjoint of the mean electrode potential in (kReact, sigma) and
    the current against fvm_tpu's, and the tangent in the same direction
    against it (the shell closure is the reaction's, so kReact reaches the
    potential; the electrode's Li content is fixed by dt I / F, so a
    concentration functional would have no gradient)."""
    for m, jside in ((jb, True), (tb, False)):
        tight(m, jside)
    n = tb.mesh.n_interior_cells
    dsig = np.random.default_rng(5).uniform(0.5, 1.5, n)
    tans = {"kReact": 1e-10, "sigma": dsig}
    # fvm_tpu's tangent runs op by op (~17 s here): the port's is held
    # through the duality with its adjoint, which is held to fvm_tpu's
    dt_ = tb.solve_tangent(tans)
    w = np.where(xc2 >= 1.0, 1.0 / n, 0.0)

    def fun_t(u):
        return torch.sum((u[:, 1] if transient else u) * torch.from_numpy(w))

    def fun_j(u):
        return jnp.sum((u[:, 1] if transient else u) * jnp.asarray(w))

    keys = ("kReact", "sigma")
    gt = tb.solve_adjoint(fun_t, keys, ("right:specifiedCurrent",))
    gj = jb.solve_adjoint(fun_j, keys, ("right:specifiedCurrent",))
    assert gt["kReact"] == pytest.approx(gj["kReact"], rel=RTOL)
    close(gt["sigma"], gj["sigma"], RTOL)
    close(gt["right:specifiedCurrent"], gj["right:specifiedCurrent"], RTOL)
    tang = float(np.sum((dt_[:, 1] if transient else dt_) * w))
    adj = 1e-10 * gt["kReact"] + float(np.sum(gt["sigma"] * dsig))
    assert adj == pytest.approx(tang, rel=RTOL)


def test_tangent_adjoint_and_duality(steady_shell):
    check_tangent_adjoint(*steady_shell[:3], transient=False)
