"""Double-shell interfaces in the port against fvm_tpu (float64, CPU).

* ``ThermalModel`` on a split plate (``Mesh.make_interface``): the
  continuous closure reproduces the unsplit profile; the linear jump
  phi_R = A phi_L + B with dissimilar conductivities (both orientations
  of ``left_cells``) and the contact-resistance flux closure (the thermal
  shell test, ``tests/test_interfaces.py:458-511``) reproduce the exact
  piecewise-linear profiles to 1e-8; a nonlinear (sinh) closure converges
  and the balance and closure rows with ``weight_R`` and ``urf``
  assemble to fvm_tpu's ``(A, r)`` to 1e-12; histories to 1e-8.
* ``ElectricModel``'s dielectric shell (``:268``): the series capacitor's
  exact potential (rtol 1e-8, atol 1e-10) and ``(A, r)`` to 1e-12.
* ``cases.two_material_plate`` at 64 x 16: the periodic variant's series
  profile to 1e-8 and its history against fvm_tpu's model of the same
  configuration to 1e-8; the Mixed variant's energy balance (the heat
  flows over all groups sum to 0) and temperatures against fvm_tpu to
  1e-8; the ``outerChunk`` advance (the closure's derivatives inside the
  chunk) equals the eager one.
* A model without interface support raises ``ConfigError`` on such a
  mesh.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.models.electric import ElectricModel as JElectric
from fvm_tpu_torch import cases
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.models import EPS0, ElectricModel, FlowModel
from test_torch_newton import one_thread  # noqa: F401
from test_torch_periodic import (configure_pair, device_pair, same_history,
                                 same_system, set_state)


def _split(pkg, nx=16, ny=4, flip=False, name="mid"):
    m = pkg.quad_2d(nx, ny, lx=2.0, ly=1.0)
    xc = jfvm.mesh.compute_geometry(m).cell_centroid[: m.n_interior_cells, 0]
    left = xc < 1.0
    lc = ~left if flip else left
    return m.make_interface(name, m.interface_faces_between(left, ~left),
                            left_cells=lc)


def _two_walls(k_left, k_right, T0=1.0, T1=0.0, cfg=None, jcfg=None):
    """Two-region conduction: conductivities, walls T0 | T1, symmetry top
    and bottom; ``cfg`` the port's interface options, ``jcfg`` fvm_tpu's
    (the same with its jax callables; default ``cfg``)."""
    def configure(m, cc):
        m.vc["thermalConductivity"] = np.where(cc[:, 0] < 1.0, k_left,
                                               k_right)
        jax_model = type(m).__module__.startswith("fvm_tpu.")
        c = jcfg if jax_model and jcfg is not None else cfg
        if c is not None:
            m.interface["mid"] = c
        m.bc["left"].bc_type = "SpecifiedTemperature"
        m.bc["left"]["specifiedTemperature"] = T0
        m.bc["right"].bc_type = "SpecifiedTemperature"
        m.bc["right"]["specifiedTemperature"] = T1
        m.bc["top"].bc_type = "Symmetry"
        m.bc["bottom"].bc_type = "Symmetry"
    return configure


def _exact_jump(xc, left, A, B, DL, DR, phi0=1.0, phi1=0.0):
    q = (A * phi0 + B - phi1) / (1.0 / DR + A * 1.0 / DL)
    phiR_i = A * (phi0 - q / DL) + B
    return np.where(left, phi0 - q / DL * xc, phiR_i - q / DR * (xc - 1.0))


def _xc(dm):
    return dm.cell_centroid[: dm.n_interior_cells, 0].numpy()


def test_continuous_interface_matches_unsplit():
    tdm, jdm = device_pair(_split)
    tm, jm = configure_pair(tdm, jdm, _two_walls(1.0, 1.0))
    th = tm.advance(3)
    np.testing.assert_allclose(tm.getTemperature(), 1.0 - _xc(tdm) / 2.0,
                               atol=1e-10)
    same_history(th, jm.advance(3))


@pytest.mark.parametrize("flip", [False, True])
def test_jump_interface_exact(flip):
    A, B, DL, DR = 2.0, 0.1, 1.0, 0.25
    tdm, jdm = device_pair(lambda pkg: _split(pkg, flip=flip))
    cfg = {"A_coeff": A, "B_coeff": B}
    tm, jm = configure_pair(tdm, jdm, _two_walls(DL, DR, cfg=cfg))
    th = tm.advance(3)
    xc = _xc(tdm)
    left = xc < 1.0
    if flip:
        # the right region is "L": the jump runs right to left, the mirror
        # image of the unflipped problem (walls and conductivities swapped)
        exact = _exact_jump(2.0 - xc, ~left, A, B, DR, DL, 0.0, 1.0)
    else:
        exact = _exact_jump(xc, left, A, B, DL, DR)
    np.testing.assert_allclose(tm.getTemperature(), exact, atol=1e-9)
    same_history(th, jm.advance(3))
    fin = tm.getHeatFluxIntegral("left")
    assert fin + tm.getHeatFluxIntegral("right") == pytest.approx(
        0.0, abs=1e-10 * max(abs(fin), 1.0))


def test_thermal_shell_contact_resistance():
    """The series circuit q = dT / (L1/k1 + R_c + L2/k2) of
    tests/test_interfaces.py:458-511, continuous and with the closure."""
    k1, k2, Rc, T0, T1 = 2.0, 0.5, 0.4, 400.0, 300.0
    for cfg, Rs in ((None, 0.0),
                    ({"type": "flux", "flux_fn": lambda tl, tr: (tr - tl) / Rc},
                     Rc)):
        tdm, jdm = device_pair(_split)
        tm, jm = configure_pair(tdm, jdm, _two_walls(k1, k2, T0, T1, cfg))
        th = tm.advance(5)
        xc = _xc(tdm)
        q = (T0 - T1) / (1.0 / k1 + Rs + 1.0 / k2)
        TLi = T0 - q / k1
        TRi = TLi - q * Rs
        exact = np.where(xc < 1.0, T0 - q / k1 * xc,
                         TRi - q / k2 * (xc - 1.0))
        np.testing.assert_allclose(tm.getTemperature(), exact, atol=1e-8)
        same_history(th, jm.advance(5))


def test_nonlinear_closure_rows_equal_fvm_tpu():
    """A sinh (Butler-Volmer-like) closure with weight_R and urf: (A, r)
    at a random state to 1e-12, then the outer history to 1e-8."""
    k, c = 0.8, 3.0
    tcfg = {"type": "flux", "weight_R": 0.9, "urf": 0.7,
            "flux_fn": lambda pl, pr: k * torch.sinh(c * (pr - pl))}
    jcfg = dict(tcfg, flux_fn=lambda pl, pr: k * jnp.sinh(c * (pr - pl)))
    tdm, jdm = device_pair(_split)
    tm, jm = configure_pair(tdm, jdm, _two_walls(1.0, 0.5, cfg=tcfg,
                                                 jcfg=jcfg))
    T = np.random.default_rng(2).uniform(0.0, 1.0, tdm.n_cells)
    set_state(tm, jm, "T", T)
    same_system(tm, jm)
    same_history(tm.advance(12), jm.advance(12))


def test_dielectric_shell_capacitor():
    e1, e2, ed, t_d = 2.0, 4.0, 0.5, 0.1
    V0, V1 = 5.0, 0.0
    tdm, jdm = device_pair(lambda pkg: _split(pkg, name="diel"))
    models = []
    for Model, dm in ((ElectricModel, tdm), (JElectric, jdm)):
        m = Model(dm)
        m.options["verbose"] = False
        xc = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
        m.vc["dielectric_constant"] = np.where(xc < 1.0, e1, e2)
        m.interface["diel"] = {"type": "dielectric", "constant": ed * EPS0,
                               "thickness": t_d, "charge": 1e-12}
        m.bc["left"].bc_type = "SpecifiedPotential"
        m.bc["left"]["specifiedPotential"] = V0
        m.bc["right"].bc_type = "SpecifiedPotential"
        m.bc["right"]["specifiedPotential"] = V1
        m.bc["top"].bc_type = "Symmetry"
        m.bc["bottom"].bc_type = "Symmetry"
        m.init()
        models.append(m)
    tm, jm = models
    phi = np.random.default_rng(6).standard_normal(tdm.n_cells)
    set_state(tm, jm, "potential", phi)
    same_system(tm, jm, "_linearize_potential")
    for m in models:
        m.interface["diel"]["charge"] = 0.0
        m.state["potential"] = m.state["potential"] * 0.0
    th = tm.advance(5)
    xc = _xc(tdm)
    left = xc < 1.0
    D = (V0 - V1) / (1.0 / e1 + t_d / ed + 1.0 / e2) * EPS0
    phiL_i = V0 - D / (e1 * EPS0) * 1.0
    phiR_i = phiL_i - D * t_d / (ed * EPS0)
    exact = np.where(left, V0 - D / (e1 * EPS0) * xc,
                     phiR_i - D / (e2 * EPS0) * (xc - 1.0))
    np.testing.assert_allclose(tm.getPotential(), exact, rtol=1e-8,
                               atol=1e-10)
    same_history(th, jm.advance(5))


def _jax_plate(nx, ny, walls):
    """fvm_tpu's model of ``cases.two_material_plate``'s configuration."""
    from fvm_tpu.models import ThermalModel as JThermal

    m = _split(jfvm.mesh.generate, nx, ny, name="tc")
    if walls == "periodic":
        m.make_periodic("bottom", "top")
    dm = jfvm.mesh.build_device_mesh(m, dtype=jnp.float64)
    t = JThermal(dm)
    t.options["verbose"] = False
    xc = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
    t.vc["thermalConductivity"] = np.where(xc < 1.0, *cases.PLATE_K)
    t.interface["tc"] = {"type": "flux",
                         "flux_fn": lambda tl, tr: (tr - tl) / cases.PLATE_RC}
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = cases.PLATE_T[0]
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = cases.PLATE_T[1]
    for side in ("bottom", "top"):
        if walls == "periodic":
            t.bc[side].bc_type = "Periodic"
        else:
            t.bc[side].bc_type = "Mixed"
            for k, v in cases.PLATE_MIXED.items():
                t.bc[side][k] = v
    t.options["relativeTolerance"] = cases.PLATE_RTOL
    t.init()
    return t


@pytest.mark.parametrize("walls", ["periodic", "mixed"])
def test_two_material_plate(walls):
    nx, ny = 64, 16
    t, secs = cases.two_material_plate(device="cpu", nx=nx, ny=ny,
                                       walls=walls)
    assert set(secs) == {"mesh", "interface", "periodic", "device mesh",
                         "model"}
    out = cases.plate_run(t)
    assert out["converged"] and out["outers"] <= 4
    jt = _jax_plate(nx, ny, walls)
    jh = jt.advance(cases.PLATE_MAX)
    np.testing.assert_allclose(out["history"], [h[1] for h in jh],
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(t.getTemperature(), jt.getTemperature(),
                               rtol=1e-8)
    if walls == "periodic":
        np.testing.assert_allclose(t.getTemperature(), cases.plate_exact(t),
                                   atol=1e-8)
    assert out["balance_rel"] < 1e-8
    for g, v in out["heat_flux"].items():
        assert v == pytest.approx(jt.getHeatFluxIntegral(g), rel=1e-8,
                                  abs=1e-9)


def test_plate_chunked_equals_eager():
    """The closure's forward-mode derivatives inside an ``outerChunk``
    advance: the chunk equals the eager outers."""
    eager, _ = cases.two_material_plate(device="cpu", nx=32, ny=8)
    chunked, _ = cases.two_material_plate(device="cpu", nx=32, ny=8)
    chunked.options["outerChunk"] = 3
    for m in (eager, chunked):
        m.options["relativeTolerance"] = 0.0
        m.options["absoluteTolerance"] = 0.0
    he, hc = eager.advance(5), chunked.advance(5)
    np.testing.assert_allclose([h[1] for h in hc], [h[1] for h in he],
                               rtol=1e-12)
    assert np.array_equal(chunked.getTemperature(), eager.getTemperature())


def test_model_without_interfaces_raises():
    tdm, _ = device_pair(_split)
    with pytest.raises(ConfigError, match="interfaces"):
        FlowModel(tdm)
