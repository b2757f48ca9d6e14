"""DielectricChargingModel against fvm_tpu (float64, CPU).

The reference's 1x1x1000.cas and its DIALECTRIC_CHARGING golden are not in
the repository (``tests/test_charging.py`` skips without them), so both
packages run the same generated stand-in column: ``cases.
dielectric_column(150)``, hex_3d(1, 1, 150) over the reference's 200 nm
(zmin the substrate, zmax the membrane at 100 V), with the reference
script's constants.  Tolerances:

* the Fermi equilibrium init against its analytic values
  (``tests/test_charging.py:84-93``): 1e-12;
* capture and Poole-Frenkel emission alone at zero bias stay stationary
  (``tests/test_charging.py:61-82``): 1e-12;
* the static walks equal fvm_tpu's; every coefficient array of
  ``_coeffs`` at the first step's field: 1e-12 of fvm_tpu's largest entry
  (measured 2.5e-13 at most);
* the residual and its diagonal at a random state: 1e-12;
* the totalCharges history over 5 time steps (dt 1e-9 x 1.1^k, 3
  Newton iterations each): 1e-8 (measured 1.4e-15; fvm_tpu's own history
  moves by the ``charging`` spread of ``scripts/roundoff_sensitivity.py``
  under a 1e-15 change of the membrane voltage);
* ``interop.load_model_state`` with fvm_tpu's state and ``_rho_acc``:
  the next step's history entry to 1e-8; and a 2 x 2 membrane of
  columns gives the column's averages to 1e-12.

Histories and charges are compared column by column, each on its own
scale: the band charge is many orders of magnitude below the trapped.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models.charging import DielectricChargingModel as JCharging
from fvm_tpu_torch import cases
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.models import DielectricChargingConstants, fermi
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

N = 150
STEPS = 5
RTOL = 1e-8
SYS_RTOL = 1e-12


def jax_column(n=N, **kw):
    h = cases.CHARGING_THICKNESS / n
    m = JCharging(jgen.hex_3d(1, 1, n, lx=h, ly=h,
                              lz=cases.CHARGING_THICKNESS),
                  "zmin", "zmax", **kw)
    m.init()
    return m


@pytest.fixture(scope="module")
def columns():
    """Both packages' columns after STEPS time steps, and histories."""
    jm, tm = jax_column(), cases.dielectric_column(N, device="cpu")
    return jm, tm, cases.charging_run(jm, STEPS), cases.charging_run(
        tm, STEPS)


def test_fermi_equilibrium_values():
    m = cases.dielectric_column(N, device="cpu")
    x = m.state["charge"].numpy()
    F = fermi(-3.0 - 1.5, -5.0, 300.0)
    np.testing.assert_allclose(x[:, 0], 3e25 * F, rtol=1e-12)
    np.testing.assert_allclose(x[:, 1], 3e25 * F, rtol=1e-12)
    np.testing.assert_allclose(x[:, 2], 2 * 3e25 * fermi(-3.0, -5.0, 300.0),
                               rtol=1e-12)


def test_capture_emission_stationary():
    c = DielectricChargingConstants(membrane_voltage=0.0)
    m = cases.dielectric_column(N, device="cpu", constants=c,
                                space_charge=None)
    n = m._n_int
    k = m._coeffs(torch.zeros(n, dtype=torch.float64),
                  torch.zeros((n, 3), dtype=torch.float64))
    x0 = m.state["charge"].clone()
    k = dict(k, **{key: torch.zeros_like(k[key]) for key in (
        "tun_in", "tun_out", "inj", "tbt", "conv_i", "conv_b")})
    x = m._step(m.state["charge"], m.state["chargeN1"], 1e-3, k, 2)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), rtol=1e-12)


def test_walks_and_coefficients_equal_fvm_tpu():
    jm, tm = jax_column(), cases.dielectric_column(N, device="cpu")
    assert np.array_equal(tm._sub["paths"].numpy(),
                          np.asarray(jm._sub["paths"]))
    assert np.array_equal(tm._tbt_paths.numpy(), np.asarray(jm._tbt_paths))
    phi_j, E_j = jm._solve_potential()
    phi_t, E_t = tm._solve_potential()
    close(phi_t.numpy(), np.asarray(phi_j), SYS_RTOL)
    close(E_t.numpy(), np.asarray(E_j), 1e-12)
    kj = jm._coeffs(phi_j, E_j)
    kt = tm._coeffs(torch.from_numpy(np.array(phi_j)),
                    torch.from_numpy(np.array(E_j)))
    assert sorted(kj) == sorted(kt)
    for key in kj:
        close(kt[key].numpy(), np.asarray(kj[key]), SYS_RTOL)
    # the residual and its diagonal at a random state
    rng = np.random.default_rng(1)
    x = np.asarray(jm.state["charge"]) * rng.uniform(0.5, 2.0, (N, 3))
    xN1 = np.asarray(jm.state["charge"])
    kt = {key: torch.from_numpy(np.array(np.asarray(v)))
          for key, v in kj.items()}
    rt = tm._residual(torch.from_numpy(x), torch.from_numpy(xN1), 1e-9, kt)
    dt_ = tm._diag(torch.from_numpy(x), 1e-9, kt)
    # fvm_tpu's residual and diagonal are closures inside its step: its
    # Newton step from x at niter 0 is x itself, so compare through one
    # Newton iteration's update instead
    xj = np.asarray(jm._step(jnp.asarray(x), jnp.asarray(xN1),
                             jnp.asarray(1e-9), kj, niter=1))
    xt = tm._step(torch.from_numpy(x), torch.from_numpy(xN1), 1e-9, kt, 1)
    close(xt.numpy(), xj, RTOL)
    assert np.isfinite(rt.numpy()).all() and (dt_.numpy() > 0).all()


def test_history_matches_fvm_tpu(columns):
    jm, tm, hj, ht = columns
    close(ht[:, 0], hj[:, 0], 1e-15)
    for col in (1, 2):
        close(ht[:, col], hj[:, col], RTOL)
    for col in range(3):
        close(tm.state["charge"].numpy()[:, col],
              np.asarray(jm.state["charge"])[:, col], RTOL)
    close(tm.state["_rho_acc"].numpy(), np.asarray(jm._rho_acc), RTOL)
    assert ht[-1, 1] > 3 * ht[0, 1]  # the traps charge


def test_loaded_state_continues_like_fvm_tpu(columns):
    jm, _, _, _ = columns
    fresh = cases.dielectric_column(N, device="cpu")
    load_model_state(fresh, {"charge": np.asarray(jm.state["charge"]),
                             "chargeN1": np.asarray(jm.state["chargeN1"]),
                             "_rho_acc": np.asarray(jm._rho_acc)})
    dt = cases.CHARGING_DT * cases.CHARGING_SCALE ** STEPS
    hj = jm.advance_transient(2, dt)
    ht = fresh.advance_transient(2, dt)
    for col in (1, 2):
        close(ht[:, col], hj[:, col], RTOL)


def test_membrane_of_columns_gives_the_columns_averages():
    col = cases.dielectric_column(40, device="cpu")
    mem = cases.charging_membrane(2, 2, 40, device="cpu")
    hc, hm = cases.charging_run(col, 3), cases.charging_run(mem, 3)
    for j in range(3):  # each column on its own scale
        close(hm[:, j], hc[:, j], 1e-12)
