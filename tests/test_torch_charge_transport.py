"""ElectricModel's charge transport against fvm_tpu (float64, CPU).

The cases of ``tests/test_electric_species.py:60-295`` at their sizes, run
by both packages from the same inputs (random states from a seed):

* drift and diffusion in a closed box (quad_2d(16, 4), 3 x 3 transient
  outers): charge, potential and the outer residuals to 1e-8 of fvm_tpu's
  largest entry, and the charge conserved as in the JAX test;
* Fowler-Nordheim injection with capture and emission (quad_2d(12, 4),
  5 x 3 outers): free and trapped charge to 1e-8;
* trap-band tunneling (quad_2d(40, 2), 5 x 2 outers): the walks equal
  fvm_tpu's, the rates to 1e-12, the exit cells and found flags equal;
  charge and traps to 1e-8 with the total conserved to 1e-10;
* Poole-Frenkel emission (quad_2d(12, 4), 10 x 3 outers at 50 and 100 V):
  traps to 1e-8, and the decay rate against the analytic one at 5%;
* ``_linearize_charge``'s (A, r) at a random state with every term on:
  1e-12; the ``outerChunk`` advance against the eager one: 1e-12.

The charge solves are BiCGStab(Jacobi(3)) at 1e-8 in both packages (the
port's stops early every 10 trips: the same result); both run the same
trips from the same start, so their results differ by round-off (measured
below 1e-12 here), far inside the 1e-8 held.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models.electric import ElectricModel as JElectric
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import EPS0, ElectricModel as TElectric
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

RTOL = 1e-8
SYS_RTOL = 1e-12


def _model(cls, dm, opts, vc, bias):
    """An ElectricModel with ``bias`` = (left V, right V) on the x walls
    and Symmetry on y."""
    m = cls(dm)
    m.options["verbose"] = False
    m.options["chargetransport_enable"] = True
    m.options["transient"] = True
    for k, v in opts.items():
        m.options[k] = v
    for k, v in vc.items():
        m.vc[k] = v
    for g, V in zip(("left", "right"), bias):
        m.bc[g].bc_type = "SpecifiedPotential"
        m.bc[g]["specifiedPotential"] = V
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def pair(shape, opts, vc, bias, lx=1.0, ly=1.0):
    jdm = jfvm.mesh.build_device_mesh(jgen.quad_2d(*shape, lx=lx, ly=ly),
                                      dtype=jnp.float64)
    tdm = build_device_mesh(tgen.quad_2d(*shape, lx=lx, ly=ly),
                            dtype="float64", device="cpu")
    return (_model(JElectric, jdm, opts, vc, bias),
            _model(TElectric, tdm, opts, vc, bias))


def run(m, outer, inner):
    """``outer`` time steps of ``inner`` outers each; the residuals."""
    hist = []
    for _ in range(outer):
        hist += [h[1] for h in m.advance(inner)]
        m.updateTime()
    return hist


def seed_traps(jm, tm, ct0):
    """Both models' trapped charge (and its old level) set to ``ct0``."""
    n = jm.mesh.n_cells
    full = np.zeros(n)
    full[: len(ct0)] = ct0
    jm.state["trapped"] = jm.state["trapped_N1"] = jnp.asarray(full)
    tm.state["trapped"] = tm.state["trapped_N1"] = torch.from_numpy(full)


DRIFT = ({"timeStep": 1e-2},
         {"initialCharge": 1e-12, "mobility": 1.0, "diffusivity": 1e-3},
         (10.0, 0.0))
INJECT = ({"timeStep": 0.1, "injection_enable": True,
           "trapping_enable": True},
          {"dielectric_constant": 1.0 / EPS0, "initialCharge": 1e-15,
           "mobility": 1e-3, "diffusivity": 1e-4, "injectionA": 1e-5,
           "injectionB": 5.0, "trapDensity": 1.0, "captureCoefficient": 0.5,
           "emissionCoefficient": 0.01},
          (50.0, 0.0))
TBT = ({"timeStep": 0.01, "trapping_enable": True,
        "trapbandtunneling_enable": True},
       {"dielectric_constant": 1.0 / EPS0, "mobility": 0.0,
        "diffusivity": 1e-6, "trapDensity": 1.0, "trapDepth": 2.0,
        "wkbFactor": -3.0, "tunnelingRateScale": 1.0},
       (0.0, 10.0))


def pf(volts, on):
    return ({"timeStep": 0.02, "trapping_enable": True,
             "poole_frenkel_enable": on},
            {"dielectric_constant": 1.0 / EPS0, "initialTrappedCharge": 1.0,
             "mobility": 1e-6, "diffusivity": 1e-6, "trapDensity": 1.0,
             "emissionCoefficient": 0.01, "emissionFrequency": 1.0,
             "trapDepth": 1.5, "pfBeta": 0.15, "thermalVoltage": 0.5},
            (volts, 0.0))


def test_drift_conserves_charge_and_matches_fvm_tpu():
    jm, tm = pair((16, 4), *DRIFT)
    V = tm.mesh.cell_volume[: tm.mesh.n_interior_cells].numpy()
    q0 = float((tm.getCharge() * V).sum())
    hj, ht = run(jm, 3, 3), run(tm, 3, 3)
    close(ht, hj, RTOL)
    close(tm.getCharge(), jm.getCharge(), RTOL)
    close(tm.getPotential(), jm.getPotential(), RTOL)
    close(tm.getElectricField(), jm.getElectricField(), RTOL)
    assert float((tm.getCharge() * V).sum()) == pytest.approx(q0, rel=5e-3)
    c = tm.getCharge().reshape(16, 4)
    assert c[-1].mean() > c[0].mean()


def test_injection_and_trapping_match_fvm_tpu():
    jm, tm = pair((12, 4), *INJECT)
    run(jm, 5, 3), run(tm, 5, 3)
    c, ct = tm.getCharge(), tm.getTrappedCharge()
    close(c, jm.getCharge(), RTOL)
    close(ct, jm.getTrappedCharge(), RTOL)
    assert c.max() > 1e-6 and 0.0 < ct.max() <= 1.0 + 1e-9


def test_trap_band_tunneling_matches_fvm_tpu():
    nx = 40
    jm, tm = pair((nx, 2), *TBT, ly=0.05)
    dm = tm.mesh
    assert np.array_equal(tm.params["tun_path"].numpy(),
                          np.asarray(jm.params["tun_path"]))
    x = dm.cell_centroid[: dm.n_interior_cells, 0].numpy()
    ct0 = np.where(x < 0.3, 0.5, 0.0)
    seed_traps(jm, tm, ct0)
    Vc = dm.cell_volume[: dm.n_interior_cells].numpy()
    total0 = float((ct0 * Vc).sum() + (tm.getCharge() * Vc).sum())
    run(jm, 5, 2), run(tm, 5, 2)
    ct, q = tm.getTrappedCharge(), tm.getCharge()
    close(ct, jm.getTrappedCharge(), RTOL)
    close(q, jm.getCharge(), RTOL)
    assert ct[x < 0.3].sum() < ct0[x < 0.3].sum() and q.max() > 0
    assert float((ct * Vc).sum() + (q * Vc).sum()) == pytest.approx(
        total0, rel=1e-10)
    # the rates at a random field, against fvm_tpu's
    E = np.random.default_rng(3).normal(size=(dm.n_cells, 2))
    rj, ej, fj = jm._tunneling_rates(jm.mesh, jm.params, jm.state,
                                     jnp.asarray(E))
    rt, et, ft = tm._tunneling_rates(dm, tm.params, tm.state,
                                     torch.from_numpy(E))
    close(rt.numpy(), np.asarray(rj), SYS_RTOL)
    assert np.array_equal(et.numpy(), np.asarray(ej))
    assert np.array_equal(ft.numpy(), np.asarray(fj))
    src = np.where((x < 0.3) & ft.numpy())[0]
    xe = x[et.numpy()[src]]
    assert (xe > x[src] + 2.0 / 10.0 - 1e-9).all()
    assert (xe < x[src] + 2.0 / 10.0 + 1.5 / nx).all()


@pytest.mark.parametrize("volts,on", [(50.0, False), (50.0, True),
                                      (100.0, True)])
def test_poole_frenkel_decay_matches_fvm_tpu(volts, on):
    nu, depth, beta, vT, dt, nstep = 1.0, 1.5, 0.15, 0.5, 0.02, 10
    jm, tm = pair((12, 4), *pf(volts, on))
    t0 = float(tm.getTrappedCharge().sum())
    run(jm, nstep, 3), run(tm, nstep, 3)
    close(tm.getTrappedCharge(), jm.getTrappedCharge(), RTOL)
    k = -np.log(float(tm.getTrappedCharge().sum()) / t0) / (nstep * dt)
    expect = 0.01 + (nu * np.exp(-max((depth - beta * np.sqrt(volts)) / vT,
                                      0.0)) if on else 0.0)
    assert k == pytest.approx(expect, rel=0.05)


def test_linearize_charge_equals_fvm_tpu():
    """(A, r) of the charge equation at a random state with injection,
    capture, Poole-Frenkel emission and the transient term on."""
    opts, vc, bias = INJECT
    opts = dict(opts, poole_frenkel_enable=True)
    vc = dict(vc, emissionFrequency=1.0, pfBeta=0.15, thermalVoltage=0.5,
              trapDepth=1.5)
    jm, tm = pair((9, 7), opts, vc, bias)
    rng = np.random.default_rng(0)
    n = tm.mesh.n_cells
    st = {k: rng.uniform(0.0, 0.8, n) for k in ("charge", "trapped",
                                                "charge_N1")}
    st["potential"] = 50.0 * rng.uniform(size=n)
    E = 60.0 * rng.normal(size=(n, 2))
    for k, v in st.items():
        jm.state[k] = jnp.asarray(v)
        tm.state[k] = torch.from_numpy(v.copy())
    bc = jm._resolve_bcvals()
    A1, r1 = jax.jit(lambda st, e: jm._linearize_charge(
        jm.mesh, jm.params, st, bc, e))(jm.state, jnp.asarray(E))
    A2, r2 = tm._linearize_charge(tm.mesh, tm.params, tm.state,
                                  tm._resolve_bcvals(), torch.from_numpy(E))
    for a, b in ((A1.diag, A2.diag), (A1.off, A2.off), (r1, r2)):
        close(b.numpy(), np.asarray(a), SYS_RTOL)


def test_chunked_transport_equals_eager():
    _, eager = pair((12, 4), *INJECT)
    _, chunked = pair((12, 4), *INJECT)
    chunked.options["outerChunk"] = 2
    for _ in range(2):
        he = [h[1] for h in eager.advance(3)]
        hc = [h[1] for h in chunked.advance(3)]
        np.testing.assert_allclose(hc, he, rtol=1e-12)
        eager.updateTime()
        chunked.updateTime()
    close(chunked.getCharge(), eager.getCharge(), 1e-12)
    close(chunked.getTrappedCharge(), eager.getTrappedCharge(), 1e-12)


def test_partitioned_mesh_raises_item_8():
    """The distributed branch is ported (``tests/test_torch_dist.py``): a
    partition needs the rank's local mesh (``Partition.local_mesh``)."""
    dm = build_device_mesh(tgen.quad_2d(4, 4), dtype="float64", device="cpu")
    with pytest.raises(ConfigError, match="local mesh"):
        TElectric(dm, partition=object())
