"""The phonon BTE's outer steps, sensitivities and the two-zone slice
against fvm_tpu (float64, CPU).

fvm_tpu's own phonon runs move with round-off (``python3 -m
scripts.roundoff_sensitivity --cases phonon``): under a 1e-15 change of
the hot wall's temperature the interior energy after ONE outer moves by
3.4e-14 of its largest entry on the gray slab (COMET at the default inner
solve, and Picard), but by 8.0e-10 on the two-band slab and 1.6e-9 on the
ballistic two-material slab (their inner BiCGStab stops at 1e-8 with
digits to spare) and by 1.3e-3 on the thick slab with the DSA (20 trips);
the residuals after the first move by up to 1.5 relative (a converged
COMET outer's residual is round-off).  So the comparisons here are one
outer from the same seeded state with the inner solve at 1e-12 on the
COMET path, held at 1e-12 of the largest entry; the first residual norm,
a difference of O(1) terms, at 1e-10; converged states at 1e-10:

* one outer of each path from the same state: gray (COMET, Picard,
  transient COMET), two-band (COMET, Picard), two materials across a DMM
  interface (COMET) and the full scattering matrix (COMET);
* ``solve_tangent`` in tau and the hot wall's temperature at once at
  fvm_tpu's converged gray slab (loaded with ``interop.load_model_state``)
  against fvm_tpu's to 1e-8, ``solve_tangent_temperature`` against the
  temperature's derivative of fvm_tpu's tangent, and the port's adjoint
  in tau and the wall temperature against its tangents (duality) to
  1e-8;
* ``outerChunk`` on the CPU (the chunk runs eagerly, with forward-mode
  products): the same history and state as the loop on the same step, bit
  for bit;
* the two-zone slice: a Fluent case written by ``scripts/fluent_case.py``
  read by both packages' readers, the fused-mesh route (zone masks,
  ``interface_faces_between``, ``make_interface``, per-cell materials,
  DMM), converged in both to 1e-10, the port's ``cases.phonon_two_zone``
  on the same file equal, both at the ballistic closed form, and the
  energy flux through the interface balanced.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fvm_tpu.io import read_fluent_mesh as jread
from fvm_tpu_torch import cases
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.io import read_fluent_mesh as tread
from fvm_tpu_torch.kinetic import phonon as tphonon
from test_torch_newton import one_thread  # noqa: F401
from test_torch_phonon import (BANDS, PACKAGES, pair, seeded_e, slab, tt,
                               two_materials)
from test_torch_sensitivity import close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from scripts.fluent_case import two_zone_split, write_fluent_case  # noqa: E402

OUTER_TOL = 1e-12
RNORM_TOL = 1e-10
SENS_TOL = 1e-8
CONVERGED_TOL = 1e-10


def tight(m):
    m.options["innerTolerance"] = 1e-12
    m.options["innerIterations"] = 400


def scattering(D, B=1):
    """A detailed-balance-corrected collision matrix with 30% random mode
    coupling (``tests/test_phonon_walls.py:247``)."""
    rng = np.random.default_rng(5)
    w = tphonon.sn_directions(2, 4)[1]
    M = tphonon.rta_scattering_matrix(0.1, D=D, B=B) \
        + 0.3 * rng.random((D * B, D * B)) / (D * B)
    return tphonon.detailed_balance_correct(M, w, B)


CASES = {
    "gray-COMET": (dict(), lambda m: (slab(m), tight(m))),
    "gray-sweep": (dict(), lambda m: (
        slab(m), m.options.__setitem__("solver", "sweep"))),
    "gray-transient": (dict(), lambda m: (
        slab(m), tight(m), m.options.__setitem__("transient", True),
        m.options.__setitem__("timeStep", 0.02))),
    "two-band-COMET": (dict(bands=BANDS), lambda m: (
        slab(m, "Reflecting"), tight(m))),
    "two-band-sweep": (dict(bands=BANDS), lambda m: (
        slab(m, "Adiabatic"), m.options.__setitem__("solver", "sweep"))),
    "two-materials-COMET": (dict(bands=two_materials, interface={},
                                 lx=2.0), lambda m: (slab(m), tight(m))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_outer_from_the_same_state(case):
    kw, conf = CASES[case]
    jm, tm = pair(8, 3, conf, **kw)
    e = seeded_e(jm, 11)
    jm.state = dict(jm.state, e=jnp.asarray(e))
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()})
    hj, ht = jm.advance(1), tm.advance(1)
    close(ht[0][1], hj[0][1], RNORM_TOL)
    close(tm.state["e"].numpy(), np.asarray(jm.state["e"]), OUTER_TOL)
    if jm.options["transient"]:
        jm.updateTime()
        tm.updateTime()
        close(tm.state["e_N1"].numpy(), np.asarray(jm.state["e_N1"]),
              OUTER_TOL)


def test_full_scattering_matrix_outer():
    M = scattering(8)

    def conf(m):
        slab(m)
        tight(m)

    models = []
    for name in ("jax", "torch"):
        gen, _, build, P = PACKAGES[name]
        m = P(build(gen.quad_2d(8, 3)), 2, 4, scattering_matrix=M)
        conf(m)
        m.init()
        models.append(m)
    jm, tm = models
    e = seeded_e(jm, 12)
    jm.state = dict(jm.state, e=jnp.asarray(e))
    load_model_state(tm, {"e": e})
    hj, ht = jm.advance(1), tm.advance(1)
    close(ht[0][1], hj[0][1], RNORM_TOL)
    close(tm.state["e"].numpy(), np.asarray(jm.state["e"]), OUTER_TOL)
    # converged: the walls' energy fluxes balance (energy conservation)
    h2 = tm.advance(4)
    assert h2[-1][1] < 1e-8 * ht[0][1]
    qL, qR = tm.getHeatFluxIntegral("left"), tm.getHeatFluxIntegral("right")
    assert abs(qL + qR) < 1e-9 * abs(qL)


@pytest.fixture(scope="module")
def converged():
    """fvm_tpu's gray slab (tau 0.15, 310 / 290) converged, and the port's
    model with that state loaded."""
    def conf(m):
        slab(m, tau=0.15)
        m.options["relativeTolerance"] = 1e-12

    jm, tm = pair(8, 3, conf)
    jm.advance(10)
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()})
    return jm, tm


def test_tangent_against_fvm_tpu_and_duality(converged):
    jm, tm = converged
    ni = tm.mesh.n_interior_cells
    bc = "left:specifiedTemperature"
    dtau = np.random.default_rng(3).standard_normal(tm.D * tm.B)
    both = ({"tau": dtau}, {bc: 1.0})
    dj = np.asarray(jm.solve_tangent(*both))
    close(tm.solve_tangent(*both), dj, SENS_TOL)
    # the temperature's chain rule against fvm_tpu's tangent's
    e0 = jnp.asarray(np.asarray(jm.state["e"])[:ni])
    want = jax.jvp(jm.temperature, (e0,), (jnp.asarray(dj),))[1]
    close(tm.solve_tangent_temperature(*both), np.asarray(want), SENS_TOL)
    dt_ = tm.solve_tangent(param_tangents={"tau": dtau})
    dtb = tm.solve_tangent(bc_tangents={bc: 1.0})
    # the port's adjoint of an x-weighted temperature against its tangents
    xw = tm.mesh.cell_centroid[:ni, 0]

    def J(ee):
        return torch.sum(tm.temperature(ee) * xw)

    g = tm.solve_adjoint(J, param_keys=("tau",), bc_keys=(bc,))
    assert g["tau"].shape == (tm.D * tm.B,) and g[bc].shape == (3,)
    f0 = tm.state["e"][:ni]

    def dJ(de):
        return float(torch.func.jvp(J, (f0,), (tt(de),))[1])

    for lhs, rhs in ((float(np.dot(g["tau"], dtau)), dJ(dt_)),
                     (float(np.sum(g[bc])), dJ(dtb))):
        assert abs(rhs) > 1e-6
        assert abs(lhs - rhs) <= SENS_TOL * abs(rhs)


def test_outer_chunk_equals_the_loop():
    """tests/test_chunked.py:143's case (its inner solve capped at 20
    trips): outerChunk 2 against the loop on the same (forward-product)
    step, 4 outers."""
    runs = []
    for chunk in (0, 2):
        def conf(m, chunk=chunk):
            slab(m, tau=0.1)
            m.options["outerChunk"] = chunk
            m.options["relativeTolerance"] = 0.0
            m.options["absoluteTolerance"] = 0.0
            m.options["innerIterations"] = 20

        (m,) = pair(12, 3, conf, packages=("torch",))
        if not chunk:
            m._step = m._build_step("forward")
        h = m.advance(4)
        runs.append(([r[1] for r in h], m.state["e"]))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 4
    assert torch.equal(runs[0][1], runs[1][1])


def test_two_zone_case_from_a_fluent_file(tmp_path):
    path = str(tmp_path / "two_zone.cas")
    mesh = PACKAGES["torch"][0].quad_2d(12, 4, lx=2.0)
    write_fluent_case(path, mesh, "f64", zones=two_zone_split(mesh, 1.0))
    models = []
    for read, (_, _, build, P) in ((jread, PACKAGES["jax"]),
                                   (tread, PACKAGES["torch"])):
        host = read(path)
        left = host.cell_zone_mask("left")
        m2 = host.make_interface(
            "mid", host.interface_faces_between(left, ~left),
            left_cells=left)
        m = P(build(m2), 4, 8, bands=[(np.where(left, 1.0, 3.0), 1.0, 1e8)])
        slab(m, tau=None)
        m.bc["right"]["specifiedTemperature"] = 300.0
        m.options["relativeTolerance"] = 1e-11
        m.options["innerIterations"] = 200
        m.init()
        models.append((m, m.advance(8)))
    (jm, hj), (tm, ht) = models
    close(ht[0][1], hj[0][1], RNORM_TOL)
    close(tm.getTemperature(), np.asarray(jm.getTemperature()),
          CONVERGED_TOL)
    cm = cases.phonon_two_zone(path, device="cpu")
    assert len(cm.advance(8)) == len(ht)
    assert np.array_equal(cm.getTemperature(), tm.getTemperature())
    T, left = tm.getTemperature(), cm.left_cells
    tL, tR = cases.phonon_two_zone_exact(cm)
    assert (tL, tR) == (310.0 - 5.0 * 0.75, 300.0 + 5.0 * 0.25)
    close(T[left], np.full(left.sum(), tL), 1e-7)
    close(T[~left], np.full((~left).sum(), tR), 1e-7)
    qL, qR = tm.getHeatFluxIntegral("mid:L"), tm.getHeatFluxIntegral("mid:R")
    assert abs(qL + qR) < 1e-10 * abs(qL)
    assert abs(tm.getHeatFluxIntegral("left") + qL) < 1e-6 * abs(qL)
