"""The remaining single-device boundary physics against fvm_tpu (float64,
CPU): thermal 'Radiative' and 'Mixed' walls, the flow 'SlipJump' wall and
persistence.

* ``ThermalModel._linearize`` with 'Radiative' and 'Mixed' walls (per-face
  emissivity, coefficient and far-field temperature; a random state):
  ``(A, r)`` equal fvm_tpu's to 1e-12; outer histories and temperatures to
  1e-8.
* The slip-wall Couette flow of ``tests/test_flow.py:105``: the Maxwell
  slip profile u = (y + Ls) / (H + 2 Ls) (to 3e-3, the first-order wall
  model's error on 16 rows, as there); the slip velocity at the wall; the
  ghost velocities of ``_refresh_ghosts`` equal fvm_tpu's to 1e-12 at a
  random state; the outer history against fvm_tpu to 1e-8 over the first
  outers.
* ``getPersistenceData`` / ``restart`` (``tests/test_thermal.py:191``):
  the round trip is exact; a restart after an ``outerChunk`` advance
  continues exactly as the uninterrupted chunked run.
* The tangent-only option ``differentiable`` raises ``ConfigError``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import FlowModel, ThermalModel
from fvm_tpu_torch.models.thermal import STEFAN_BOLTZMANN
from test_torch_newton import one_thread  # noqa: F401
from test_torch_periodic import (configure_pair, device_pair, same_history,
                                 same_system, set_state)


def _box(pkg):
    return pkg.quad_2d(12, 8, lx=1.5, ly=1.0)


def _walls(kind):
    def configure(m, cc):
        m.vc["thermalConductivity"] = 5.0 + cc[:, 0]
        m.vc["heatSource"] = 1e3 * cc[:, 1]
        m.bc["left"].bc_type = "SpecifiedTemperature"
        m.bc["left"]["specifiedTemperature"] = 500.0
        m.bc["right"].bc_type = "Symmetry"
        for side, n in (("bottom", 12), ("top", 12)):
            m.bc[side].bc_type = kind
            m.bc[side]["surfaceEmissivity"] = np.linspace(0.3, 0.9, n)
            m.bc[side]["heatTransferCoefficient"] = 25.0
            m.bc[side]["farFieldTemperature"] = 280.0 if side == "top" \
                else np.linspace(250.0, 320.0, n)
    return configure


@pytest.mark.parametrize("kind", ["Radiative", "Mixed", "Convective"])
def test_radiative_mixed_equal_fvm_tpu(kind):
    tdm, jdm = device_pair(_box)
    tm, jm = configure_pair(tdm, jdm, _walls(kind))
    T = 300.0 + 50.0 * np.random.default_rng(8).random(tdm.n_cells)
    set_state(tm, jm, "T", T)
    same_system(tm, jm)
    set_state(tm, jm, "T", np.full(tdm.n_cells, 300.0))
    th, jh = tm.advance(8), jm.advance(8)
    same_history(th, jh)
    np.testing.assert_allclose(tm.getTemperature(), jm.getTemperature(),
                               rtol=1e-8)
    if kind == "Radiative":
        assert STEFAN_BOLTZMANN == 5.670374419e-8
        # energy balance at convergence: the flows into the domain sum to
        # the source's total
        flows = sum(tm.getHeatFluxIntegral(g) for g in
                    ("left", "right", "bottom", "top"))
        src = float((tm.params["src"] * tdm.cell_volume)[
            : tdm.n_interior_cells].sum())
        assert flows + src == pytest.approx(0.0, abs=1e-6 * src)


def _couette(Model, dm, acc, outers):
    m = Model(dm)
    m.options["verbose"] = False
    m.vc["viscosity"] = 1.0
    # lambda = mu/p sqrt(0.5 pi R T) = 0.1: R = 8314.472/molWt = 1, T = 2/pi
    m.options["molecularWeight"] = 8314.472
    m.options["operatingTemperature"] = 2.0 / np.pi
    m.options["operatingPressure"] = 10.0
    m.bc["bottom"].bc_type = "SlipJump"
    m.bc["bottom"]["accomodationCoefficient"] = acc
    m.bc["top"].bc_type = "SlipJump"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.bc["top"]["accomodationCoefficient"] = acc
    m.bc["left"].bc_type = "PressureBoundary"
    m.bc["right"].bc_type = "PressureBoundary"
    m.init()
    return m, m.advance(outers)


def test_slip_jump_couette():
    tdm, jdm = device_pair(lambda pkg: pkg.quad_2d(4, 16))
    tm, th = _couette(FlowModel, tdm, 1.0, 400)
    y = tdm.cell_centroid[: tdm.n_interior_cells, 1].numpy()
    Ls = 0.1
    V = tm.getVelocity()
    np.testing.assert_allclose(V[:, 0], (y + Ls) / (1.0 + 2.0 * Ls),
                               atol=3e-3)
    u_bot = V[:, 0][y < y.min() + 1e-9].mean()
    assert u_bot > 0.5 * Ls / (1 + 2 * Ls)
    # the first outers against fvm_tpu, then the ghosts at a random state
    jm, jh = _couette(JFlow, jdm, 0.7, 6)
    tm2, th2 = _couette(FlowModel, tdm, 0.7, 6)
    np.testing.assert_allclose([h[1:] for h in th2], [h[1:] for h in jh],
                               rtol=1e-8, atol=1e-12)
    V = np.random.default_rng(9).standard_normal((tdm.n_cells, 2))
    set_state(tm2, jm, "velocity", V)
    jst = jm._refresh_ghosts(jm.mesh, jm.params, jm.state,
                             jm._resolve_bcvals())
    tst = tm2._refresh_ghosts(tm2.mesh, tm2.params, tm2.state,
                              tm2._resolve_bcvals())
    np.testing.assert_allclose(tst["velocity"].numpy(),
                               np.asarray(jst["velocity"]), rtol=1e-12,
                               atol=1e-14)


def _thermal(n=8, chunk=0):
    m = ThermalModel(build_device_mesh(tgen.quad_2d(n, n), dtype="float64",
                                       device="cpu"))
    m.options["verbose"] = False
    m.options["outerChunk"] = chunk
    m.options["relativeTolerance"] = 0.0
    m.bc["left"].bc_type = "SpecifiedTemperature"
    m.bc["left"]["specifiedTemperature"] = 400.0
    m.bc["right"].bc_type = "Mixed"
    m.bc["right"]["heatTransferCoefficient"] = 4.0
    m.bc["right"]["surfaceEmissivity"] = 0.6
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def test_persistence_roundtrip():
    m = _thermal()
    m.advance(3)
    data = m.getPersistenceData()
    assert set(data) == set(m.state)
    assert all(isinstance(v, np.ndarray) for v in data.values())
    m2 = _thermal()
    m2.restart(data)
    np.testing.assert_array_equal(m.getTemperature(), m2.getTemperature())
    # the restored state is a copy, not a view of the caller's arrays
    data["T"][:] = 0.0
    assert float(m2.state["T"].abs().min()) > 0.0
    # unknown keys are ignored, as in the JAX package
    m2.restart({"nope": np.zeros(3)})
    assert "nope" not in m2.state


def test_restart_after_chunked_advance():
    """Restart after an ``outerChunk`` advance: the next chunks continue
    from the restored state exactly as the uninterrupted run (on a CUDA
    mesh the runner copies the state into its graph's buffers on every
    call; on the CPU it runs eagerly)."""
    ref = _thermal(chunk=3)
    ref.advance(3)
    h_ref = ref.advance(6)
    m = _thermal(chunk=3)
    m.advance(3)
    data = m.getPersistenceData()
    m.advance(3)  # moves the state on
    m.restart(data)
    h = m.advance(6)
    assert [r[1] for r in h] == [r[1] for r in h_ref]
    np.testing.assert_array_equal(m.getTemperature(), ref.getTemperature())


def test_tangent_only_option_raises():
    """The JAX package's implicit-differentiation solves (the
    ``differentiable`` option) serve tangents only: the port's steps with
    them equal the plain steps, and reverse mode through such a step
    raises (its solves are not transposable; ``solve_adjoint`` makes its
    own)."""
    def model(differentiable):
        m = ThermalModel(build_device_mesh(tgen.quad_2d(4, 4), device="cpu",
                                           dtype="float64"))
        m.options["verbose"] = False
        for g in ("left", "right", "bottom", "top"):
            m.bc[g].bc_type = "Symmetry"
        m.bc["left"].bc_type = "SpecifiedTemperature"
        m.bc["left"]["specifiedTemperature"] = 400.0
        m.options["differentiable"] = differentiable
        m.init()
        return m

    plain, diff = model(False), model(True)
    assert [r[1] for r in diff.advance(3)] == [r[1] for r in plain.advance(3)]
    k = diff.params["k_cell"].clone().requires_grad_(True)
    T = diff._step(diff.mesh, dict(diff.params, k_cell=k), diff.state,
                   diff._resolve_bcvals())[0]["T"]
    with pytest.raises(RuntimeError, match="transposable"):
        torch.autograd.grad(T.sum(), k)
