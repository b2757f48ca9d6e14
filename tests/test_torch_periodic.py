"""Periodic pairs in the port against fvm_tpu (float64, CPU).

* The exact profiles of ``tests/test_periodic.py:18-66``: an x-independent
  solution on a periodic-in-x strip, and the roll invariance of an
  x-periodic source (to 1e-8); the implicit wrap converges a linear
  problem in one outer (``:121``); a 'Periodic' group without
  ``make_periodic`` raises ``ConfigError``.
* ``ThermalModel._linearize`` with 'Periodic' groups, a source and a
  random state: ``(A, r)`` equal fvm_tpu's to 1e-12 (quad 2D and hex 3D,
  ``core/bcs.periodic_rows`` and the slot-1 coupling); the periodic
  ghosts mirror their partner owners (``bcs.extend_to_ghosts``); outer
  histories and temperatures against fvm_tpu to 1e-8.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.models import ThermalModel as JThermal
from fvm_tpu_torch.core import bcs
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.linear import BiCGStab, JacobiSolver
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import ThermalModel
from test_torch_newton import one_thread  # noqa: F401

SYS_RTOL = 1e-12
HIST_RTOL = 1e-8


def device_pair(build):
    """The same host mesh (``build(generate_module)``) as a port CPU device
    mesh and a JAX package one, float64."""
    return (build_device_mesh(build(tgen), dtype="float64", device="cpu"),
            jfvm.mesh.build_device_mesh(build(jfvm.mesh.generate),
                                        dtype=jnp.float64))


def configure_pair(tdm, jdm, configure):
    """A port and a JAX ``ThermalModel`` configured by ``configure(model,
    interior centroids)`` and initialised."""
    out = []
    for Model, dm in ((ThermalModel, tdm), (JThermal, jdm)):
        m = Model(dm)
        m.options["verbose"] = False
        cc = np.asarray(dm.cell_centroid)[: dm.n_interior_cells]
        configure(m, cc)
        m.init()
        out.append(m)
    return out


def set_state(tm, jm, key, values):
    """The same state entry in both models."""
    tm.state[key] = torch.from_numpy(np.array(values))
    jm.state[key] = jnp.asarray(values)


def same_system(tm, jm, linearize="_linearize", rtol=SYS_RTOL):
    """The two models' assembled (A, r) at their current states."""
    A1, r1 = getattr(jm, linearize)(jm.mesh, jm.params, jm.state,
                                    jm._resolve_bcvals())
    A2, r2 = getattr(tm, linearize)(tm.mesh, tm.params, tm.state,
                                    tm._resolve_bcvals())
    assert np.array_equal(np.asarray(A1.cols), A2.cols.numpy())
    assert np.array_equal(np.asarray(A1.mask), A2.mask.numpy())
    for a, b in ((A1.diag, A2.diag), (A1.off, A2.off), (r1, r2)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * np.abs(a).max())


# outer residuals below this fraction of the first outer's are round-off
# floors: the default thermal solve stops at 1e-10 of its initial residual,
# and the next outer's residual is that solve's remainder, which moves by
# up to 1.5e-4 relative between the packages (2 outers of a split plate:
# 1.0017929e-08 and 1.0016374e-08 of 3388.46)
HIST_FLOOR = 1e-10


def same_history(th, jh, rtol=HIST_RTOL):
    """Outer histories to ``rtol`` above the round-off floor
    (``HIST_FLOOR`` of the first outer's residual)."""
    assert len(th) == len(jh)
    a, b = [h[1] for h in th], [h[1] for h in jh]
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=HIST_FLOOR * abs(b[0]))


def _strip(pkg, nx=8, ny=12):
    m = pkg.quad_2d(nx, ny)
    m.make_periodic("left", "right")
    return m


def _walls(bottom="SpecifiedTemperature", top="SpecifiedTemperature"):
    def configure(m, cc):
        m.options["relativeTolerance"] = 1e-14
        m.bc["left"].bc_type = "Periodic"
        m.bc["right"].bc_type = "Periodic"
        m.bc["bottom"].bc_type = bottom
        m.bc["bottom"]["specifiedTemperature"] = 400.0
        m.bc["top"].bc_type = top
        m.bc["top"]["specifiedTemperature"] = 300.0
    return configure


def test_periodic_thermal_1d_exact():
    tdm, jdm = device_pair(_strip)
    tm, jm = configure_pair(tdm, jdm, _walls())
    th = tm.advance(200)
    cc = tdm.cell_centroid[: tdm.n_interior_cells].numpy()
    np.testing.assert_allclose(tm.getTemperature(), 400.0 - 100.0 * cc[:, 1],
                               atol=1e-8)
    same_history(th, jm.advance(200))
    np.testing.assert_allclose(tm.getTemperature(), jm.getTemperature(),
                               rtol=HIST_RTOL)


def _source(shift, nx=16):
    def configure(m, cc):
        _walls(top="Symmetry")(m, cc)
        m.bc["bottom"]["specifiedTemperature"] = 300.0
        m.options["relativeTolerance"] = 1e-13
        m.vc["heatSource"] = np.cos(2 * np.pi * (cc[:, 0] - shift)) * 10.0
    return configure


def test_periodic_thermal_roll_invariance():
    """Shifting an x-periodic source by k cells shifts the solution by
    exactly k cells (the wrap carries fluxes like an interior face).  The
    implicit wrap converges in one outer, and the residual then floors at
    1.5e-12 of the first outer's in both packages, above the 1e-13 of
    ``tests/test_periodic.py:41``: 5 outers here, not 400."""
    nx, ny = 16, 4

    def solve(shift):
        tdm, jdm = device_pair(lambda pkg: _strip(pkg, nx, ny))
        tm, jm = configure_pair(tdm, jdm, _source(shift))
        th = tm.advance(5)
        cc = tdm.cell_centroid[: tdm.n_interior_cells].numpy()
        idx = np.lexsort((cc[:, 0], cc[:, 1]))
        if shift == 0.0:
            same_history(th, jm.advance(5))
        return tm.getTemperature()[idx].reshape(ny, nx)

    np.testing.assert_allclose(np.roll(solve(0.0), 4, axis=1),
                               solve(4.0 / nx), atol=1e-7)


def test_periodic_requires_pairing():
    dm = build_device_mesh(tgen.quad_2d(4, 4), dtype="float64", device="cpu")
    m = ThermalModel(dm)
    m.options["verbose"] = False
    m.bc["left"].bc_type = "Periodic"
    m.bc["right"].bc_type = "Periodic"
    m.bc["bottom"].bc_type = "SpecifiedTemperature"
    m.bc["top"].bc_type = "SpecifiedTemperature"
    with pytest.raises(ConfigError, match="make_periodic"):
        m.init()


def test_periodic_implicit_one_shot():
    """The implicit rows (slot 1 to the wrapped partner owner) converge a
    linear ring-dominated problem in ONE outer."""
    tdm, jdm = device_pair(lambda pkg: _strip(pkg, 16, 4))

    def configure(m, cc):
        _source(0.0)(m, cc)
        pkg = (JBiCGStab, JJacobi) if isinstance(m, JThermal) else (
            BiCGStab, JacobiSolver)
        m.options["linearSolver"] = pkg[0](
            relative_tolerance=1e-12, max_iterations=400,
            preconditioner=pkg[1](sweeps=3))

    tm, jm = configure_pair(tdm, jdm, configure)
    th = tm.advance(2)
    assert th[1][1] / th[0][1] < 1e-9
    np.testing.assert_allclose(th[0][1], jm.advance(2)[0][1], rtol=1e-12)


@pytest.mark.parametrize("build", [
    lambda pkg: _strip(pkg, 8, 6),
    lambda pkg: (lambda m: (m.make_periodic("xmin", "xmax"), m)[1])(
        pkg.hex_3d(4, 3, 2)),
], ids=["quad", "hex"])
def test_periodic_system_equals_fvm_tpu(build):
    tdm, jdm = device_pair(build)
    ga, gb = ("left", "right") if tdm.dim == 2 else ("xmin", "xmax")

    def configure(m, cc):
        for g in m.mesh.boundary_groups():
            m.bc[g[1]].bc_type = "Symmetry"
        m.bc[ga].bc_type = "Periodic"
        m.bc[gb].bc_type = "Periodic"
        other = [g[1] for g in m.mesh.boundary_groups()
                 if g[1] not in (ga, gb)]
        m.bc[other[0]].bc_type = "SpecifiedTemperature"
        m.bc[other[0]]["specifiedTemperature"] = 350.0
        m.vc["heatSource"] = np.sin(3.0 * cc[:, 0]) + cc[:, 1]
        m.vc["thermalConductivity"] = 1.0 + cc[:, 0] ** 2

    tm, jm = configure_pair(tdm, jdm, configure)
    T = 300.0 + np.random.default_rng(3).standard_normal(tdm.n_cells)
    set_state(tm, jm, "T", T)
    same_system(tm, jm)
    # the periodic ghosts mirror their wrapped partner owners
    x = torch.from_numpy(T)
    y = bcs.extend_to_ghosts(tdm, x)
    assert torch.equal(y[tdm.periodic_ghost], x[tdm.periodic_src])
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jfvm.core.bcs.extend_to_ghosts(
            jdm, jnp.asarray(T))))
    same_history(tm.advance(4), jm.advance(4))
