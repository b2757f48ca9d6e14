"""``GenericScalarModel``, ``VacancyModel`` and ``SpeciesModel`` against
fvm_tpu (float64, CPU).

Both packages build the same case from the same numpy inputs; the outer
residual histories must agree to 1e-8 (above a floor of 1e-10 of the first
outer's residual, a converged solve's round-off remainder) and the fields
and flux integrals to 1e-8 of their largest entry:

* a ``GenericScalarModel`` subclass with a linear sink (the ``_source_terms``
  hook), convection by a fixed face mass flux, per-cell diffusivity and a
  tri mesh;
* the vacancy slab, steady, and transient (BDF2) with ``updateTime``;
* two species with their own diffusivities and BCs (``bc_for``);
* the ``outerChunk`` advance against the eager one;
* each model's state and params loaded from fvm_tpu's
  (``interop.load_model_state``) give the same next step.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.core.options import (BoundaryCondition as JBC,
                                  ModelOptions as JOptions)
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import SpeciesModel as JSpecies
from fvm_tpu.models.scalar_generic import GenericScalarModel as JGeneric
from fvm_tpu.models.vacancy import VacancyModel as JVacancy
from fvm_tpu_torch.core.options import (BoundaryCondition as TBC,
                                        ModelOptions as TOptions)
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import (GenericScalarModel as TGeneric,
                                  SpeciesModel as TSpecies,
                                  VacancyModel as TVacancy)
from test_torch_newton import one_thread  # noqa: F401

RTOL = 1e-8
FLOOR = 1e-10


def same_history(th, jh):
    assert len(th) == len(jh)
    a, b = [h[1] for h in th], [h[1] for h in jh]
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=FLOOR * abs(b[0]))


def close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def meshes(kind, nx, ny):
    return (jfvm.mesh.build_device_mesh(getattr(jgen, kind)(nx, ny),
                                        dtype=jnp.float64),
            build_device_mesh(getattr(tgen, kind)(nx, ny), dtype="float64",
                              device="cpu"))


def _sink_model(base, bc, opts):
    """A GenericScalarModel with a linear sink -k phi (the source hook)."""

    class Options(opts):
        _defaults = {"transient": False, "convective": True,
                     "nonOrthogonalCorrection": True,
                     "relativeTolerance": 1e-12, "absoluteTolerance": 1e-30,
                     "verbose": False}

    class BC(bc):
        _allowed_types = ("Dirichlet", "SpecifiedFlux", "Symmetry")
        _defaults = {"specifiedValue": 0.0, "specifiedFlux": 0.0}

    class VC(bc):
        _defaults = {"diffusivity": 1.0, "initialValue": 0.0}

    class Sink(base):
        name = "SinkModel"

        def __init__(self, mesh):
            super().__init__(mesh)
            self.vc = VC()

        def _make_options(self):
            return Options()

        def _make_bc(self):
            return BC()

        def _source_terms(self, mesh, params, state, phi):
            V = mesh.cell_volume
            return 0.7 * V, -0.7 * phi * V

    return Sink


def _sink(cls, dm, n):
    m = cls(dm)
    m.vc["diffusivity"] = 0.5 + np.linspace(0, 1, n)
    m.bc["left"].bc_type = "Dirichlet"
    m.bc["left"]["specifiedValue"] = 2.0
    m.bc["right"].bc_type = "SpecifiedFlux"
    m.bc["right"]["specifiedFlux"] = 0.4
    m.bc["top"].bc_type = "Symmetry"
    m.bc["bottom"].bc_type = "Dirichlet"
    m.init()
    # a fixed face mass flux (+x on every face carrying one)
    nf = dm.n_faces
    mdot = 0.3 * np.asarray(dm.face_area)[:, 0]
    m.state["massFlux"] = (jnp.asarray(mdot) if isinstance(
        m.state["massFlux"], jnp.ndarray) else torch.as_tensor(mdot))
    assert m.state["massFlux"].shape[0] == nf
    return m


def test_generic_model_with_a_source_hook_and_convection():
    jdm, tdm = meshes("tri_2d", 10, 8)
    n = tdm.n_interior_cells
    jm = _sink(_sink_model(JGeneric, JBC, JOptions), jdm, n)
    tm = _sink(_sink_model(TGeneric, TBC, TOptions), tdm, n)
    same_history(tm.advance(12), jm.advance(12))
    close(tm.get_field(), jm.get_field())
    for g in ("left", "right", "bottom"):
        assert tm.getFluxIntegral(g) == pytest.approx(
            jm.getFluxIntegral(g), rel=RTOL, abs=RTOL)


def _vacancy(cls, dm, transient=False):
    m = cls(dm)
    m.options["verbose"] = False
    m.options["relativeTolerance"] = 1e-14
    if transient:
        m.options["transient"] = True
        m.options["timeStep"] = 0.05
        m.options["timeDiscretizationOrder"] = 2
    m.vc["vacancyDiffusivity"] = 2.0
    m.vc["initialVacancyConcentration"] = 0.5
    m.bc["left"].bc_type = "Dirichlet"
    m.bc["left"]["specifiedConcentration"] = 1.0
    m.bc["right"].bc_type = "SpecifiedFlux"
    m.bc["right"]["specifiedVacaFlux"] = 3.0
    m.bc["top"].bc_type = "Symmetry"
    m.bc["bottom"].bc_type = "Symmetry"
    m.init()
    return m


@pytest.mark.parametrize("transient", [False, True])
def test_vacancy_history(transient):
    jdm, tdm = meshes("quad_2d", 12, 4)
    jm, tm = _vacancy(JVacancy, jdm, transient), _vacancy(TVacancy, tdm,
                                                          transient)
    for _ in range(3 if transient else 1):
        same_history(tm.advance(6), jm.advance(6))
        if transient:
            jm.updateTime()
            tm.updateTime()
    close(tm.getConcentration(), jm.getConcentration())
    assert tm.getFluxIntegral("right") == pytest.approx(
        jm.getFluxIntegral("right"), rel=RTOL)


def _species(cls, dm, n):
    s = cls(dm, n_species=2)
    s.options["verbose"] = False
    s.options["relativeTolerance"] = 1e-14
    s.vcs[0]["massDiffusivity"] = 1.0 + 0.5 * np.linspace(0, 1, n)
    s.vcs[1]["massDiffusivity"] = 0.3
    for i, (left, flux) in enumerate(((1.0, -0.3), (0.2, 0.1))):
        bc = s.bc_for(i)
        bc["left"].bc_type = "SpecifiedMassFraction"
        bc["left"]["specifiedMassFraction"] = left
        bc["right"].bc_type = "SpecifiedMassFlux"
        bc["right"]["specifiedMassFlux"] = flux
        bc["top"].bc_type = "Symmetry"
        bc["bottom"].bc_type = "Symmetry"
    s.init()
    return s


def test_species_history_and_integrals():
    jdm, tdm = meshes("quad_2d", 16, 8)
    n = tdm.n_interior_cells
    jm, tm = _species(JSpecies, jdm, n), _species(TSpecies, tdm, n)
    same_history(tm.advance(8), jm.advance(8))
    for i in range(2):
        close(tm.getMassFraction(i), jm.getMassFraction(i))
        for g in ("left", "right"):
            assert tm.getMassFluxIntegral(g, i) == pytest.approx(
                jm.getMassFluxIntegral(g, i), rel=RTOL, abs=RTOL)


@pytest.mark.parametrize("model", ["vacancy", "species"])
def test_outer_chunk_equals_the_eager_advance(model):
    _, tdm = meshes("quad_2d", 12, 4)
    n = tdm.n_interior_cells
    make = ((lambda: _vacancy(TVacancy, tdm)) if model == "vacancy"
            else (lambda: _species(TSpecies, tdm, n)))
    eager, chunked = make(), make()
    chunked.options["outerChunk"] = 4
    h1, h2 = eager.advance(10), chunked.advance(10)
    assert [h[1] for h in h2] == pytest.approx([h[1] for h in h1],
                                               rel=1e-12, abs=1e-30)
    for k, v in eager.state.items():
        torch.testing.assert_close(chunked.state[k], v, rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("model", ["vacancy", "species"])
def test_loaded_state_gives_the_same_step(model):
    """fvm_tpu's state and params after 2 outers, loaded into the port:
    the next outer's residual and field agree."""
    jdm, tdm = meshes("quad_2d", 12, 4)
    n = tdm.n_interior_cells
    if model == "vacancy":
        jm, tm = _vacancy(JVacancy, jdm), _vacancy(TVacancy, tdm)
    else:
        jm, tm = _species(JSpecies, jdm, n), _species(TSpecies, tdm, n)
    jm.advance(2)
    load_model_state(tm, {k: np.asarray(v) for k, v in jm.state.items()},
                     {k: np.asarray(v) for k, v in jm.params.items()})
    rj = jm.advance(1)[0][1]
    rt = tm.advance(1)[0][1]
    assert rt == pytest.approx(rj, rel=RTOL)
    for k, v in jm.state.items():
        close(tm.state[k].numpy(), np.asarray(v))
