"""The sensitivities of the diffusion-family models against fvm_tpu
(float64, CPU).

The cases of ``tests/test_sensitivity.py`` on the same meshes: the
flux-driven vacancy slab (12 x 4), the thermal slab with graded
conductivity (24 x 8, left 400 K, right heat flux 10), electrostatics with
space charge and graded permittivity (16 x 8) and the flux-driven species
slab (16 x 8).  Both packages build the same case from the same numpy
inputs (directions from a seed), converge it, and ``solve_tangent`` and
``solve_adjoint`` must agree with fvm_tpu's to 1e-8 relative to the
largest entry of fvm_tpu's result (``solve_mc`` and ``solve_pc``:
``tests/test_torch_sensitivity_uq.py``).  The adjoint against the tangent (duality), the vacancy case
against its analytic solution, and a model on a partitioned mesh raises.
``jfnk_adjoint`` and the ``differentiable`` thermal step:
``tests/test_torch_sensitivity_jfnk.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import (ElectricModel as JElectric,
                            SpeciesModel as JSpecies,
                            ThermalModel as JThermal)
from fvm_tpu.models.electric import EPS0
from fvm_tpu.models.vacancy import VacancyModel as JVacancy
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import (ElectricModel as TElectric,
                                  SpeciesModel as TSpecies,
                                  ThermalModel as TThermal,
                                  VacancyModel as TVacancy)
from test_torch_newton import one_thread  # noqa: F401

RTOL = 1e-8


def close(port, ref, rtol=RTOL, scale=None):
    """``port`` against ``ref`` to ``rtol`` of the largest entry of
    ``ref`` (or of ``scale``)."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale)


def meshes(nx, ny):
    return (jfvm.mesh.build_device_mesh(jgen.quad_2d(nx, ny, lx=1.0, ly=1.0),
                                        dtype=jnp.float64),
            build_device_mesh(tgen.quad_2d(nx, ny, lx=1.0, ly=1.0),
                              dtype="float64", device="cpu"))


def lateral_symmetry(m):
    m.bc["top"].bc_type = "Symmetry"
    m.bc["bottom"].bc_type = "Symmetry"


def vacancy(cls, dm, D=2.0, q=3.0):
    m = cls(dm)
    m.options["verbose"] = False
    m.vc["vacancyDiffusivity"] = D
    m.bc["left"].bc_type = "Dirichlet"
    m.bc["left"]["specifiedConcentration"] = 1.0
    m.bc["right"].bc_type = "SpecifiedFlux"
    m.bc["right"]["specifiedVacaFlux"] = q
    lateral_symmetry(m)
    m.init()
    m.advance(5)
    return m


def thermal(cls, dm, n):
    t = cls(dm)
    t.options["verbose"] = False
    t.vc["thermalConductivity"] = 1.0 + 0.5 * np.linspace(0, 1, n)
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedHeatFlux"
    t.bc["right"]["specifiedHeatFlux"] = 10.0
    lateral_symmetry(t)
    t.init()
    t.advance(30)
    return t


def electric(cls, dm, n):
    m = cls(dm)
    m.options["verbose"] = False
    m.options["chargetransport_enable"] = False
    m.vc["dielectric_constant"] = 2.0 + np.linspace(0, 1, n)
    m.vc["initialCharge"] = 1e-8
    m.bc["left"].bc_type = "SpecifiedPotential"
    m.bc["left"]["specifiedPotential"] = 1.0
    m.bc["right"].bc_type = "SpecifiedPotential"
    m.bc["right"]["specifiedPotential"] = 0.0
    lateral_symmetry(m)
    m.init()
    m.advance(5)
    return m


def species(cls, dm, n):
    s = cls(dm)
    s.options["verbose"] = False
    s.vc["massDiffusivity"] = 1.0 + 0.5 * np.linspace(0, 1, n)
    s.bc["left"].bc_type = "SpecifiedMassFraction"
    s.bc["left"]["specifiedMassFraction"] = 1.0
    s.bc["right"].bc_type = "SpecifiedMassFlux"
    s.bc["right"]["specifiedMassFlux"] = -0.3
    lateral_symmetry(s)
    s.init()
    s.advance(20)
    return s


# model: (build function, mesh, parameter key, its scale, the state getter)
CASES = {
    "vacancy": (lambda c, dm, n: vacancy(c, dm), (12, 4), "D", 1.0,
                "get_field"),
    "thermal": (thermal, (24, 8), "k_cell", 1.0, "getTemperature"),
    "electric": (electric, (16, 8), "eps", EPS0, "getPotential"),
    "species": (species, (16, 8), "D0", 1.0, "getMassFraction"),
}
CLASSES = {"vacancy": (JVacancy, TVacancy), "thermal": (JThermal, TThermal),
           "electric": (JElectric, TElectric), "species": (JSpecies, TSpecies)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(name, fvm_tpu model, port model, n_interior, x centroids), both
    converged from the same inputs."""
    name = request.param
    build, shape, *_ = CASES[name]
    jdm, tdm = meshes(*shape)
    n = tdm.n_interior_cells
    jcls, tcls = CLASSES[name]
    jm, tm = build(jcls, jdm, n), build(tcls, tdm, n)
    getter = CASES[name][4]
    close(getattr(tm, getter)(), getattr(jm, getter)())
    x = tdm.cell_centroid[:n, 0].numpy()
    return name, jm, tm, n, x


def test_tangent_matches(pair):
    name, jm, tm, n, x = pair
    key, scale = CASES[name][2], CASES[name][3]
    direction = np.random.default_rng(1).standard_normal(n) * scale
    close(tm.solve_tangent({key: direction}),
          jm.solve_tangent({key: direction}))


def test_adjoint_matches_and_is_dual_to_the_tangent(pair):
    """The gradient of J = sum(w x) + 1e-3 sum(x^2) equals fvm_tpu's, and
    <grad, v> = dJ . solve_tangent(v) (its transposed solve at 1e-10)."""
    name, jm, tm, n, x = pair
    key, scale = CASES[name][2], CASES[name][3]
    w = 1.0 + x
    gj = jm.solve_adjoint(
        lambda u: jnp.sum(jnp.asarray(w) * u) + 1e-3 * jnp.sum(u * u),
        [key])[key]
    wt = torch.as_tensor(w)
    gt = tm.solve_adjoint(lambda u: (wt * u).sum() + 1e-3 * (u * u).sum(),
                          [key])[key]
    close(gt, gj)
    v = np.random.default_rng(2).standard_normal(n) * scale
    dx = tm.solve_tangent({key: v})
    u = getattr(tm, CASES[name][4])()
    dJ = float(np.dot(w + 2e-3 * u, dx))
    assert abs(float(np.dot(gt, v)) - dJ) <= 1e-6 * abs(dJ)


def test_two_argument_functional_matches():
    """The functional's explicit parameter dependence (the two-argument
    form: a sum of k T, as a heat-flux integral contains k) reaches the
    gradient as in fvm_tpu."""
    jdm, tdm = meshes(24, 8)
    n = tdm.n_interior_cells
    jt, tt = thermal(JThermal, jdm, n), thermal(TThermal, tdm, n)
    gj = jt.solve_adjoint(lambda u, p: jnp.sum(u * p["k_cell"][:n]),
                          ["k_cell"])["k_cell"]
    gt = tt.solve_adjoint(lambda u, p: (u * p["k_cell"][:n]).sum(),
                          ["k_cell"])["k_cell"]
    close(gt, gj)


def test_vacancy_tangent_and_samples_are_analytic():
    """phi = 1 + q x / D, so d(phi)/dD = -q x / D^2, and a scalar sample D
    gives 1 + q x / D (the first and third cases of
    ``tests/test_sensitivity.py``)."""
    _, tdm = meshes(12, 4)
    m = vacancy(TVacancy, tdm)
    n = tdm.n_interior_cells
    x = tdm.cell_centroid[:n, 0].numpy()
    np.testing.assert_allclose(m.get_field(), 1.0 + 3.0 * x / 2.0, atol=1e-9)
    np.testing.assert_allclose(m.solve_tangent({"D": np.ones(n)}),
                               -3.0 * x / 4.0, atol=1e-8)
    Ds = np.random.default_rng(0).uniform(1.0, 4.0, size=3)
    for sol, D in zip(m.solve_mc("D", Ds, niter=6), Ds):
        np.testing.assert_allclose(sol, 1.0 + 3.0 * x / D, atol=1e-6)


def test_partitioned_model_raises():
    """The distributed branches wait for ROADMAP queue 1 item 8."""
    _, tdm = meshes(12, 4)
    m = vacancy(TVacancy, tdm)
    m.partition = object()
    n = tdm.n_interior_cells
    for call in (lambda: m.solve_tangent({"D": np.ones(n)}),
                 lambda: m.solve_adjoint(lambda u: u.sum(), ["D"]),
                 lambda: m.solve_mc("D", [1.0], niter=1)):
        with pytest.raises(ConfigError, match="item 8"):
            call()
