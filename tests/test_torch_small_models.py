"""The small models against fvm_tpu (float64, CPU): fracture (the
source-steady case of ``tests/test_small_models.py:39`` and a transient
driven case), the ideal-gas density, the Rosseland conductivity, the Sod
shock tube, 1D conduction (exact profile and the batched Monte Carlo),
``TimeStepController`` and ``KSearchTree`` / ``Octree`` / ``AABB``.
Tolerances: the fields to 1e-10 of the largest entry (the explicit and
direct models to 1e-13), the controller's and the trees' answers
exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import fvm_tpu as jfvm
from fvm_tpu.core.timestep import TimeStepController as JTimeStep
from fvm_tpu.geom.search import AABB as JAABB, Octree as JOctree
from fvm_tpu.mesh import generate as jgen
from fvm_tpu.models import (FractureModel as JFracture,
                            IdealGasDensityModel as JGas,
                            OneDConduction as JOneD,
                            RosselandModel as JRosseland,
                            ShockTube as JShock,
                            ThermalModel as JThermal)
from fvm_tpu_torch.core.timestep import TimeStepController as TTimeStep
from fvm_tpu_torch.exceptions import ConfigError, DeviceError
from fvm_tpu_torch.geom import AABB as TAABB, KSearchTree, Octree as TOctree
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import (FractureModel as TFracture,
                                  IdealGasDensityModel as TGas,
                                  OneDConduction as TOneD,
                                  RosselandModel as TRosseland,
                                  ShockTube as TShock,
                                  ThermalModel as TThermal)
from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import close

RTOL = 1e-10
EXACT = 1e-13


def meshes(nx, ny):
    return (jfvm.mesh.build_device_mesh(jgen.quad_2d(nx, ny),
                                        dtype=jnp.float64),
            build_device_mesh(tgen.quad_2d(nx, ny), dtype="float64",
                              device="cpu"))


def fracture(cls, dm, transient):
    m = cls(dm)
    m.options["verbose"] = False
    m.options["transient"] = transient
    m.options["timeStep"] = 0.05
    m.vc["fractureConductivity"] = 0.3
    m.vc["fractureSource"] = 1.0
    m.vc["fractureSourceCoef"] = 4.0
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "Symmetry"
    if transient:
        m.bc["left"].bc_type = "Dirichlet"
        m.bc["left"]["specifiedPhaseFieldValue"] = 0.2
    m.init()
    return m


@pytest.mark.parametrize("transient", [False, True])
def test_fracture_matches(transient):
    jdm, tdm = meshes(8, 8)
    jm, tm = fracture(JFracture, jdm, transient), fracture(TFracture, tdm,
                                                           transient)
    rng = np.random.default_rng(4)
    n = tdm.n_cells
    src, coef = rng.uniform(0, 2, n), rng.uniform(1, 5, n)
    for step in range(3 if transient else 1):
        if transient:
            jm.set_driving_source(src * (step + 1), coef)
            tm.set_driving_source(src * (step + 1), coef)
        jm.advance(10)
        tm.advance(10)
        if transient:
            jm.updateTime()
            tm.updateTime()
        close(tm.getPhaseFieldValue(), jm.getPhaseFieldValue(), RTOL)
    if not transient:
        np.testing.assert_allclose(tm.getPhaseFieldValue(), 0.5, rtol=1e-8)


def test_ideal_gas_and_rosseland_match():
    jdm, tdm = meshes(4, 4)
    jg, tg = JGas(jdm), TGas(tdm)
    for g in (jg, tg):
        g.vc["molecularWeight"] = 28.966
        g.vc["temperature"] = np.linspace(280.0, 320.0, jdm.n_cells)
        g.vc["pressure"] = 50.0
        g.vc["urf"] = 0.7
        g.init()
        g.advance(1)
    close(tg.getDensity(), jg.getDensity(), EXACT)
    ts = []
    for cls, dm in ((JThermal, jdm), (TThermal, tdm)):
        t = cls(dm)
        t.options["verbose"] = False
        for s in ("left", "right", "bottom", "top"):
            t.bc[s].bc_type = "Symmetry"
        t.vc["initialTemperature"] = 500.0
        t.init()
        ts.append(t)
    jr, tr = JRosseland(jdm, ts[0]), TRosseland(tdm, ts[1])
    for r in (jr, tr):
        r.vc["scatteringCoefficient"] = 0.4
        r.vc["anisotropyFactor"] = 0.2
        r.vc["refractiveIndex"] = 1.3
        r.init()
        r.advance(1)
    close(tr.getConductivity(), jr.getConductivity(), EXACT)
    close(ts[1].params["k_cell"].numpy(), np.asarray(ts[0].params["k_cell"]),
          EXACT)


def test_shock_tube_matches():
    js, ts = JShock(nx=200), TShock(nx=200, device="cpu")
    js.run(0.2)
    ts.run(0.2)
    for a, b in zip(ts.primitives(), js.primitives()):
        close(a, b, EXACT, scale=1.0)
    rho = ts.primitives()[0]
    assert rho.mean() == pytest.approx((1.0 + 0.125) / 2, rel=1e-10)


def test_one_d_conduction_matches():
    jm, tm = JOneD(nx=40, kConst=2.0), TOneD(nx=40, kConst=2.0, device="cpu")
    for m in (jm, tm):
        m.setBoundaryTemperatures(400.0, 300.0)
    close(tm.solve().numpy(), np.asarray(jm.solve()), EXACT)
    x = (np.arange(40) + 0.5) / 40
    np.testing.assert_allclose(tm.solve().numpy(), 400.0 - 100.0 * x,
                               rtol=1e-12)
    ks = np.exp(np.random.default_rng(0).normal(0, 0.3, size=(16, 40)))
    Tj, Tt = np.asarray(jm.solve_mc(ks)), tm.solve_mc(ks).numpy()
    assert Tt.shape == (16, 40)
    close(Tt, Tj, EXACT)
    close(tm.solve(ks[3]).numpy(), Tj[3], EXACT)


def test_time_step_controller_matches():
    jc, tc = JTimeStep(0.1, dt_max=1.0), TTimeStep(0.1, dt_max=1.0)
    for its, conv in ((2, True), (3, True), (12, True), (5, False), (9, True),
                      (1, True), (1, True), (1, True), (1, True)):
        assert tc.update(its, conv) == jc.update(its, conv)

    class Stub:
        """A transient model's surface: options, advance, updateTime."""

        def __init__(self):
            self.options = {"relativeTolerance": 1e-6,
                            "absoluteTolerance": 1e-12}
            self.updates = 0

        def advance(self, n):
            return [(i, 10.0 ** -i) for i in range(min(n, 4))]

        def updateTime(self):
            self.updates += 1

    js, ts = Stub(), Stub()
    assert tc.step_model(ts, 3) == jc.step_model(js, 3)
    assert ts.updates == 1 and tc.dt == jc.dt
    assert ts.options["timeStep"] == js.options["timeStep"]


def test_search_structures_match():
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 1, (200, 2))
    q = rng.uniform(0, 1, (30, 2))
    jt, tt = JOctree(pts), TOctree(pts)
    dj, ij = jt.query_batch(q, 3)
    dt, it = tt.query_batch(q, 3)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert tt.getNode(q[0]) == jt.getNode(q[0])
    np.testing.assert_array_equal(np.sort(tt.getNodes(q[1], 0.2)),
                                  np.sort(jt.getNodes(q[1], 0.2)))
    np.testing.assert_array_equal(KSearchTree(pts).findNeighbors(q[2], 4),
                                  jt.findNeighbors(q[2], 4))
    ang = np.linspace(0, 2 * np.pi, 17)[:-1]
    verts = np.stack([0.5 + 0.3 * np.cos(ang), 0.5 + 0.3 * np.sin(ang)], 1)
    elems = np.stack([np.arange(16), (np.arange(16) + 1) % 16], 1)
    ja, ta = JAABB(verts, elems), TAABB(verts, elems)
    np.testing.assert_array_equal(ta.is_inside(q), ja.is_inside(q))
    np.testing.assert_array_equal(ta.segment_intersections(q, q[::-1]),
                                  ja.segment_intersections(q, q[::-1]))


def test_devices_and_partitions():
    with pytest.raises(ConfigError, match="item 8"):
        TFracture(meshes(2, 2)[1], partition=object())
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            TShock(nx=10)
        with pytest.raises(DeviceError):
            TOneD(nx=10)
