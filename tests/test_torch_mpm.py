"""The material-point method and its FVM coupling against fvm_tpu (CPU).

* ``MPM``'s particle files: the port writes the bytes fvm_tpu writes, and
  each package reads the other's back bit for bit.
* ``MPMSolver``: the two-block collision of ``tests/test_mpm.py:41`` on a
  16^2 grid (``cases.mpm_block``), 20 substeps in float64: x, v, F and C
  at 1e-12 of their scales (x, v: their largest entries; F: 1; C: v / h);
  ``from_particles`` / ``export_particles`` round trip; the free fall of
  ``tests/test_mpm.py:19`` held exactly as there (1e-6 relative, the
  zero-stress flight is exact up to round-off).
* ``MPMCoupling``: ``acceptMPM``'s marks and ``sample_particle_field``'s
  values bit for bit against fvm_tpu's (``tests/test_mpm.py:126``), and
  the JAX test's thermal pin on the port.
* The unsteady IB cantilever (``cases.ibm_cantilever``, the particle
  cloud's marks driving the flow) against its demo.
"""

import sys
from pathlib import Path

import numpy as np
import torch

import fvm_tpu as jfvm
from fvm_tpu.geom.mpm import MPM as JMPM, MPMCoupling as JCoupling, \
    MPMSolver as JSolver
from fvm_tpu_torch import cases
from fvm_tpu_torch.geom import IBType, MPM, MPMCoupling, MPMSolver
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import ThermalModel
from test_torch_newton import one_thread  # noqa: F401

RTOL = 1e-12


def _cloud(n=17, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)), rng.random((n, 3)),
            (rng.random(n) > 0.5).astype(int), rng.random(n))


def test_particle_files_byte_identical(tmp_path):
    data = _cloud()
    jm, tm = JMPM(), MPM()
    jm.Init(*data)
    tm.Init(*data)
    fj, ft = tmp_path / "jax.dat", tmp_path / "torch.dat"
    jm.setandwriteParticles(str(fj))
    tm.setandwriteParticles(str(ft))
    assert fj.read_bytes() == ft.read_bytes()
    a, b = JMPM(str(ft)), MPM(str(fj))
    for get in ("getCoordinates", "getVelocities", "getTypes",
                "getTemperatures"):
        x, y = getattr(a, get)(), getattr(b, get)()
        assert x.dtype == y.dtype and np.array_equal(x, y), get
    assert b.getParticles() == 17
    # trailing sections may be absent: zeros
    (tmp_path / "short.dat").write_text("2\n0 0 0\n1 1 1\n")
    s = MPM(str(tmp_path / "short.dat"))
    assert np.array_equal(s.getVelocities(), np.zeros((2, 3)))
    assert np.array_equal(s.getTypes(), np.zeros(2, np.int32))


def _jax_block(n=16):
    """``cases.mpm_block``'s blocks in the JAX package."""
    b, h = n // 4, 1.0 / n
    s = JSolver(origin=(0, 0), h=h, dims=(n, n), youngs=5e3, density=1000.0)
    lo, y0 = 0.5 - b * h, 0.5 - 0.5 * b * h
    s.seed_box((lo, y0), (0.5, y0 + b * h), velocity=(0.5, 0.0))
    s.seed_box((0.5, y0), (0.5 + b * h, y0 + b * h), velocity=(-0.5, 0.0))
    return s


def test_two_block_collision_matches_fvm_tpu():
    j = _jax_block()
    t = cases.mpm_block(16, device="cpu", dtype="float64")
    for k in ("x", "v", "F", "C", "m", "V0"):
        assert np.array_equal(np.asarray(j.state[k]), t.state[k].numpy()), k
    assert t.cfl_dt() == j.cfl_dt()
    j.advance(0.1, substeps=20)
    t.advance(0.1, substeps=20)
    v_scale = float(np.abs(np.asarray(j.state["v"])).max())
    scales = {"x": float(np.abs(np.asarray(j.state["x"])).max()),
              "v": v_scale, "F": 1.0, "C": v_scale * 16}
    for k, scale in scales.items():
        np.testing.assert_allclose(t.state[k].numpy(),
                                   np.asarray(j.state[k]), rtol=0,
                                   atol=RTOL * scale, err_msg=k)
    # the blocks collided: the deformation gradient moved off I
    assert np.abs(t.state["F"].numpy() - np.eye(2)).max() > 1e-3
    np.testing.assert_allclose(t.momentum(), j.momentum(), rtol=0,
                               atol=RTOL * float(t.state["m"].sum()))
    assert abs(t.kinetic_energy() - j.kinetic_energy()) <= \
        RTOL * j.kinetic_energy()
    # CFL-bounded substeps, as fvm_tpu picks them
    assert t.advance(0.01) == j.advance(0.01)


def test_container_round_trip():
    t = cases.mpm_block(16, device="cpu", dtype="float64")
    mpm = MPM()
    t.export_particles(mpm)
    assert mpm.getParticles() == t.state["x"].shape[0]
    t2 = MPMSolver.from_particles(mpm, t.h, (0, 0), t.dims,
                                  youngs=t.E, device="cpu",
                                  dtype="float64")
    for k in ("x", "v"):
        assert torch.equal(t2.state[k], t.state[k])


def test_free_fall_exact():
    """``tests/test_mpm.py:19`` on the port: v = g t and the symplectic
    Euler positions."""
    g = -9.81
    s = MPMSolver(origin=(0, 0), h=0.1, dims=(20, 40), youngs=0.0,
                  gravity=(0.0, g), device="cpu", dtype="float64")
    s.seed_box((0.6, 2.4), (1.0, 2.8))
    x0 = s.state["x"].numpy().copy()
    T, n = 0.2, 20
    for _ in range(n):
        s.advance(T / n, substeps=1)
    v, x = s.state["v"].numpy(), s.state["x"].numpy()
    np.testing.assert_allclose(v[:, 1], g * T, rtol=1e-6)
    np.testing.assert_allclose(v[:, 0], 0.0, atol=1e-12)
    dt = T / n
    expected_dy = np.sum(g * dt * np.arange(1, n + 1) * dt)
    np.testing.assert_allclose(x[:, 1] - x0[:, 1], expected_dy, rtol=1e-6)


def test_coupling_mark_and_sample_match_fvm_tpu():
    mesh_j = jfvm.mesh.generate.quad_2d(24, 24)
    mesh_t = quad_2d(24, 24)
    couplings = []
    for Solver, Mpm, Coupling, kw in (
            (JSolver, JMPM, JCoupling, {}),
            (MPMSolver, MPM, MPMCoupling, {"device": "cpu",
                                           "dtype": "float64"})):
        s = Solver(origin=(0, 0), h=1.0 / 24, dims=(24, 24), youngs=1e3,
                   **kw)
        s.seed_box((0.4, 0.4), (0.6, 0.6))
        mpm = Mpm()
        s.export_particles(mpm)
        cpl = Coupling(mpm, s)
        cpl.updateMPM(1e-3)
        couplings.append(cpl)
    jc, tc = couplings
    assert tc.timeMPM == jc.timeMPM
    np.testing.assert_allclose(tc.mpm.getCoordinates(),
                               jc.mpm.getCoordinates(), rtol=0, atol=1e-15)
    mark_j, mark_t = jc.acceptMPM(mesh_j), tc.acceptMPM(mesh_t)
    assert np.array_equal(mark_j, mark_t)
    n_int = mesh_t.n_interior_cells
    assert int((mark_t[:n_int] == IBType.SOLID).sum()) >= 16
    field = np.linspace(300.0, 400.0, n_int)
    assert np.array_equal(tc.sample_particle_field(mesh_t, field),
                          jc.sample_particle_field(mesh_j, field))
    # the JAX test's pin of the marked cells, on the port
    t = ThermalModel(build_device_mesh(mesh_t, dtype="float64",
                                       device="cpu"))
    t.options["verbose"] = False
    for side, kind in (("left", "SpecifiedTemperature"),
                       ("right", "SpecifiedTemperature"),
                       ("top", "Symmetry"), ("bottom", "Symmetry")):
        t.bc[side].bc_type = kind
        if kind == "SpecifiedTemperature":
            t.bc[side]["specifiedTemperature"] = 300.0
    t.init()
    im = mark_t[:n_int] != IBType.FLUID
    t.set_immersed_boundary(im, 400.0)
    t.advance(30)
    T = t.getTemperature()
    assert abs(T[im].max() - 400.0) < 1e-6
    assert tc.sample_particle_field(mesh_t, T).min() > 399.0


def test_ibm_cantilever_matches_the_demo(tmp_path):
    """``demos/ibm_unsteady_cantilever.py``'s ``build`` and
    ``advance_unsteady`` against ``cases.ibm_cantilever`` and
    ``cases.cantilever_unsteady`` on a small generated box (quad_2d(30,
    20) over 60 x 40 um: the demo's 2 um cells) written as a Fluent case
    by ``scripts/fluent_case.py`` and read by each package's reader, and
    the generated 35 x 1 um beam: the marks bit for bit, the IB-force
    history over 3 time steps of 15 outers at 1e-8."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "demos"))
    sys.path.insert(0, str(root))
    import ibm_unsteady_cantilever as drv
    from fvm_tpu.io.fluent import read_fluent_mesh
    from scripts.fluent_case import write_fluent_case

    path = str(tmp_path / "box.cas")
    write_fluent_case(path, quad_2d(30, 20, lx=60e-6, ly=40e-6), "f64")
    pts = cases.cantilever_beam(height_um=40.0)
    jf, jsolid, jt = drv.build(read_fluent_mesh(path), pts)
    tf, tsolid, tt = cases.ibm_cantilever(path, pts, device="cpu")
    assert np.array_equal(jt, tt) and tsolid.sum() > 30
    for key in ("momentumLinearSolver", "pressureLinearSolver"):
        tf.options[key].exit_every = 5
    hj = drv.advance_unsteady(jf, jsolid, 3, 15)
    ht = cases.cantilever_unsteady(tf, tsolid, 3, 15)
    np.testing.assert_array_equal(ht[:, :2], hj[:, :2])
    np.testing.assert_allclose(ht[:, 2:], hj[:, 2:], rtol=0,
                               atol=1e-8 * np.abs(hj[:, 3]).max())
    # the demo test's physics: the force opposes the started motion
    assert ht[0, 1] > 0 and ht[0, 3] < 0
