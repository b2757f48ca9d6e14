"""The geometry modules against fvm_tpu (host numpy and scipy, CPU).

* ``IBManager``: ``ib_type``, ``ib_cells``, ``ib_nearest_element``, the
  interpolation stencil's four arrays, ``ib_faces`` and both
  ``dirichlet_mask`` forms bit for bit, on quad_2d(24, 24) with the
  1024-gon of ``cases.ib_cylinder`` and the 32-gon of
  ``tests/test_ibm.py:138``, and on hex_3d(10, 10, 10) with a generated
  icosphere (80 triangles); ``cell_mark_particles`` on the 200-point
  cloud of ``tests/test_ibm.py:186``, bit for bit.
* ``ParticleTracker``: ``velocity_at`` and ``track`` on the rotation of
  ``tests/test_ibm.py:116``, 1e-12; the JAX test's own assertions on the
  port.
* ``Grid``: ``computeInterpolatedVelocity`` and ``interpolate_to_faces``,
  1e-14.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import fvm_tpu as jfvm
from fvm_tpu.geom import Grid as JGrid, IBManager as JIB, \
    ParticleTracker as JTracker
from fvm_tpu.geom.ibm import cell_mark_particles as jmark
from fvm_tpu_torch import cases
from fvm_tpu_torch.geom import Grid, IBManager, IBType, ParticleTracker, \
    cell_mark_particles
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import hex_3d, quad_2d
from test_torch_newton import one_thread  # noqa: F401


def icosphere(r=0.3, center=(0.47, 0.52, 0.49)):
    """An icosahedron subdivided once onto the sphere: 42 vertices, 80
    triangles."""
    t = (1.0 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
         (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(p, float) / np.linalg.norm(p) for p in v]
    mid = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid:
            m = verts[a] + verts[b]
            verts.append(m / np.linalg.norm(m))
            mid[key] = len(verts) - 1
        return mid[key]

    faces = []
    for a, b, c in f:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return (np.asarray(center) + r * np.asarray(verts),
            np.asarray(faces, dtype=np.int64))


CASES = {
    "cylinder 1024-gon": (lambda g: g.quad_2d(24, 24), lambda: cases.
                          circle_polygon(1024, 0.1, (0.4, 0.5))),
    "hot 32-gon": (lambda g: g.quad_2d(24, 24),
                   lambda: cases.circle_polygon(32, 0.15)),
    "icosphere": (lambda g: g.hex_3d(10, 10, 10), icosphere),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ibmanager_tables_bit_for_bit(case):
    make, surface = CASES[case]
    verts, elems = surface()
    ji = JIB(make(jfvm.mesh.generate))

    class _Gen:
        quad_2d, hex_3d = staticmethod(quad_2d), staticmethod(hex_3d)

    ti = IBManager(make(_Gen))
    assert np.array_equal(ji.update(verts, elems), ti.update(verts, elems))
    assert (ti.ib_type == IBType.IB).sum() > 0
    assert (ti.ib_type == IBType.SOLID).sum() > 0
    for k in ("ib_type", "ib_cells", "ib_nearest_element"):
        a, b = getattr(ji, k), getattr(ti, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k_fluid in (4, 6):
        for a, b in zip(ji.interpolation_stencil(k_fluid),
                        ti.interpolation_stencil(k_fluid)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ji.wall_point, ti.wall_point)
    assert np.array_equal(ji.ib_faces(), ti.ib_faces())
    for inc in (True, False):
        assert np.array_equal(ji.dirichlet_mask(inc), ti.dirichlet_mask(inc))


def test_stencil_before_update_raises():
    with pytest.raises(ValueError):
        IBManager(quad_2d(4, 4)).interpolation_stencil()


def test_cell_mark_particles_bit_for_bit():
    th = np.random.default_rng(0).uniform(0, 2 * np.pi, 200)
    r = np.sqrt(np.random.default_rng(1).uniform(0, 1, 200)) * 0.12
    pts = np.stack([0.5 + r * np.cos(th), 0.5 + r * np.sin(th)], 1)
    a = jmark(jfvm.mesh.generate.quad_2d(20, 20), pts, radius=0.05)
    b = cell_mark_particles(quad_2d(20, 20), pts, radius=0.05)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (b == IBType.SOLID).sum() > 0 and (b == IBType.IB).sum() > 0
    with pytest.raises(ValueError):
        cell_mark_particles(quad_2d(4, 4), np.zeros((0, 2)), 0.1)


def _rotation(cc):
    return np.stack([-cc[:, 1], cc[:, 0]], axis=1)


def test_particle_tracker_matches_fvm_tpu():
    jdm = jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(32, 32, lx=2.0, ly=2.0), dtype=jnp.float64)
    tdm = build_device_mesh(quad_2d(32, 32, lx=2.0, ly=2.0),
                            dtype="float64", device="cpu")
    cc = tdm.cell_centroid.numpy()[: tdm.n_interior_cells] - 1.0
    vel = _rotation(cc)
    jt, tt = JTracker(jdm), ParticleTracker(tdm)
    gj, gt = jt._velocity_gradient(vel), tt._velocity_gradient(vel)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12)
    pts = np.array([[1.37, 0.81], [0.42, 1.63], [1.0, 1.0], [0.05, 1.9]])
    for g_j, g_t in ((None, None), (gj, gt)):
        np.testing.assert_allclose(tt.velocity_at(pts, vel, g_t),
                                   jt.velocity_at(pts, vel, g_j),
                                   rtol=0, atol=1e-12)
    p0 = np.array([[1.5, 1.0], [1.2, 0.7]])
    traj = tt.track(p0, vel, dt=0.05, n_steps=50)
    np.testing.assert_allclose(traj, jt.track(p0, vel, dt=0.05, n_steps=50),
                               rtol=0, atol=1e-12)
    # the JAX test's assertions: the tracker is exact for the linear field
    r = np.linalg.norm(traj - 1.0, axis=2)
    assert abs(r[-1, 0] - 0.5) < 2e-3
    # (at the JAX test's two interior points: the ghosts' zero-gradient
    # extension bends the gradients next to the walls)
    exact = _rotation(pts[:2] - 1.0)
    np.testing.assert_allclose(tt.velocity_at(pts[:2], vel, gt), exact,
                               atol=1e-10)


def test_grid_matches_fvm_tpu():
    xs = np.linspace(0, 1, 11)
    ys = np.linspace(0, 1.5, 7)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vals = np.stack([X + Y, X - Y * X, np.sin(3 * X) * Y], axis=-1)
    jg, tg = JGrid((xs, ys), vals), Grid((xs, ys), vals)
    pts = np.random.default_rng(2).uniform(-0.1, 1.6, (50, 2))
    np.testing.assert_allclose(tg.computeInterpolatedVelocity(pts),
                               jg.computeInterpolatedVelocity(pts),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        tg.computeInterpolatedVelocity([[0.25, 0.5], [0.7, 0.1]])[:, :2],
        [[0.75, 0.25 - 0.125], [0.8, 0.7 - 0.07]], atol=1e-12)
    jdm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(6, 5),
                                      dtype=jnp.float64)
    tdm = build_device_mesh(quad_2d(6, 5), dtype="float64", device="cpu")
    for group in (None, "top", "left"):
        np.testing.assert_allclose(tg.interpolate_to_faces(tdm, group),
                                   jg.interpolate_to_faces(jdm, group),
                                   rtol=0, atol=1e-14)
