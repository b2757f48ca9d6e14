"""The API remainder against its fvm_tpu twins (float64, CPU, 16^2):

``ELLMatrix.colored_gs_step`` (both sweep orders), ``transpose_apply``
and ``rowsum_offdiag_abs`` on a seeded matrix over the mesh's slot
table, (n,) and (n, 2); ``greedy_coloring``; ``ops.face_values``;
``FaceFlux.zeros``; ``Mesh.ghost_cell_of_boundary_face``;
``ResidualHistory.converged``; ``Model.update_time``;
``zero_float_tangent``.  Bit for bit, or 1e-14 of the largest entry where
the packages sum in other orders.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
from fvm_tpu.models import ThermalModel as JThermal
from fvm_tpu.models.base import ResidualHistory as JHistory, \
    zero_float_tangent as jzero
from fvm_tpu.ops import assembly as jassembly
from fvm_tpu.ops.ell import ELLMatrix as JELL, greedy_coloring as jcolor
from fvm_tpu_torch import ops
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import ThermalModel
from fvm_tpu_torch.models.base import ResidualHistory, zero_float_tangent
from fvm_tpu_torch.ops.assembly import FaceFlux
from fvm_tpu_torch.ops.ell import ELLMatrix, greedy_coloring
from test_torch_newton import one_thread  # noqa: F401

N = 16
RTOL = 1e-14


def _close(t, j, rtol=RTOL):
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=rtol * max(float(np.abs(j).max()), 1e-300))


@pytest.fixture(scope="module")
def meshes():
    jm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(N, N),
                                     dtype=jnp.float64)
    tm = build_device_mesh(quad_2d(N, N), dtype="float64", device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def matrices(meshes):
    """A seeded diagonally dominant matrix over the slot table, in both
    packages (the port's with and without its DIA form)."""
    jm, tm = meshes
    rng = np.random.default_rng(5)
    K, n = tm.cf_nbr.shape
    off = -rng.random((K, n))
    diag = 4.0 + rng.random(n)
    cols, mask = tm.cf_nbr, tm.cf_mask
    jA = JELL(diag=jnp.asarray(diag), off=jnp.asarray(off),
              cols=jnp.asarray(cols.numpy()), mask=jnp.asarray(mask.numpy()))
    tA = ELLMatrix(torch.from_numpy(diag), torch.from_numpy(off), cols, mask)
    tA_dia = ELLMatrix(torch.from_numpy(diag), torch.from_numpy(off), cols,
                       mask, dia=tm.dia)
    return jA, tA, tA_dia, rng


def test_greedy_coloring_bit_for_bit(meshes):
    _, tm = meshes
    cols, mask = tm.host_cf()
    a, b = jcolor(cols, mask), greedy_coloring(cols, mask)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    # no two coupled rows share a color
    color = np.argmax(b, axis=0)
    rows = np.arange(len(color))[:, None]
    assert not ((color[cols] == color[:, None]) & mask
                & (cols != rows)).any()


@pytest.mark.parametrize("m", [1, 2])
def test_ell_extras_match(meshes, matrices, m):
    jA, tA, tA_dia, rng = matrices
    _, tm = meshes
    n = tA.n
    shape = (n,) if m == 1 else (n, m)
    x, b = rng.standard_normal(shape), rng.standard_normal(shape)
    masks = greedy_coloring(*tm.host_cf())
    for fwd in (True, False):
        ref = jA.colored_gs_step(jnp.asarray(x), jnp.asarray(b),
                                 jnp.asarray(masks), forward=fwd)
        _close(tA.colored_gs_step(torch.from_numpy(x), torch.from_numpy(b),
                                  torch.from_numpy(masks), forward=fwd),
               ref)
        _close(tA_dia.colored_gs_step(torch.from_numpy(x),
                                      torch.from_numpy(b),
                                      torch.from_numpy(masks), forward=fwd),
               ref)
    _close(tA.transpose_apply(torch.from_numpy(x)),
           jA.transpose_apply(jnp.asarray(x)))
    _close(tA.rowsum_offdiag_abs(), jA.rowsum_offdiag_abs(), 0.0)


def test_face_values_and_zero_fluxes(meshes):
    """On the faces the cells use (the device meshes pad the interior
    faces to K per cell; a padding face's value is never read, and the
    JAX package's plane-major gathers fill it from another cell)."""
    jm, tm = meshes
    used = np.zeros(tm.n_faces, dtype=bool)
    used[tm.cf_face[tm.cf_mask].numpy()] = True
    assert used.sum() == 2 * N * (N - 1) + 4 * N
    for shape in ((tm.n_cells,), (tm.n_cells, 2)):
        x = np.random.default_rng(6).standard_normal(shape)
        for w in (0.5, 0.3):
            _close(ops.face_values(tm, torch.from_numpy(x), w)[used],
                   np.asarray(jassembly.face_values(jm, jnp.asarray(x),
                                                    w))[used], 0.0)
    for m in (None, 3):
        a = jassembly.FaceFlux.zeros(tm.n_faces, m)
        b = FaceFlux.zeros(tm.n_faces, m)
        for k in ("F", "dF_dO", "dF_dN"):
            _close(getattr(b, k), getattr(a, k), 0.0)
            assert getattr(b, k).dtype == torch.float64


def test_ghost_cell_of_boundary_face():
    jm, tm = jfvm.mesh.generate.quad_2d(5, 4), quad_2d(5, 4)
    for f in range(tm.n_interior_faces, tm.n_faces):
        g = tm.ghost_cell_of_boundary_face(f)
        assert g == jm.ghost_cell_of_boundary_face(f)
        assert tm.face_cells[f, 1] == g


def test_residual_history_and_update_time(meshes):
    jm, tm = meshes
    for H in (JHistory, ResidualHistory):
        h = H()
        assert not h.converged(1.0)
        h.extend([(0, 2.0), (1, 0.5)])
        assert h.converged(0.5) and not h.converged(0.4)
    models = []
    for cls, mesh in ((JThermal, jm), (ThermalModel, tm)):
        t = cls(mesh)
        t.options["verbose"] = False
        t.options["transient"] = True
        t.options["timeStep"] = 0.1
        for s in ("left", "right", "bottom", "top"):
            t.bc[s].bc_type = "SpecifiedTemperature"
        t.bc["left"]["specifiedTemperature"] = 400.0
        t.init()
        t.advance(2)
        t.update_time()
        models.append(t)
    jt, tt = models
    _close(tt.state["T_N1"], jt.state["T_N1"], 1e-10)
    assert torch.equal(tt.state["T_N1"], tt.state["T"])


def test_zero_float_tangent():
    tree = {"a": np.ones((3, 2)), "b": [np.arange(4), np.float32(2.0)],
            "c": (np.array([True]),)}
    a = jzero(jax.tree.map(jnp.asarray, tree))
    b = zero_float_tangent(tree)
    _close(b["a"], a["a"], 0.0)
    assert b["b"][1].dtype == torch.float32 and float(b["b"][1]) == 0.0
    assert a["b"][0].dtype == jax.dtypes.float0 and b["b"][0] is None
    assert a["c"][0].dtype == jax.dtypes.float0 and b["c"][0] is None
