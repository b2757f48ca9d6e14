"""The port's block-ELL matrices, CoupledSIMPLE, advanceCoupled, Anderson
acceleration and state moves against fvm_tpu (float64, CPU).

* ``small_inv`` (B = 1-4), the ``BlockELLMatrix`` products and
  ``assemble_block`` with the two ghost-row helpers, on seeded random
  blocks over one mesh in both packages: 1e-13 relative (a handful of
  float64 operations per entry, summed in another order).
* ``CoupledSIMPLE`` M(r), momentum "jacobi" and "amg", on the Picard
  surrogate of a 32^2 cavity state handed to both packages: 1e-12 (the AMG
  cycles' Jacobi sweeps and the coarse solve, the port inverts the coarse
  matrix where fvm_tpu eliminates, in another rounding).
* ``advanceCoupled`` in the configurations of ``tests/test_flow.py:145,
  170`` (12 and 25 outers instead of 40 and 120, for time) and
  Anderson-accelerated SIMPLE in that of ``:334`` (at 24^2 and 30 outers
  instead of 48^2 and 1500): residual histories at rtol 1e-8 with the
  golden suite's atol 1e-12 (round-off floors of converged outers),
  velocities at 1e-10; ``Anderson.mix`` over a few steps at 1e-12.  The
  Poiseuille case runs its coupled solves to rtol 1e-10 instead of the
  default 1e-3: with the default, fvm_tpu's own history moves by 2.1e-7
  relative when the viscosity moves by 1e-15
  (``scripts/roundoff_sensitivity.py``), so no port can be held to it at
  1e-8; the cavity's history is not that sensitive.
* ``snapshot_state``/``restore_state``/``promote_state`` round trips, and
  ``interop.load_model_state`` of fvm_tpu's ``snapshot_state`` (with
  ``momAp`` and ``massFlux``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear.anderson import Anderson as JAnderson
from fvm_tpu.linear.coupled import CoupledSIMPLE as JCoupledSIMPLE
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models.fmg import snapshot_state as jsnapshot
from fvm_tpu.ops import bell as jbell
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear import Anderson as TAnderson, CoupledSIMPLE
from fvm_tpu_torch.models import FlowModel as TFlow
from fvm_tpu_torch.models.fmg import (promote_state, restore_state,
                                      snapshot_state)
from fvm_tpu_torch.ops import bell as tbell
from test_torch_newton import one_thread  # noqa: F401

OP_RTOL = 1e-13
PRE_RTOL = 1e-12
HIST_RTOL = 1e-8
HIST_ATOL = 1e-12  # as tests/test_golden_histories.py: round-off floors
FIELD_RTOL = 1e-10


def _meshes(nx, ny):
    return (jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(nx, ny),
                                        dtype=jnp.float64),
            tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(nx, ny),
                                        dtype="float64", device="cpu"))


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * float(np.abs(j).max()))


def _blocks(rng, shape, B):
    """Diagonally dominant (..., B, B) blocks."""
    M = rng.standard_normal(tuple(shape) + (B, B))
    return M + 4.0 * B * np.eye(B)


@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_small_inv(B):
    M = _blocks(np.random.default_rng(B), (50,), B)
    _close(tbell.small_inv(torch.from_numpy(M)),
           jbell.small_inv(jnp.asarray(M)), OP_RTOL)
    np.testing.assert_allclose(
        tbell.small_inv(torch.from_numpy(M)).numpy() @ M,
        np.broadcast_to(np.eye(B), M.shape), atol=1e-13)


def _block_pair(B, seed=0):
    jm, tm = _meshes(7, 6)
    rng = np.random.default_rng(seed)
    K, n = tuple(tm.cf_nbr.shape)
    diag = _blocks(rng, (n,), B)
    off = rng.standard_normal((K, n, B, B))
    mask = tm.cf_mask.numpy()
    jA = jbell.BlockELLMatrix(diag=jnp.asarray(diag), off=jnp.asarray(off),
                              cols=jm.cf_nbr, mask=jm.cf_mask)
    tA = tbell.BlockELLMatrix(diag=torch.from_numpy(diag),
                              off=torch.from_numpy(off), cols=tm.cf_nbr,
                              mask=torch.from_numpy(mask))
    return jA, tA, rng, n


@pytest.mark.parametrize("B", [2, 3, 4])
def test_block_ell_products(B):
    jA, tA, rng, n = _block_pair(B)
    x, b = rng.standard_normal((n, B)), rng.standard_normal((n, B))
    jx, tx, jb, tb = (jnp.asarray(x), torch.from_numpy(x), jnp.asarray(b),
                      torch.from_numpy(b))
    _close(tA.mv(tx), jA.mv(jx), OP_RTOL)
    _close(tA.diag_solve(tb), jA.diag_solve(jb), OP_RTOL)
    _close(tA.jacobi_step(tx, tb, 0.7), jA.jacobi_step(jx, jb, 0.7), OP_RTOL)
    _close(tA.residual(tx, tb), jb - jA.mv(jx), OP_RTOL)
    np.testing.assert_allclose(float(tA.dot(tx, tb)), float(jA.dot(jx, jb)),
                               rtol=OP_RTOL)
    np.testing.assert_allclose(float(tA.norm(tx)), float(jA.norm(jx)),
                               rtol=OP_RTOL)


def test_assemble_block_and_ghost_rows():
    B = 3
    jm, tm = _meshes(6, 5)
    rng = np.random.default_rng(7)
    nf, nc = tm.n_faces, tm.n_cells
    F = rng.standard_normal((nf, B))
    dO = rng.standard_normal((nf, B, B))
    dN = rng.standard_normal((nf, B, B))
    rc = rng.standard_normal((nc, B))
    dc = rng.standard_normal((nc, B, B))
    jA, jr = jbell.assemble_block(jm, *map(jnp.asarray, (F, dO, dN)),
                                  r_cell=jnp.asarray(rc),
                                  diag_cell=jnp.asarray(dc))
    tA, tr = tbell.assemble_block(tm, *map(torch.from_numpy, (F, dO, dN)),
                                  r_cell=torch.from_numpy(rc),
                                  diag_cell=torch.from_numpy(dc))
    for t, j in ((tA.diag, jA.diag), (tA.off, jA.off), (tr, jr)):
        _close(t, j, OP_RTOL)
    assert torch.equal(tA.cols, torch.from_numpy(np.asarray(jA.cols)
                                                 .astype(np.int64)))

    g = [g for g in tm.boundary_groups() if g[1] == "left"][0]
    gc = tm.ghost_cells_of_group(g)
    rows = gc.stop - gc.start
    x = rng.standard_normal((nc, B))
    value = rng.standard_normal((rows, B))
    scale = np.abs(rng.standard_normal(rows)) + 0.5
    valid = rng.random(rows) > 0.3
    T = rng.standard_normal((rows, B, B))
    extra = rng.standard_normal((rows, B))
    jo = jbell.dirichlet_rows_block(jm, jA, jr, gc, jnp.asarray(value),
                                    jnp.asarray(x), jnp.asarray(valid),
                                    jnp.asarray(scale))
    to = tbell.dirichlet_rows_block(tm, tA, tr, gc, torch.from_numpy(value),
                                    torch.from_numpy(x),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(scale))
    for t, j in ((to[0].diag, jo[0].diag), (to[0].off, jo[0].off),
                 (to[1], jo[1])):
        _close(t, j, OP_RTOL)
    jo = jbell.transform_rows_block(jm, jA, jr, gc, jnp.asarray(T),
                                    jnp.asarray(x), jnp.asarray(valid),
                                    jnp.asarray(scale), jnp.asarray(extra))
    to = tbell.transform_rows_block(tm, tA, tr, gc, torch.from_numpy(T),
                                    torch.from_numpy(x),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(extra))
    for t, j in ((to[0].diag, jo[0].diag), (to[0].off, jo[0].off),
                 (to[1], jo[1])):
        _close(t, j, OP_RTOL)


def _cavity(Flow, dmesh, **opts):
    f = Flow(dmesh)
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    for k, v in opts.items():
        f.options[k] = v
    f.init()
    return f


@pytest.fixture(scope="module")
def surrogate():
    """The Picard block surrogate of a 32^2 cavity after 20 SIMPLE outers."""
    jm, tm = _meshes(32, 32)
    tf = _cavity(TFlow, tm)
    tf.advance(20)
    parts = tf._newton_parts(tm, tf.params, tf.state, tf._resolve_bcvals())
    return jm, tm, tf._newton_surrogate(tm, tf.params, parts)


@pytest.mark.parametrize("momentum", ["jacobi", "amg"])
def test_coupled_simple_preconditioner(surrogate, momentum):
    jm, tm, tA = surrogate
    jA = jbell.BlockELLMatrix(diag=jnp.asarray(tA.diag.numpy()),
                              off=jnp.asarray(tA.off.numpy()),
                              cols=jm.cf_nbr, mask=jm.cf_mask)
    jpre = JCoupledSIMPLE(dia=jm.dia, momentum=momentum)
    jpre.setup_structure(*jm.host_cf())
    tpre = CoupledSIMPLE(dia=tm.dia, momentum=momentum)
    tpre.setup_structure(*tm.host_cf(), tm.device)
    r = np.random.default_rng(3).standard_normal((tm.n_cells, 3))
    _close(tpre.precond_setup(tA)(torch.from_numpy(r)),
           jpre.precond_setup(jA)(jnp.asarray(r)), PRE_RTOL)


def _histories_match(hj, ht):
    a = np.array([h[1:] for h in hj], dtype=float)
    b = np.array([[float(v) for v in h[1:]] for h in ht])
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=HIST_RTOL, atol=HIST_ATOL)


def test_advance_coupled_poiseuille_matches():
    """``tests/test_flow.py:145``: plane Poiseuille, pressure boundaries,
    the coupled solves to rtol 1e-10 (module docstring)."""
    from fvm_tpu import linear as jlin
    from fvm_tpu_torch import linear as tlin

    L_, H, dp, mu = 4.0, 1.0, 1.0, 0.1
    out = []
    for pkg, Flow, kw, L in ((jfvm, JFlow, {"dtype": jnp.float64}, jlin),
                             (tfvm, TFlow, {"dtype": "float64",
                                            "device": "cpu"}, tlin)):
        m = Flow(pkg.mesh.build_device_mesh(
            pkg.mesh.generate.quad_2d(16, 16, lx=L_, ly=H), **kw))
        m.options["verbose"] = False
        m.vc["viscosity"] = mu
        m.bc["left"].bc_type = "PressureBoundary"
        m.bc["left"]["specifiedPressure"] = dp
        m.bc["right"].bc_type = "PressureBoundary"
        m.bc["right"]["specifiedPressure"] = 0.0
        m.bc["bottom"].bc_type = "NoSlipWall"
        m.bc["top"].bc_type = "NoSlipWall"
        m.init()
        pre = L.CoupledSIMPLE(dia=m.mesh.dia)
        if L is tlin:
            pre.setup_structure(*m.mesh.host_cf(), m.mesh.device)
        else:
            pre.setup_structure(*m.mesh.host_cf())
        m.options["coupledLinearSolver"] = L.BiCGStab(
            preconditioner=pre, relative_tolerance=1e-10, max_iterations=200)
        out.append((m.advanceCoupled(12), m.getVelocity()))
    (hj, Vj), (ht, Vt) = out
    _histories_match(hj, ht)
    assert ht[-1][1] / ht[0][1] < 0.1  # converging
    np.testing.assert_allclose(Vt, Vj, rtol=FIELD_RTOL,
                               atol=FIELD_RTOL * np.abs(Vj).max())


def test_advance_coupled_cavity_matches():
    """``tests/test_flow.py:170``: the 24^2 lid cavity, coupled, 25
    outers."""
    jm, tm = _meshes(24, 24)
    jf, tf = _cavity(JFlow, jm), _cavity(TFlow, tm)
    hj, ht = jf.advanceCoupled(25), tf.advanceCoupled(25)
    _histories_match(hj, ht)
    assert ht[-1][1] / ht[0][1] < 1e-3
    _close(torch.from_numpy(tf.getVelocity()), jf.getVelocity(), FIELD_RTOL)


def test_anderson_accelerated_simple_matches():
    """``tests/test_flow.py:334`` at 24^2 and 30 outers: Anderson mixing
    after the delay, the same history and field."""
    opts = {"momentumTolerance": 1e-6, "continuityTolerance": 1e10,
            "acceleration": "anderson"}
    jm, tm = _meshes(24, 24)
    jf, tf = _cavity(JFlow, jm, **opts), _cavity(TFlow, tm, **opts)
    hj, ht = jf.advance(30), tf.advance(30)
    _histories_match(hj, ht)
    _close(torch.from_numpy(tf.getVelocity()), jf.getVelocity(), FIELD_RTOL)


def test_anderson_mix_matches():
    rng = np.random.default_rng(11)
    n = 300
    ja, ta = JAnderson(depth=3, damping=0.8), TAnderson(depth=3, damping=0.8)
    js = ja.init_state(n, jnp.float64)
    ts = ta.init_state(n, torch.float64, "cpu")
    x = rng.standard_normal(n)
    for _ in range(6):  # fills and wraps the depth-3 window
        g = 0.9 * x + 0.1 * np.sin(x) + rng.standard_normal(n) * 1e-3
        jx, js = ja.mix(js, jnp.asarray(x), jnp.asarray(g))
        tx, ts = ta.mix(ts, torch.from_numpy(x), torch.from_numpy(g))
        _close(tx, jx, PRE_RTOL)
        x = np.array(jx)


def test_state_moves_round_trip():
    _, tm = _meshes(8, 8)
    f = _cavity(TFlow, tm)
    f.advance(3)
    snap = snapshot_state(f)
    assert set(snap) == set(f.state) and all(
        isinstance(v, np.ndarray) for v in snap.values())
    g = _cavity(TFlow, tm)
    restore_state(g, dict(snap, notAKey=np.zeros(3)))  # ignored
    for k in f.state:
        assert torch.equal(g.state[k], f.state[k])
    # float32 -> float64 promotion: values cast on the host, shapes kept
    f32 = _cavity(TFlow, tfvm.mesh.build_device_mesh(
        tfvm.mesh.generate.quad_2d(8, 8), dtype="float32", device="cpu"))
    f32.advance(3)
    promote_state(f32, g)
    for k in f32.state:
        assert g.state[k].dtype == torch.float64
        assert torch.equal(g.state[k], f32.state[k].double())


def test_load_jax_snapshot():
    jm, tm = _meshes(12, 12)
    jf, tf = _cavity(JFlow, jm), _cavity(TFlow, tm)
    jf.advance(5)
    snap = jsnapshot(jf)
    load_model_state(tf, snap)
    for k in ("velocity", "pressure", "massFlux", "momAp"):
        np.testing.assert_array_equal(tf.state[k].numpy(),
                                      np.asarray(jf.state[k]))
    with pytest.raises(KeyError):
        load_model_state(tf, {"velocity": snap["velocity"]})
    with pytest.raises(KeyError):
        load_model_state(tf, dict(snap, extraKey=np.zeros(2)))
