"""The port's Newton endgame against fvm_tpu (float64, CPU).

``advanceNewton`` from fvm_tpu's state after SIMPLE outers (carried over
with ``interop``), the counterparts of ``tests/test_flow.py:393, 446,
527``: the entry residual histories at rtol 1e-8 with the golden suite's
atol 1e-12, and both packages at the SIMPLE fixed point after it (one
``advance(1)`` below 1e-9 of the first outer's residual, velocities within
1e-9).  The inner solves run to ``newtonKrylovTolerance`` 1e-8, and the
chunked BiCGStab with ``newtonForcing="fixed"``: with the default loose
inner tolerance (1e-5, or the Eisenstat-Walker eta up to 0.1) fvm_tpu's
own history moves by 5.4e-6 (one program) and 0.54 (chunked, the
continuity residual of the second step) relative when its entry state
moves by 1e-15 (32^2, ``scripts/roundoff_sensitivity.py``), so no
port can be held to it there; tight inner solves make the Newton steps
well defined.  The port alone also reaches the fixed point at the
reference test's own settings.  Meshes: ``quad_2d(16, 16)`` and
``tri_2d(12, 12)`` (the reference tests' 32^2 and 16^2, for time).  The
Jacobian action itself is held against ``jax.jvp`` in
``tests/test_torch_jvp.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models.fmg import snapshot_state as jsnapshot
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.models import FlowModel as TFlow

N = 16
HIST_RTOL = 1e-8
HIST_ATOL = 1e-12  # as tests/test_golden_histories.py: round-off floors
FIXED_POINT = 1e-9
KTOL = 1e-8


def _pair(kind, n):
    gen = {"quad": lambda g: g.quad_2d(n, n), "tri": lambda g: g.tri_2d(n, n)}
    return (jfvm.mesh.build_device_mesh(gen[kind](jfvm.mesh.generate),
                                        dtype=jnp.float64),
            tfvm.mesh.build_device_mesh(gen[kind](tfvm.mesh.generate),
                                        dtype="float64", device="cpu"))


def _cavity(Flow, dmesh, viscosity=0.01, **opts):
    f = Flow(dmesh)
    f.options["verbose"] = False
    f.vc["viscosity"] = viscosity
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    for k, v in opts.items():
        f.options[k] = v
    f.init()
    return f


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread per test process while these modules run: their
    tensors are small (a few thousand cells), and the test run's workers
    share the machine's cores, where one pool of threads per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def entry():
    """fvm_tpu's quad cavity after 60 SIMPLE outers: (snapshot, norm0
    pair)."""
    jm, _ = _pair("quad", N)
    jf = _cavity(JFlow, jm)
    jf.advance(60)
    return jsnapshot(jf), jf._norm0


def _models(entry, **opts):
    """Both packages' cavity models at the entry state."""
    snap, norm0 = entry
    jm, tm = _pair("quad", N)
    jf, tf = _cavity(JFlow, jm, **opts), _cavity(TFlow, tm, **opts)
    jf.state = {k: jnp.asarray(v) for k, v in snap.items()}
    load_model_state(tf, snap)
    jf._norm0 = tf._norm0 = norm0
    return jf, tf


def _run(entry, niter, **opts):
    """advanceNewton(niter) in both packages from the entry state, inner
    tolerance KTOL: histories, contraction and the fixed point checked."""
    jf, tf = _models(entry, newtonKrylovTolerance=KTOL, **opts)
    hj, ht = jf.advanceNewton(niter), tf.advanceNewton(niter)
    a = np.array([h[1:] for h in hj], dtype=float)
    b = np.array([[float(v) for v in h[1:]] for h in ht])
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=HIST_RTOL, atol=HIST_ATOL)
    n0 = entry[1][0]
    assert b[-1, 0] / n0 < 1e-2 * b[0, 0] / n0  # decades of contraction
    for f in (jf, tf):
        assert float(f.advance(1)[0][1]) / n0 < FIXED_POINT
    Vj = jf.getVelocity()
    np.testing.assert_allclose(tf.getVelocity(), Vj, rtol=0,
                               atol=FIXED_POINT * np.abs(Vj).max())
    return jf, tf


def test_newton_one_program_matches(entry):
    """``tests/test_flow.py:393``: each Newton step one outer step."""
    _run(entry, 3)


def test_newton_tri_mesh_matches():
    """``tests/test_flow.py:446``: a tri mesh (non-orthogonal correction
    and LS gradients inside R under forward-mode AD)."""
    jm, tm = _pair("tri", 12)
    jf = _cavity(JFlow, jm, 0.02, newtonKrylovTolerance=KTOL)
    tf = _cavity(TFlow, tm, 0.02, newtonKrylovTolerance=KTOL)
    h = jf.advance(60)
    n0 = float(h[0][1])
    load_model_state(tf, jsnapshot(jf))
    tf._norm0 = jf._norm0
    hj, ht = jf.advanceNewton(3), tf.advanceNewton(3)
    np.testing.assert_allclose(
        np.array([[float(v) for v in r[1:]] for r in ht]),
        np.array([r[1:] for r in hj], dtype=float),
        rtol=HIST_RTOL, atol=HIST_ATOL)
    for f in (jf, tf):
        assert float(f.advance(1)[0][1]) / n0 < 1e-10
