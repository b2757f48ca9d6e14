"""The Jacobian action of the port's Newton residual against fvm_tpu's
(float64, CPU).

J v = -dR/dq v at a cavity state that both packages hold (fvm_tpu's state
after SIMPLE outers, carried over with ``interop``), on ``quad_2d(32, 32)``
and ``tri_2d(16, 16)`` (non-orthogonal faces and LS gradients inside R):

* R(q0) itself and the port's ``torch.func.jvp`` of its R against
  ``jax.jvp`` of fvm_tpu's R at 1e-12 relative (forward-mode AD of the same
  formulas: a few roundings per entry);
* against a central difference of the port's R at 1e-6 (h = 1e-7 of the
  state's scale: truncation O(h^2) and cancellation ~1e-16 / h; R is only
  piecewise smooth where the upwind direction of a face flips, and a
  smaller h makes a flip inside [-h, h] unlikely).

fvm_tpu's R is a closure inside its Newton step; the step is run until it
builds its matrix-free operator, which hands (R, q0) out.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu.linear.base as jbase
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models.fmg import snapshot_state as jsnapshot
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.linear.base import newton_operator
from fvm_tpu_torch.models import FlowModel as TFlow
from test_torch_newton import one_thread, _cavity, _pair  # noqa: F401

JV_RTOL = 1e-12
FD_RTOL = 1e-6


class _Captured(Exception):
    pass


def _jax_residual(jf):
    """fvm_tpu's R and q0 at the model's state: its Newton step is run
    eagerly until it builds the matrix-free operator, which hands (R, q0)
    out."""
    real = jbase.newton_operator

    def grab(R, q0):
        raise _Captured(R, q0)

    jbase.newton_operator = grab
    try:
        step = jf._build_newton_step("full")
        step(jf.mesh, jf.params, jf.state, jf._resolve_bcvals())
    except _Captured as c:
        return c.args
    finally:
        jbase.newton_operator = real
    raise AssertionError("fvm_tpu's Newton step built no operator")


@pytest.mark.parametrize("kind,n,visc,outers", [("quad", 32, 0.01, 40),
                                                ("tri", 16, 0.02, 30)])
def test_jacobian_action_matches(kind, n, visc, outers):
    jm, tm = _pair(kind, n)
    jf, tf = _cavity(JFlow, jm, visc), _cavity(TFlow, tm, visc)
    jf.advance(outers)
    load_model_state(tf, jsnapshot(jf))
    jR, jq0 = _jax_residual(jf)
    parts = tf._newton_parts(tm, tf.params, tf.state, tf._resolve_bcvals())
    R, q0 = parts["R"], parts["q0"]
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq0))
    r0 = np.asarray(jax.jit(jR)(jq0))
    np.testing.assert_allclose(R(q0).numpy(), r0, rtol=JV_RTOL,
                               atol=JV_RTOL * float(np.abs(r0).max()))
    jvp = jax.jit(lambda q, v: jax.jvp(jR, (q,), (v,))[1])
    rng = np.random.default_rng(2)
    for _ in range(2):
        v = rng.standard_normal(tuple(q0.shape))
        jv = -np.asarray(jvp(jq0, jnp.asarray(v)))
        tv = newton_operator(R, q0)(torch.from_numpy(v)).numpy()
        scale = float(np.abs(jv).max())
        np.testing.assert_allclose(tv, jv, rtol=JV_RTOL,
                                   atol=JV_RTOL * scale)
        h = 1e-7 * float(q0.abs().max()) / float(np.abs(v).max())
        vt = torch.from_numpy(v)
        fd = -((R(q0 + h * vt) - R(q0 - h * vt)) / (2 * h)).numpy()
        np.testing.assert_allclose(tv, fd, rtol=FD_RTOL,
                                   atol=FD_RTOL * scale)
