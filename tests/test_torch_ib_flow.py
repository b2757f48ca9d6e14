"""The flow cylinder's immersed-boundary stencil rows against fvm_tpu
(float64, CPU).

The case is ``cases.ib_cylinder`` at quad_2d(24, 24) (its JAX twin
``scripts/roundoff_sensitivity.ib_cylinder_jax``): the solid pinned at
rest, the IB band's momentum rows the implicit interpolation stencil,
bench's cavity solvers.

* The momentum (n, 2) system the solver receives after ``_apply_ib``,
  from fvm_tpu's state after 3 outers (``interop.load_model_state``;
  the JAX step under ``jax.jit``, the system returned from the trace),
  entry by entry at 1e-14 of the largest, with its widened slot tables
  and its condensed form.  Its DIA form has fallback entries; the
  pressure AMG holds a greedy hierarchy of the widened pattern beside its
  structured one, as fvm_tpu's does.
* 40 SIMPLE outers' histories to 1e-8.  fvm_tpu's own history moves by
  7.5e-15 under a 1e-15 change of the viscosity (``python3 -m
  scripts.roundoff_sensitivity --cases ib_stencil``).
* After 250 outers (momentum residual below 1e-4 of its first) the force
  on the fluid region's body faces balances the boundary's momentum flux
  (``cases.ib_force_balance``) to 2% of its scale, with the stencil rows
  and with the mask form (band and solid pinned).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import jax

import fvm_tpu as jfvm
from fvm_tpu.models.fmg import snapshot_state
from fvm_tpu_torch import cases
from fvm_tpu_torch.interop import load_model_state
from test_torch_assembly import _recording
from test_torch_ib_stencil import _close, systems_close
from test_torch_newton import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from scripts.roundoff_sensitivity import IBS_N, IBS_OUTERS, \
    ib_cylinder_jax  # noqa: E402

HIST_RTOL = 1e-8


def test_widened_momentum_system_matches():
    jf, _, _ = ib_cylinder_jax(jfvm, IBS_N)
    tf = cases.ib_cylinder(IBS_N, device="cpu", dtype="float64")
    jf.advance(3)
    load_model_state(tf, snapshot_state(jf))
    for m in (jf, tf):
        _recording(m.options["momentumLinearSolver"])
    tf._drop_compiled()
    jrec = jf.options["momentumLinearSolver"].systems
    step = jf._build_step()

    @jax.jit
    def jsystem(params, state, bcvals):
        jrec.clear()
        step(jf.mesh, params, state, bcvals)
        A, r = jrec[0]
        A2, r2, _ = A.condense(r)
        return A, r, A2, r2

    jA, jb, jA2, jb2 = jsystem(jf.params, jf.state, jf._resolve_bcvals())
    tf._step(tf.mesh, tf.params, tf.state, tf._resolve_bcvals())
    tA, tb = tf.options["momentumLinearSolver"].systems[0]
    assert tuple(tb.shape) == (tf.mesh.n_cells, 2)
    assert tA.dia is not None and tA.dia.fb_rows.shape[0] > 0
    systems_close((jA, jb), (tA, tb), (jA2, jb2))
    # the widened pattern's hierarchy beside the mesh's own
    assert len(tf.options["pressureLinearSolver"]._levels_cache) == 2


def test_flow_cylinder_histories_match_fvm_tpu():
    jf, _, _ = ib_cylinder_jax(jfvm, IBS_N)
    tf = cases.ib_cylinder(IBS_N, device="cpu", dtype="float64")
    hj, ht = jf.advance(IBS_OUTERS), tf.advance(IBS_OUTERS)
    _close([h[1:] for h in ht], [h[1:] for h in hj], HIST_RTOL)
    _close(tf.getVelocity(), np.asarray(jf.getVelocity()), HIST_RTOL)
    _close(tf.getIBForceIntegral(), np.asarray(jf.getIBForceIntegral()),
           HIST_RTOL)


@pytest.mark.parametrize("stencil", [True, False])
def test_flow_cylinder_force_balance(stencil):
    f = cases.ib_cylinder(IBS_N, device="cpu", dtype="float64",
                          stencil=stencil)
    for key in ("momentumLinearSolver", "pressureLinearSolver"):
        f.options[key].exit_every = 5
    hist = f.advance(250)
    assert hist[-1][1] < 1e-4 * hist[0][1]
    F_body, F_bdry = cases.ib_force_balance(f)
    scale = np.abs(F_bdry).max()
    np.testing.assert_allclose(F_body, -F_bdry, atol=2e-2 * scale)


