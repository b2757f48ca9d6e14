"""The mesh-sequencing warm start against fvm_tpu (float64, CPU).

``interp_to_points``, ``interp_cell_field`` and ``prolong_flow_state``
from a 16^2 cavity after 30 SIMPLE outers (fvm_tpu's state, loaded with
``interop.load_model_state``) onto a 32^2 cavity: the prolonged velocity,
pressure and interior mass flux at 1e-12 of their largest entries, with
and without the gradient correction; a distributed model raises
``ConfigError`` (ROADMAP queue 1 item 8); the warm start lowers the fine
model's first residual against a cold start.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import fvm_tpu as jfvm
from fvm_tpu.models import FlowModel as JFlow
from fvm_tpu.models import fmg as jfmg
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import FlowModel
from fvm_tpu_torch.models import fmg
from test_torch_newton import one_thread  # noqa: F401

RTOL = 1e-12


def _cavity(m):
    m.options["verbose"] = False
    m.vc["viscosity"] = 0.01
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.init()
    return m


def _jax(n):
    return _cavity(JFlow(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(n, n), dtype=jnp.float64)))


def _port(n):
    return _cavity(FlowModel(build_device_mesh(quad_2d(n, n),
                                               dtype="float64",
                                               device="cpu")))


@pytest.fixture(scope="module")
def coarse():
    jc = _jax(16)
    jc.advance(30)
    tc = _port(16)
    load_model_state(tc, jfmg.snapshot_state(jc))
    return jc, tc


def _close(t, j):
    t = t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=RTOL * float(np.abs(j).max()))


@pytest.mark.parametrize("grad", [True, False])
def test_prolong_flow_state_matches_fvm_tpu(coarse, grad):
    jc, tc = coarse
    jf, tf = _jax(32), _port(32)
    jfmg.prolong_flow_state(jc, jf, grad=grad)
    fmg.prolong_flow_state(tc, tf, grad=grad)
    for k in ("velocity", "pressure", "massFlux"):
        _close(tf.state[k], jf.state[k])
    vals = np.concatenate([tc.getVelocity(), tc.getPressure()[:, None]], 1)
    _close(fmg.interp_cell_field(tc.mesh, tf.mesh, vals, grad=grad),
           jfmg.interp_cell_field(jc.mesh, jf.mesh, vals, grad=grad))
    pts = np.random.default_rng(3).random((40, 2))
    _close(fmg.interp_to_points(tc.mesh, pts, vals[:, 0], k=6, grad=grad),
           jfmg.interp_to_points(jc.mesh, pts, vals[:, 0], k=6, grad=grad))


def test_warm_start_beats_a_cold_start(coarse):
    _, tc = coarse
    warm, cold = _port(32), _port(32)
    fmg.prolong_flow_state(tc, warm)
    hw, hc = warm.advance(1), cold.advance(1)
    assert hw[0][1] < hc[0][1]


def test_distributed_prolongation_raises(coarse):
    _, tc = coarse
    fine = _port(8)
    fine.partition = object()  # the distributed branch (a Partition's model)
    with pytest.raises(ConfigError, match="item 8"):
        fmg.prolong_flow_state(tc, fine)
