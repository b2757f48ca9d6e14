"""The port's device-resident outer loops on the CPU (float64).

* ``outerChunk`` > 1 (``Model._advance_chunked``, the flow variant) runs the
  chunk function eagerly on the CPU; on a CUDA mesh the same function is
  one CUDA graph replay (``tests/test_torch_gpu.py``).  Against the port's
  classic per-iteration loop: identical histories and fields.  Against
  fvm_tpu's chunked advance: histories to 1e-8 relative and 1e-12
  absolute (the golden tolerances: the thermal case's second outer
  residual, ~5e-8 after a first of ~980, is where its BiCGStab stopped
  and moves by ~1e-13 between the packages) and fields to 1e-10.  The configurations are those of
  ``tests/test_chunked.py:43, 59, 93``: thermal with an early exit inside a
  chunk, a chunk larger than niter, and the lid-driven cavity in chunks.
* ``cases.coupled_steps`` (k coupled steps as one program) against the
  per-step ``coupled_step`` loop: identical residuals and fields; against
  the ``lax.scan`` of ``bench.py:246-282`` built here from fvm_tpu models:
  residuals to 1e-8, fields to 1e-10.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import AMG as JAMG, BiCGStab as JBiCGStab
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu_torch.cases import coupled_cavity, coupled_step, coupled_steps
from fvm_tpu_torch.interop import load_model_state
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal

HIST_RTOL = 1e-8
HIST_ATOL = 1e-12  # as tests/test_golden_histories.py: round-off floors
FIELD_RTOL = 1e-10


def _mesh(pkg, nx, ny):
    if pkg is tfvm:
        return tfvm.mesh.build_device_mesh(tfvm.mesh.generate.quad_2d(nx, ny),
                                           dtype="float64", device="cpu")
    return jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(nx, ny),
                                       dtype=jnp.float64)


def _drive_thermal(pkg, Thermal, chunk, niter=7, sync=True, stop=True):
    t = Thermal(_mesh(pkg, 24, 24))
    if not stop:  # no early exit: every call runs niter outers
        t.options["relativeTolerance"] = 1e-30
        t.options["absoluteTolerance"] = 0.0
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedHeatFlux"
    t.bc["right"]["specifiedHeatFlux"] = 10.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.options["verbose"] = False
    t.options["residualSync"] = sync
    t.options["outerChunk"] = chunk
    t.init()
    h = t.advance(niter)
    return [(i, float(r)) for i, r in h], np.asarray(t.getTemperature())


def _drive_flow(pkg, Flow, chunk, niter=9):
    f = Flow(_mesh(pkg, 16, 16))
    f.bc["top"].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    for g in ("left", "right", "bottom"):
        f.bc[g].bc_type = "NoSlipWall"
    f.options["verbose"] = False
    f.options["outerChunk"] = chunk
    f.init()
    h = f.advance(niter)
    return [(i, float(m), float(c)) for i, m, c in h], np.asarray(
        f.getVelocity())


def _against_jax(h_t, f_t, h_j, f_j):
    assert [h[0] for h in h_t] == [h[0] for h in h_j]
    np.testing.assert_allclose([h[1:] for h in h_t], [h[1:] for h in h_j],
                               rtol=HIST_RTOL, atol=HIST_ATOL)
    np.testing.assert_allclose(f_t, f_j, rtol=FIELD_RTOL,
                               atol=FIELD_RTOL * float(np.abs(f_j).max()))


@pytest.mark.parametrize("chunk,niter,stop", [
    (4, 7, True), (16, 3, True), (16, 3, False), (3, 7, False)],
    ids=["early-exit", "chunk-above-niter", "chunk-above-niter-no-exit",
         "three-chunks-no-exit"])
def test_thermal_chunked(chunk, niter, stop):
    h0, T0 = _drive_thermal(tfvm, TThermal, 0, niter, stop=stop)
    h1, T1 = _drive_thermal(tfvm, TThermal, chunk, niter, stop=stop)
    assert h1 == h0
    assert np.abs(T0 - T1).max() == 0.0
    # the linear problem exits early (after 2 outers) inside the first
    # chunk; without the tolerances every outer runs
    assert len(h1) == (2 if stop else niter)
    hj, Tj = _drive_thermal(jfvm, JThermal, chunk, niter, stop=stop)
    _against_jax(h1, T1, hj, Tj)


def test_thermal_chunked_without_residual_sync():
    """The thermal chunk path does not depend on residualSync (as in the
    JAX package): the host reads one block per chunk either way."""
    h0, T0 = _drive_thermal(tfvm, TThermal, 0)
    h1, T1 = _drive_thermal(tfvm, TThermal, 4, sync=False)
    assert h1 == h0
    assert np.abs(T0 - T1).max() == 0.0


def test_flow_chunked():
    h0, v0 = _drive_flow(tfvm, TFlow, 0)
    h1, v1 = _drive_flow(tfvm, TFlow, 4)
    assert len(h1) == 9
    assert h1 == h0
    assert np.abs(v0 - v1).max() == 0.0
    hj, vj = _drive_flow(jfvm, JFlow, 4)
    _against_jax(h1, v1, hj, vj)


def _jax_coupled_cavity(n):
    """The JAX package's models in the bench.py:main() configuration."""
    dmesh = _mesh(jfvm, n, n)
    flow = JFlow(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc["top"]["specifiedXVelocity"] = 1.0
    flow.options["pressureLinearSolver"] = JAMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    flow.options["momentumLinearSolver"] = JBiCGStab(
        relative_tolerance=1e-2, max_iterations=10)
    flow.init()
    thermal = JThermal(dmesh)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = JAMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "SpecifiedTemperature"
    thermal.bc["right"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "Symmetry"
    thermal.bc["top"].bc_type = "Symmetry"
    thermal.init()
    return flow, thermal


def _jax_scan(flow, thermal, k):
    """bench.py:246-282: k coupled steps as one lax.scan."""
    fstep, tstep = flow._step_raw, thermal._step_raw
    fbc, tbc = flow._resolve_bcvals(), thermal._resolve_bcvals()

    def one(carry, _):
        fstate, tstate = carry
        fstate, faux = fstep(flow.mesh, flow.params, fstate, fbc)
        tstate = dict(tstate, massFlux=fstate["massFlux"])
        tstate, taux = tstep(thermal.mesh, thermal.params, tstate, tbc)
        return (fstate, tstate), (faux["mom_norm"], faux["cont_norm"],
                                  taux["rnorm"])

    @jax.jit
    def run(fstate, tstate):
        (fstate, tstate), res = jax.lax.scan(one, (fstate, tstate), None,
                                             length=k)
        return fstate, tstate, res

    fs, ts, res = run(flow.state, thermal.state)
    flow.state, thermal.state = fs, ts
    return np.stack([np.asarray(r) for r in res], axis=1)


def test_coupled_steps():
    n = 16
    # the per-step loop and coupled_steps from the same start
    fa, ta = coupled_cavity(n, device="cpu", dtype="float64")
    per_step = np.array([[float(v) for v in coupled_step(fa, ta)]
                         for _ in range(5)])
    fb, tb = coupled_cavity(n, device="cpu", dtype="float64")
    fused = torch.cat([coupled_steps(fb, tb, 3), coupled_steps(fb, tb, 2)])
    assert tuple(fused.shape) == (5, 3)
    np.testing.assert_array_equal(fused.numpy(), per_step)
    for key in ("velocity", "pressure", "massFlux"):
        assert torch.equal(fa.state[key], fb.state[key])
    assert torch.equal(ta.state["T"], tb.state["T"])
    assert tb.state["massFlux"] is fb.state["massFlux"]
    # against the JAX package's fused scan from the same state
    jf, jt = _jax_coupled_cavity(n)
    tf, tt = coupled_cavity(n, device="cpu", dtype="float64")
    for jm, tm in ((jf, tf), (jt, tt)):
        load_model_state(
            tm, {k: np.asarray(v) for k, v in jm.state.items()},
            {k: np.asarray(v) for k, v in jm.params.items()})
    res_j = _jax_scan(jf, jt, 4)
    res_t = coupled_steps(tf, tt, 4).numpy()
    np.testing.assert_allclose(res_t, res_j, rtol=HIST_RTOL)
    for t, j in ((tf.state["velocity"], jf.state["velocity"]),
                 (tt.state["T"], jt.state["T"])):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=FIELD_RTOL,
                                   atol=FIELD_RTOL * float(np.abs(j).max()))


def test_pack_unpack_and_info_check():
    """A chunk's results travel in one float64 tensor (one read-back), and
    a factorisation's ``info`` raises SolverError when it is not 0 (on the
    CPU at once; inside a CUDA graph capture after the replay)."""
    from fvm_tpu_torch.exceptions import SolverError
    from fvm_tpu_torch.linear import DirectSolver
    from fvm_tpu_torch.linear.base import check_info
    from fvm_tpu_torch.models.base import pack, unpack
    from fvm_tpu_torch.ops.ell import ELLMatrix

    hist = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, float("nan")])]
    packed = pack(hist, torch.tensor(1), torch.tensor(True),
                  torch.tensor(5.0), torch.tensor(6.0))
    rows, cnt, done, norms = unpack(packed, 2, width=2)
    assert rows[0] == (1.0, 2.0) and rows[1][0] == 3.0
    assert (cnt, done, norms) == (1, True, (5.0, 6.0))
    check_info(torch.zeros((), dtype=torch.int32), "ok")
    with pytest.raises(SolverError, match="singular"):
        check_info(torch.ones((), dtype=torch.int32), "singular")
    n = 4
    A = ELLMatrix(diag=torch.zeros(n, dtype=torch.float64),
                  off=torch.zeros((1, n), dtype=torch.float64),
                  cols=torch.arange(n)[None, :],
                  mask=torch.zeros((1, n), dtype=torch.bool))
    with pytest.raises(SolverError, match="DirectSolver"):
        DirectSolver().solve_fn(A, torch.ones(n, dtype=torch.float64),
                                torch.zeros(n, dtype=torch.float64))


def test_dropped_models_free_their_runners_at_once():
    """A model holds its runners (on a CUDA mesh, their captured graphs)
    and nothing a runner holds leads back to the model: dropped models are
    freed by their reference count, without the cycle collector, so no
    dead graph is ever freed in the middle of another capture."""
    import gc
    import weakref

    collecting = gc.isenabled()
    gc.disable()
    try:
        flow, thermal = coupled_cavity(8, device="cpu", dtype="float64")
        coupled_steps(flow, thermal, 2)
        for model in (flow, thermal):
            model.options["outerChunk"] = 2
            model.options["residualSync"] = True
            model.advance(3)
        assert len(flow._runners) == 2 and len(thermal._runners) == 1
        refs = [weakref.ref(m) for m in (flow, thermal)]
        del flow, thermal, model
        assert [r() for r in refs] == [None, None]
    finally:
        if collecting:
            gc.enable()
