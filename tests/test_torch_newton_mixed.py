"""The mixed-precision Newton endgame and the converge path (CPU).

* ``newtonInnerPrecision="float32"`` (``tests/test_flow.py:552``, at
  16^2): the Newton state, rhs and update stay float64 while the inner
  solve runs on float32 views of (mesh, params, state).  The float32 inner
  path differs between the packages by float32 round-off, amplified by
  the loose BiCGStab solves, so their iterates cannot be compared.  What
  both must reach is the same float64 root: the fixed point of the float64
  residual, whatever inexact steps led there (each Newton step recomputes
  the rhs in float64, so the inner solve's errors only cost steps).  So:
  one ``advance(1)`` after the endgame below 1e-8 of the first outer's
  residual in both, velocities within 1e-9 (of the largest), the state
  still float64, and the number of Newton steps to an entry residual
  below 1e-7 of it within one of each other.  Five Newton steps, not the
  reference test's six: at 16^2 the sixth starts at round-off (2.5e-14 of
  the first residual), where a float32 inner solve cannot make progress
  and spends its whole 1500-iteration budget.
* ``cases.converge_cavity(32, device="cpu")``, the counterpart of
  ``bench.py``'s converge mode, with the Newton and the Anderson polish:
  it reaches 1e-6 and returns bench's keys.
"""

import numpy as np
import pytest
import torch

from fvm_tpu_torch.cases import converge_cavity
from test_torch_newton import one_thread, _models, entry  # noqa: F401

BENCH_KEYS = {"metric", "target_rel", "reached_rel", "converged", "n_cells",
              "value", "unit", "outer_steps", "phases"}


def test_mixed_precision_newton_reaches_the_float64_root(entry):
    jf, tf = _models(entry, newtonChunkIterations=40,
                     newtonInnerPrecision="float32",
                     newtonKrylovTolerance=1e-3)
    hj, ht = jf.advanceNewton(5), tf.advanceNewton(5)
    assert tf.state["velocity"].dtype == torch.float64
    n0 = entry[1][0]
    for f in (jf, tf):
        assert float(f.advance(1)[0][1]) / n0 < 1e-8
    Vj = jf.getVelocity()
    np.testing.assert_allclose(tf.getVelocity(), Vj, rtol=0,
                               atol=1e-9 * np.abs(Vj).max())

    def steps(h):
        return next((k for k, r in enumerate(h) if float(r[1]) / n0 < 1e-7),
                    len(h))

    assert abs(steps(ht) - steps(hj)) <= 1


@pytest.mark.parametrize("polish", ["newton", "anderson"])
def test_converge_cavity_reaches_the_target(polish):
    r = converge_cavity(32, device="cpu", polish=polish)
    assert set(r) == BENCH_KEYS
    assert r["metric"] == "time_to_rel_residual" and r["converged"]
    assert r["reached_rel"] < r["target_rel"] == 1e-6
    assert r["phases"]["f32_steps"] > 0 and r["value"] > 0
    assert bool(r["phases"]["newton"]) == (polish == "newton")
    for tr in r["phases"]["newton"]:
        assert {"entry_rel", "eta", "inner_its", "inner_rel", "s"} <= set(tr)


def test_converge_cavity_needs_a_gpu_or_the_cpu(monkeypatch):
    """With no GPU and no ``device="cpu"`` the entry point raises."""
    from fvm_tpu_torch.exceptions import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        converge_cavity(8)
