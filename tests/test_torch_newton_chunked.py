"""The port's chunked Newton endgame against fvm_tpu (float64, CPU).

The inner Krylov solve in chunks of 25 iterations (``models/newton.py``;
on the CPU the chunks run eagerly, on a CUDA mesh as graph replays), from
fvm_tpu's 16^2 cavity state after 60 SIMPLE outers, the counterparts of
``tests/test_flow.py:422, 527``:

* BiCGStab with ``newtonForcing="fixed"`` at inner tolerance 1e-8: entry
  residual histories at rtol 1e-8 with atol 1e-12 and both packages at the
  SIMPLE fixed point (``tests/test_torch_newton.py`` says why the inner
  solves are tight);
* GMRES(30) with the default Eisenstat-Walker forcing (its least-squares
  residual is monotone within a cycle, and its history is not sensitive to
  round-off the way BiCGStab's is at loose tolerances): the same checks;
* the port alone at ``tests/test_flow.py:527``'s own settings (inner
  tolerance 1e-5, Eisenstat-Walker forcing): it reaches the fixed point.
"""

from test_torch_newton import (  # noqa: F401
    FIXED_POINT, _models, _run, entry, one_thread)


def test_newton_chunked_matches(entry):
    """``tests/test_flow.py:527``: chunks of 25 inner iterations."""
    _, tf = _run(entry, 3, newtonChunkIterations=25, newtonForcing="fixed")
    assert max(t["inner_its"] for t in tf._newton_trace) > 25


def test_newton_gmres_inner_matches(entry):
    """``tests/test_flow.py:422``: GMRES(30) inner solves in chunks."""
    jf, tf = _run(entry, 3, newtonChunkIterations=25,
                  newtonInnerSolver="gmres", newtonGmresRestart=30)
    assert [t["inner_its"] for t in tf._newton_trace] == [
        t["inner_its"] for t in jf._newton_trace]


def test_newton_reference_settings_reach_the_fixed_point(entry):
    """The port at ``tests/test_flow.py:527``'s own settings (inner
    tolerance 1e-5, Eisenstat-Walker forcing, chunks of 25): the last
    step's entry is below 1e-6 of the first outer's residual and one
    SIMPLE step after it below 1e-9."""
    _, tf = _models(entry, newtonChunkIterations=25)
    hn = tf.advanceNewton(4)
    n0 = entry[1][0]
    assert hn[-1][1] / n0 < 1e-6
    assert float(tf.advance(1)[0][1]) / n0 < FIXED_POINT
