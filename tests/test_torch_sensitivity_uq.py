"""Monte Carlo and polynomial chaos of the diffusion-family models against
fvm_tpu (float64, CPU).

The four cases of ``tests/test_torch_sensitivity.py`` (its ``pair``
fixture: both packages converged from the same numpy inputs): per-cell
Monte-Carlo samples (zero-padded and ghost-extended) and a 2-D
polynomial-chaos expansion, each against fvm_tpu's at 1e-8 of the largest
entry (the PC coefficients at 1e-8 of the mean's largest entry, since a
cross term may be round-off alone).
"""

import numpy as np

from test_torch_newton import one_thread  # noqa: F401
from test_torch_sensitivity import CASES, close, pair  # noqa: F401


def test_mc_matches(pair):
    """Per-cell samples (zero-padded and ghost-extended; scalar samples:
    ``test_vacancy_tangent_and_samples_are_analytic``)."""
    name, jm, tm, n, x = pair
    key, scale = CASES[name][2], CASES[name][3]
    rng = np.random.default_rng(3)
    fields = (1.0 + rng.uniform(0.0, 1.0, size=(2, n))) * scale
    close(tm.solve_mc(key, fields, niter=2),
          jm.solve_mc(key, fields, niter=2))


def test_pc_matches(pair):
    """A 2-D expansion of total order 2 on 2 x 2 Gauss-Hermite nodes."""
    name, jm, tm, n, x = pair
    key, scale = CASES[name][2], CASES[name][3]
    left = (x < 0.5).astype(float)
    mean, dirs = 2.0 * scale, [0.2 * scale * left, 0.2 * scale * (1 - left)]
    pj = jm.solve_pc(key, mean, dirs, order=2, quad_points=2, niter=3)
    pt = tm.solve_pc(key, mean, dirs, order=2, quad_points=2, niter=3)
    assert sorted(pt.coefficients) == sorted(pj.coefficients)
    # each coefficient to 1e-8 of the mean's largest entry (a cross term
    # may be round-off alone)
    top = np.abs(pj.mean()).max()
    for a, c in pj.coefficients.items():
        close(pt.coefficients[a], c, scale=top)
    close(pt.variance(), pj.variance())
    close(pt.eval([0.5, -0.3]), pj.eval([0.5, -0.3]))
