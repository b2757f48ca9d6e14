"""``demos/adjoint_design.py`` against ``cases.adjoint_design`` (float64,
CPU): from the same seeded perturbation of uniform k at 16^2, the hot-wall
objective of each of 3 projected-gradient iterations and the last adjoint
gradient of the whole conductivity field at 1e-10 of their largest
entries.  (The demo's ``build`` and ``project`` run unchanged; its loop is
repeated here, as its ``main`` prints rather than returns.)
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from fvm_tpu.ops import discretizations as jdisc
from fvm_tpu.ops.gradients import gradient as jgradient
from fvm_tpu_torch import cases
from test_torch_newton import one_thread  # noqa: F401

N, STEPS, RTOL = 16, 3, 1e-10


def _demo_loop(D, n, steps):
    """``demos/adjoint_design.py:main``'s loop, returning (J per
    iteration, the last gradient)."""
    nc = n * n
    k = D.project(1.0 + 0.05 * np.random.default_rng(0).standard_normal(nc))
    Js, gK = [], None
    for _ in range(steps):
        t = D.build(k, n)
        Js.append(float(t.getHeatFluxIntegral("left")))
        grp = t.mesh.group_by_name("left")
        T_tail = jnp.asarray(t.state["T"])[nc:]

        def functional(T_int, params, t=t, grp=grp, T_tail=T_tail):
            T_full = jnp.concatenate([T_int, T_tail])

            def face_flux(m, T, kk, grad_coeff=None):
                gamma_f = jdisc.harmonic_face_gamma(m, kk)
                gradT = (jgradient(m, grad_coeff, T)
                         if grad_coeff is not None else None)
                return jdisc.diffusion_flux(m, T, gamma_f, gradT).F

            args = (T_full, params["k_cell"])
            if "grad_coeff" in params:
                args = args + (params["grad_coeff"],)
            return -t._sum_group(grp, t._map_mesh(face_flux, *args))

        gK = t.solve_adjoint(functional, ["k_cell"])["k_cell"]
        k = D.project(k - 2.0 * gK / (np.abs(gK).max() + 1e-30))
    return np.asarray(Js), np.asarray(gK)


def test_adjoint_design_matches_the_demo():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demos"))
    import adjoint_design as D

    Jj, gj = _demo_loop(D, N, STEPS)
    out = cases.adjoint_design(N, STEPS, device="cpu")
    np.testing.assert_allclose(out["J"], Jj, rtol=0,
                               atol=RTOL * np.abs(Jj).max())
    np.testing.assert_allclose(out["grad"], gj, rtol=0,
                               atol=RTOL * np.abs(gj).max())
    # the demo's claim: the layout insulates better than uniform k (J =
    # 100 there), and each step lowers the flux
    assert out["J"][-1] < 100.0 and np.all(np.diff(out["J"]) < 0)
    k = out["k"]
    assert abs(k.mean() - 1.0) < 1e-9 and k.min() >= 0.2 and k.max() <= 5.0
