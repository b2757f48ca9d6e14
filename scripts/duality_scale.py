"""The JAX package's own adjoint-tangent duality on the sensitivity slab,
by size.

    python3 -m scripts.duality_scale [--sizes 64,128,256,512]

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference, and nothing of the port).  For each n it builds the
variable-conductivity slab of ``tests/test_sensitivity.py:382-411`` on
``quad_2d(n, n)`` (the port's ``cases.sensitivity_slab``), converges it,
and prints:

* the duality gap |<grad, v> - mean(dT . v)| / |mean(dT . v)| between
  ``solve_adjoint`` of the mean temperature and ``solve_tangent`` along a
  random direction v (numpy seed 0);
* the adjoint's transposed solve alone (``LinearSolver.transpose_solve_fn``'s
  BiCGStab(Jacobi(3)) at min(rtol, 1e-10), at most max(4 maxit, 400)
  iterations) on the mean's gradient: its iterations, final relative
  residual and whether it reached its tolerance.

From the size where the transposed solve stops at its cap the gap grows
with the solve's remainder: it is a fact about the reference's adjoint
solver at scale, which the port keeps (ROADMAP queue 3).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import fvm_tpu as fvm
    from fvm_tpu.linear import BiCGStab, JacobiSolver
    from fvm_tpu.linear.base import TransposedOperator
    from fvm_tpu.mesh.generate import quad_2d
    from fvm_tpu.models import ThermalModel

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,128,256,512")
    args = ap.parse_args()
    for n in (int(v) for v in args.sizes.split(",")):
        t0 = time.time()
        dm = fvm.mesh.build_device_mesh(quad_2d(n, n), dtype=jnp.float64)
        t = ThermalModel(dm)
        t.options["verbose"] = False
        N = dm.n_interior_cells
        t.vc["thermalConductivity"] = 1.0 + 0.5 * np.linspace(0, 1, N)
        t.bc["left"].bc_type = "SpecifiedTemperature"
        t.bc["left"]["specifiedTemperature"] = 400.0
        t.bc["right"].bc_type = "SpecifiedHeatFlux"
        t.bc["right"]["specifiedHeatFlux"] = 10.0
        t.bc["top"].bc_type = "Symmetry"
        t.bc["bottom"].bc_type = "Symmetry"
        t.init()
        hist = t.advance(30)
        v = np.random.default_rng(0).standard_normal(N)
        dT = t.solve_tangent({"k_cell": v})
        g = t.solve_adjoint(lambda T: jnp.mean(T), ["k_cell"])["k_cell"]
        want = float(np.mean(dT))
        gap = abs(float(np.dot(g, v)) - want) / abs(want)
        A, _ = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
        s = t.options["linearSolver"]
        solver = BiCGStab(
            preconditioner=JacobiSolver(sweeps=3),
            relative_tolerance=min(s.relativeTolerance, 1e-10),
            absolute_tolerance=s.absoluteTolerance,
            max_iterations=max(s.nMaxIterations * 4, 400))
        b = jnp.zeros(A.n).at[:N].set(1.0 / N)
        _, st = solver.solve_fn(TransposedOperator(A), b, jnp.zeros_like(b))
        print(f"{n}^2: {len(hist)} outers; duality gap {gap:.3e}; "
              f"transposed solve {int(st.iterations)} iterations, relative "
              f"residual {float(st.residual) / float(st.residual0):.3e}, "
              f"converged {bool(st.converged)} ({time.time() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
