"""Linear solver interfaces (counterpart of ``fvm_tpu/linear/base.py``).

The reference's ``LinearSolver`` (LinearSolver.h:15-35): relative and
absolute tolerances, max iterations, verbosity.  ``solve_fn(A, b, x0) ->
(x, stats)`` is functional; the object holds options and mirrors the
reference's scripting API (``options.linearSolver = AMG(...)``).

Convergence loops run a FIXED number of trips (``max_iterations``) and
freeze the iterate once the stopping test would have ended the JAX
package's ``lax.while_loop``: the stopping test stays on the device (no
``.item()`` per inner iteration), the frozen state is selected with
``torch.where`` so values computed after convergence (NaNs from a
post-convergence breakdown included) never reach the kept state, and the
results equal the while_loop's.  A converged solve still pays up to
``max_iterations`` of work; in exchange the loop has no host round trip
and can later be captured whole in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SolveStats:
    iterations: torch.Tensor  # int64 scalar: trips that were not frozen
    residual0: torch.Tensor  # initial residual norm
    residual: torch.Tensor  # final residual norm
    converged: torch.Tensor  # bool scalar


def norm(x):
    """Frobenius norm over all components."""
    return torch.sqrt(torch.sum(x * x))


def prepared(A):
    """Precompute DIA coefficients once per solve."""
    return A.prepare()


def condensed(A, b):
    """Boundary-row condensation at solve entry.

    Returns (A', b', recover); solvers apply recover to the solution."""
    return A.condense(b)


class LinearSolver:
    """Base options holder (LinearSolver.h:22-35)."""

    def __init__(
        self,
        relative_tolerance: float = 1e-8,
        absolute_tolerance: float = 1e-50,
        max_iterations: int = 100,
        verbosity: int = 0,
    ):
        self.relativeTolerance = relative_tolerance
        self.absoluteTolerance = absolute_tolerance
        self.nMaxIterations = max_iterations
        self.verbosity = verbosity

    def solve_fn(self, A, b, x0):
        raise NotImplementedError

    def solve(self, A, b, x0=None):
        if x0 is None:
            x0 = torch.zeros_like(b)
        x, stats = self.solve_fn(A, b, x0)
        if self.verbosity > 0:
            print(
                f"{type(self).__name__}: iters={int(stats.iterations)} "
                f"r0={float(stats.residual0):.3e} r={float(stats.residual):.3e}"
            )
        return x, stats
