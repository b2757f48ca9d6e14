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

from ..exceptions import SolverError


@dataclass
class SolveStats:
    iterations: torch.Tensor  # int64 scalar: trips that were not frozen
    residual0: torch.Tensor  # initial residual norm
    residual: torch.Tensor  # final residual norm
    converged: torch.Tensor  # bool scalar


# (info, what) pairs registered while a CUDA graph is being captured:
# the capture cannot read them, so the graph's runner checks them after
# each replay (models/chunk.py)
_deferred_checks: list | None = None


def check_info(info, what: str) -> None:
    """Raise SolverError when a LAPACK-style ``info`` (from the ``_ex``
    forms of ``torch.linalg``) is not 0.  While a CUDA graph is captured
    the check is handed to the graph's runner instead, which makes it
    after each replay."""
    if _deferred_checks is not None and info.is_cuda \
            and torch.cuda.is_current_stream_capturing():
        _deferred_checks.append((info, what))
    elif bool((info != 0).any()):
        raise SolverError(f"{what} failed: info {info.tolist()}")


def norm(x):
    """Frobenius norm over all components."""
    return torch.sqrt(torch.sum(x * x))


def prepared(A):
    """Precompute DIA coefficients once per solve."""
    return A.prepare()


def condensed(A, b):
    """Boundary-row condensation at solve entry (a no-op for operators).

    Returns (A', b', recover); solvers apply recover to the solution."""
    if hasattr(A, "condense"):
        return A.condense(b)
    return A, b, (lambda x: x)


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


class MatrixFreeOperator:
    """The exact Jacobian as an operator, with a surrogate matrix for the
    reductions and the diagonal (``fvm_tpu/linear/base.py:103-135``).

    ``mv_fn`` applies the operator (``newton_operator``: forward-mode AD of
    a residual function); ``surrogate`` is an assembled ELL/BlockELL
    approximation used for ``dot``, ``norm`` and ``diag_solve`` and to
    build the preconditioner."""

    def __init__(self, mv_fn, surrogate):
        self._mv = mv_fn
        self.surrogate = surrogate

    def prepare(self):
        return self

    def mv(self, x):
        return self._mv(x)

    def residual(self, x, b):
        return b - self._mv(x)

    def dot(self, a, b):
        return self.surrogate.dot(a, b)

    def norm(self, x):
        return self.surrogate.norm(x)

    def diag_solve(self, r):
        return self.surrogate.diag_solve(r)

    def jacobi_step(self, x, b, omega=1.0):
        return x + omega * self.diag_solve(b - self.mv(x))


def newton_operator(residual_fn, x):
    """A v = -dR/dx|_x . v by one forward-mode AD product
    (``torch.func.jvp``) per application, linearised at x."""

    def mv(v):
        return -torch.func.jvp(residual_fn, (x,), (v,))[1]

    return mv
