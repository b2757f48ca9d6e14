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
from ..ops.dia_kernel import launch_scope, untracked


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


def distributed(A) -> bool:
    """Whether an operator is a shard's local operator: its reductions
    all-reduce over the ranks (``ELLMatrix.psum``)."""
    A = getattr(A, "surrogate", A)
    return getattr(A, "group", None) is not None


def psum(A, v):
    """``A.psum(v)``: the sum over the ranks of a distributed operator,
    else ``v``."""
    return A.psum(v) if hasattr(A, "psum") else v


def dots(A, *pairs):
    """<a, b> of each pair, stacked, with one sum over the ranks: each is
    the operator's own sum on this rank (``local_dot`` of a distributed
    ``ELLMatrix``, else ``dot``), then ``psum`` (the identity on one
    device).  Every single-device ``dot`` is ``torch.sum(a * b)`` but the
    kinetic operators' (``kinetic/esbgk._sum2``: ordinates, then cells),
    so on one device each entry equals ``A.dot(a, b)`` bit for bit."""
    A = getattr(A, "surrogate", A)
    f = getattr(A, "local_dot", A.dot)
    return psum(A, torch.stack([f(a, b) for a, b in pairs]))


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

    def transpose_solve_fn(self, A, b):
        """Solve A^T y = b (adjoint systems; ``fvm_tpu/linear/base.py:
        226-246``).  AMG and ILU hierarchies are set up for A, not A^T, so
        the adjoint runs Jacobi(3)-preconditioned BiCGStab on the
        materialized transpose (``TransposedOperator``; the two share the
        diagonal), at min(rtol, 1e-10) in at most max(4 maxit, 400)
        iterations.  The solve stops once every later trip would be frozen
        (``exit_every``: the same result).  Its stats are kept in
        ``transpose_stats``."""
        from .krylov import BiCGStab, JacobiSolver

        solver = BiCGStab(
            preconditioner=JacobiSolver(sweeps=3),
            relative_tolerance=min(self.relativeTolerance, 1e-10),
            absolute_tolerance=self.absoluteTolerance,
            max_iterations=max(self.nMaxIterations * 4, 400),
        )
        solver.exit_every = TRANSPOSE_EXIT_EVERY
        with launch_scope("transposed solve"), untracked():
            y, self.transpose_stats = solver.solve_fn(
                TransposedOperator(A), b, torch.zeros_like(b))
        return y

    def solve_fn_implicit(self, A, b, x0, transposable: bool = False):
        """A solve that is differentiated implicitly
        (``fvm_tpu/linear/base.py:248-288``, ``lax.custom_linear_solve``):
        x = A^-1 b by ``solve_fn`` from zero, and

        * forward mode (``torch.func.jvp``): dx = A^-1 (db - dA x), solved
          by the same solver, with dA x a product on the tangent's values
          (``dia_stencil`` on its coefficients for a DIA matrix);
        * reverse mode, only with ``transposable``: b-bar = lambda =
          A^-T x-bar (``transpose_solve_fn``) and A-bar = -lambda x^T on
          A's slots.

        Differentiating the Krylov loop itself would give zero tangents
        once the loop stops at the primal solution.  ``A`` is an
        ``ELLMatrix``; ``x0`` is ignored, as in the JAX package.  Stats
        are not returned."""
        x = _ImplicitSolve.apply(A.diag, A.off, b, self, A, transposable)
        return x, None

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

    def psum(self, v):
        return psum(self.surrogate, v)

    def diag_solve(self, r):
        return self.surrogate.diag_solve(r)

    def jacobi_step(self, x, b, omega=1.0):
        return x + omega * self.diag_solve(b - self.mv(x))


class DiagonalSurrogate:
    """A ``MatrixFreeOperator`` surrogate given by a diagonal alone (the
    unknowns' shape): the reductions over all entries and the Jacobi
    diagonal solve, for residuals assembled without a matrix."""

    def __init__(self, diag):
        self.diag = diag

    def dot(self, a, b):
        return torch.sum(a * b)

    def norm(self, x):
        return torch.sqrt(torch.sum(x * x))

    def diag_solve(self, r):
        return r / self.diag


# trips between the early-exit read-backs of the default JFNK solvers'
# eager loops (``linear/krylov._all_frozen``: the same result)
JFNK_EXIT_EVERY = 10


# the JFNK models replay the product from a CUDA graph up to this many cells
# (there an eager product is launch-bound); above it the reverse-mode
# product is faster: NVIDIA H100 80GB HBM3, 700.00 W, the 630,784-cell
# cantilever, 18.6 ms reverse against 45.2 ms graph (chip_smoke.py phase
# 24)
GRAPH_PRODUCT_MAX_CELLS = 1 << 17


def product_mode(x) -> str:
    """The ``newton_operator`` mode of the JFNK models' Jacobian products
    for unknowns ``x``: "graph" (torch.func.jvp replayed from a CUDA graph
    captured once per outer) on a CUDA mesh of up to
    GRAPH_PRODUCT_MAX_CELLS cells, where an eager product is
    launch-bound; else "reverse" (the backward pass of the residual's
    reverse-mode product, built once per outer)."""
    small = x.shape[0] <= GRAPH_PRODUCT_MAX_CELLS
    return "graph" if x.is_cuda and small else "reverse"


def newton_operator(residual_fn, x, mode: str = "forward"):
    """A v = -dR/dx|_x . v, linearised at x.

    ``mode`` "forward": one forward-mode AD product (``torch.func.jvp``)
    per application.  "graph" (a CUDA ``x`` only): the same product
    captured once in a CUDA graph (``models/chunk.Graph``) and replayed
    per application, its input copied into the graph's buffer; an eager
    product of a small residual is some hundreds of kernel launches that
    the host launches slower than the card runs them.  "reverse": the same
    product as the derivative of the reverse-mode product u -> (dR/dx)^T
    u (linear in u) with respect to u: R's graph and its backward graph
    are built once at x, and each application is one backward pass
    through them, run by the autograd engine with no Python per
    operation.  All are exact; "reverse" differs from the others in the
    rounding of the sums only."""
    if mode == "forward":
        def mv(v):
            return -torch.func.jvp(residual_fn, (x,), (v,))[1]

        return mv
    if mode == "graph":
        from ..models.chunk import Graph

        if not x.is_cuda:
            raise ValueError("newton_operator: mode 'graph' needs a CUDA "
                             "tensor")
        v_in = torch.zeros_like(x)

        def product():
            return torch.func.jvp(residual_fn, (x,), (v_in,))[1]

        graph = Graph(product, product, x.device)

        def mv_graph(v):
            v_in.copy_(v)
            graph.replay()
            return -graph.outputs  # a new tensor: the next replay rewrites

        return mv_graph
    if mode != "reverse":
        raise ValueError(f"newton_operator: unknown mode {mode!r}")
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        r = residual_fn(xg)
        ub = torch.zeros_like(r, requires_grad=True)
        (g,) = torch.autograd.grad(r, xg, ub, create_graph=True)

    def mv_rev(v):
        return -torch.autograd.grad(g, ub, v, retain_graph=True)[0]

    return mv_rev


# trips between the early-exit read-backs of the adjoint's transposed solve
TRANSPOSE_EXIT_EVERY = 20


def _with_values(A, diag, off):
    """``A`` with its diagonal and slot values replaced (unprepared)."""
    return A.replace(diag=diag, off=off, dia_coef=None, dia_fb_vals=None)


class _ImplicitSolve(torch.autograd.Function):
    """x = A^-1 b over (A.diag, A.off, b) (``solve_fn_implicit``)."""

    @staticmethod
    def forward(diag, off, b, solver, A, transposable):
        with untracked():
            x, _ = solver.solve_fn(_with_values(A, diag, off), b,
                                   torch.zeros_like(b))
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        diag, off, _, solver, A, transposable = inputs
        ctx.solver, ctx.A, ctx.transposable = solver, A, transposable
        ctx.save_for_forward(diag, off, output)
        ctx.save_for_backward(diag, off, output)

    @staticmethod
    def jvp(ctx, ddiag, doff, db, *_):
        diag, off, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if db is None else db
        if ddiag is not None or doff is not None:
            dA = _with_values(
                ctx.A, torch.zeros_like(diag) if ddiag is None else ddiag,
                torch.zeros_like(off) if doff is None else doff)
            with launch_scope("tangent dA x"):
                rhs = rhs - dA.mv(x)
        # the tangent solve as the Function again: under torch.func the
        # rule sees wrapped tensors, which only a forward unwraps
        with launch_scope("tangent solve"):
            return _ImplicitSolve.apply(diag, off, rhs, ctx.solver, ctx.A,
                                        False)

    @staticmethod
    def backward(ctx, gx):
        if not ctx.transposable:
            raise RuntimeError(
                "solve_fn_implicit: reverse mode needs transposable=True")
        diag, off, x = ctx.saved_tensors
        A = ctx.A
        lam = ctx.solver.transpose_solve_fn(_with_values(A, diag, off), gx)
        # A-bar = -lambda x^T sampled on A's diagonal and slots
        prod = lam * x
        gd = -(prod if x.ndim == 1 else prod.sum(dim=1))
        xs = x[A.cols]
        goff = -(lam * xs if x.ndim == 1 else (lam[None] * xs).sum(dim=2))
        goff = torch.where(A.mask, goff, 0.0)
        return gd, goff, lam, None, None, None


class TransposedOperator:
    """A^T as a solver-facing operator (adjoint systems;
    ``fvm_tpu/linear/base.py:138-190``).

    The JAX package applies ``jax.linear_transpose`` of A's product and
    drops its Pallas kernel, which has no transpose rule.  Here A^T is
    materialized once per solve (``ELLMatrix.transposed``): for a DIA
    matrix a DIA operator, so every product, residual and Jacobi step of
    the adjoint solve launches ``dia_stencil`` on a CUDA tensor.  The
    diagonal is shared (diag(A^T) = diag(A)), and with it the Jacobi
    preconditioner.  No condensation: the transpose is applied as it is,
    as in the JAX package."""

    def __init__(self, A):
        self._A = A
        self._At = A.transposed().prepare()

    @property
    def n(self):
        return self._A.n

    def prepare(self):
        return self

    def mv(self, x):
        return self._At.mv(x)

    def residual(self, x, b):
        return self._At.residual(x, b)

    def jacobi_step(self, x, b, omega=1.0):
        return self._At.jacobi_step(x, b, omega)

    def dot(self, a, b):
        return self._A.dot(a, b)

    def norm(self, x):
        return self._A.norm(x)

    def diag_solve(self, r):
        return self._A.diag_solve(r)


class TransposedPrecond:
    """M^-T from a preconditioner that knows its own transpose
    (``fvm_tpu/linear/base.py:196-212``): its ``precond_setup_T`` gives
    the transposed application r -> M^-T r (exact for the closed-form
    Woodbury; a symmetric cycle reuses itself), as good for the transposed
    system as the original is for the primal.  The kinetic adjoint reuses
    the Woodbury(+DSA) composition on A^T through it."""

    def __init__(self, inner):
        self._inner = inner

    def precond_setup(self, op):
        return self._inner.precond_setup_T(op)
