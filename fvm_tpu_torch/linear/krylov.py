"""Krylov solvers: BiCGStab and damped Jacobi (``fvm_tpu/linear/krylov.py``).

Counterparts of the reference's BCGStab (BCGStab.h:20) and JacobiSolver
(JacobiSolver.h:20).  A preconditioner is itself a LinearSolver exposing
``precond_setup(A) -> (r -> z)``.  Loops are the fixed-trip frozen form
described in ``linear/base.py``.  GMRES, CG and the chunked
``init_carry``/``solve_chunk`` protocol are not ported yet.
"""

from __future__ import annotations

import torch

from .base import LinearSolver, SolveStats, condensed, prepared


def _setup_precond(precond, A):
    """Resolve a preconditioner to an r -> z function with its setup
    hoisted out of the iteration loop."""
    if precond is None:
        return lambda r: r
    return precond.precond_setup(A)


def _stall_tol(dtype):
    """Shadow-orthogonality threshold for the rho-breakdown restart (opt-in
    ``stall_restart``): when |<rhat, r>| < tol |rhat| |r| the Krylov
    sequence restarts at the current residual."""
    return 1e-8 if dtype == torch.float64 else 1e-4


class BiCGStab(LinearSolver):
    """Preconditioned BiCGStab (general nonsymmetric systems).

    Multi-RHS vectors (n, m) run ONE block recurrence: ``A.dot`` sums over
    all (n, m) entries, so the components share alpha, beta and omega, as
    in the JAX package.  The best iterate seen is returned, and the
    iteration stops (freezes) on clear divergence."""

    def __init__(self, preconditioner: LinearSolver | None = None,
                 stall_restart: bool = False, **kw):
        super().__init__(**kw)
        self.preconditioner = preconditioner
        self.stall_restart = stall_restart

    def solve_fn(self, A, b, x0, target=None):
        """``target``: optional ABSOLUTE residual-norm target overriding
        max(rtol*|b - A x0|, atol)."""
        A, b, recover = condensed(A, b)
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        rtol, atol, maxit = (
            self.relativeTolerance,
            self.absoluteTolerance,
            self.nMaxIterations,
        )
        dev, dt = b.device, b.dtype
        tiny = torch.tensor(1e-300 if dt == torch.float64 else 1e-30,
                            dtype=dt, device=dev)

        r0 = A.residual(x0, b)
        rnorm0 = A.norm(r0)
        if target is None:
            target = torch.clamp(rtol * rnorm0, min=atol)
        else:
            target = torch.as_tensor(target, dtype=dt, device=dev)
        # divergence guard in one unit (the residual norm): stop and return
        # the best iterate once rn leaves 1e8 * (|r0| + atol)
        limit = 1e8 * (rnorm0 + atol)
        stol = _stall_tol(dt) if self.stall_restart else 0.0

        one = torch.ones((), dtype=dt, device=dev)
        i = torch.zeros((), dtype=torch.int64, device=dev)
        x, r = x0, r0
        p = torch.zeros_like(b)
        v = torch.zeros_like(b)
        rho = alpha = omega = one
        rn = bnorm = rhn = rnorm0
        bx, rhat = x0, r0
        for _ in range(maxit):
            active = (rn > target) & torch.isfinite(rn) & (rn < limit)

            rho_raw = A.dot(rhat, r)
            stall = rho_raw.abs() < stol * rhn * rn
            rhat_n = torch.where(stall, r, rhat)
            rhn_n = torch.where(stall, rn, rhn)
            rho_n = torch.where(stall, rn * rn, rho_raw)
            beta = (rho_n / torch.where(rho.abs() > tiny, rho, tiny)) * (
                alpha / torch.where(omega.abs() > tiny, omega, tiny)
            )
            p_n = torch.where(stall, r, r + beta * (p - omega * v))
            phat = M(p_n)
            v_n = A.mv(phat)
            denom = A.dot(rhat_n, v_n)
            alpha_n = rho_n / torch.where(denom.abs() > tiny, denom, tiny)
            s = r - alpha_n * v_n
            shat = M(s)
            t = A.mv(shat)
            tt = A.dot(t, t)
            omega_n = A.dot(t, s) / torch.where(tt > tiny, tt, tiny)
            x_n = x + alpha_n * phat + omega_n * shat
            r_n = s - omega_n * t
            rn_n = A.norm(r_n)
            better = torch.isfinite(rn_n) & (rn_n < bnorm)

            i = i + active.to(i.dtype)
            bx = torch.where(active & better, x_n, bx)
            bnorm = torch.where(active & better, rn_n, bnorm)
            x, r, p, v, rhat = (
                torch.where(active, a, c) for a, c in
                ((x_n, x), (r_n, r), (p_n, p), (v_n, v), (rhat_n, rhat)))
            rho, alpha, omega, rn, rhn = (
                torch.where(active, a, c) for a, c in
                ((rho_n, rho), (alpha_n, alpha), (omega_n, omega), (rn_n, rn),
                 (rhn_n, rhn)))
        return recover(bx), SolveStats(i, rnorm0, bnorm, bnorm <= target)


class JacobiSolver(LinearSolver):
    """Damped-Jacobi relaxation solver / preconditioner (JacobiSolver.h:20)."""

    def __init__(self, omega: float = 0.7, sweeps: int = 5, **kw):
        super().__init__(**kw)
        self.omega = omega
        self.sweeps = sweeps

    def precond_setup(self, A):
        A = prepared(A)
        omega, sweeps = self.omega, self.sweeps

        def M(r):
            z = A.diag_solve(r)
            for _ in range(sweeps - 1):
                z = z + omega * A.diag_solve(A.residual(z, r))
            return z

        return M

    def solve_fn(self, A, b, x0):
        A, b, recover = condensed(A, b)
        A = prepared(A)
        rtol, atol, maxit = (
            self.relativeTolerance,
            self.absoluteTolerance,
            self.nMaxIterations,
        )
        rnorm0 = A.norm(A.residual(x0, b))
        target = torch.clamp(rtol * rnorm0, min=atol)
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        x, rn = x0, rnorm0
        for _ in range(maxit):
            active = rn > target
            x_n = A.jacobi_step(x, b, self.omega)
            rn_n = A.norm(A.residual(x_n, b))
            i = i + active.to(i.dtype)
            x, rn = torch.where(active, x_n, x), torch.where(active, rn_n, rn)
        return recover(x), SolveStats(i, rnorm0, rn, rn <= target)
