"""Krylov solvers: CG, BiCGStab, GMRES and damped Jacobi
(``fvm_tpu/linear/krylov.py``).

Counterparts of the reference's CG (CG.h:20), BCGStab (BCGStab.h:20) and
JacobiSolver (JacobiSolver.h:20), and of the JAX package's restarted
GMRES.  A preconditioner is itself a LinearSolver exposing
``precond_setup(A) -> (r -> z)``.  Loops are the fixed-trip frozen form
described in ``linear/base.py``: no ``.item()`` inside, so a CUDA graph
can capture a solve.  The chunked ``init_carry``/``solve_chunk``
protocol is not ported yet.
"""

from __future__ import annotations

import math

import torch

from .base import LinearSolver, SolveStats, condensed, prepared


def _setup_precond(precond, A):
    """Resolve a preconditioner to an r -> z function with its setup
    hoisted out of the iteration loop."""
    if precond is None:
        return lambda r: r
    return precond.precond_setup(A)


def _target(target, rtol, atol, rnorm0):
    """The absolute residual-norm target: max(rtol |r0|, atol), or the
    caller's, as a device scalar (made on the device, with no host copy:
    a CUDA graph can capture the solve)."""
    if target is None:
        return torch.clamp(rtol * rnorm0, min=atol)
    if isinstance(target, torch.Tensor):
        return target.to(rnorm0.dtype)
    return torch.full((), float(target), dtype=rnorm0.dtype,
                      device=rnorm0.device)


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
        # scalars made on the device (a fill, no host copy: a CUDA graph
        # can capture the solve)
        tiny = torch.full((), 1e-300 if dt == torch.float64 else 1e-30,
                          dtype=dt, device=dev)

        r0 = A.residual(x0, b)
        rnorm0 = A.norm(r0)
        target = _target(target, rtol, atol, rnorm0)
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


class CG(LinearSolver):
    """Preconditioned conjugate gradients (SPD systems), the JAX package's
    ``CG.solve_fn`` (fvm_tpu/linear/krylov.py:38-82) in the frozen form:
    a trip is active while the residual norm is above the target."""

    def __init__(self, preconditioner: LinearSolver | None = None, **kw):
        super().__init__(**kw)
        self.preconditioner = preconditioner

    def solve_fn(self, A, b, x0):
        A, b, recover = condensed(A, b)
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        rtol, atol, maxit = (
            self.relativeTolerance,
            self.absoluteTolerance,
            self.nMaxIterations,
        )
        r0 = A.residual(x0, b)
        z0 = M(r0)
        rnorm0 = A.norm(r0)
        target = torch.clamp(rtol * rnorm0, min=atol)
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        x, r, p, rz, rn = x0, r0, z0, A.dot(r0, z0), rnorm0
        for _ in range(maxit):
            active = rn > target
            Ap = A.mv(p)
            alpha = rz / A.dot(p, Ap)
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z_n = M(r_n)
            rz_n = A.dot(r_n, z_n)
            p_n = z_n + (rz_n / rz) * p
            rn_n = A.norm(r_n)
            i = i + active.to(i.dtype)
            x, r, p, rz, rn = (
                torch.where(active, a, c) for a, c in
                ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz), (rn_n, rn)))
        return recover(x), SolveStats(i, rnorm0, rn, rn <= target)


class GMRES(LinearSolver):
    """Right-preconditioned restarted GMRES(m), the JAX package's
    ``GMRES.solve_fn`` (fvm_tpu/linear/krylov.py:331-505): Arnoldi with
    classical Gram-Schmidt applied twice, Givens rotations, the least
    squares problem solved by back-substitution
    (``torch.linalg.solve_triangular``), the best iterate kept and the
    solve stopped on divergence.

    The frozen form runs ceil(max_iterations / restart) cycles of
    ``restart`` Arnoldi trips each.  The JAX loop may start one more
    cycle after a cycle whose Givens estimate met the target while the
    recomputed residual did not; here no cycle beyond that count runs.
    The rotations are kept as one (m + 1)-square orthogonal matrix, so a
    new Hessenberg column is rotated by one small product instead of a
    chain of m sequential updates (the same rotations, another rounding).
    """

    def __init__(self, preconditioner: LinearSolver | None = None,
                 restart: int = 32, **kw):
        super().__init__(**kw)
        self.preconditioner = preconditioner
        self.restart = int(restart)

    def _cycle(self, A, M, x, b, active0, target):
        """One GMRES(m) cycle from x, every trip frozen once the cycle
        ends; returns (x_new, |b - A x_new|, Arnoldi steps taken)."""
        m = self.restart
        dt, dev = b.dtype, b.device
        tiny = torch.finfo(dt).tiny
        r = b - A.mv(x)
        beta = A.norm(r)
        V = torch.zeros((m + 1,) + tuple(b.shape), dtype=dt, device=dev)
        V[0] = r / torch.clamp(beta, min=tiny)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        # the product of the rotations so far; g = Q (beta e_0)
        Q = torch.eye(m + 1, dtype=dt, device=dev)
        g = torch.zeros(m + 1, dtype=dt, device=dev)
        g[0] = beta
        j = torch.zeros((), dtype=torch.int64, device=dev)
        res = beta
        for jj in range(m):
            active = active0 & (res > target) & torch.isfinite(res)
            w = A.mv(M(V[jj]))
            Vb = V[: jj + 1]
            h1 = torch.einsum("k...,...->k", Vb, w)
            w = w - torch.einsum("k,k...->...", h1, Vb)
            h2 = torch.einsum("k...,...->k", Vb, w)
            w = w - torch.einsum("k,k...->...", h2, Vb)
            hw = A.norm(w)
            h = torch.cat([h1 + h2, hw[None],
                           torch.zeros(m - jj - 1, dtype=dt, device=dev)])
            h = Q @ h  # the earlier rotations
            hj, hj1 = h[jj], h[jj + 1]
            den = torch.sqrt(hj * hj + hj1 * hj1)
            ok = den > tiny
            c = torch.where(ok, hj / torch.clamp(den, min=tiny), 1.0)
            s = torch.where(ok, hj1 / torch.clamp(den, min=tiny), 0.0)
            h = torch.cat([h[:jj], (c * hj + s * hj1)[None],
                           torch.zeros(m - jj, dtype=dt, device=dev)])
            qj, qj1 = Q[jj], Q[jj + 1]
            Q_n = Q.clone()
            Q_n[jj] = c * qj + s * qj1
            Q_n[jj + 1] = c * qj1 - s * qj
            gj = g[jj]
            g_n = g.clone()
            g_n[jj] = c * gj
            g_n[jj + 1] = -s * gj
            H[:, jj] = torch.where(active, h, H[:, jj])
            V[jj + 1] = torch.where(active, w / torch.clamp(hw, min=tiny),
                                    V[jj + 1])
            Q = torch.where(active, Q_n, Q)
            g = torch.where(active, g_n, g)
            res = torch.where(active, torch.abs(g_n[jj + 1]), res)
            j = j + active.to(j.dtype)
        # back-substitution on the j-leading block of R = H[:m, :m]; the
        # rows and columns past j are the identity with a zero right side
        idx = torch.arange(m, device=dev)
        live = idx < j
        R = H[:m]
        eye = torch.eye(m, dtype=dt, device=dev)
        diag = torch.diagonal(R)
        R = torch.where(live[:, None] & live[None, :], R, eye)
        R = R + torch.diag(torch.where(
            live & ~(torch.abs(diag) > tiny), 1.0 - diag, 0.0))
        rhs = torch.where(live, g[:m], 0.0)
        y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
        x_new = x + M(torch.einsum("k,k...->...", y, V[:m]))
        rn_new = A.norm(b - A.mv(x_new))
        return x_new, rn_new, j

    def solve_fn(self, A, b, x0, target=None):
        """``target``: optional ABSOLUTE residual-norm target overriding
        max(rtol |b - A x0|, atol)."""
        A, b, recover = condensed(A, b)
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        atol, maxit = self.absoluteTolerance, self.nMaxIterations
        rnorm0 = A.norm(b - A.mv(x0))
        target = _target(target, self.relativeTolerance, atol, rnorm0)
        limit = 1e8 * (rnorm0 + atol)
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        x, rn, bx, bnorm = x0, rnorm0, x0, rnorm0
        for _ in range(max(1, math.ceil(maxit / self.restart))):
            active = ((i < maxit) & (rn > target) & torch.isfinite(rn)
                      & (rn < limit))
            x_n, rn_n, used = self._cycle(A, M, x, b, active, target)
            better = active & torch.isfinite(rn_n) & (rn_n < bnorm)
            bx = torch.where(better, x_n, bx)
            bnorm = torch.where(better, rn_n, bnorm)
            i = i + torch.where(active, used, 0)
            x, rn = torch.where(active, x_n, x), torch.where(active, rn_n, rn)
        last = torch.isfinite(rn) & (rn <= bnorm)
        x_out = torch.where(last, x, bx)
        rn_out = torch.where(last, rn, bnorm)
        return recover(x_out), SolveStats(i, rnorm0, rn_out, rn_out <= target)


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
