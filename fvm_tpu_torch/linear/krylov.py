"""Krylov solvers: CG, BiCGStab, GMRES and damped Jacobi
(``fvm_tpu/linear/krylov.py``).

Counterparts of the reference's CG (CG.h:20), BCGStab (BCGStab.h:20) and
JacobiSolver (JacobiSolver.h:20), and of the JAX package's restarted
GMRES.  A preconditioner is itself a LinearSolver exposing
``precond_setup(A) -> (r -> z)``.  Loops are the fixed-trip frozen form
described in ``linear/base.py``: no ``.item()`` inside, so a CUDA graph
can capture a solve.

BiCGStab and GMRES also offer the JAX package's chunked protocol:
``init_carry(A, b, x0)`` and ``solve_chunk(A, carry, target)`` run a solve
in pieces of ``max_iterations`` iterations that continue one iteration
exactly (the whole Krylov state rides the carry; iterations count
globally), and ``solve_fn`` is ``init_carry`` plus one ``solve_chunk``, so
the two cannot drift apart.
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


def _all_frozen(solver, trip, active) -> bool:
    """Whether an eager solve may stop: every ``exit_every`` trips (0: never)
    one read-back of the trip's activity, outside a graph capture.  A trip
    that is frozen leaves every later one frozen, so stopping there returns
    the frozen form's result."""
    every = getattr(solver, "exit_every", 0)
    if not every or trip == 0 or trip % every:
        return False
    if active.is_cuda and torch.cuda.is_current_stream_capturing():
        return False
    return not bool(active)


def _tiny(dt, dev):
    """The breakdown guard of the recurrence scalars, as a device scalar."""
    return torch.full((), 1e-300 if dt == torch.float64 else 1e-30,
                      dtype=dt, device=dev)


class BiCGStab(LinearSolver):
    """Preconditioned BiCGStab (general nonsymmetric systems).

    Multi-RHS vectors (n, m) run ONE block recurrence: ``A.dot`` sums over
    all (n, m) entries, so the components share alpha, beta and omega, as
    in the JAX package.  The best iterate seen is kept, and the iteration
    stops (freezes) on clear divergence.

    The carry is the JAX package's 13-tuple
    ``(i, x, r, p, v, rho, alpha, omega, rn, bx, brn, rhat, rnorm0)``;
    |rhat|, which the stall test needs, is recomputed from rhat at the
    start of each chunk (it is |r| at the last restart of the shadow, the
    same number)."""

    def __init__(self, preconditioner: LinearSolver | None = None,
                 stall_restart: bool = False, **kw):
        super().__init__(**kw)
        self.preconditioner = preconditioner
        self.stall_restart = stall_restart

    # --- carry protocol ---------------------------------------------------

    def carry_template(self, vec_shape, dtype, device):
        """Zeros with the carry's structure (a placeholder before the first
        chunk)."""
        z = torch.zeros(vec_shape, dtype=dtype, device=device)
        s = torch.zeros((), dtype=dtype, device=device)
        i = torch.zeros((), dtype=torch.int64, device=device)
        return (i, z, z, z, z, s, s, s, s, z, s, z, s)

    def init_carry(self, A, b, x0):
        """The carry of a solve from x0 (``fvm_tpu`` ``init_carry``)."""
        A = prepared(A)
        r0 = A.residual(x0, b)
        rnorm0 = A.norm(r0)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        return (i, x0, r0, torch.zeros_like(b), torch.zeros_like(b),
                one, one, one, rnorm0, x0, rnorm0, r0, rnorm0)

    def _iterate(self, A, M, carry, target, trips):
        """``trips`` frozen BiCGStab trips from ``carry``; returns the
        carry after them.  A trip is active while the residual norm is
        above ``target``, finite and below 1e8 (|r0| + atol)."""
        (i, x, r, p, v, rho, alpha, omega, rn, bx, brn, rhat,
         rnorm0) = carry
        dt, dev = x.dtype, x.device
        # scalars made on the device (a fill, no host copy: a CUDA graph
        # can capture the solve)
        tiny = _tiny(dt, dev)
        limit = 1e8 * (rnorm0 + self.absoluteTolerance)
        stol = _stall_tol(dt) if self.stall_restart else 0.0
        rhn = A.norm(rhat)
        for trip in range(trips):
            active = (rn > target) & torch.isfinite(rn) & (rn < limit)
            if _all_frozen(self, trip, active):
                break

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
            better = torch.isfinite(rn_n) & (rn_n < brn)

            i = i + active.to(i.dtype)
            bx = torch.where(active & better, x_n, bx)
            brn = torch.where(active & better, rn_n, brn)
            x, r, p, v, rhat = (
                torch.where(active, a, c) for a, c in
                ((x_n, x), (r_n, r), (p_n, p), (v_n, v), (rhat_n, rhat)))
            rho, alpha, omega, rn, rhn = (
                torch.where(active, a, c) for a, c in
                ((rho_n, rho), (alpha_n, alpha), (omega_n, omega), (rn_n, rn),
                 (rhn_n, rhn)))
        return (i, x, r, p, v, rho, alpha, omega, rn, bx, brn, rhat, rnorm0)

    def solve_chunk(self, A, carry, target, trips=None):
        """Up to ``max_iterations`` MORE iterations (or ``trips``) from a
        carry toward the ABSOLUTE residual ``target``
        (``fvm_tpu/linear/krylov.py:133-220``).  Returns (x, stats,
        carry_out): x is the last iterate, or the best one seen when the
        last left 100 (|r0| + atol); stats.iterations counts globally.
        Operators without boundary condensation only."""
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        rnorm0 = carry[-1]
        target = _target(target, 0.0, 0.0, rnorm0)
        out = self._iterate(A, M, carry, target,
                            self.nMaxIterations if trips is None else trips)
        i, x, rn, bx, brn = out[0], out[1], out[8], out[9], out[10]
        ok_last = torch.isfinite(rn) & (rn < 100.0 * (
            rnorm0 + self.absoluteTolerance))
        x_out = torch.where(ok_last, x, bx)
        rn_out = torch.where(ok_last, rn, brn)
        return x_out, SolveStats(i, rnorm0, rn_out, rn_out <= target), out

    def solve_fn(self, A, b, x0, target=None):
        """``target``: optional ABSOLUTE residual-norm target overriding
        max(rtol*|b - A x0|, atol).  Returns the best iterate."""
        A, b, recover = condensed(A, b)
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        carry = self.init_carry(A, b, x0)
        rnorm0 = carry[-1]
        target = _target(target, self.relativeTolerance,
                         self.absoluteTolerance, rnorm0)
        out = self._iterate(A, M, carry, target, self.nMaxIterations)
        i, bx, brn = out[0], out[9], out[10]
        return recover(bx), SolveStats(i, rnorm0, brn, brn <= target)


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
    ``GMRES`` (fvm_tpu/linear/krylov.py:331-505): Arnoldi with classical
    Gram-Schmidt applied twice, Givens rotations, the least-squares problem
    solved by back-substitution (``torch.linalg.solve_triangular``), the
    best iterate kept and the solve stopped on divergence.  The carry is
    the JAX package's ``(i, x, b, rn, bx, brn, rnorm0)``.

    ``solve_chunk`` is the JAX package's restart loop in the frozen form.
    A cycle starts while i < i0 + max_iterations and the recomputed
    residual |b - A x| is above the target; inside it only ``restart`` and
    the Givens estimate bound the Arnoldi steps, so a cycle may end early
    on its estimate with the true residual still above the target, and
    then another one starts.  The frozen loop is flat: max_iterations - 1
    + restart trips (the most Arnoldi steps such a restart loop can take),
    each one Arnoldi step of the open cycle followed by that cycle's close
    (back-substitution, update, recomputed residual, best iterate and the
    decision to open the next cycle), kept only where the cycle ends.  A
    trip therefore costs two preconditioner applications, two products
    with A and five passes over the (restart + 1)-vector basis, about
    twice an Arnoldi step.  The rotations so far are kept as one
    (m + 1)-square orthogonal matrix, so a new Hessenberg column is rotated
    by one small product instead of a chain of m sequential updates (the
    same rotations, another rounding).
    """

    def __init__(self, preconditioner: LinearSolver | None = None,
                 restart: int = 32, **kw):
        super().__init__(**kw)
        self.preconditioner = preconditioner
        self.restart = int(restart)

    # --- carry protocol ---------------------------------------------------

    def carry_template(self, vec_shape, dtype, device):
        """Zeros with the carry's structure."""
        z = torch.zeros(vec_shape, dtype=dtype, device=device)
        s = torch.zeros((), dtype=dtype, device=device)
        i = torch.zeros((), dtype=torch.int64, device=device)
        return (i, z, z, s, z, s, s)

    def init_carry(self, A, b, x0):
        A = prepared(A)
        rn = A.norm(b - A.mv(x0))
        i = torch.zeros((), dtype=torch.int64, device=b.device)
        return (i, x0, b, rn, x0, rn, rn)

    def solve_chunk(self, A, carry, target):
        """Up to ``max_iterations`` MORE iterations (whole restart cycles,
        the last may run past the count) toward the ABSOLUTE residual
        ``target``; returns (x, stats, carry_out) as the JAX package's
        ``solve_chunk`` (fvm_tpu/linear/krylov.py:459-493)."""
        A = prepared(A)
        M = _setup_precond(self.preconditioner, A)
        m, maxit = self.restart, self.nMaxIterations
        i0, x, b, rn, bx, brn, rnorm0 = carry
        target = _target(target, 0.0, 0.0, rnorm0)
        dt, dev = x.dtype, x.device
        tiny = torch.finfo(dt).tiny
        limit = 1e8 * (rnorm0 + self.absoluteTolerance)
        k = torch.arange(m + 1, device=dev)
        col = torch.arange(m, device=dev)
        live_idx = torch.arange(m, device=dev)
        eye1 = torch.eye(m + 1, dtype=dt, device=dev)
        eye = torch.eye(m, dtype=dt, device=dev)

        r = b - A.mv(x)
        V = torch.zeros((m + 1,) + tuple(x.shape), dtype=dt, device=dev)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        Q, g = eye1, torch.zeros(m + 1, dtype=dt, device=dev)
        j = torch.zeros((), dtype=torch.int64, device=dev)
        res = torch.zeros((), dtype=dt, device=dev)
        is_open = torch.zeros((), dtype=torch.bool, device=dev)
        i = i0
        for trip in range(maxit - 1 + m):
            # open a cycle where none is open (the restart loop's test)
            start = (~is_open & (i < i0 + maxit) & (rn > target)
                     & torch.isfinite(rn) & (rn < limit))
            if _all_frozen(self, trip, is_open | start):
                break
            beta = A.norm(r)
            V[0] = torch.where(start, r / torch.clamp(beta, min=tiny), V[0])
            H = torch.where(start, 0.0, H)
            Q = torch.where(start, eye1, Q)
            g = torch.where(start, torch.where(k == 0, beta, 0.0), g)
            j = torch.where(start, 0, j)
            res = torch.where(start, beta, res)
            is_open = is_open | start

            # one Arnoldi step of the open cycle
            step = is_open & (j < m) & (res > target) & torch.isfinite(res)
            w = A.mv(M(V.index_select(0, j.reshape(1))[0]))
            le = (k <= j).to(dt)
            h1 = torch.einsum("k...,...->k", V, w) * le
            w = w - torch.einsum("k,k...->...", h1, V)
            h2 = torch.einsum("k...,...->k", V, w) * le
            w = w - torch.einsum("k,k...->...", h2, V)
            hw = A.norm(w)
            h = Q @ (h1 + h2 + torch.where(k == j + 1, hw, 0.0))
            hj = h.gather(0, j.reshape(1))[0]
            hj1 = h.gather(0, (j + 1).clamp(max=m).reshape(1))[0]
            den = torch.sqrt(hj * hj + hj1 * hj1)
            ok = den > tiny
            c = torch.where(ok, hj / torch.clamp(den, min=tiny), 1.0)
            s = torch.where(ok, hj1 / torch.clamp(den, min=tiny), 0.0)
            h = torch.where(k == j, c * hj + s * hj1,
                            torch.where(k == j + 1, 0.0, h))
            qj = Q.index_select(0, j.reshape(1))
            qj1 = Q.index_select(0, (j + 1).clamp(max=m).reshape(1))
            Q_n = torch.where((k == j)[:, None], c * qj + s * qj1,
                              torch.where((k == j + 1)[:, None],
                                          c * qj1 - s * qj, Q))
            gj = g.gather(0, j.reshape(1))[0]
            g_n = torch.where(k == j, c * gj,
                              torch.where(k == j + 1, -s * gj, g))
            jn = (j + 1).clamp(max=m).reshape(1)
            V.index_copy_(0, jn, torch.where(
                step, w / torch.clamp(hw, min=tiny),
                V.index_select(0, jn)[0])[None])
            H = torch.where(step & (col == j)[None, :], h[:, None], H)
            Q = torch.where(step, Q_n, Q)
            g = torch.where(step, g_n, g)
            res = torch.where(step, g_n.gather(0, jn)[0].abs(), res)
            j = j + step.to(j.dtype)

            # close the cycle whose Arnoldi loop test now fails:
            # back-substitution on the j-leading block of R = H[:m, :m]
            # (rows and columns past j are the identity with a zero right
            # side), the update and the recomputed residual
            ends = is_open & ~((j < m) & (res > target) & torch.isfinite(res))
            live = live_idx < j
            R = torch.where(live[:, None] & live[None, :], H[:m], eye)
            diag = torch.diagonal(R)
            R = R + torch.diag(torch.where(
                live & ~(torch.abs(diag) > tiny), 1.0 - diag, 0.0))
            rhs = torch.where(live, g[:m], 0.0)
            y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
            x_n = x + M(torch.einsum("k,k...->...", y, V[:m]))
            r_n = b - A.mv(x_n)
            rn_n = A.norm(r_n)
            better = ends & torch.isfinite(rn_n) & (rn_n < brn)
            bx = torch.where(better, x_n, bx)
            brn = torch.where(better, rn_n, brn)
            x = torch.where(ends, x_n, x)
            r = torch.where(ends, r_n, r)
            rn = torch.where(ends, rn_n, rn)
            i = i + torch.where(ends, j, 0)
            is_open = is_open & ~ends
        ok_last = torch.isfinite(rn) & (rn <= brn)
        x_out = torch.where(ok_last, x, bx)
        rn_out = torch.where(ok_last, rn, brn)
        return x_out, SolveStats(i, rnorm0, rn_out, rn_out <= target), (
            i, x, b, rn, bx, brn, rnorm0)

    def solve_fn(self, A, b, x0, target=None):
        """``init_carry`` and one ``solve_chunk``, as the JAX package's
        ``solve_fn``.  ``target``: optional ABSOLUTE residual-norm target
        overriding max(rtol |b - A x0|, atol)."""
        A, b, recover = condensed(A, b)
        carry = self.init_carry(A, b, x0)
        target = _target(target, self.relativeTolerance,
                         self.absoluteTolerance, carry[3])
        x, stats, _ = self.solve_chunk(A, carry, target)
        return recover(x), stats


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
