"""Truncated-SPIKE solver / preconditioner (counterpart of
``fvm_tpu/linear/spike.py``).

The reference's SPIKE banded solver (SpikeSolver.h:21, SpikeMatrix.h:20),
as the JAX package reformulates it (truncated SPIKE, Polizzi & Sameh 2006):
fixed-length chunks of the tridiagonal band along the mesh's line ordering
(the DIA offsets +-1) play the role of ranks.

  1. every chunk solves its local tridiagonal with a Thomas sweep, all
     chunks at once (the sequential span is the chunk length L, not n);
  2. the spike tips v = T^-1 a_cross e_1 and w = T^-1 c_cross e_L couple
     adjacent chunks; with diagonal dominance the far tips decay, so the
     reduced system splits into independent 2x2 interface solves;
  3. the interior is corrected with the spike vectors.

The off-band couplings stay with the outer Krylov iteration, making this a
line-relaxation preconditioner.  The Thomas sweep is a Python loop over L
steps of elementwise PyTorch ops on (m, k) slices: the JAX package's
``lax.scan`` over the chunk length, which is no TPU kernel.  The spikes,
the Thomas denominators and the interface determinants depend on the
matrix alone, so ``SpikeFactors`` computes them once per matrix and each
apply runs the sweep on the right-hand sides only; every column of a
Thomas sweep is computed independently of the others, so the result is the
JAX package's bit for bit in the same arithmetic.

Not a device fallback: a matrix with fallback entries or without a +-1
band is preconditioned by diagonal scaling, the JAX package's own
semantics (``spike.py:327-356``), on every device.  The cross-shard SPIKE
(``setup_structure_dist``, the ``axis`` branch of ``spike_apply``) runs
only across shards and raises ``ConfigError`` here (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import torch

from ..exceptions import ConfigError
from .base import LinearSolver, prepared
from .ilu import diag_scaling, stationary_solve

_DIST = ("the cross-shard SPIKE runs only on a sharded mesh, which the "
         "port does not build yet (ROADMAP queue 1 item 8)")


def _thomas_factor(a, d, c):
    """The matrix half of a batched Thomas sweep (the JAX ``fwd`` scan's
    ``w`` and guarded denominators): ``a``, ``d``, ``c`` (m, L) with the
    neighbour-chunk couplings zeroed.  Returns (w, denom), each (L, m, 1)."""
    aT = a.T[..., None]
    dT = d.T[..., None]
    cT = c.T[..., None]
    w_prev = torch.zeros_like(dT[0])
    ws, dens = [], []
    for i in range(aT.shape[0]):
        denom = dT[i] - aT[i] * w_prev
        denom = torch.where(torch.abs(denom) > 0.0, denom, 1.0)
        w_prev = cT[i] / denom
        ws.append(w_prev)
        dens.append(denom)
    return torch.stack(ws), torch.stack(dens)


def _thomas_solve(aT, wT, denomT, rT):
    """The right-hand-side half: forward elimination g_i = (r_i - a_i
    g_{i-1}) / denom_i, then back substitution x_i = g_i - w_i x_{i+1}
    (the JAX ``fwd`` scan's ``g`` and its ``bwd`` scan).  ``aT``, ``wT``,
    ``denomT`` (L, m, 1); ``rT`` (L, m, k).  Returns x (m, L, k)."""
    L = aT.shape[0]
    g_prev = torch.zeros_like(rT[0])
    gs = []
    for i in range(L):
        g_prev = (rT[i] - aT[i] * g_prev) / denomT[i]
        gs.append(g_prev)
    x_next = torch.zeros_like(rT[0])
    xs = [None] * L
    for i in range(L - 1, -1, -1):
        x_next = gs[i] - wT[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=1)


def _pad(x, pad, fill):
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


class SpikeFactors:
    """What a truncated-SPIKE apply needs of the tridiagonal T = tridiag(a,
    d, c) of size n in chunks of L (padded to m L with d = 1): the Thomas
    sweep's w and denominators, the spikes v, w and the interface
    determinants, computed once (``spike_apply`` recomputes them on every
    call in the JAX package, with the same arithmetic)."""

    def __init__(self, a_full, d_full, c_full, L: int):
        n = d_full.shape[0]
        m = -(-n // L)
        self.n, self.L, self.m, self.pad = n, L, m, m * L - n
        a = _pad(a_full, self.pad, 0.0).reshape(m, L)
        d = _pad(d_full, self.pad, 1.0).reshape(m, L)
        c = _pad(c_full, self.pad, 0.0).reshape(m, L)
        # couplings that cross chunk boundaries move to the spike RHS
        a_cross = a[:, 0]  # couples chunk j row 0 to chunk j-1 row L-1
        c_cross = c[:, -1]  # couples chunk j row L-1 to chunk j+1 row 0
        a_in = a.clone()
        a_in[:, 0].fill_(0.0)
        c_in = c.clone()
        c_in[:, -1].fill_(0.0)
        self.wT, self.denomT = _thomas_factor(a_in, d, c_in)
        self.aT = a_in.T[..., None].contiguous()
        e = torch.zeros((m, L, 2), dtype=d.dtype, device=d.device)
        e[:, 0, 0] = a_cross
        e[:, -1, 1] = c_cross
        sp = _thomas_solve(self.aT, self.wT, self.denomT, e.transpose(0, 1))
        self.v = sp[:, :, 0]  # (m, L) left spike
        self.w = sp[:, :, 1]  # (m, L) right spike
        # truncated reduced system: independent 2x2 solves per interface
        #   b_j     + w_j[L-1] t_{j+1} = y_j[L-1]
        #   v_{j+1}[0] b_j + t_{j+1}   = y_{j+1}[0]
        self.wL = self.w[:-1, -1]  # (m-1,)
        self.v0 = self.v[1:, 0]
        det = 1.0 - self.wL * self.v0
        self.det = torch.where(torch.abs(det) > 0.0, det, 1.0)

    def apply(self, r):
        """T^-1 r (truncated) for r of shape (n,) or (n, k)."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        k = r.shape[1]
        m, L = self.m, self.L
        rr = _pad(r, self.pad, 0.0).reshape(m, L, k)
        y = _thomas_solve(self.aT, self.wT, self.denomT, rr.transpose(0, 1))
        yb = y[:-1, -1, :]  # (m-1, k)
        yt = y[1:, 0, :]
        det = self.det[:, None]
        b = (yb - self.wL[:, None] * yt) / det  # x_j[L-1], j = 0..m-2
        t = (yt - self.v0[:, None] * yb) / det  # x_{j+1}[0]
        zero = r.new_zeros((1, k))
        b_prev = torch.cat([zero, b], dim=0)  # (m, k): b_{j-1}
        t_next = torch.cat([t, zero], dim=0)  # (m, k): t_{j+1}
        # interior correction: x_j = y_j - v_j b_{j-1} - w_j t_{j+1}
        x = (y - self.v[:, :, None] * b_prev[:, None, :]
             - self.w[:, :, None] * t_next[:, None, :])
        x = x.reshape(m * L, k)[: self.n]
        return x[:, 0] if squeeze else x


def spike_apply(a_full, d_full, c_full, r, L, axis=None, axis_size=1,
                psub=None, psup=None):
    """Truncated-SPIKE application M(r) ~ T^-1 r for the tridiagonal T =
    tridiag(a, d, c) of size n (padded to m L); r (n,) or (n, k).  The
    ``axis`` (cross-shard) mode raises ``ConfigError`` (module
    docstring)."""
    if axis is not None:
        raise ConfigError(f"spike_apply(axis=...): {_DIST}")
    return SpikeFactors(a_full, d_full, c_full, int(L)).apply(r)


class SpikeSolver(LinearSolver):
    """Truncated-SPIKE line solver / preconditioner.

    ``chunk``: Thomas chunk length L (the sequential span of the sweep; the
    parallel "rank count" is n / L).  Without a +-1 DIA band it scales by
    the diagonal (module docstring)."""

    def __init__(self, chunk: int = 64, omega: float = 1.0, **kw):
        kw.setdefault("max_iterations", 50)
        super().__init__(**kw)
        self.chunk = int(chunk)
        self.omega = omega

    def setup_structure_dist(self, partition) -> bool:
        raise ConfigError(f"SpikeSolver.setup_structure_dist: {_DIST}")

    def _band(self, A):
        if getattr(A, "dia", None) is None or A.dia_coef is None:
            return None
        if A.dia.fb_rows.shape[0]:
            return None
        offs = [int(o) for o in A.dia.offsets]
        if 1 not in offs or -1 not in offs:
            return None
        # copies: the matrix's dia_coef is the kernel's live operand, which
        # every later product reads
        a = A.dia_coef[offs.index(-1)].clone()
        c = A.dia_coef[offs.index(1)].clone()
        # dia_coef[o][i] = A[i, i+o]: row 0 has no i-1 neighbour and row
        # n-1 no i+1 (their coefficients are zero on line ends)
        a[0].fill_(0.0)
        c[-1].fill_(0.0)
        return a, A.diag, c

    def precond_setup(self, A):
        A = prepared(A)
        band = self._band(A)
        if band is None:
            return diag_scaling(A)
        return SpikeFactors(*band, self.chunk).apply

    def solve_fn(self, A, b, x0):
        return stationary_solve(self, A, b, x0)
