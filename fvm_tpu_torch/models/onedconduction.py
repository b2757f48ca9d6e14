"""OneDConduction: the 1-D conduction mini-model
(``fvm_tpu/models/onedconduction.py``).

The reference's OneDConduction (OneDConduction.h:26 with
testOneDConduction.cpp / testOneDConductionExactMC.cpp): -d/dx(k dT/dx) =
0 on [0, 1], T(0) = TL, T(1) = TR, variable k(x), by a Thomas
(tridiagonal) solve.  ``solve_mc`` runs a batch of conductivity fields
through one batched solve (the JAX package vmaps it).
"""

from __future__ import annotations

import torch

from ..config import resolve_device


def thomas_solve(lower, diag, upper, rhs):
    """Tridiagonal solve along the last axis (leading axes batch): the
    forward elimination and the back substitution as sequential loops of
    tensor ops, the JAX package's two ``lax.scan``s."""
    n = diag.shape[-1]
    zero = torch.zeros_like(diag[..., 0])
    cp_prev, dp_prev = zero, zero
    cps, dps = [], []
    for i in range(n):
        a, b, c, d = lower[..., i], diag[..., i], upper[..., i], rhs[..., i]
        denom = b - a * cp_prev
        cp_prev = c / denom
        dp_prev = (d - a * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * n
    x_next = zero
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


class OneDConduction:
    def __init__(self, nx: int = 50, kConst=1.0, device=None,
                 dtype=torch.float64):
        self.nx = nx
        self.kConst = kConst
        self.TL = 0.0
        self.TR = 0.0
        self.device = resolve_device(device)
        self.dtype = dtype

    def setBoundaryTemperatures(self, TL, TR):
        self.TL = float(TL)
        self.TR = float(TR)

    def _tensor(self, k):
        return torch.as_tensor(k).to(device=self.device, dtype=self.dtype)

    def solve(self, k=None):
        """Cell temperatures (nx,), or (S, nx) for a batch of (S, nx) cell
        conductivities, as tensors on the model's device."""
        nx = self.nx
        dx = 1.0 / nx
        if k is None:
            k = torch.full((nx,), float(self.kConst), dtype=self.dtype,
                           device=self.device)
        else:
            k = self._tensor(k)
        # harmonic face conductivities; the walls at half a spacing
        kf = 2.0 * k[..., :-1] * k[..., 1:] / (k[..., :-1] + k[..., 1:])
        z = torch.zeros_like(k[..., :1])
        aW = torch.cat([z, -kf / dx], dim=-1)
        aE = torch.cat([-kf / dx, z], dim=-1)
        diag = -(aW + aE)
        rhs = torch.zeros_like(k)
        wl, wr = 2.0 * k[..., 0] / dx, 2.0 * k[..., -1] / dx
        diag = diag.clone()
        diag[..., 0] += wl
        diag[..., -1] += wr
        rhs[..., 0] += wl * self.TL
        rhs[..., -1] += wr * self.TR
        return thomas_solve(aW, diag, aE, rhs)

    def solve_mc(self, k_samples):
        """Monte-Carlo / UQ sweep over (nsamples, nx) conductivity fields,
        one batched solve (the reference's PC atype for this model)."""
        return self.solve(self._tensor(k_samples))
