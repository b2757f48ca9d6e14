"""ShockTube: the 1-D compressible Euler mini-model
(``fvm_tpu/models/shocktube.py``).

The reference's ShockTube (ShockTube.h:12), a shock-tube model for quick
verification: an explicit FVM with the HLL approximate Riemann flux and a
fixed step, whose time loop (the JAX package's ``lax.scan``) is a loop of
tensor ops on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device


class ShockTube:
    """Sod-type shock tube on [0, 1] with nx uniform cells (float64)."""

    def __init__(self, nx: int = 100, gamma: float = 1.4, device=None):
        self.nx = nx
        self.gamma = gamma
        self.device = resolve_device(device)
        x = (np.arange(nx) + 0.5) / nx
        self.x = x
        # the classic Sod initial condition
        rho = np.where(x < 0.5, 1.0, 0.125)
        p = np.where(x < 0.5, 1.0, 0.1)
        self.set_state(rho, np.zeros(nx), p)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            self.device)

    def set_state(self, rho, u, p):
        g = self.gamma
        rho, u, p = self._t(rho), self._t(u), self._t(p)
        E = p / (g - 1.0) + 0.5 * rho * u * u
        self.U = torch.stack([rho, rho * u, E], dim=1)  # (nx, 3)

    def primitives(self):
        g = self.gamma
        rho = self.U[:, 0]
        u = self.U[:, 1] / rho
        p = (g - 1.0) * (self.U[:, 2] - 0.5 * rho * u * u)
        return tuple(v.cpu().numpy() for v in (rho, u, p))

    @staticmethod
    def _hll_flux(UL, UR, gamma):
        def flux(U):
            rho = U[:, 0]
            u = U[:, 1] / rho
            E = U[:, 2]
            p = (gamma - 1.0) * (E - 0.5 * rho * u * u)
            return torch.stack([U[:, 1], U[:, 1] * u + p, (E + p) * u],
                               dim=1), u, p

        FL, uL, pL = flux(UL)
        FR, uR, pR = flux(UR)
        cL = torch.sqrt(gamma * pL / UL[:, 0])
        cR = torch.sqrt(gamma * pR / UR[:, 0])
        sL = torch.minimum(uL - cL, uR - cR)
        sR = torch.maximum(uL + cL, uR + cR)
        sL = torch.clamp(sL, max=0.0)[:, None]
        sR = torch.clamp(sR, min=0.0)[:, None]
        return (sR * FL - sL * FR + sL * sR * (UR - UL)) / (sR - sL)

    def run(self, t_end: float, cfl: float = 0.45):
        """Advance to t_end with a fixed dt chosen from the initial state."""
        g = self.gamma
        dx = 1.0 / self.nx
        rho = self.U[:, 0]
        u = self.U[:, 1] / rho
        p = (g - 1.0) * (self.U[:, 2] - 0.5 * rho * u * u)
        smax = float((u.abs() + torch.sqrt(g * p / rho)).max())
        # conservative: the largest wave speed roughly doubles in the run
        dt = cfl * dx / (2.0 * smax)
        nsteps = int(math.ceil(t_end / dt))
        dt = t_end / nsteps
        U = self.U
        for _ in range(nsteps):
            # transmissive boundaries by edge padding
            Upad = torch.cat([U[:1], U, U[-1:]], dim=0)
            F = self._hll_flux(Upad[:-1], Upad[1:], g)  # (nx + 1, 3)
            U = U - (dt / dx) * (F[1:] - F[:-1])
        self.U = U
        return self
