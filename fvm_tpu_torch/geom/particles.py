"""Passive particle tracking through a cell velocity field (counterpart of
``fvm_tpu/geom/particles.py``).

The reference's FVMParticles (FVMParticles.h) and the MPM particle
containers (MPM_Particles.h:15) in their tracer role.  Particles advect
with RK2; the velocity at a particle is the gradient-corrected
inverse-distance interpolation over the k nearest cells,

    u(x) = sum_i w_i [u_i + G_i . (x - x_i)] / sum_i w_i,

exact for linear velocity fields.  The cell gradients are the mesh's
least-squares gradients (``ops/gradients.py``) on the mesh's device; the
search and the interpolation are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .search import KSearchTree


class ParticleTracker:
    def __init__(self, dmesh, k: int = 4):
        self.mesh = dmesh
        self.k = int(k)
        self.cc = dmesh.cell_centroid.cpu().numpy()[: dmesh.n_interior_cells]
        self.tree = KSearchTree(self.cc)

    def _velocity_gradient(self, cell_velocity) -> np.ndarray:
        """LS cell gradients of the velocity, (n_interior, m, dim)."""
        from ..core import bcs as bck
        from ..ops.gradients import gradient, ls_gradient_coefficients

        dm = self.mesh
        v = torch.as_tensor(np.asarray(cell_velocity, dtype=float))
        full = torch.zeros((dm.n_cells,) + tuple(v.shape[1:]),
                           dtype=dm.dtype, device=dm.device)
        full[: v.shape[0]] = v.to(dm.device, dm.dtype)
        full = bck.extend_to_ghosts(dm, full)
        coeff = getattr(self, "_grad_coeff", None)
        if coeff is None:
            coeff = self._grad_coeff = ls_gradient_coefficients(dm)
        G = gradient(dm, coeff, full)
        return G[: dm.n_interior_cells].cpu().numpy()

    def velocity_at(self, positions, cell_velocity, grad=None) -> np.ndarray:
        p = np.asarray(positions, dtype=np.float64)
        v = np.asarray(cell_velocity, dtype=np.float64)
        kk = min(self.k, len(self.cc))
        d, idx = self.tree.query_batch(p, kk)
        d = np.asarray(d).reshape(len(p), kk)
        idx = np.asarray(idx).reshape(len(p), kk)
        w = 1.0 / np.maximum(d, 1e-12)
        w = w / w.sum(axis=1, keepdims=True)
        vals = v[idx]  # (np, k, m)
        if grad is not None:
            dx = p[:, None, :] - self.cc[idx]  # (np, k, dim)
            vals = vals + np.einsum("pkmd,pkd->pkm", grad[idx], dx)
        return np.einsum("pk,pkm->pm", w, vals)

    def step(self, positions, cell_velocity, dt, grad=None) -> np.ndarray:
        """One RK2 advection step; returns the new positions."""
        p = np.asarray(positions, dtype=np.float64)
        if grad is None:
            grad = self._velocity_gradient(cell_velocity)
        v1 = self.velocity_at(p, cell_velocity, grad)
        mid = p + 0.5 * dt * v1
        v2 = self.velocity_at(mid, cell_velocity, grad)
        return p + dt * v2

    def track(self, positions, cell_velocity, dt, n_steps) -> np.ndarray:
        """The trajectory, (n_steps + 1, n, dim)."""
        grad = self._velocity_gradient(cell_velocity)
        traj = [np.asarray(positions, dtype=np.float64)]
        for _ in range(n_steps):
            traj.append(self.step(traj[-1], cell_velocity, dt, grad))
        return np.stack(traj)
