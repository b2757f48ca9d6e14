"""Anderson acceleration of fixed-point (outer) iterations
(counterpart of ``fvm_tpu/linear/anderson.py``).

Windowed Anderson mixing of x_{k+1} = G(x_k) over the last ``depth``
iterates:

    f_k = G(x_k) - x_k
    gamma = argmin || f_k - dF gamma ||_2          (depth x depth normal eqs)
    x_{k+1} = G(x_k) - dG gamma

with dF/dG the difference histories of residuals and images, kept in
circular (depth, n) buffers with a step counter (static shapes).  The Gram
reductions and the small solve run in float64 whatever the state's dtype
(``torch.linalg.solve_ex``, its ``info`` checked by
``linear.base.check_info``).  No reference counterpart (the reference
iterates plain SIMPLE, FlowModel_impl.h:1433).
"""

from __future__ import annotations

import torch

from .base import check_info


class Anderson:
    """Windowed Anderson mixing over flattened state vectors."""

    def __init__(self, depth: int = 4, damping: float = 1.0,
                 regularization: float = 1e-10):
        self.depth = int(depth)
        self.damping = float(damping)
        self.reg = float(regularization)

    def init_state(self, n: int, dtype, device) -> dict:
        m = self.depth
        z = dict(dtype=dtype, device=device)
        return {
            "dF": torch.zeros((m, n), **z),
            "dG": torch.zeros((m, n), **z),
            "f_prev": torch.zeros((n,), **z),
            "g_prev": torch.zeros((n,), **z),
            "k": torch.zeros((), dtype=torch.int64, device=device),
        }

    def mix(self, astate: dict, x_old, g_new):
        """One Anderson update: x_old = x_k, g_new = G(x_k); returns
        (x_accelerated, new_astate)."""
        m = self.depth
        f = g_new - x_old
        k = astate["k"]
        rows = torch.arange(m, device=f.device)

        # push difference columns once a previous (f, g) pair exists
        slot = torch.clamp(k - 1, min=0) % m
        put = ((rows == slot) & (k > 0))[:, None]
        dF = torch.where(put, (f - astate["f_prev"])[None], astate["dF"])
        dG = torch.where(put, (g_new - astate["g_prev"])[None], astate["dG"])
        n_hist = torch.clamp(k, max=m)

        # normal equations with Tikhonov regularisation scaled to the Gram
        # diagonal; dead history rows get identity equations (gamma_j = 0)
        hi = torch.float64
        validh = (rows < n_hist).to(hi)
        dFh = dF.to(hi)
        G = (dFh @ dFh.T) * validh[:, None] * validh[None, :]
        scale = torch.trace(G) / torch.clamp(n_hist.to(hi), min=1.0)
        A = G + (self.reg * torch.clamp(scale, min=1e-30) + 1e-30) * \
            torch.eye(m, dtype=hi, device=f.device)
        A = A + torch.diag(1.0 - validh)
        b = (dFh @ f.to(hi)) * validh
        gamma, info = torch.linalg.solve_ex(A, b)
        check_info(info, "Anderson normal equations")
        gamma = gamma.to(f.dtype)
        x_acc = g_new - gamma @ dG
        if self.damping != 1.0:
            x_acc = x_acc - (1.0 - self.damping) * (f - gamma @ dF)
        # a non-finite extrapolation falls back to the plain step
        x_acc = torch.where(torch.isfinite(x_acc).all(), x_acc, g_new)
        return x_acc, {"dF": dF, "dG": dG, "f_prev": f, "g_prev": g_new,
                       "k": k + 1}
