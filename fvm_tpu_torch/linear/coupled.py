"""SIMPLE-type block preconditioner for the coupled pressure-velocity
system (counterpart of ``fvm_tpu/linear/coupled.py``).

The reference's coupled FlowModel (FlowModel_impl.h:1474 advanceCoupled)
hands the (dim+1)-block system to its AMG.  ``CoupledSIMPLE`` applies one
SIMPLE pass as the preconditioner M^-1 (r_u, r_p):

  1. momentum predictor   dV* = r_u / diag_vv  (or AMG cycles on the
                                scalar momentum stencil)
  2. continuity residual  r_p' = r_p - (P-V row) dV*     (one block product)
  3. pressure correction  dp   = AMG cycles on the p-p scalar sub-matrix
                                 (the Rhie-Chow Df Laplacian)
  4. velocity correction  dV   = dV* - M_v (V-P column) dp

The scalar sub-matrices are ``ELLMatrix`` objects with the mesh's DIA
metadata, so their AMG cycles, smoothers and residuals run through
``dia_stencil`` on a CUDA tensor.  ``precond_setup`` builds the condensed
sub-matrices and their hierarchies once per surrogate; each application
condenses only its right side.
"""

from __future__ import annotations

import torch

from ..ops.ell import ELLMatrix
from .amg import AMG
from .base import LinearSolver


class CoupledSIMPLE(LinearSolver):
    """SIMPLE block preconditioner for BiCGStab on a BlockELL coupled
    system.  ``dia`` is the mesh's DIAInfo.  ``momentum``: "jacobi" (the
    diagonal predictor) or "amg" (one AMG cycle per velocity component on
    the scalar momentum stencil, which is elliptic at practical resolutions;
    the Newton endgame uses it)."""

    def __init__(self, amg: AMG | None = None, cycles: int = 2, dia=None,
                 momentum: str = "jacobi", **kw):
        super().__init__(**kw)
        self.amg = amg or AMG(coarse_size=256)
        self.cycles = int(cycles)
        self.dia = dia
        self.momentum = momentum
        self.momentum_cycles = 1

    def setup_structure(self, cols, mask, device) -> None:
        """Host-side AMG set-up for the pressure block (once per mesh)."""
        self.amg.setup_structure(cols, mask, device)

    def _scalar_block(self, Ab, i):
        """The (i, i) scalar sub-matrix of a BlockELL matrix, condensed:
        (condensed matrix, its hierarchy, rhs condenser)."""
        A = ELLMatrix(diag=Ab.diag[:, i, i], off=Ab.off[:, :, i, i],
                      cols=Ab.cols, mask=Ab.mask, dia=self.dia).prepare()
        A2, rhs = A.condenser()
        return A2, self.amg._build_hierarchy(A2), rhs

    def _cycles(self, A2, hier, rhs, ncycles, r):
        """``ncycles`` AMG cycles on the condensed system of right side r,
        back-substituted to the full rows."""
        b2, recover = rhs(r)
        amg = self.amg
        z = amg._cycle0(*hier, b2)
        for _ in range(ncycles - 1):
            z = z + amg._cycle0(*hier, A2.residual(z, b2))
        return recover(z)

    def precond_setup(self, Ab):
        B = Ab.block
        dim = B - 1
        idx = torch.arange(dim, device=Ab.diag.device)
        dvv = Ab.diag[:, idx, idx]  # (n, dim) momentum diagonals
        dvv = torch.where(torch.abs(dvv) > 0.0, dvv, 1.0)

        p_sys = self._scalar_block(Ab, dim)
        cycles = self.cycles

        def pressure_solve(rp):
            return self._cycles(*p_sys, cycles, rp)

        if self.momentum == "amg":
            # the vv block is dF * I (one face-flux linearisation shared by
            # every component), so ONE hierarchy serves all components
            v_sys = self._scalar_block(Ab, 0)
            mcyc = int(self.momentum_cycles or 1)

            def mom_solve(rv):
                return torch.stack([self._cycles(*v_sys, mcyc, rv[:, d])
                                    for d in range(dim)], dim=1)
        else:
            def mom_solve(rv):
                return rv / dvv

        def M(r):
            rv, rp = r[:, :dim], r[:, dim]
            dVs = mom_solve(rv)
            q = torch.cat([dVs, torch.zeros_like(rp)[:, None]], dim=1)
            rp2 = rp - Ab.mv(q)[:, dim]
            dp = pressure_solve(rp2)
            q2 = torch.cat([torch.zeros_like(dVs), dp[:, None]], dim=1)
            dV = dVs - mom_solve(Ab.mv(q2)[:, :dim])
            return torch.cat([dV, dp[:, None]], dim=1)

        return M
