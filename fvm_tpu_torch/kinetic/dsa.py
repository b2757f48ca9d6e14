"""Diffusion synthetic acceleration for the kinetic COMET solver
(counterpart of ``fvm_tpu/kinetic/dsa.py``).

The role of the reference's COMET coarse-model hierarchy
(phononbase/COMETModel.h:1080 MakeCoarseModel, :2800-2985 cycle): the
point-coupled Woodbury preconditioner handles the local collision coupling
but nothing accelerates the SMOOTH equilibrium modes, whose error obeys a
diffusion equation in the thick regime.  The coarse correction on the
equilibrium subspace is

    z = M_point(r) + P M_T(R r)

with R a restriction onto the temperature mode, M_T two AMG V-cycles on
the synthetic operator -div(k_eff grad) and P the equilibrium-increment
prolongation: additive composition only, on the CONDENSED operator (the
AMG hierarchy is built on the condensed pattern).  Every product,
residual and Jacobi sweep of the cycles is a DIA product of the
synthetic operator: ``dia_stencil`` on a CUDA mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linear import AMG
from ..ops import assembly
from ..ops.assembly import FaceFlux


def build_scalar_diffusion_cycles(model, k_eff: float, dirichlet_types):
    """M_T(rT): two condensed AMG V-cycles on the synthetic scalar
    diffusion operator over ``model.mesh``.  Boundary faces of groups whose
    bc_type is in ``dirichlet_types`` keep their coupling (ghost rows are
    Dirichlet delta = 0); all other boundary faces carry no flux."""
    mesh0 = model.mesh
    dtype, dev = mesh0.dtype, mesh0.device
    dir_face = np.zeros(mesh0.n_faces, dtype=bool)
    for g, bc in model._group_bcs():
        if bc.bc_type in dirichlet_types:
            dir_face[mesh0.group_faces(g)] = True
    bnd = np.arange(mesh0.n_faces) >= mesh0.n_interior_faces
    keep = torch.from_numpy(~bnd | dir_face).to(dev)
    gamT = torch.where(keep, float(k_eff) * mesh0.face_e_over_d, 0.0)
    A_T, _ = assembly.assemble(
        mesh0, FaceFlux(F=torch.zeros(mesh0.n_faces, dtype=dtype, device=dev),
                        dF_dO=gamT, dF_dN=-gamT))
    n_int = mesh0.n_interior_cells
    diag = A_T.diag.clone()
    diag[n_int:] = 1.0
    off = A_T.off.clone()
    off[:, n_int:] = 0.0
    A_T = A_T.replace(diag=diag, off=off).prepare()
    amg_T = AMG(coarse_size=32)
    amg_T.setup_structure(*mesh0.host_cf(), dev)
    A2c, _b0, _rec0 = A_T.condense(torch.zeros(mesh0.n_cells, dtype=dtype,
                                               device=dev))
    M_T1 = amg_T.precond_setup(A2c)
    plan = None if A_T.dia is None else A_T.dia.cond_plan
    if plan is not None and plan.ok:
        er, es, ep, ir, ik, ie = plan.t
        offv = torch.where(A_T.mask, A_T.off, 0.0)  # (K, n)
        vE = torch.where(es >= 0, offv[es.clamp(min=0), er], 0.0)
        dE = A_T.diag[er]
        vIn = offv[ik, ir]
        scale = vIn / dE[ie]

        def _fold(b):
            b2 = b.index_add(0, ir, -scale * b[er][ie])
            return b2.index_fill(0, er, 0.0)

        def _recover(x2, b):
            xE = (b[er] - vE * x2[ep]) / dE
            return x2.index_put((er,), xE)
    else:
        def _fold(b):
            return b

        def _recover(x2, b):
            return x2

    def M_T(rT):
        r2 = _fold(rT)
        z = M_T1(r2)
        z = z + M_T1(r2 - A2c.mv(z))
        return _recover(z, rT)

    # the hierarchy and the condensed fine-level matrix, for launch
    # accounting by level and the kernel checks
    M_T.amg, M_T.matrix = amg_T, A2c
    return M_T


class DSAPrecond:
    """Point preconditioner + additive equilibrium-subspace correction."""

    def __init__(self, point, M_T, wE, pcoef, alive):
        self.point = point
        self.M_T = M_T
        self.wE = wE
        self.pcoef = pcoef
        self.alive = alive

    def _compose(self, Mp, restrict, prolong):
        M_T, alive = self.M_T, self.alive

        def M(r):
            z1 = Mp(r)
            rT = r @ restrict
            dT = M_T(torch.where(alive, rT, 0.0))
            return z1 + torch.where(alive, dT, 0.0)[:, None] * prolong[None, :]

        return M

    def precond_setup(self, op):
        return self._compose(self.point.precond_setup(op), self.wE,
                             self.pcoef)

    def precond_setup_T(self, op):
        """The transposed application (the adjoint solves): the additive
        composition transposes term by term, M^T = Mp^T + wE (x) M_T^T
        pcoef^T, restriction and prolongation swapping roles.  M_T stands in
        for its own transpose: the synthetic operator is symmetric and the
        V-cycle near-symmetric, and a preconditioner only shapes the
        convergence (BiCGStab on A^T stays exact)."""
        return self._compose(self.point.precond_setup_T(op), self.pcoef,
                             self.wE)
