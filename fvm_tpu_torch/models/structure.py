"""StructureModel: linear-elastic solid mechanics, small strain
(``fvm_tpu/models/structure.py``).

The reference's StructureModel (StructureModel.h:19, StructureModel_impl.h:
displacement-based FVM elasticity, StructureSourceDiscretization.h giving
the stress divergence; creep follows StructurePlasticDiscretization.h:
102-160 and StructureModel_impl.h:713 creepInit: an explicit Norton
power-law update of the plastic strain from the deviatoric / von Mises
stress, the plastic traction 2 mu eps_p . A subtracted from the elastic
face flux).

    div sigma = b,   sigma = mu (grad w + grad w^T) + lambda tr(grad w) I

Each outer iteration is one Jacobian-free Newton-Krylov step: the exact
Jacobian action is AD of the residual (``linear.base.newton_operator``:
``torch.func.jvp`` replayed from a CUDA graph on a small CUDA mesh, else
the backward pass of its reverse-mode product; ``product_mode``), and
the two-point block surrogate (per-face B x B blocks of the compact stress)
gives the diagonal, the reductions and the preconditioner.  The block
products are plain PyTorch on every device, as the JAX package's einsums
are outside any Pallas kernel.

BC types: 'SpecifiedDeformation' (a Dirichlet vector), 'SpecifiedTraction'
(traction per unit area), 'SpecifiedForce' (total force over the group),
'Symmetry', 'ZeroTraction' (a free surface).  A partitioned mesh raises
``ConfigError`` (ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear import BiCGStab, JacobiSolver
from ..linear.base import (JFNK_EXIT_EVERY, MatrixFreeOperator,
                           newton_operator, product_mode)
from ..ops import assembly, discretizations as disc
from ..ops.bell import (assemble_block, dirichlet_rows_block,
                        residual_block, transform_rows_block)
from ..ops.gradients import gradient, ls_gradient_coefficients
from .base import (Model, ResidualHistory, newton_advance,
                   single_device_model)

def trace(G):
    """tr over the last two axes."""
    return torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)


def bmv(M, v):
    """sum_j M[..., i, j] v[..., j]."""
    return torch.einsum("fij,fj->fi", M, v)


class StructureBC(BoundaryCondition):
    _allowed_types = (
        "SpecifiedDeformation",
        "SpecifiedTraction",
        "SpecifiedForce",
        "Symmetry",
        "ZeroTraction",
    )
    _defaults = {
        "specifiedXDeformation": 0.0,
        "specifiedYDeformation": 0.0,
        "specifiedZDeformation": 0.0,
        "specifiedXTraction": 0.0,
        "specifiedYTraction": 0.0,
        "specifiedZTraction": 0.0,
        "specifiedXForce": 0.0,
        "specifiedYForce": 0.0,
        "specifiedZForce": 0.0,
    }


class StructureVC(BoundaryCondition):
    _defaults = {
        "youngsModulus": 1e9,
        "poissonsRatio": 0.3,
        "density": 1000.0,
        "bodyForceX": 0.0,
        "bodyForceY": 0.0,
        "bodyForceZ": 0.0,
    }


class StructureModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 1e-3,
        # Norton power-law creep (StructurePlasticDiscretization.h,
        # creepModel 1): deps_p/dt = A (VM/Sy0)^m dev(sigma) / VM;
        # deviatoric flow, so no lambda term in the plastic traction
        "creep": False,
        "creepConstant": 1e-3,  # A
        "creepExponent": 1.0,  # m
        "yieldStress": 1.0,  # Sy0
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-30,
        "urf": 1.0,
        "verbose": True,
    }


def lame(E, nu):
    """(mu, lambda) from Young's modulus and Poisson's ratio."""
    return {"mu": E / (2.0 * (1.0 + nu)),
            "lam": E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))}


class StructureModel(Model):
    name = "StructureModel"

    def __init__(self, mesh, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.partition = None
        self.vc = StructureVC()

    def _make_options(self):
        return StructureModelOptions()

    def _make_bc(self):
        return StructureBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        dim = mesh.dim
        self.state = {"deformation": self._full_cells(0.0, trailing=(dim,))}
        if self.options["transient"]:
            self.state["deformation_N1"] = self.state["deformation"]
            self.state["deformation_N2"] = self.state["deformation"]
        if self.options["creep"]:
            # in 2D only the in-plane block is stored; eps_p_zz follows
            # from incompressible plastic flow: -tr(eps_p_2d)
            self.state["plastic_strain"] = self._full_cells(
                0.0, trailing=(dim, dim))
        E = self._cell_field(self.vc, "youngsModulus", extend_ghosts=True)
        nu = self._cell_field(self.vc, "poissonsRatio", extend_ghosts=True)
        self._E, self._nu = E, nu  # the tangents' chain rule
        props = lame(E, nu)
        self._mu0, self._lam0 = props["mu"], props["lam"]  # undegraded
        body_keys = ("bodyForceX", "bodyForceY", "bodyForceZ")[:dim]
        self.params = {
            "mu": props["mu"],
            "lam": props["lam"],
            "rho": self._cell_field(self.vc, "density"),
            "body": torch.stack([self._cell_field(self.vc, k)
                                 for k in body_keys], dim=-1),
            "grad_coeff": ls_gradient_coefficients(mesh),
        }
        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                              relative_tolerance=1e-6, max_iterations=200)
            solver.exit_every = JFNK_EXIT_EVERY
            self.options["linearSolver"] = solver
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _bc_vector(self, mesh, bcvals, g, stem):
        comps = [f"specified{ax}{stem}" for ax in ("X", "Y", "Z")[:mesh.dim]]
        return torch.stack([bcvals[f"{g[1]}:{c}"] for c in comps], dim=1)

    def _stress_flux(self, mesh, params, state, w, matrix=True):
        """Face traction flux F = -sigma_f . A (plastic traction removed),
        the block surrogate (None without ``matrix``), the face stiffness
        2 mu + lambda and the ghost-extended cell gradients.

        The surrogate is the two-point gradient G ~ (w_N - w_O) (x) ds/|ds|^2:
          B_im = [mu((d.A) delta_im + d_i A_m) + lam A_i d_m] / |d|^2."""
        dim = mesh.dim
        mu, lam = params["mu"], params["lam"]
        mu_f = disc.harmonic_face_gamma(mesh, mu)
        lam_f = disc.harmonic_face_gamma(mesh, lam)
        gradw = gradient(mesh, params["grad_coeff"], w)  # (nc, comp, dir)
        # ghost-cell LS stencils are rank-deficient: owner gradients there
        gradw = bck.extend_to_ghosts(mesh, gradw)
        Gf = assembly.cells_to_faces_distance_weighted(mesh, gradw)
        # compact correction: the ds-direction component of the face
        # gradient replaced by the two-point difference
        d = mesh.face_ds
        d2 = torch.clamp((d * d).sum(dim=1), min=1e-300)
        dw_f = mesh.take_nbr(w) - mesh.take_owner(w)
        defect = dw_f - bmv(Gf, d)
        Gf = Gf + defect[:, :, None] * (d / d2[:, None])[:, None, :]
        eye = torch.eye(dim, dtype=w.dtype, device=w.device)
        sigma = (mu_f[:, None, None] * (Gf + Gf.transpose(1, 2))
                 + lam_f[:, None, None] * trace(Gf)[:, None, None] * eye)
        F = -bmv(sigma, mesh.face_area)
        ep = state.get("plastic_strain")
        if ep is not None:
            # sigma_total = sigma_el - 2 mu eps_p
            epf = assembly.cells_to_faces_distance_weighted(
                mesh, bck.extend_to_ghosts(mesh, ep))
            F = F + 2.0 * mu_f[:, None] * bmv(epf, mesh.face_area)
        gamma_f = disc.harmonic_face_gamma(mesh, 2.0 * mu + lam)
        if not matrix:
            return F, None, gamma_f, gradw
        Av = mesh.face_area
        dA = (d * Av).sum(dim=1)
        Bblk = (mu_f[:, None, None] * (dA[:, None, None] * eye)
                + mu_f[:, None, None] * d[:, :, None] * Av[:, None, :]
                + lam_f[:, None, None] * Av[:, :, None] * d[:, None, :]
                ) / d2[:, None, None]
        return F, Bblk, gamma_f, gradw

    def _system(self, mesh, params, state, bcvals, w, matrix=True):
        """Residual and block surrogate as a function of all unknowns
        (interior and ghost cells); ``matrix`` False returns (None, r),
        which is what the Jacobian-free products differentiate."""
        opts = self.options
        dim = mesh.dim
        F, B, gamma_f, gradw = self._stress_flux(mesh, params, state, w,
                                                 matrix)
        dO = dN = None
        if matrix:
            dO, dN = B, -B
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            t = bc.bc_type
            if t in ("SpecifiedTraction", "ZeroTraction", "SpecifiedForce"):
                if t == "SpecifiedTraction":
                    tv = self._bc_vector(mesh, bcvals, g, "Traction")
                    Fb = -tv * mesh.face_area_mag[sl][:, None]
                elif t == "SpecifiedForce":
                    fv = self._bc_vector(mesh, bcvals, g, "Force")
                    total = torch.clamp(mesh.face_area_mag[sl].sum(),
                                        min=1e-300)
                    Fb = -fv * (mesh.face_area_mag[sl] / total)[:, None]
                else:
                    Fb = torch.zeros((g[4], dim), dtype=w.dtype,
                                     device=w.device)
                F = F.clone()
                F[sl] = Fb
                if matrix:
                    dO, dN = dO.clone(), dN.clone()
                    dO[sl] = 0.0
                    dN[sl] = 0.0

        r_cell = params["body"] * mesh.cell_volume[:, None]
        diag_cell = None
        if opts["transient"]:
            dt = opts["timeStep"]
            coeff = params["rho"] * mesh.cell_volume / (dt * dt)
            accel = w - 2.0 * state["deformation_N1"] + state["deformation_N2"]
            r_cell = r_cell - coeff[:, None] * accel
            if matrix:
                eye = torch.eye(dim, dtype=w.dtype, device=w.device)
                diag_cell = coeff[:, None, None] * eye
        if matrix:
            if diag_cell is None:
                diag_cell = torch.zeros((mesh.n_cells, dim, dim),
                                        dtype=w.dtype, device=w.device)
            A, r = assemble_block(mesh, F, dO, dN, r_cell=r_cell,
                                  diag_cell=diag_cell)
        else:
            A, r = None, residual_block(mesh, F, r_cell)

        eyeF = torch.eye(dim, dtype=w.dtype, device=w.device)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = gamma_f[sl] * mesh.face_e_over_d[sl]
            t = bc.bc_type
            if t == "SpecifiedDeformation":
                val = self._bc_vector(mesh, bcvals, g, "Deformation")
                A, r = dirichlet_rows_block(mesh, A, r, gc, val, w, valid,
                                            scale)
            elif t == "Symmetry":
                # the ghost sits at the face: zero normal component,
                # tangential extrapolation, w_g = (I - n n^T) w_O
                amag = torch.clamp(mesh.face_area_mag[sl], min=1e-300)
                nhat = mesh.face_area[sl] / amag[:, None]
                T = eyeF - nhat[:, :, None] * nhat[:, None, :]
                A, r = transform_rows_block(mesh, A, r, gc, T, w, valid,
                                            scale)
            else:
                # traction type: gradient extrapolation w_g = w_O + G_O . d
                T = eyeF.expand(g[4], dim, dim)
                own = mesh.face_cell0[sl]
                extra = bmv(gradw[own], mesh.face_ds[sl])
                A, r = transform_rows_block(mesh, A, r, gc, T, w, valid,
                                            scale, extra)
        return A, r

    def _jfnk_operator(self, mesh, params, state, bcvals, w, A, mode=None):
        """The exact Jacobian at w (one AD product of the residual per
        application, ``newton_operator`` in ``mode``, by default
        ``product_mode``) with the block surrogate ``A``."""
        me = weakref.proxy(self)

        def R(ww):
            return me._system(mesh, params, state, bcvals, ww,
                              matrix=False)[1]

        return MatrixFreeOperator(
            newton_operator(R, w, mode or product_mode(w)), A)

    def _build_step(self):
        opts = self.options
        solver = opts["linearSolver"]
        urf = float(opts["urf"])
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            w = state["deformation"]
            A, r = me._system(mesh, params, state, bcvals, w)
            rnorm = A.norm(r)
            op = me._jfnk_operator(mesh, params, state, bcvals, w, A)
            dw, _ = solver.solve_fn(op, r, torch.zeros_like(r))
            return dict(state, deformation=w + urf * dw), {"rnorm": rnorm}

        return step

    # --- sensitivities (the reference builds StructureModel with the
    # Tangent atype, models.cpp:10-74; Simulator_Cantilever_UQ.py) ----------

    def _map_param_tangents(self, t):
        if not ({"youngsModulus", "poissonsRatio"} & set(t)):
            return t
        E, nu = self._E, self._nu
        dE = self._pad_cell_tangent(E, t.pop("youngsModulus", 0.0))
        dnu = self._pad_cell_tangent(nu, t.pop("poissonsRatio", 0.0))
        _, d = torch.func.jvp(lame, (E, nu), (dE, dnu))
        for k, v in d.items():
            if k in t:
                v = v + self._pad_cell_tangent(self.params[k], t[k])
            t[k] = v
        return t

    def solve_tangent(self, param_tangents=None, bc_tangents=None):
        """Forward sensitivity d(deformation) . (dparams, dBCs) at the
        converged state: J dw = dR/dp . dp with the same exact-jvp operator
        and preconditioner as the primal step.  ``param_tangents`` takes
        params keys ('mu', 'lam', 'body') or 'youngsModulus' /
        'poissonsRatio' (chain rule); ``bc_tangents`` is keyed
        'group:entry'.  Returns (n_interior, dim) numpy."""
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_tangent")
        mesh, state, params = self.mesh, self.state, self.params
        bcvals = self._resolve_bcvals()
        solver = self.options["linearSolver"]
        base, tans = self._tangent_inputs(param_tangents, bc_tangents, bcvals)
        w = state["deformation"]

        def r_of(p_sub, b_sub):
            return self._system(mesh, dict(params, **p_sub), state,
                                dict(bcvals, **b_sub), w, matrix=False)[1]

        _, dr = torch.func.jvp(r_of, base, tans)
        A, _ = self._system(mesh, params, state, bcvals, w)
        op = self._jfnk_operator(mesh, params, state, bcvals, w, A)
        dw, _ = solver.solve_fn(op, dr, torch.zeros_like(dr))
        return dw[: mesh.n_interior_cells].detach().cpu().numpy()

    def solve_adjoint(self, functional, param_keys=(), bc_keys=()) -> dict:
        """Reverse-mode gradient of a scalar functional of the converged
        deformation with respect to parameter fields and BC values, from
        one transposed JFNK solve (``models/sensitivity.jfnk_adjoint``).
        ``functional(w_interior) -> scalar tensor``; ``param_keys`` may
        hold 'youngsModulus' / 'poissonsRatio' (chain-ruled through the
        Lame map)."""
        from .sensitivity import jfnk_adjoint

        chain = ({"youngsModulus": self._E, "poissonsRatio": self._nu},
                 lambda ins: lame(ins["youngsModulus"], ins["poissonsRatio"]))
        return jfnk_adjoint(self, "deformation", self._system, functional,
                            param_keys, bc_keys, chain)

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """JFNK outer iterations; returns [(iter, rnorm), ...]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        return newton_advance(self, niter)

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("StructureModel: transient option is off")
        self.state["deformation_N2"] = self.state["deformation_N1"]
        self.state["deformation_N1"] = self.state["deformation"]

    def _interior(self, x):
        return x[: self.mesh.n_interior_cells].detach().cpu().numpy()

    def getDeformation(self) -> np.ndarray:
        return self._interior(self.state["deformation"])

    def _grad(self):
        return gradient(self.mesh, self.params["grad_coeff"],
                        self.state["deformation"])

    def _cell_stress(self):
        """Cell stress tensors (nc, dim, dim), plastic part removed."""
        G = self._grad()
        mu, lam = self.params["mu"], self.params["lam"]
        eye = torch.eye(self.mesh.dim, dtype=G.dtype, device=G.device)
        sigma = (mu[:, None, None] * (G + G.transpose(1, 2))
                 + lam[:, None, None] * trace(G)[:, None, None] * eye)
        ep = self.state.get("plastic_strain")
        if ep is not None:
            sigma = sigma - 2.0 * mu[:, None, None] * ep
        return sigma

    def getStress(self) -> np.ndarray:
        """Cell stress tensors (n_interior, dim, dim)."""
        return self._interior(self._cell_stress())

    def getBoundaryForceIntegral(self, group_name) -> np.ndarray:
        """The reaction force on a boundary group: the sum over its faces
        of sigma_owner . A."""
        mesh = self.mesh
        sl = mesh.group_faces(self._group(group_name))
        sigma = self._cell_stress()
        own = mesh.face_cell0[sl]
        return bmv(sigma[own], mesh.face_area[sl]).sum(
            dim=0).detach().cpu().numpy()

    def getStrain(self) -> np.ndarray:
        """Small-strain tensors sym(grad w), (n_interior, dim, dim)."""
        G = self._grad()
        return self._interior(0.5 * (G + G.transpose(1, 2)))

    def getElasticEnergyDensity(self) -> np.ndarray:
        """The undegraded elastic energy density psi0 = lam/2 tr(eps)^2 +
        mu eps:eps per interior cell, from the base moduli (the phase-field
        fracture driving force)."""
        G = self._grad()
        eps = 0.5 * (G + G.transpose(1, 2))
        tr = trace(eps)
        psi0 = (0.5 * self._lam0 * tr * tr
                + self._mu0 * torch.einsum("nij,nij->n", eps, eps))
        return self._interior(psi0)

    def set_stiffness_degradation(self, g) -> None:
        """Scale the moduli by a per-cell degradation factor g (interior
        cells; ghosts take their owner's), from the undegraded base each
        call (g = 1 restores the virgin stiffness)."""
        mesh = self.mesh
        dtype = self.params["mu"].dtype
        g = torch.as_tensor(np.asarray(g, dtype=np.float64)).to(
            device=mesh.device, dtype=dtype).reshape(-1)
        full = torch.ones(mesh.n_cells, dtype=dtype, device=mesh.device)
        full[: g.shape[0]] = g
        full = bck.extend_to_ghosts(mesh, full)
        self.params = dict(self.params, mu=self._mu0 * full,
                           lam=self._lam0 * full)

    # --- creep ------------------------------------------------------------

    def _stress_3d(self):
        """Full 3 x 3 cell stress (the plane-strain embedding in 2D:
        sigma_zz from eps_zz = 0 and trace-free plastic flow)."""
        mesh = self.mesh
        dim = mesh.dim
        G = self._grad()
        mu, lam = self.params["mu"], self.params["lam"]
        nc = mesh.n_cells
        ep = self.state.get("plastic_strain")
        if ep is None:
            ep = torch.zeros((nc, dim, dim), dtype=G.dtype, device=G.device)
        G3 = torch.zeros((nc, 3, 3), dtype=G.dtype, device=G.device)
        G3[:, :dim, :dim] = G
        ep3 = torch.zeros((nc, 3, 3), dtype=G.dtype, device=G.device)
        ep3[:, :dim, :dim] = ep
        if dim == 2:
            ep3[:, 2, 2] = -trace(ep)
        eye3 = torch.eye(3, dtype=G.dtype, device=G.device)
        return (mu[:, None, None] * (G3 + G3.transpose(1, 2))
                - 2.0 * mu[:, None, None] * ep3
                + lam[:, None, None] * trace(G3)[:, None, None] * eye3)

    @staticmethod
    def _deviator_vm(sigma):
        eye3 = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
        dev = sigma - (trace(sigma) / 3.0)[:, None, None] * eye3
        return dev, torch.sqrt(1.5 * torch.einsum("nij,nij->n", dev, dev))

    def getVMStress(self) -> np.ndarray:
        """Von Mises stress per interior cell."""
        return self._interior(self._deviator_vm(self._stress_3d())[1])

    def advanceCreep(self, dt=None) -> None:
        """Explicit Norton update eps_p += A (VM/Sy0)^m dev(sigma)/VM dt
        (StructurePlasticDiscretization.h:119-136); re-advance() after it
        to relax the displacement against the new plastic strain."""
        opts = self.options
        if not opts["creep"]:
            raise ConfigError("StructureModel: creep option is off")
        if dt is None:
            dt = opts["timeStep"]
        dim = self.mesh.dim
        dev, vm = self._deviator_vm(self._stress_3d())
        A = float(opts["creepConstant"])
        m = float(opts["creepExponent"])
        Sy = float(opts["yieldStress"])
        mult = A * (vm / Sy) ** m / torch.clamp(vm, min=1e-300)
        dep3 = mult[:, None, None] * dev * dt
        self.state["plastic_strain"] = (self.state["plastic_strain"]
                                        + dep3[:, :dim, :dim])

    def getPlasticStrain(self) -> np.ndarray:
        ep = self.state.get("plastic_strain")
        if ep is None:
            raise ConfigError("StructureModel: creep option is off")
        return self._interior(ep)
