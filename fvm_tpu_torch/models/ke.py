"""KeModel: standard k-epsilon turbulence (``fvm_tpu/models/ke.py``).

The reference's KeModel (KeModel.h:19, KeModel_impl.h with
SourceDiscretizationene.h / SourceDiscretizationdissi.h for the k and eps
sources; the wall functions follow WallDiscretization.h: zero-gradient k,
eps fixed at Cmu^0.75 k^1.5 / (kappa y) in wall cells, log-law production
and ``getWallViscosity`` for the momentum wall shear).

    d(rho k)/dt + div(mdot k) = div((mu + mu_t/sigma_k) grad k) + P - rho eps
    d(rho e)/dt + div(mdot e) = div((mu + mu_t/sigma_e) grad e)
                                + (C1 P - C2 rho eps) eps/k
    mu_t = rho Cmu k^2/eps;  P = mu_t S^2,  S^2 = 2 Sij Sij

Cmu 0.09, C1 1.44, C2 1.92, sigma_k 1.0, sigma_e 1.3.  The destruction
terms are implicit (diag += rho eps/k V, ...) for positivity.  The
velocity and the mass flux come from a flow model (``set_flow_state``);
production takes the velocity's least-squares gradient.  Each outer
iteration solves k, then eps, with the default
BiCGStab(Jacobi(3), 1e-8, 100) on the assembled ELL matrix, whose sweeps
and residuals are ``dia_stencil`` launches on a CUDA mesh with DIA
structure; ``outerChunk`` runs the chunked loop (a CUDA graph replay on a
CUDA mesh).  BC types: 'SpecifiedKE', 'Wall', 'Symmetry'.  A partitioned
mesh raises ``ConfigError`` (ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear import BiCGStab, JacobiSolver
from ..ops import assembly, discretizations as disc
from ..ops.gradients import gradient, ls_gradient_coefficients
from ..linear.base import JFNK_EXIT_EVERY
from .base import (Model, ResidualHistory, as_tensor_like, newton_advance,
                   single_device_model)

CMU = 0.09
C1 = 1.44
C2 = 1.92
SIGMA_K = 1.0
SIGMA_E = 1.3
KAPPA = 0.4187  # von Karman
E_WALL = 9.793  # log-law constant


class KeBC(BoundaryCondition):
    _allowed_types = ("SpecifiedKE", "Wall", "Symmetry")
    _defaults = {
        "specifiedK": 1.0,
        "specifiedE": 1.0,
    }


class KeVC(BoundaryCondition):
    _defaults = {
        "density": 1.0,
        "viscosity": 1e-5,
        "initialK": 1.0,
        "initialE": 1.0,
    }


class KeModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.1,
        "convectionScheme": "upwind",
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-7,
        "absoluteTolerance": 1e-16,
        "urf": 0.7,
        "verbose": True,
    }


class KeModel(Model):
    name = "KeModel"

    def __init__(self, mesh, flow_model=None, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = KeVC()
        self.flow = flow_model

    def _make_options(self):
        return KeModelOptions()

    def _make_bc(self):
        return KeBC()

    def init(self) -> None:
        mesh = self.mesh
        self.state = {
            "k": self._cell_field(self.vc, "initialK"),
            "eps": self._cell_field(self.vc, "initialE"),
            "massFlux": self._full_faces(0.0),
            "velocity": self._full_cells(0.0, trailing=(mesh.dim,)),
        }
        if self.options["transient"]:
            self.state["k_N1"] = self.state["k"]
            self.state["eps_N1"] = self.state["eps"]
        self.params = {
            "rho": self._cell_field(self.vc, "density", extend_ghosts=True),
            "mu": self._cell_field(self.vc, "viscosity", extend_ghosts=True),
            "grad_coeff": ls_gradient_coefficients(mesh),
        }
        # wall-function data: the wall-adjacent cells and their distance to
        # the wall (WallDiscretization.h), on the host once
        wall_mask = np.zeros(mesh.n_cells, dtype=bool)
        wall_dist = np.full(mesh.n_cells, 1.0)
        for g, bc in self._group_bcs():
            if bc.bc_type == "Wall":
                sl = mesh.group_faces(g)
                own = mesh.face_cell0[sl].cpu().numpy()
                cc = mesh.host.cell_centroid[own]
                fc = mesh.face_centroid[sl].cpu().double().numpy()
                d = np.linalg.norm(cc - fc, axis=1)
                wall_mask[own] = True
                wall_dist[own] = np.minimum(wall_dist[own],
                                            np.maximum(d, 1e-12))
        self.params["wall_mask"] = torch.from_numpy(wall_mask).to(mesh.device)
        self.params["wall_dist"] = torch.from_numpy(wall_dist).to(
            mesh.device, mesh.dtype)

        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                              relative_tolerance=1e-8, max_iterations=100)
            solver.exit_every = JFNK_EXIT_EVERY
            self.options["linearSolver"] = solver
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    def set_flow_state(self, velocity=None, mass_flux=None):
        """Take the velocity (n_cells, dim) and the mass flux (n_faces,)
        from the flow model for the production and convection terms."""
        if velocity is not None:
            self.state["velocity"] = as_tensor_like(velocity,
                                                    self.state["velocity"])
        if mass_flux is not None:
            self.state["massFlux"] = as_tensor_like(mass_flux,
                                                    self.state["massFlux"])

    def getWallViscosity(self, group_name) -> np.ndarray:
        """The effective wall viscosity per face of a wall group for the
        momentum wall shear: mu_w = rho u_tau kappa y / ln(E y+)
        (WallDiscretization.h)."""
        mesh = self.mesh
        sl = mesh.group_faces(self._group(group_name))
        own = mesh.face_cell0[sl]

        def at(x):
            return x[own].cpu().double().numpy()

        k, rho = at(self.state["k"]), at(self.params["rho"])
        mu, y = at(self.params["mu"]), at(self.params["wall_dist"])
        u_tau = CMU**0.25 * np.sqrt(np.maximum(k, 1e-30))
        yplus = np.maximum(rho * u_tau * y / mu, 11.0)
        return rho * u_tau * KAPPA * y / np.log(E_WALL * yplus)

    def getTurbulentViscosity(self) -> np.ndarray:
        """mu_t = rho Cmu k^2 / eps per interior cell."""
        k, e = self.state["k"], self.state["eps"]
        mu_t = self.params["rho"] * CMU * k * k / e.clamp(min=1e-30)
        return self._interior(mu_t)

    # ------------------------------------------------------------------

    def _production(self, mesh, params, state):
        """(P, mu_t): P = mu_t 2 Sij Sij from the stored velocity."""
        G = gradient(mesh, params["grad_coeff"], state["velocity"])
        S = 0.5 * (G + G.transpose(1, 2))
        S2 = 2.0 * torch.einsum("nij,nij->n", S, S)
        k = state["k"]
        e = state["eps"].clamp(min=1e-30)
        mu_t = params["rho"] * CMU * k * k / e
        return mu_t * S2, mu_t

    def _linearize_scalar(self, mesh, params, state, bcvals, which, mu_t, P):
        """(A, r) of the k (``which`` "k") or eps equation."""
        opts = self.options
        phi = state[which]
        rho = params["rho"]
        k = state["k"].clamp(min=1e-30)
        e = state["eps"].clamp(min=1e-30)
        sigma = SIGMA_K if which == "k" else SIGMA_E
        gamma = params["mu"] + bck.extend_to_ghosts(mesh, mu_t) / sigma
        gamma_f = disc.harmonic_face_gamma(mesh, gamma)
        gradp = gradient(mesh, params["grad_coeff"], phi)
        flux = disc.diffusion_flux(mesh, phi, gamma_f, gradp)
        flux = flux + disc.convection_flux(
            mesh, phi, state["massFlux"], opts["convectionScheme"], gradp)
        V = mesh.cell_volume
        wall, yw = params["wall_mask"], params["wall_dist"]
        if which == "k":
            # r += (P - rho eps) V; implicit destruction diag += rho eps/k V;
            # wall cells produce from the log-law shear P_w = u_tau^3 /
            # (kappa y), u_tau = Cmu^(1/4) sqrt(k)
            u_tau = CMU**0.25 * torch.sqrt(k)
            P = torch.where(wall, rho * u_tau**3 / (KAPPA * yw), P)
            r_cell = (P - rho * e) * V
            diag_cell = rho * e / k * V
        else:
            # r += (C1 P - C2 rho e) e/k V; implicit diag += C2 rho e/k V
            r_cell = (C1 * P - C2 * rho * e) * (e / k) * V
            diag_cell = (2.0 * C2 * rho * e / k * V
                         - C1 * P * (1.0 / k) * V).clamp(min=0.0)
        if opts["transient"]:
            d2, r2 = disc.transient_term(mesh, phi, state[f"{which}_N1"],
                                         opts["timeStep"], rho)
            diag_cell = diag_cell + d2
            r_cell = r_cell + r2
        A, r = assembly.assemble(mesh, flux, r_cell=r_cell,
                                 diag_cell=diag_cell)
        if which == "eps":
            # wall cells: eps pinned to Cmu^(3/4) k^(3/2) / (kappa y)
            A, r = assembly.dirichlet_cells(
                A, r, wall, CMU**0.75 * k**1.5 / (KAPPA * yw), phi)
        key = "specifiedK" if which == "k" else "specifiedE"
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = gamma_f[sl] * mesh.face_e_over_d[sl]
            if bc.bc_type == "SpecifiedKE":
                A, r = bck.dirichlet_rows(mesh, A, r, gc,
                                          bcvals[f"{g[1]}:{key}"], phi,
                                          valid, scale)
            else:  # Wall / Symmetry: a zero-gradient ghost
                A, r = bck.extrapolation_rows(mesh, A, r, gc, phi, valid,
                                              scale)
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _build_step(self):
        solver = self.options["linearSolver"]
        urf = float(self.options["urf"])
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            P, mu_t = me._production(mesh, params, state)
            Ak, rk = me._linearize_scalar(mesh, params, state, bcvals, "k",
                                          mu_t, P)
            dk, _ = solver.solve_fn(Ak, rk, torch.zeros_like(rk))
            knew = (state["k"] + urf * dk).clamp(min=1e-20)
            state = dict(state, k=knew)
            Ae, re = me._linearize_scalar(mesh, params, state, bcvals, "eps",
                                          mu_t, P)
            de, _ = solver.solve_fn(Ae, re, torch.zeros_like(re))
            enew = (state["eps"] + urf * de).clamp(min=1e-20)
            # wall cells: eps hard-fixed at the log-law value (the
            # under-relaxation must not dilute the pin)
            eps_wall = CMU**0.75 * knew**1.5 / (KAPPA * params["wall_dist"])
            enew = torch.where(params["wall_mask"], eps_wall, enew)
            rnorm = torch.sqrt(Ak.norm(rk) ** 2 + Ae.norm(re) ** 2)
            return dict(state, eps=enew), {"rnorm": rnorm}

        return step

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer iterations; returns [(iter, rnorm), ...]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk,
                                         self._resolve_bcvals())
        return newton_advance(self, niter)

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("KeModel: transient option is off")
        self.state["k_N1"] = self.state["k"]
        self.state["eps_N1"] = self.state["eps"]

    def _interior(self, x):
        return x[: self.mesh.n_interior_cells].cpu().numpy()

    def getK(self) -> np.ndarray:
        return self._interior(self.state["k"])

    def getEpsilon(self) -> np.ndarray:
        return self._interior(self.state["eps"])
