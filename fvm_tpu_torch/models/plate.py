"""PlateModel: Mindlin-Reissner plate bending for MEMS beams and membranes
(``fvm_tpu/models/plate.py``).

The reference's PlateModel (PlateModel.h:19, PlateModel_impl.h with
PlateSourceDiscretization.h and TimeDerivativePlateDiscretization.h; the
MEMS switch script scripts/Simulator.py).  Unknowns per cell: u =
(beta_x, beta_y, w), rotations and transverse deflection on a 2D
mid-surface mesh (D = E h^3 / 12(1 - nu^2), S = kappa G h):

  moment balance:   div M - Q = 0        (2 equations)
  transverse:       div Q + q = 0        (1 equation)
  M = D [ (1-nu)/2 (grad b + grad b^T) + nu tr(grad b) I ]
  Q = S (grad w + b)

On a (n, 3) block-ELL surrogate with the exact Jacobian action by AD of
the residual (the JFNK pattern of ``StructureModel``).  BC types: 'Clamped',
'Free', 'Symmetry', 'SpecifiedDeformation'.  A partitioned mesh raises
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
                        residual_block, small_inv, transform_rows_block)
from ..ops.gradients import gradient, ls_gradient_coefficients
from .base import (Model, ResidualHistory, newton_advance,
                   single_device_model)
from .structure import bmv, trace


class PlateBC(BoundaryCondition):
    _allowed_types = ("Clamped", "Free", "Symmetry", "SpecifiedDeformation")
    _defaults = {
        "specifiedXRotation": 0.0,
        "specifiedYRotation": 0.0,
        "specifiedZDeformation": 0.0,
    }


class PlateVC(BoundaryCondition):
    _defaults = {
        "ym": 1e9,  # Young's modulus (the reference's name)
        "nu": 0.3,
        "density": 1000.0,
        "thickness": 0.01,
        "pressure": 0.0,  # transverse load q per area
    }


class PlateModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 1e-4,
        "shearCorrection": 5.0 / 6.0,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-30,
        "verbose": True,
    }


def plate_props(E, nu, h, kappa):
    """D, S and nu of the plate from E, nu and the thickness."""
    return {"D": E * h**3 / (12.0 * (1.0 - nu * nu)),
            "S": kappa * E / (2.0 * (1.0 + nu)) * h,
            "nu": nu}


class PlateModel(Model):
    name = "PlateModel"

    def __init__(self, mesh, partition=None):
        if mesh.dim != 2:
            raise ConfigError("PlateModel requires a 2D mid-surface mesh")
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.partition = None
        self.vc = PlateVC()

    def _make_options(self):
        return PlateModelOptions()

    def _make_bc(self):
        return PlateBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        self.state = {"u": self._full_cells(0.0, trailing=(3,))}
        if self.options["transient"]:
            self.state["u_N1"] = self.state["u"]
            self.state["u_N2"] = self.state["u"]
        E = self._cell_field(self.vc, "ym", extend_ghosts=True)
        nu = self._cell_field(self.vc, "nu", extend_ghosts=True)
        h = self._cell_field(self.vc, "thickness", extend_ghosts=True)
        self._E, self._h = E, h  # the tangents' chain rule
        kappa = float(self.options["shearCorrection"])
        # the JAX package's formulas, term for term
        D = E * h**3 / (12.0 * (1.0 - nu * nu))
        G = E / (2.0 * (1.0 + nu))
        self.params = {
            "D": D,
            "S": kappa * G * h,
            "nu": nu,
            "rho_h": (self._cell_field(self.vc, "density")
                      * self._cell_field(self.vc, "thickness")),
            "q": self._cell_field(self.vc, "pressure"),
            "grad_coeff": ls_gradient_coefficients(mesh),
        }
        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                              relative_tolerance=1e-8, max_iterations=400)
            solver.exit_every = JFNK_EXIT_EVERY
            self.options["linearSolver"] = solver
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _system(self, mesh, params, state, bcvals, u, matrix=True):
        """Residual and block surrogate; u = (nc, 3) = (bx, by, w).
        ``matrix`` False returns (None, r)."""
        nu, D, S = params["nu"], params["D"], params["S"]
        beta = u[:, :2]
        dt_, dev = u.dtype, u.device

        # face gradients with the ghost extension and the two-point
        # correction of the structure model
        gradu = gradient(mesh, params["grad_coeff"], u)  # (nc, 3, 2)
        gradu = bck.extend_to_ghosts(mesh, gradu)
        Gf = assembly.cells_to_faces_distance_weighted(mesh, gradu)
        d = mesh.face_ds
        d2m = torch.clamp((d * d).sum(dim=1), min=1e-300)
        du_f = mesh.take_nbr(u) - mesh.take_owner(u)
        defect = du_f - bmv(Gf, d)
        Gf = Gf + defect[:, :, None] * (d / d2m[:, None])[:, None, :]

        Gb = Gf[:, :2, :]  # face grad beta (2 x 2)
        gw = Gf[:, 2, :]  # face grad w
        D_f = disc.harmonic_face_gamma(mesh, D)
        S_f = disc.harmonic_face_gamma(mesh, S)
        # shear-locking relief (stabilized Mindlin): the face shear
        # stiffness capped at the bending scale D / h_mesh^2
        h2 = torch.clamp(mesh.face_dsmag ** 2, min=1e-300)
        alpha = float(self.options.get("shearStabilization", 2.0))
        S_f = S_f / (1.0 + S_f * h2 / (alpha * torch.clamp(D_f, min=1e-300)))
        nu_f = assembly.cells_to_faces_distance_weighted(mesh, nu)
        beta_f = assembly.cells_to_faces_distance_weighted(mesh, beta)

        eye2 = torch.eye(2, dtype=dt_, device=dev)
        M = D_f[:, None, None] * (
            0.5 * (1.0 - nu_f)[:, None, None] * (Gb + Gb.transpose(1, 2))
            + nu_f[:, None, None] * trace(Gb)[:, None, None] * eye2)
        A_vec = mesh.face_area
        F_moment = -bmv(M, A_vec)
        Qf = S_f[:, None] * (gw + beta_f)
        F_w = -(Qf * A_vec).sum(dim=1)
        F = torch.cat([F_moment, F_w[:, None]], dim=1)  # (nf, 3)

        gam_m = D_f * mesh.face_e_over_d
        gam_w = S_f * mesh.face_e_over_d
        dO = dN = None
        if matrix:
            # two-point block surrogate, diagonal blocks
            B = torch.zeros((mesh.n_faces, 3, 3), dtype=dt_, device=dev)
            B[:, 0, 0] = gam_m
            B[:, 1, 1] = gam_m
            B[:, 2, 2] = gam_w
            dO, dN = B, -B

        for g, bc in self._group_bcs():
            if bc.bc_type == "Free":
                sl = mesh.group_faces(g)
                F = F.clone()
                F[sl] = 0.0
                if matrix:
                    dO, dN = dO.clone(), dN.clone()
                    dO[sl] = 0.0
                    dN[sl] = 0.0

        # cell sources: the moment equations get -Q V, w gets q V.  The
        # assumed-shear cell vector from the face-normal shear components
        # only: Q_c = (sum n n^T)^-1 sum n (Q_f . n)
        V = mesh.cell_volume
        Qf_cell = mesh.take_faces(Qf)  # (K, nc, 2)
        Af = mesh.take_faces(mesh.face_area)
        Amag = torch.sqrt(torch.clamp((Af * Af).sum(dim=2), min=1e-300))
        sK = torch.where(mesh.cf_is_owner, 1.0, -1.0).to(dt_)
        n_out = sK[:, :, None] * Af / Amag[:, :, None]
        n_out = torch.where(mesh.cf_mask[:, :, None], n_out, 0.0)
        qn = torch.einsum("kni,kni->kn", Qf_cell, n_out)
        M2 = torch.einsum("kni,knj->nij", n_out, n_out) + 1e-10 * eye2
        Qc = bmv(small_inv(M2), torch.einsum("kni,kn->ni", n_out, qn))
        r_cell = torch.cat([-Qc * V[:, None], (params["q"] * V)[:, None]],
                           dim=1)
        diag_cell = None
        if matrix:
            # the implicit part of -Q in beta: S V on the rotations, with
            # the stabilized cell shear stiffness
            S_c = S / (1.0 + S * V / (alpha * torch.clamp(D, min=1e-300)))
            diag_cell = torch.zeros((mesh.n_cells, 3, 3), dtype=dt_,
                                    device=dev)
            diag_cell[:, 0, 0] = S_c * V
            diag_cell[:, 1, 1] = S_c * V
        if self.options["transient"]:
            dt = self.options["timeStep"]
            coeff = params["rho_h"] * V / (dt * dt)
            accel = u - 2.0 * state["u_N1"] + state["u_N2"]
            r_cell = r_cell - coeff[:, None] * accel
            if matrix:
                eye3 = torch.eye(3, dtype=dt_, device=dev)
                diag_cell = diag_cell + coeff[:, None, None] * eye3
        if matrix:
            A, r = assemble_block(mesh, F, dO, dN, r_cell=r_cell,
                                  diag_cell=diag_cell)
        else:
            A, r = None, residual_block(mesh, F, r_cell)

        eye3 = torch.eye(3, dtype=dt_, device=dev)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = gam_m[sl] + gam_w[sl]
            t = bc.bc_type
            if t in ("Clamped", "SpecifiedDeformation"):
                val = torch.stack([
                    bcvals[f"{g[1]}:specifiedXRotation"],
                    bcvals[f"{g[1]}:specifiedYRotation"],
                    bcvals[f"{g[1]}:specifiedZDeformation"]], dim=1)
                A, r = dirichlet_rows_block(mesh, A, r, gc, val, u, valid,
                                            scale)
            elif t == "Symmetry":
                amag = torch.clamp(mesh.face_area_mag[sl], min=1e-300)
                nhat = mesh.face_area[sl] / amag[:, None]
                # rotations: no normal rotation; w: zero gradient
                T = torch.zeros((g[4], 3, 3), dtype=dt_, device=dev)
                T[:, :2, :2] = eye2 - nhat[:, :, None] * nhat[:, None, :]
                T[:, 2, 2] = 1.0
                A, r = transform_rows_block(mesh, A, r, gc, T, u, valid,
                                            scale)
            else:  # Free: zero gradient in all components
                T = eye3.expand(g[4], 3, 3)
                own = mesh.face_cell0[sl]
                extra = bmv(gradu[own], mesh.face_ds[sl])
                A, r = transform_rows_block(mesh, A, r, gc, T, u, valid,
                                            scale, extra)
        return A, r

    def _jfnk_operator(self, mesh, params, state, bcvals, u, A, mode=None):
        """The exact Jacobian at u (``StructureModel._jfnk_operator``)."""
        me = weakref.proxy(self)

        def R(uu):
            return me._system(mesh, params, state, bcvals, uu,
                              matrix=False)[1]

        return MatrixFreeOperator(
            newton_operator(R, u, mode or product_mode(u)), A)

    def _build_step(self):
        solver = self.options["linearSolver"]
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            u = state["u"]
            A, r = me._system(mesh, params, state, bcvals, u)
            rnorm = A.norm(r)
            op = me._jfnk_operator(mesh, params, state, bcvals, u, A)
            du, _ = solver.solve_fn(op, r, torch.zeros_like(r))
            return dict(state, u=u + du), {"rnorm": rnorm}

        return step

    # --- sensitivities (PlateModel with the Tangent atype; the MEMS UQ
    # scripts sweep ym and thickness) ------------------------------------

    def _map_param_tangents(self, t):
        if not ({"ym", "thickness"} & set(t)) and "nu_vc" not in t:
            return t
        E, h, nu = self._E, self._h, self.params["nu"]
        kappa = float(self.options["shearCorrection"])
        dE = self._pad_cell_tangent(E, t.pop("ym", 0.0))
        dh = self._pad_cell_tangent(h, t.pop("thickness", 0.0))
        dnu = self._pad_cell_tangent(nu, t.pop("nu_vc", 0.0))
        _, d = torch.func.jvp(lambda E, nu, h: plate_props(E, nu, h, kappa),
                              (E, nu, h), (dE, dnu, dh))
        for k, v in d.items():
            if k in t:
                v = v + self._pad_cell_tangent(self.params[k], t[k])
            t[k] = v
        return t

    def solve_tangent(self, param_tangents=None, bc_tangents=None):
        """Forward sensitivity d(u) . (dparams, dBCs) at the converged
        state by one exact-Jacobian tangent solve (the primal's operator).
        ``param_tangents``: params keys ('D', 'S', 'q', ...) or 'ym' /
        'thickness' / 'nu_vc' (chain rule).  Returns (n_interior, 3)
        numpy = (dbeta_x, dbeta_y, dw)."""
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_tangent")
        mesh, state, params = self.mesh, self.state, self.params
        bcvals = self._resolve_bcvals()
        solver = self.options["linearSolver"]
        base, tans = self._tangent_inputs(param_tangents, bc_tangents, bcvals)
        u = state["u"]

        def r_of(p_sub, b_sub):
            return self._system(mesh, dict(params, **p_sub), state,
                                dict(bcvals, **b_sub), u, matrix=False)[1]

        _, dr = torch.func.jvp(r_of, base, tans)
        A, _ = self._system(mesh, params, state, bcvals, u)
        op = self._jfnk_operator(mesh, params, state, bcvals, u, A)
        du, _ = solver.solve_fn(op, dr, torch.zeros_like(dr))
        return du[: mesh.n_interior_cells].detach().cpu().numpy()

    def solve_adjoint(self, functional, param_keys=(), bc_keys=()) -> dict:
        """Reverse-mode gradient of a scalar functional of the converged
        plate unknowns (``functional(u_interior) -> scalar``, u_interior
        (n_interior, 3)) with respect to parameter fields and BC values,
        from one transposed JFNK solve; 'ym' / 'thickness' / 'nu_vc' are
        chain-ruled through D and S."""
        from .sensitivity import jfnk_adjoint

        kappa = float(self.options["shearCorrection"])
        chain = ({"ym": self._E, "nu_vc": self.params["nu"],
                  "thickness": self._h},
                 lambda ins: plate_props(ins["ym"], ins["nu_vc"],
                                         ins["thickness"], kappa))
        return jfnk_adjoint(self, "u", self._system, functional, param_keys,
                            bc_keys, chain)

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """JFNK outer iterations; returns [(iter, rnorm), ...]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        return newton_advance(self, niter)

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("PlateModel: transient option is off")
        self.state["u_N2"] = self.state["u_N1"]
        self.state["u_N1"] = self.state["u"]

    def getDeflection(self) -> np.ndarray:
        return self.state["u"][: self.mesh.n_interior_cells, 2].detach(
            ).cpu().numpy()

    def getRotations(self) -> np.ndarray:
        return self.state["u"][: self.mesh.n_interior_cells, :2].detach(
            ).cpu().numpy()

    def set_pressure(self, q) -> None:
        """Replace the transverse load field (e.g. the electrostatic
        pressure of the MEMS switch coupling); a scalar or (n_cells,)."""
        ref = self.params["q"]
        q = torch.as_tensor(np.asarray(q, dtype=np.float64) if not
                            isinstance(q, torch.Tensor) else q)
        self.params["q"] = q.to(device=ref.device, dtype=ref.dtype).expand(
            ref.shape).clone()
