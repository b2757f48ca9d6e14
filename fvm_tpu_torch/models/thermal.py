"""ThermalModel: heat conduction/convection (``fvm_tpu/models/thermal.py``).

The reference's ThermalModel (ThermalModel.h:19, ThermalModel_impl.h:84
``init``, :236 ``linearize``, :424 ``advance``; BC/VC dicts in
ThermalBC.h): one linearize-assemble-solve step per outer iteration.

BC types ported so far: 'SpecifiedTemperature', 'SpecifiedHeatFlux'
(per-area, positive into the domain), 'Symmetry' and 'Convective'
(heatTransferCoefficient + farFieldTemperature).  'ZeroGradient',
'Radiative', 'Mixed', 'Periodic', double-shell interfaces, immersed
boundaries and tangents come later.
"""

from __future__ import annotations

import torch

from ..core.options import BoundaryCondition, ModelOptions
from ..core import bcs as bck
from ..ops import assembly, discretizations as disc
from ..ops.halo import maybe_sync
from ..ops.gradients import ls_gradient_coefficients, gradient
from ..linear import AMG, BiCGStab
from ..exceptions import ConfigError
from .base import Model, ResidualHistory


class ThermalBC(BoundaryCondition):
    _allowed_types = (
        "SpecifiedTemperature",
        "SpecifiedHeatFlux",
        "Symmetry",
        "Convective",
    )
    _defaults = {
        "specifiedTemperature": 300.0,
        "specifiedHeatFlux": 0.0,
        "heatTransferCoefficient": 0.0,
        "farFieldTemperature": 300.0,
    }


class ThermalVC(BoundaryCondition):
    """Volume conditions (reference: ThermalVC in ThermalBC.h)."""

    _defaults = {
        "thermalConductivity": 1.0,
        "density": 1.0,
        "specificHeat": 1.0,
        "initialTemperature": 300.0,
        "heatSource": 0.0,
    }


class ThermalModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.1,
        "timeDiscretizationOrder": 1,
        "convective": False,  # enable convection using state['massFlux']
        "convectionScheme": "upwind",
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "urf": 1.0,
        "verbose": True,
    }


class ThermalModel(Model):
    name = "ThermalModel"

    def __init__(self, mesh):
        super().__init__(mesh)
        self.vc = ThermalVC()

    def _make_options(self):
        return ThermalModelOptions()

    def _make_bc(self):
        return ThermalBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        self.state = {
            "T": self._cell_field(self.vc, "initialTemperature"),
            "massFlux": self._full_faces(0.0),
        }
        if self.options["transient"]:
            self.state["T_N1"] = self.state["T"]
            if self.options["timeDiscretizationOrder"] > 1:
                self.state["T_N2"] = self.state["T"]

        self.params = {
            "k_cell": self._cell_field(self.vc, "thermalConductivity",
                                       extend_ghosts=True),
            "rho_cp": self._cell_field(self.vc, "density")
            * self._cell_field(self.vc, "specificHeat"),
            "src": self._cell_field(self.vc, "heatSource"),
        }
        needs_grad = self.options["nonOrthogonalCorrection"] and not (
            mesh.orthogonal and self.options["convectionScheme"] != "sou"
        )
        if needs_grad:
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)

        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(
                preconditioner=AMG(), relative_tolerance=1e-10,
                max_iterations=50,
            )
            self.options["linearSolver"] = solver
        for s in (solver, getattr(solver, "preconditioner", None)):
            if isinstance(s, AMG):
                s.setup_structure(*mesh.host_cf(), mesh.device)

        self._step = self._build_step()
        self._initial_norm = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _linearize(self, mesh, params, state, bcvals):
        """Build (A, r) for the current state."""
        opts = self.options
        T = maybe_sync(mesh, state["T"])

        gamma_f = disc.harmonic_face_gamma(mesh, params["k_cell"])
        gradT = None
        if "grad_coeff" in params:
            gradT = maybe_sync(mesh, gradient(mesh, params["grad_coeff"], T))
        flux = disc.diffusion_flux(mesh, T, gamma_f, gradT)
        if opts["convective"]:
            flux = flux + disc.convection_flux(
                mesh, T, state["massFlux"], opts["convectionScheme"]
            )

        # phase 1: flux patches on boundary groups
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            t = bc.bc_type
            if t == "SpecifiedHeatFlux":
                q = bcvals[f"{g[1]}:specifiedHeatFlux"]
                flux = bck.set_flux_fixed(flux, sl, -q * mesh.face_area_mag[sl])
            elif t == "Symmetry":
                flux = bck.set_flux_fixed(flux, sl, 0.0)
            # SpecifiedTemperature / Convective keep the diffusive face
            # flux (it references the ghost value)

        # cell terms
        diag_cell, r_cell = disc.source_term(mesh, params["src"])
        if opts["transient"]:
            d2, r2 = disc.transient_term(
                mesh, T, state["T_N1"], opts["timeStep"], params["rho_cp"],
                state.get("T_N2"),
            )
            diag_cell = diag_cell + d2
            r_cell = r_cell + r2

        A, r = assembly.assemble(mesh, flux, r_cell=r_cell, diag_cell=diag_cell)

        # phase 2: ghost-row patches
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            t = bc.bc_type
            scale = gamma_f[sl] * mesh.face_e_over_d[sl]
            if t == "SpecifiedTemperature":
                A, r = bck.dirichlet_rows(
                    mesh, A, r, gc, bcvals[f"{g[1]}:specifiedTemperature"], T,
                    valid, scale,
                )
            elif t in ("SpecifiedHeatFlux", "Symmetry"):
                A, r = bck.extrapolation_rows(mesh, A, r, gc, T, valid, scale)
            elif t == "Convective":
                amag = mesh.face_area_mag[sl]
                h = bcvals[f"{g[1]}:heatTransferCoefficient"]
                Tinf = bcvals[f"{g[1]}:farFieldTemperature"]
                coeff = h * amag
                sink = h * amag * (Tinf - T[gc])
                A, r = bck.robin_sink_rows(mesh, A, r, gc, coeff, sink)
            else:
                raise ConfigError(f"ThermalModel: unhandled bc_type {t!r}")

        # double-shell interfaces (fvm_tpu: ifc.apply_model_interfaces) are
        # an identity on a mesh without them, which is every mesh the port
        # builds so far; halo rows do not exist on one device
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _build_step(self):
        solver = self.options["linearSolver"]
        urf = float(self.options["urf"])

        def step(mesh, params, state, bcvals):
            A, r = self._linearize(mesh, params, state, bcvals)
            rnorm = A.norm(r)
            dx, stats = solver.solve_fn(A, r, torch.zeros_like(r))
            state = dict(state)
            state["T"] = state["T"] + urf * dx
            return state, {"rnorm": rnorm}

        return step

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer (nonlinear) iterations; returns [(iter, rnorm), ...].

        Mirrors ThermalModel_impl.h:424-454: linearize, solve, update,
        check rNorm against absolute/relative tolerances."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        opts = self.options
        hist = ResidualHistory()
        bcvals = self._resolve_bcvals()
        sync = self._residual_sync()
        for it in range(niter):
            self.state, aux = self._step(self.mesh, self.params, self.state,
                                         bcvals)
            if not sync:
                hist.append((it, aux["rnorm"]))
                continue
            rnorm = float(aux["rnorm"])
            self._guard_residual(rnorm, it)
            if self._initial_norm is None or self._initial_norm == 0.0:
                self._initial_norm = rnorm
            hist.append((it, rnorm))
            self._log_iteration(f"{self.name}: {it}: {rnorm:.6e}")
            if rnorm < opts["absoluteTolerance"]:
                break
            if rnorm / max(self._initial_norm, 1e-300) < opts["relativeTolerance"]:
                break
        return hist

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("ThermalModel: transient option is off")
        if "T_N2" in self.state:
            self.state["T_N2"] = self.state["T_N1"]
        self.state["T_N1"] = self.state["T"]

    def getTemperature(self):
        """Interior-cell temperatures as a host numpy array."""
        return self.state["T"][: self.mesh.n_interior_cells].cpu().numpy()
