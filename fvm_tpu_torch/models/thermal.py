"""ThermalModel: heat conduction/convection (``fvm_tpu/models/thermal.py``).

The reference's ThermalModel (ThermalModel.h:19, ThermalModel_impl.h:84
``init``, :236 ``linearize``, :424 ``advance``; BC/VC dicts in
ThermalBC.h): one linearize-assemble-solve step per outer iteration.

BC types: 'SpecifiedTemperature', 'SpecifiedHeatFlux' (per-area,
positive into the domain), 'Symmetry', 'ZeroGradient' (a convective
outflow), 'Convective' (heatTransferCoefficient + farFieldTemperature),
'Radiative' (surfaceEmissivity + farFieldTemperature), 'Mixed' (convective
+ radiative) and 'Periodic' (the implicit wrap of ``Mesh.make_periodic``
pairs); double-shell interfaces (contact resistance, thermal jump layers:
``model.interface[name]``, core/interfaces.py); the immersed boundary
(mask form, and the ``IBManager`` stencil rows, implicit or lagged) and
``getHeatFluxIntegral``; sensitivities (``TangentMixin``: tangent,
adjoint, Monte-Carlo and polynomial chaos of T with respect to "k_cell",
"rho_cp" and "src") and the ``differentiable`` option, whose steps solve
through ``solve_fn_implicit`` so ``torch.func.jvp`` and reverse mode
through a whole step give exact sensitivities.

Distributed (``ThermalModel(local_mesh, partition=part)``,
``fvm_tpu/models/thermal.py:143-184, 376-406``): the default solver is
``BiCGStab(JacobiSolver(sweeps=3), 1e-10, 500)`` (the ghost rows are not
symmetric and a shard's matrix is not condensed, so CG could diverge); an
AMG solver or preconditioner gets the shard-local hierarchy.  Flux
integrals and ``getTemperature`` are global on every rank; the
sensitivities and the immersed boundary on shards are not ported yet
(ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import weakref

import torch

from ..core.options import BoundaryCondition, ModelOptions
from ..core import bcs as bck
from ..core import interfaces as ifc
from ..ops import assembly, discretizations as disc
from ..ops.halo import maybe_sync
from ..ops.gradients import ls_gradient_coefficients, gradient
from ..linear import AMG, BiCGStab, JacobiSolver
from ..exceptions import ConfigError
from .base import Model, ResidualHistory
from .sensitivity import TangentMixin

STEFAN_BOLTZMANN = 5.670374419e-8


class ThermalBC(BoundaryCondition):
    _allowed_types = (
        "SpecifiedTemperature",
        "SpecifiedHeatFlux",
        "Symmetry",
        # convective outflow: the ghost is extrapolated (no diffusive flux)
        # but the convective face flux stays, unlike Symmetry, which zeroes
        # the whole face flux and traps energy at a flow-through boundary
        "ZeroGradient",
        "Convective",
        "Radiative",
        "Mixed",
        "Periodic",
    )
    _defaults = {
        "specifiedTemperature": 300.0,
        "specifiedHeatFlux": 0.0,
        "heatTransferCoefficient": 0.0,
        "farFieldTemperature": 300.0,
        "surfaceEmissivity": 1.0,
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
        # implicitly differentiated solves, so torch.func.jvp (and reverse
        # mode) through a step gives exact sensitivities (the Tangent
        # atype's role)
        "differentiable": False,
    }


class ThermalModel(TangentMixin, Model):
    # double-shell interfaces (contact resistance, thermal jump layers;
    # the reference's BatteryLinearizeThermalInterface.h): the default
    # closure is the continuous interface (A = 1, B = 0)
    _supports_interfaces = True
    name = "ThermalModel"
    # the unknown the sensitivities differentiate (TangentMixin)
    var = "T"

    def __init__(self, mesh, partition=None):
        super().__init__(mesh, partition)
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
        for g, bc in self._group_bcs():
            if bc.bc_type == "Periodic":
                self.params[f"periodic_src:{g[1]}"] = \
                    self._periodic_group_src(g)
        needs_grad = self.options["nonOrthogonalCorrection"] and not (
            mesh.orthogonal and self.options["convectionScheme"] != "sou"
        )
        if needs_grad:
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)

        solver = self.options.get("linearSolver")
        if solver is None:
            if self._dist:
                solver = BiCGStab(
                    preconditioner=JacobiSolver(sweeps=3),
                    relative_tolerance=1e-10, max_iterations=500)
            else:
                solver = BiCGStab(
                    preconditioner=AMG(), relative_tolerance=1e-10,
                    max_iterations=50,
                )
            self.options["linearSolver"] = solver
        for s in (solver, getattr(solver, "preconditioner", None)):
            if isinstance(s, AMG):
                if not self._dist:
                    s.setup_structure(*mesh.host_cf(), mesh.device)
                elif not s.setup_structure_dist(*mesh.host_cf(),
                                                mesh.n_owned_cells,
                                                mesh.group):
                    raise ConfigError(
                        "ThermalModel: no shard-local AMG coarsening is "
                        "possible on this partition; use BiCGStab with a "
                        "Jacobi preconditioner")

        self._step = self._build_step()
        self._runners = {}
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
                mesh, T, state["massFlux"], opts["convectionScheme"], gradT
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
            # the other types keep the face flux (its diffusive part
            # references the ghost value)

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
            elif t in ("SpecifiedHeatFlux", "Symmetry", "ZeroGradient"):
                A, r = bck.extrapolation_rows(mesh, A, r, gc, T, valid, scale)
            elif t == "Periodic":
                # implicit wrap: the geometry wraps through the repositioned
                # ghost, the partner coupling is slot 1
                A, r = bck.periodic_rows(
                    mesh, A, r, gc, T, params[f"periodic_src:{g[1]}"],
                    valid, scale)
            elif t in ("Convective", "Radiative", "Mixed"):
                amag = mesh.face_area_mag[sl]
                coeff = torch.zeros_like(amag)
                sink = torch.zeros_like(amag)
                Tg = T[gc]
                if t in ("Convective", "Mixed"):
                    h = bcvals[f"{g[1]}:heatTransferCoefficient"]
                    Tinf = bcvals[f"{g[1]}:farFieldTemperature"]
                    coeff = coeff + h * amag
                    sink = sink + h * amag * (Tinf - Tg)
                if t in ("Radiative", "Mixed"):
                    eps = bcvals[f"{g[1]}:surfaceEmissivity"]
                    Tinf = bcvals[f"{g[1]}:farFieldTemperature"]
                    coeff = coeff + (4.0 * STEFAN_BOLTZMANN * eps * amag
                                     * Tg**3)
                    sink = sink + (STEFAN_BOLTZMANN * eps * amag
                                   * (Tinf**4 - Tg**4))
                A, r = bck.robin_sink_rows(mesh, A, r, gc, coeff, sink)
            else:
                raise ConfigError(f"ThermalModel: unhandled bc_type {t!r}")

        # immersed-boundary rows (the mask form: pinned cells)
        A, r = self._apply_ib(mesh, params, A, r, T)

        A, r = ifc.apply_model_interfaces(mesh, self.interface, A, r, T,
                                          flux, gamma_f)
        # halo rows are owned by another rank: identity here
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _build_step(self):
        solver = self.options["linearSolver"]
        urf = float(self.options["urf"])
        solve = (solver.solve_fn_implicit
                 if self.options.get("differentiable") else solver.solve_fn)

        # the step holds its model weakly: the model holds the step and,
        # through its runners, the CUDA graphs captured from it, so a strong
        # reference would make a cycle that only the cycle collector frees
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            A, r = me._linearize(mesh, params, state, bcvals)
            rnorm = A.norm(r)
            dx, _ = solve(A, r, torch.zeros_like(r))
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
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk, bcvals)
        for it in range(niter):
            with self._phase("step"):
                self.state, aux = self._step(self.mesh, self.params,
                                             self.state, bcvals)
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

    def set_immersed_boundary(self, mask, value, stencil=None,
                              implicit=True) -> None:
        """Pin the cells of ``mask`` to a temperature ``value`` (scalar or
        per cell).  With ``stencil`` (``IBManager.interpolation_stencil()``)
        pass ``mask = ibm.dirichlet_mask(include_ib=False)``: the IB band
        carries the interpolation rows, in the matrix (``implicit``, the
        reference's GenericIBDiscretization.h) or lagged by one outer."""
        self._set_immersed_boundary(mask, value, stencil, implicit)

    def getHeatFluxIntegral(self, group_name) -> float:
        """Net heat flow INTO the domain through a boundary group
        (reference: ThermalModel_impl.h:400 getHeatFluxIntegral)."""
        mesh = self.mesh
        g = self._group(group_name)
        bc = self.bc[g[1]]
        if bc.bc_type == "SpecifiedHeatFlux":
            q = self._group_bc_values(g, bc, "specifiedHeatFlux")
            F = torch.zeros_like(mesh.face_area_mag)
            sl = mesh.group_faces(g)
            F[sl] = q * mesh.face_area_mag[sl]
            return float(self._sum_group(g, F))
        if bc.bc_type == "Symmetry":
            return 0.0

        def face_flux(m, T, k, grad_coeff=None):
            gamma_f = disc.harmonic_face_gamma(m, k)
            gradT = (gradient(m, grad_coeff, T) if grad_coeff is not None
                     else None)
            return disc.diffusion_flux(m, T, gamma_f, gradT).F

        args = (self.state["T"], self.params["k_cell"])
        if "grad_coeff" in self.params:
            args = args + (self.params["grad_coeff"],)
        F = self._map_mesh(face_flux, *args)
        return float(-self._sum_group(g, F))

    def getTemperature(self):
        """Interior-cell temperatures as a host numpy array (in the global
        numbering, gathered from every rank, when distributed)."""
        return self._gather_cells(self.state["T"])
