"""Generic scalar transport model (``fvm_tpu/models/scalar_generic.py``).

The diffusion / convection / source / transient + BC pattern shared by
several of the reference's scalar models (VacancyModel_impl.h,
FractureModel_impl.h, and the thermal and species structure) in one
parameterized implementation: d(phi)/dt + div(mdot phi) = div(D grad phi)
+ S.  Subclasses set the field and BC vocabulary and may override the
source hook; ``TangentMixin`` gives them the sensitivities.
"""

from __future__ import annotations

import weakref

import torch

from ..core import bcs as bck
from ..core import interfaces as ifc
from ..exceptions import ConfigError
from ..linear import AMG, BiCGStab
from ..ops import assembly, discretizations as disc
from ..ops.gradients import gradient, ls_gradient_coefficients
from .base import Model, ResidualHistory
from .sensitivity import TangentMixin


class GenericScalarModel(TangentMixin, Model):
    """Scalar transport.  Subclass knobs:

      var            state key of the unknown
      diffusivity_vc VC key of D
      initial_vc     VC key of the initial value
      bc_dirichlet   BC key of the Dirichlet value
      bc_flux        BC key of the specified boundary flux (per area)

    BC types: 'Dirichlet', 'SpecifiedFlux', 'Symmetry', 'Periodic' (any
    other type extrapolates its ghost)."""

    var = "phi"
    _supports_interfaces = True
    diffusivity_vc = "diffusivity"
    initial_vc = "initialValue"
    bc_dirichlet = "specifiedValue"
    bc_flux = "specifiedFlux"

    def init(self) -> None:
        mesh = self.mesh
        x0 = self._cell_field(self.vc, self.initial_vc, extend_ghosts=True)
        self.state = {self.var: x0, "massFlux": self._full_faces(0.0)}
        if self.options["transient"]:
            self.state[f"{self.var}_N1"] = x0
            if self.options.get("timeDiscretizationOrder", 1) > 1:
                self.state[f"{self.var}_N2"] = x0
        self.params = {
            "D": self._cell_field(self.vc, self.diffusivity_vc,
                                  extend_ghosts=True),
        }
        self._extra_params()
        for g, bc in self._group_bcs():
            if bc.bc_type == "Periodic":
                self.params[f"periodic_src:{g[1]}"] = \
                    self._periodic_group_src(g)
        if self.options.get("nonOrthogonalCorrection", True):
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)
        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=AMG(), relative_tolerance=1e-10,
                              max_iterations=50)
            self.options["linearSolver"] = solver
        for s in (solver, getattr(solver, "preconditioner", None)):
            if isinstance(s, AMG):
                s.setup_structure(*mesh.host_cf(), mesh.device)
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    # hooks ---------------------------------------------------------------

    def _extra_params(self):
        pass

    def _source_terms(self, mesh, params, state, phi):
        """(diag_cell, r_cell) source contributions."""
        z = torch.zeros(mesh.n_cells, dtype=phi.dtype, device=phi.device)
        return z, z

    # ---------------------------------------------------------------------

    def _linearize(self, mesh, params, state, bcvals):
        opts = self.options
        phi = state[self.var]
        D_f = disc.harmonic_face_gamma(mesh, params["D"])
        gradp = None
        if "grad_coeff" in params:
            gradp = gradient(mesh, params["grad_coeff"], phi)
        flux = disc.diffusion_flux(mesh, phi, D_f, gradp)
        if opts.get("convective", False):
            flux = flux + disc.convection_flux(
                mesh, phi, state["massFlux"],
                opts.get("convectionScheme", "upwind"), gradp)
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            if bc.bc_type == "Symmetry":
                flux = bck.set_flux_fixed(flux, sl, 0.0)
            elif bc.bc_type == "SpecifiedFlux":
                q = bcvals[f"{g[1]}:{self.bc_flux}"]
                flux = bck.set_flux_fixed(flux, sl,
                                          -q * mesh.face_area_mag[sl])
        diag_cell, r_cell = self._source_terms(mesh, params, state, phi)
        if opts["transient"]:
            d2, r2 = disc.transient_term(
                mesh, phi, state[f"{self.var}_N1"], opts["timeStep"], 1.0,
                state.get(f"{self.var}_N2"))
            diag_cell = diag_cell + d2
            r_cell = r_cell + r2
        A, r = assembly.assemble(mesh, flux, r_cell=r_cell,
                                 diag_cell=diag_cell)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = D_f[sl] * mesh.face_e_over_d[sl]
            if bc.bc_type == "Dirichlet":
                A, r = bck.dirichlet_rows(
                    mesh, A, r, gc, bcvals[f"{g[1]}:{self.bc_dirichlet}"],
                    phi, valid, scale)
            elif bc.bc_type == "Periodic":
                A, r = bck.periodic_rows(
                    mesh, A, r, gc, phi, params[f"periodic_src:{g[1]}"],
                    valid, scale)
            else:
                A, r = bck.extrapolation_rows(mesh, A, r, gc, phi, valid,
                                              scale)
        A, r = ifc.apply_model_interfaces(mesh, self.interface, A, r, phi,
                                          flux, D_f)
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _build_step(self):
        solver = self.options["linearSolver"]
        urf = float(self.options.get("urf", 1.0))
        var = self.var
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            A, r = me._linearize(mesh, params, state, bcvals)
            rnorm = A.norm(r)
            dx, _ = solver.solve_fn(A, r, torch.zeros_like(r))
            state = dict(state)
            state[var] = state[var] + urf * dx
            return state, {"rnorm": rnorm}

        return step

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer iterations; returns [(iter, rnorm), ...] with the
        absolute and relative tests of the reference's advance loops."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        opts = self.options
        hist = ResidualHistory()
        bcvals = self._resolve_bcvals()
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk, bcvals)
        for it in range(niter):
            with self._phase("step"):
                self.state, aux = self._step(self.mesh, self.params,
                                             self.state, bcvals)
            rnorm = float(aux["rnorm"])
            self._guard_residual(rnorm, it)
            if self._initial_norm is None or self._initial_norm == 0.0:
                self._initial_norm = rnorm
            hist.append((it, rnorm))
            self._log_iteration(f"{self.name}: {it}: {rnorm:.6e}")
            if rnorm < opts["absoluteTolerance"]:
                break
            if rnorm / max(self._initial_norm, 1e-300) < opts[
                    "relativeTolerance"]:
                break
        return hist

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError(f"{self.name}: transient option is off")
        if f"{self.var}_N2" in self.state:
            self.state[f"{self.var}_N2"] = self.state[f"{self.var}_N1"]
        self.state[f"{self.var}_N1"] = self.state[self.var]

    def get_field(self):
        """Interior-cell values of the unknown as a host numpy array."""
        return self.state[self.var][: self.mesh.n_interior_cells].cpu().numpy()

    def getFluxIntegral(self, group_name) -> float:
        """Diffusive flux leaving the domain through a boundary group (the
        reference's per-model get<Var>FluxIntegral accessors)."""
        g = self._group(group_name)

        def face_flux(m, phi, D, grad_coeff=None):
            D_f = disc.harmonic_face_gamma(m, D)
            gradp = (gradient(m, grad_coeff, phi) if grad_coeff is not None
                     else None)
            return disc.diffusion_flux(m, phi, D_f, gradp).F

        args = (self.state[self.var], self.params["D"])
        if "grad_coeff" in self.params:
            args = args + (self.params["grad_coeff"],)
        F = self._map_mesh(face_flux, *args)
        return float(self._sum_group(g, F))
