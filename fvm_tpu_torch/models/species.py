"""SpeciesModel: multi-species mass transport (``fvm_tpu/models/species.py``).

The reference's SpeciesModel (SpeciesModel.h:19, SpeciesModel_impl.h): per
species the diffusion and convection of a mass fraction with SpeciesBC
dicts.  Each species is an independent scalar transport equation on the
shared mesh, solved in turn within one outer step.  BC types:
'SpecifiedMassFraction', 'SpecifiedMassFlux', 'Symmetry'; double-shell
interfaces through ``model.interface`` (a species i > 0 reads the entry
"s<i>:<name>" first).  The sensitivities bind ``TangentMixin`` per species.
"""

from __future__ import annotations

import weakref

import torch

from ..core import bcs as bck
from ..core import interfaces as ifc
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear import AMG, BiCGStab
from ..ops import assembly, discretizations as disc
from ..ops.gradients import gradient, ls_gradient_coefficients
from .base import Model, ResidualHistory
from .sensitivity import TangentMixin


class SpeciesBC(BoundaryCondition):
    _allowed_types = ("SpecifiedMassFraction", "SpecifiedMassFlux", "Symmetry")
    _defaults = {
        "specifiedMassFraction": 0.0,
        "specifiedMassFlux": 0.0,
    }


class SpeciesVC(BoundaryCondition):
    _defaults = {
        "massDiffusivity": 1e-9,
        "initialMassFraction": 0.0,
    }


class SpeciesModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.1,
        "timeDiscretizationOrder": 1,
        "convective": False,
        "convectionScheme": "upwind",
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


class SpeciesModel(TangentMixin, Model):
    """``n_species`` independent transport fields ``mf<i>``.

    BC access: ``model.bc_for(i)[group]`` (per-species BC maps, the
    reference's getBCMap(speciesId)); ``model.bc`` is species 0's."""

    _supports_interfaces = True
    name = "SpeciesModel"

    def __init__(self, mesh, n_species: int = 1):
        self.n_species = int(n_species)
        super().__init__(mesh)
        self.vcs = [SpeciesVC() for _ in range(self.n_species)]
        self.vc = self.vcs[0]
        self._bcs = [self.bc]
        for _ in range(1, self.n_species):
            bcmap = {}
            for g in mesh.boundary_groups():
                b = self._make_bc()
                bcmap[g[1]] = b
                bcmap[g[0]] = b
            self._bcs.append(bcmap)

    def _make_options(self):
        return SpeciesModelOptions()

    def _make_bc(self):
        return SpeciesBC()

    def bc_for(self, i: int) -> dict:
        return self._bcs[i]

    def _group_bcs_for(self, i):
        for g in self.mesh.boundary_groups():
            if g[2] == "interface":
                continue
            bc = self._bcs[i][g[1]]
            if bc.bc_type is None:
                raise ConfigError(
                    f"{self.name}: species {i} group {g[1]!r} has no bc_type")
            yield g, bc

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        self.state = {"massFlux": self._full_faces(0.0)}
        for i in range(self.n_species):
            # ghosts start at their owner's value (shell-ghost unknowns on
            # interface meshes need a sane nonlinear starting point)
            x0 = self._cell_field(self.vcs[i], "initialMassFraction",
                                  extend_ghosts=True)
            self.state[f"mf{i}"] = x0
            if self.options["transient"]:
                self.state[f"mf{i}_N1"] = x0
        self.params = {
            f"D{i}": self._cell_field(self.vcs[i], "massDiffusivity",
                                      extend_ghosts=True)
            for i in range(self.n_species)
        }
        if self.options["nonOrthogonalCorrection"]:
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

    def _resolve_bcvals(self):
        vals = super()._resolve_bcvals()
        mesh = self.mesh
        for i in range(1, self.n_species):
            for g, bc in self._group_bcs_for(i):
                for key in bc:
                    vals[f"s{i}:{g[1]}:{key}"] = bc.resolve(
                        key, g[4], mesh.dtype, mesh.device)
        return vals

    def _linearize_species(self, mesh, params, state, bcvals, i):
        opts = self.options
        c = state[f"mf{i}"]
        pref = "" if i == 0 else f"s{i}:"
        D_f = disc.harmonic_face_gamma(mesh, params[f"D{i}"])
        gradc = None
        if "grad_coeff" in params:
            gradc = gradient(mesh, params["grad_coeff"], c)
        flux = disc.diffusion_flux(mesh, c, D_f, gradc)
        if opts["convective"]:
            flux = flux + disc.convection_flux(
                mesh, c, state["massFlux"], opts["convectionScheme"], gradc)
        for g, bc in self._group_bcs_for(i):
            sl = mesh.group_faces(g)
            if bc.bc_type == "Symmetry":
                flux = bck.set_flux_fixed(flux, sl, 0.0)
            elif bc.bc_type == "SpecifiedMassFlux":
                q = bcvals[f"{pref}{g[1]}:specifiedMassFlux"]
                flux = bck.set_flux_fixed(flux, sl,
                                          -q * mesh.face_area_mag[sl])
        diag_cell = torch.zeros(mesh.n_cells, dtype=c.dtype, device=c.device)
        r_cell = torch.zeros(mesh.n_cells, dtype=c.dtype, device=c.device)
        if opts["transient"]:
            diag_cell, r_cell = disc.transient_term(
                mesh, c, state[f"mf{i}_N1"], opts["timeStep"])
        A, r = assembly.assemble(mesh, flux, r_cell=r_cell,
                                 diag_cell=diag_cell)
        for g, bc in self._group_bcs_for(i):
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = D_f[sl] * mesh.face_e_over_d[sl]
            if bc.bc_type == "SpecifiedMassFraction":
                A, r = bck.dirichlet_rows(
                    mesh, A, r, gc,
                    bcvals[f"{pref}{g[1]}:specifiedMassFraction"], c, valid,
                    scale)
            else:
                A, r = bck.extrapolation_rows(mesh, A, r, gc, c, valid, scale)
        cfg = (self.interface if i == 0 else {
            nm: self.interface.get(f"s{i}:{nm}", self.interface.get(nm, {}))
            for nm, _, _ in mesh.interfaces})
        A, r = ifc.apply_model_interfaces(mesh, cfg, A, r, c, flux, D_f)
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _build_step(self):
        solver = self.options["linearSolver"]
        n_species = self.n_species
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            state = dict(state)
            total = torch.zeros((), dtype=mesh.cell_volume.dtype,
                                device=mesh.device)
            for i in range(n_species):
                A, r = me._linearize_species(mesh, params, state, bcvals, i)
                total = total + A.norm(r) ** 2
                dx, _ = solver.solve_fn(A, r, torch.zeros_like(r))
                state[f"mf{i}"] = state[f"mf{i}"] + dx
            return state, {"rnorm": torch.sqrt(total)}

        return step

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer iterations over all species; returns [(iter, rnorm)]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        opts = self.options
        hist = ResidualHistory()
        bcvals = self._resolve_bcvals()
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk, bcvals)
        for it in range(niter):
            self.state, aux = self._step(self.mesh, self.params, self.state,
                                         bcvals)
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
            raise ConfigError("SpeciesModel: transient option is off")
        for i in range(self.n_species):
            self.state[f"mf{i}_N1"] = self.state[f"mf{i}"]

    # --- sensitivities (TangentMixin bound per species) ------------------

    def _species_linearize(self, i):
        return lambda m, p, s, b: self._linearize_species(m, p, s, b, i)

    def solve_tangent(self, param_tangents: dict, i: int = 0):
        """d(mf_i)/d(params) . direction at the converged state; keys index
        ``self.params`` (e.g. "D0")."""
        return self._tangent_impl(f"mf{i}", self._species_linearize(i),
                                  self.options["linearSolver"],
                                  param_tangents)

    def solve_adjoint(self, functional, param_keys, i: int = 0) -> dict:
        """Reverse-mode gradient of a scalar functional of mf_i with
        respect to parameter fields (one transposed solve)."""
        return self._adjoint_impl(f"mf{i}", self._species_linearize(i),
                                  self.options["linearSolver"], functional,
                                  param_keys)

    def solve_mc(self, param_key: str, samples, niter: int = 20, i: int = 0):
        """Re-solves of species i over a batch of parameter values."""
        return self._mc_impl(f"mf{i}", self._species_linearize(i),
                             self.options["linearSolver"], param_key,
                             samples, niter)

    def getMassFraction(self, i: int = 0):
        return self.state[f"mf{i}"][: self.mesh.n_interior_cells].cpu().numpy()

    def getMassFluxIntegral(self, group_name, i: int = 0) -> float:
        """Diffusive mass flow INTO the domain through a boundary group."""
        g = self._group(group_name)

        def face_flux(m, c, D, grad_coeff=None):
            D_f = disc.harmonic_face_gamma(m, D)
            gradc = (gradient(m, grad_coeff, c) if grad_coeff is not None
                     else None)
            return disc.diffusion_flux(m, c, D_f, gradc).F

        args = (self.state[f"mf{i}"], self.params[f"D{i}"])
        if "grad_coeff" in self.params:
            args = args + (self.params["grad_coeff"],)
        F = self._map_mesh(face_flux, *args)
        return float(-self._sum_group(g, F))
