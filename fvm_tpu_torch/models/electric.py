"""ElectricModel: electrostatics (the electrostatics half of
``fvm_tpu/models/electric.py``).

The reference's ElectricModel (ElectricModel.h:19, ElectricModel_impl.h:49;
electrostatics :136-154): the potential solve div(eps grad phi) = -rho with
a per-cell dielectric constant (times ``EPS0``) and a space-charge source,
and the field E = -grad phi from least-squares gradients.  One
linearize-solve-update step per outer iteration; ``outerChunk`` runs the
chunked loop (a CUDA graph replay on a CUDA mesh).

BC types: 'SpecifiedPotential', 'SpecifiedCharge' (surface charge density
-> flux) and 'Symmetry'; the mask form of the immersed boundary; double-
shell interfaces in the potential solve, the dielectric layer
(LinearizeDielectric.h:102) among them.  Sensitivities of the potential
solve (``solve_tangent``, ``solve_adjoint``, ``solve_mc``, charge held
fixed).  Charge transport, injection, trapping, Poole-Frenkel emission and
trap-band tunneling (ROADMAP queue 1 item 6) and the stencil form of the
immersed boundary (item 9) are not ported yet: their options raise
``ConfigError``.
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

EPS0 = 8.8542e-12


class ElectricBC(BoundaryCondition):
    _allowed_types = ("SpecifiedPotential", "SpecifiedCharge", "Symmetry")
    _defaults = {
        "specifiedPotential": 0.0,
        "specifiedCharge": 0.0,
        "specifiedChargeFlux": 0.0,
    }


class ElectricVC(BoundaryCondition):
    """Volume conditions; the transport and trap coefficients are carried
    into ``params`` as in the JAX package (its keys), unused here."""

    _defaults = {
        "dielectric_constant": 7.9,  # reference default (silicon nitride)
        "initialCharge": 0.0,
        "initialPotential": 0.0,
        "mobility": 1e-10,
        "diffusivity": 1e-12,
        "trapDensity": 0.0,
        "captureCoefficient": 0.0,
        "emissionCoefficient": 0.0,
        "initialTrappedCharge": 0.0,
    }


class ElectricModelOptions(ModelOptions):
    _defaults = {
        "electrostatics_enable": True,
        "chargetransport_enable": False,
        "injection_enable": False,
        "trapping_enable": False,
        "poole_frenkel_enable": False,
        "trapbandtunneling_enable": False,
        "transient": False,
        "timeStep": 1.0,
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


# options of the charge-transport half, not ported yet
_TRANSPORT_OPTIONS = ("chargetransport_enable", "injection_enable",
                      "trapping_enable", "poole_frenkel_enable",
                      "trapbandtunneling_enable")


class ElectricModel(TangentMixin, Model):
    _supports_interfaces = True
    name = "ElectricModel"

    def __init__(self, mesh):
        super().__init__(mesh)
        self.vc = ElectricVC()
        self._E = None

    def _make_options(self):
        return ElectricModelOptions()

    def _make_bc(self):
        return ElectricBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        on = [k for k in _TRANSPORT_OPTIONS if self.options.get(k)]
        if on:
            raise ConfigError(
                f"ElectricModel: {', '.join(on)}: charge transport is not "
                "ported yet (ROADMAP queue 1 item 6)")
        self.state = {
            "potential": self._cell_field(self.vc, "initialPotential"),
            "charge": self._cell_field(self.vc, "initialCharge"),
            "trapped": self._cell_field(self.vc, "initialTrappedCharge"),
        }
        if self.options["transient"]:
            self.state["charge_N1"] = self.state["charge"]
            self.state["trapped_N1"] = self.state["trapped"]
        self.params = {
            "eps": self._cell_field(self.vc, "dielectric_constant",
                                    extend_ghosts=True) * EPS0,
            "mobility": self._cell_field(self.vc, "mobility",
                                         extend_ghosts=True),
            "diffusivity": self._cell_field(self.vc, "diffusivity",
                                            extend_ghosts=True),
            "trapDensity": self._cell_field(self.vc, "trapDensity"),
            "k_cap": self._cell_field(self.vc, "captureCoefficient"),
            "k_em": self._cell_field(self.vc, "emissionCoefficient"),
        }
        if self.options["nonOrthogonalCorrection"]:
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)

        solver = self.options.get("electrostaticsLinearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=AMG(), relative_tolerance=1e-10,
                              max_iterations=50)
            self.options["electrostaticsLinearSolver"] = solver
        for s in (solver, getattr(solver, "preconditioner", None)):
            if isinstance(s, AMG):
                s.setup_structure(*mesh.host_cf(), mesh.device)

        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._E = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _linearize_potential(self, mesh, params, state, bcvals):
        """(A, r) of the potential equation at the current state."""
        phi = state["potential"]
        rho = state["charge"] + state["trapped"]
        eps_f = disc.harmonic_face_gamma(mesh, params["eps"])
        gradp = None
        if "grad_coeff" in params:
            gradp = gradient(mesh, params["grad_coeff"], phi)
        flux = disc.diffusion_flux(mesh, phi, eps_f, gradp)

        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            if bc.bc_type == "Symmetry":
                flux = bck.set_flux_fixed(flux, sl, 0.0)
            elif bc.bc_type == "SpecifiedCharge":
                # surface charge density sigma -> D.n = sigma
                sigma = bcvals[f"{g[1]}:specifiedCharge"]
                flux = bck.set_flux_fixed(flux, sl,
                                          -sigma * mesh.face_area_mag[sl])

        # space charge source: div(eps grad phi) = -rho  =>  r += rho V
        _, r_cell = disc.source_term(mesh, rho)
        A, r = assembly.assemble(mesh, flux, r_cell=r_cell)

        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = eps_f[sl] * mesh.face_e_over_d[sl]
            if bc.bc_type == "SpecifiedPotential":
                A, r = bck.dirichlet_rows(
                    mesh, A, r, gc, bcvals[f"{g[1]}:specifiedPotential"],
                    phi, valid, scale)
            else:
                A, r = bck.extrapolation_rows(mesh, A, r, gc, phi, valid,
                                              scale)
        if mesh.interfaces:
            A, r = ifc.apply_model_interfaces(
                mesh, self._interface_cfg(), A, r, phi, flux, eps_f)
        A, r = self._apply_ib(mesh, params, A, r, phi)
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _interface_cfg(self) -> dict:
        """``self.interface`` with each dielectric shell (type
        "dielectric": a thin layer of ``thickness`` t and ``constant``
        eps_d between the two shell potentials, with an optional layer
        surface ``charge``) written as the flux closure F_R = eps_d / t
        (phi_R - phi_L) - q t / 2 (LinearizeDielectric.h:102); plain jump
        and flux entries pass through."""
        cfg = {}
        for nm, _, _ in self.mesh.interfaces:
            c = dict(self.interface.get(nm, {}))
            if c.get("type") == "dielectric":
                epsd = float(c["constant"])
                t_d = float(c["thickness"])
                q_l = float(c.get("charge", 0.0))

                def fn(pl, pr, epsd=epsd, t_d=t_d, q_l=q_l):
                    return epsd / t_d * (pr - pl) - 0.5 * q_l * t_d

                c = {"type": "flux", "flux_fn": fn}
            cfg[nm] = c
        return cfg

    @staticmethod
    def _field(mesh, params, phi):
        """E = -grad phi (zero without LS coefficients)."""
        if "grad_coeff" in params:
            return -gradient(mesh, params["grad_coeff"], phi)
        return torch.zeros((mesh.n_cells, mesh.dim), dtype=phi.dtype,
                           device=phi.device)

    def _build_step(self):
        opts = self.options
        psolver = opts["electrostaticsLinearSolver"]
        enabled = bool(opts["electrostatics_enable"])
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            if enabled:
                A, r = me._linearize_potential(mesh, params, state, bcvals)
                rnorm = A.norm(r)
                dx, _ = psolver.solve_fn(A, r, torch.zeros_like(r))
                state = dict(state, potential=state["potential"] + dx)
            else:
                rnorm = torch.zeros((), dtype=state["potential"].dtype,
                                    device=mesh.device)
            return state, {"rnorm": rnorm,
                           "E": me._field(mesh, params, state["potential"])}

        return step

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer iterations; returns [(iter, rnorm), ...]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        opts = self.options
        bcvals = self._resolve_bcvals()
        chunk = self._chunk_size(niter)
        if chunk:
            hist = self._advance_chunked(niter, chunk, bcvals)
            # the last active trip's field: E of the state it left
            self._E = self._field(self.mesh, self.params,
                                  self.state["potential"])
            return hist
        hist = ResidualHistory()
        for it in range(niter):
            with self._phase("step"):
                self.state, aux = self._step(self.mesh, self.params,
                                             self.state, bcvals)
            self._E = aux["E"]
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
            raise ConfigError("ElectricModel: transient option is off")
        self.state["charge_N1"] = self.state["charge"]
        self.state["trapped_N1"] = self.state["trapped"]

    def set_immersed_boundary(self, mask, value, stencil=None,
                              implicit=True) -> None:
        """Pin the cells of ``mask`` to an electrode potential ``value``
        (the reference's IBM electrostatics pipeline,
        src/fvm/test/IBM_PARALLEL).  The stencil form raises (not ported
        yet)."""
        self._set_immersed_boundary(mask, value, stencil, implicit)

    # --- sensitivities (TangentMixin bound to the potential solve;
    # fvm_tpu/models/electric.py:271-300) -----------------------------------

    def solve_tangent(self, param_tangents: dict):
        """d(potential)/d(params) . direction at the current state (charge
        held fixed: the electrostatics solve is linear in the potential).
        Keys index ``self.params`` (e.g. "eps")."""
        return self._tangent_impl(
            "potential", self._linearize_potential,
            self.options["electrostaticsLinearSolver"], param_tangents)

    def solve_adjoint(self, functional, param_keys) -> dict:
        """Reverse-mode gradient of a scalar functional of the potential
        with respect to parameter fields (one transposed solve)."""
        return self._adjoint_impl(
            "potential", self._linearize_potential,
            self.options["electrostaticsLinearSolver"], functional,
            param_keys)

    def solve_mc(self, param_key: str, samples, niter: int = 20):
        """Potential re-solves over a batch of parameter fields (e.g. the
        dielectric constant's uncertainty)."""
        return self._mc_impl(
            "potential", self._linearize_potential,
            self.options["electrostaticsLinearSolver"], param_key, samples,
            niter)

    def _interior(self, x):
        return x[: self.mesh.n_interior_cells].cpu().numpy()

    def getPotential(self):
        """Interior-cell potentials as a host numpy array."""
        return self._interior(self.state["potential"])

    def getElectricField(self):
        """Interior-cell field E = -grad phi after the last advance, (n,
        dim) host numpy."""
        if self._E is None:
            raise ConfigError("call advance() before getElectricField()")
        return self._interior(self._E)

    def getCharge(self):
        """Interior-cell free charge as a host numpy array."""
        return self._interior(self.state["charge"])
