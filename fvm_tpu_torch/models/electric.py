"""ElectricModel: electrostatics and charge transport
(``fvm_tpu/models/electric.py``).

The reference's ElectricModel (ElectricModel.h:19, ElectricModel_impl.h:49;
electrostatics :136-154): the potential solve div(eps grad phi) = -rho with
a per-cell dielectric constant (times ``EPS0``) and a space-charge source,
and the field E = -grad phi from least-squares gradients.  One
linearize-solve-update step per outer iteration; ``outerChunk`` runs the
chunked loop (a CUDA graph replay on a CUDA mesh).

Charge transport (``chargetransport_enable``, ElectricModel_impl.h:218+):
drift (upwind on mobility * E . A) and diffusion of a free-charge density,
one-way coupled to the field of the same outer iteration; Fowler-Nordheim
injection at the biased contacts (InjectionDiscretization.h), trap capture
and emission (Capture/EmissionDiscretization.h) with Poole-Frenkel
field-enhanced emission (EmissionDiscretization.h:92-108), and trap-band
tunneling (TrapBandTunnelingDiscretization.h): the walks are static, built
on the host once (``_setup_tunneling_paths``), and the WKB rates are array
programs over them on the device.  In a transient run the traps are
updated explicitly after the charge solve.

BC types: 'SpecifiedPotential', 'SpecifiedCharge' (surface charge density
-> flux) and 'Symmetry'; the immersed boundary (mask and stencil forms); double-
shell interfaces in the potential solve, the dielectric layer
(LinearizeDielectric.h:102) among them.  Sensitivities of the potential
solve (``solve_tangent``, ``solve_adjoint``, ``solve_mc``, charge held
fixed).

Distributed (``ElectricModel(local_mesh, partition=part)``,
``fvm_tpu/models/electric.py:151-188, 394, 555-570``): the electrostatics
and the charge transport with trapping run on shards with the JAX
package's branches (their halo refreshes; the default potential solver
``BiCGStab(JacobiSolver(sweeps=3), 1e-10, 500)``, a given AMG without a
shard hierarchy), and the getters are global on every rank.  The
trap-band tunneling raises on shards, as in the JAX package; the
sensitivities and the immersed boundary on shards are not ported yet
(ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core import interfaces as ifc
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear import AMG, BiCGStab, JacobiSolver
from ..linear.base import JFNK_EXIT_EVERY
from ..ops import assembly, discretizations as disc
from ..ops.gradients import gradient, ls_gradient_coefficients
from ..ops.halo import maybe_sync
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
    _defaults = {
        "dielectric_constant": 7.9,  # reference default (silicon nitride)
        "initialCharge": 0.0,
        "initialPotential": 0.0,
        "mobility": 1e-10,
        "diffusivity": 1e-12,
        # charge injection at contacts (Fowler-Nordheim-shaped,
        # InjectionDiscretization.h / TunnelingDiscretization.h)
        "injectionA": 0.0,  # prefactor
        "injectionB": 1.0,  # exponential field scale
        # trap kinetics (Capture/EmissionDiscretization.h)
        "trapDensity": 0.0,  # N_t
        "captureCoefficient": 0.0,  # k_cap
        "emissionCoefficient": 0.0,  # k_em (constant-rate emission)
        # Poole-Frenkel emission (EmissionDiscretization.h:92-108): rate =
        # emissionFrequency exp(-(trapDepth - pfBeta sqrt|E|) /
        # thermalVoltage), capped at the attempt frequency
        "emissionFrequency": 0.0,
        "pfBeta": 0.0,
        "thermalVoltage": 0.0259,  # kT/q at 300 K [V]
        "initialTrappedCharge": 0.0,
        # trap-band tunneling (TrapBandTunnelingDiscretization.h)
        "bandOffset": 0.0,  # conduction band Ec = bandOffset - potential
        "trapDepth": 1.0,  # trap level below Ec
        "wkbFactor": 1.0,  # -2/hbar sqrt(2 m* me qe) in the user's units
        "tunnelingRateScale": 0.0,  # alpha = scale * V * |E|^2
    }


class ElectricModelOptions(ModelOptions):
    _defaults = {
        "electrostatics_enable": True,
        "chargetransport_enable": False,
        "injection_enable": False,
        "trapping_enable": False,
        "poole_frenkel_enable": False,
        "trapbandtunneling_enable": False,
        "tunnelingDirection": 0,  # the axis the WKB walk ascends
        "tunnelingMaxSteps": 200,  # reference nMax=200
        "transient": False,
        "timeStep": 1.0,
        "nonOrthogonalCorrection": True,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-16,
        "verbose": True,
    }


class ElectricModel(TangentMixin, Model):
    _supports_interfaces = True
    name = "ElectricModel"

    def __init__(self, mesh, partition=None):
        super().__init__(mesh, partition)
        self.vc = ElectricVC()
        self._E = None

    def _make_options(self):
        return ElectricModelOptions()

    def _make_bc(self):
        return ElectricBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
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
        if self.options["poole_frenkel_enable"]:
            self.params["em_nu"] = self._cell_field(self.vc,
                                                    "emissionFrequency")
            self.params["pf_beta"] = self._cell_field(self.vc, "pfBeta")
            self.params["pf_vT"] = self._cell_field(self.vc, "thermalVoltage")
            self.params["pf_depth"] = self._cell_field(self.vc, "trapDepth")
        if self.options["nonOrthogonalCorrection"]:
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)
        if self.options["trapbandtunneling_enable"]:
            self._setup_tunneling_paths()

        solver = self.options.get("electrostaticsLinearSolver")
        if solver is None:
            if self._dist:
                solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                                  relative_tolerance=1e-10,
                                  max_iterations=500)
            else:
                solver = BiCGStab(preconditioner=AMG(),
                                  relative_tolerance=1e-10, max_iterations=50)
            self.options["electrostaticsLinearSolver"] = solver
        csolver = self.options.get("chargeLinearSolver")
        if csolver is None:
            csolver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                               relative_tolerance=1e-8, max_iterations=100)
            csolver.exit_every = JFNK_EXIT_EVERY
            self.options["chargeLinearSolver"] = csolver
        for sv in (solver, csolver):
            for s in (sv, getattr(sv, "preconditioner", None)):
                if isinstance(s, AMG) and not self._dist:
                    s.setup_structure(*mesh.host_cf(), mesh.device)

        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._E = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _linearize_potential(self, mesh, params, state, bcvals):
        """(A, r) of the potential equation at the current state."""
        phi = maybe_sync(mesh, state["potential"])
        rho = state["charge"] + state["trapped"]
        eps_f = disc.harmonic_face_gamma(mesh, params["eps"])
        gradp = None
        if "grad_coeff" in params:
            gradp = maybe_sync(mesh, gradient(mesh, params["grad_coeff"], phi))
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

    # --- charge transport (fvm_tpu/models/electric.py:302-518) ------------

    def _emission_rate(self, params, E_field):
        """Per-cell trap emission rate: the constant k_em plus, with
        ``poole_frenkel_enable``, the field-lowered-barrier rate nu
        exp(-max(phi_t - beta sqrt|E|, 0) / vT), capped at the attempt
        frequency nu (EmissionDiscretization.h:100-108)."""
        k_em = params["k_em"]
        if self.options["poole_frenkel_enable"]:
            Emag = torch.sqrt(torch.sum(E_field * E_field, dim=-1))[
                : k_em.shape[0]]
            expt = (params["pf_depth"] - params["pf_beta"] * torch.sqrt(Emag)
                    ) / params["pf_vT"].clamp(min=1e-300)
            k_em = k_em + params["em_nu"] * torch.exp(-expt.clamp(min=0.0))
        return k_em

    def _linearize_charge(self, mesh, params, state, bcvals, E_field):
        """(A, r) of the free-charge equation in the field ``E_field``."""
        c = maybe_sync(mesh, state["charge"])
        D_f = disc.harmonic_face_gamma(mesh, params["diffusivity"])
        gradc = None
        if "grad_coeff" in params:
            gradc = maybe_sync(mesh, gradient(mesh, params["grad_coeff"], c))
        flux = disc.diffusion_flux(mesh, c, D_f, gradc)
        # drift: the "mass flux" mobility * E . A at faces
        mob_f = disc.harmonic_face_gamma(mesh, params["mobility"])
        E_f = assembly.cells_to_faces_distance_weighted(mesh, E_field)
        drift = mob_f * torch.einsum("fd,fd->f", E_f, mesh.face_area)
        flux = flux + disc.convection_flux(mesh, c, drift, "upwind", gradc)

        # boundary charge flux: zero unless specified, or injected at the
        # contacts (InjectionDiscretization.h: J = A E_n^2 exp(-B / E_n)
        # for fields that drive charge into the dielectric)
        inj_on = self.options["injection_enable"]
        A_inj = float(self.vc["injectionA"])
        B_inj = float(self.vc["injectionB"])
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            if bc.bc_type == "SpecifiedCharge":
                qf = bcvals[f"{g[1]}:specifiedChargeFlux"]
                flux = bck.set_flux_fixed(flux, sl,
                                          -qf * mesh.face_area_mag[sl])
            elif inj_on and bc.bc_type == "SpecifiedPotential":
                amag = mesh.face_area_mag[sl].clamp(min=1e-300)
                nhat = mesh.face_area[sl] / amag[:, None]
                Eb = E_field[mesh.face_cell0[sl]]
                En = -torch.einsum("fd,fd->f", Eb, nhat[:, : mesh.dim])
                En = En.clamp(min=0.0)  # the field pushing charge inward
                J = A_inj * En * En * torch.exp(-B_inj / En.clamp(min=1e-30))
                flux = bck.set_flux_fixed(flux, sl,
                                          -J * mesh.face_area_mag[sl])
            else:
                flux = bck.set_flux_fixed(flux, sl, 0.0)

        diag_cell = torch.zeros_like(c)
        r_cell = torch.zeros_like(c)
        if self.options["trapping_enable"]:
            # capture - emission exchange with the trap population
            ct = state["trapped"]
            free = (params["trapDensity"] - ct).clamp(min=0.0)
            cap = params["k_cap"] * c * free
            em = self._emission_rate(params, E_field) * ct
            V = mesh.cell_volume
            r_cell = r_cell + (em - cap) * V
            diag_cell = diag_cell + params["k_cap"] * free * V
        if self.options["transient"]:
            d2, r2 = disc.transient_term(mesh, c, state["charge_N1"],
                                         self.options["timeStep"])
            diag_cell = diag_cell + d2
            r_cell = r_cell + r2
        A, r = assembly.assemble(mesh, flux, r_cell=r_cell,
                                 diag_cell=diag_cell)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale = D_f[sl] * mesh.face_e_over_d[sl]
            A, r = bck.extrapolation_rows(mesh, A, r, gc, c, valid, scale)
        A, r = assembly.identity_unowned_rows(mesh, A, r)
        return A, r

    def _setup_tunneling_paths(self) -> None:
        """Static per-cell walks along the tunneling axis, built on the
        host once (the reference walks per cell inside every linearization,
        TrapBandTunnelingDiscretization.h:96-160; the walk depends on the
        mesh alone).  Each cell steps to its interior neighbour with the
        largest gain along the axis (the reference's "neighborUp",
        :125-131) and repeats itself at the top."""
        if self._dist:
            raise ConfigError("trap-band tunneling on shards is not "
                              "supported (as in the JAX package)")
        mesh = self.mesh
        axis = int(self.options["tunnelingDirection"])
        L = int(self.options["tunnelingMaxSteps"])
        nc_i = mesh.n_interior_cells
        cc = mesh.host.cell_centroid
        nbr, msk = mesh.host_cf()
        ds = cc[nbr, axis] - cc[:, axis][:, None]
        ds = np.where(msk & (nbr < nc_i), ds, -np.inf)
        down = nbr[np.arange(len(nbr)), np.argmax(ds, axis=1)]
        has_up = np.isfinite(ds.max(axis=1)) & (ds.max(axis=1) > 0)
        down = np.where(has_up, down, np.arange(len(nbr)))  # self-loop stop
        path = np.empty((nc_i, L), dtype=np.int64)
        path[:, 0] = np.arange(nc_i)
        for k in range(1, L):
            path[:, k] = down[path[:, k - 1]]
        self.params["tun_path"] = torch.from_numpy(path).to(mesh.device)
        self.params["tun_s"] = torch.from_numpy(
            np.ascontiguousarray(cc[:, axis])).to(mesh.device, mesh.dtype)

    def _tunneling_rates(self, mesh, params, state, E):
        """(rate, exit_cell, found) per interior cell: the WKB transmission
        to the first cell of its walk whose conduction band lies below the
        trap level (TrapBandTunnelingDiscretization.h:141-235, over all
        cells at once)."""
        phi = state["potential"]
        Ec = float(self.vc["bandOffset"]) - phi
        depth = float(self.vc["trapDepth"])
        wkb = float(self.vc["wkbFactor"])
        scale = float(self.vc["tunnelingRateScale"])
        path = params["tun_path"]  # (nc_i, L)
        nc_i = mesh.n_interior_cells
        en = Ec[:nc_i] - depth
        pEc = Ec[path]
        ps = params["tun_s"][path]
        barrier = (pEc - en[:, None]).clamp(min=0.0)
        dX = (ps[:, 1:] - ps[:, :-1]).abs()
        inc = wkb * torch.sqrt(0.5 * (barrier[:, 1:] + barrier[:, :-1])) * dX
        logT = torch.cat([torch.zeros_like(inc[:, :1]),
                          torch.cumsum(inc, dim=1)], dim=1)
        step = torch.arange(path.shape[1], device=path.device)
        exit_mask = (pEc < en[:, None]) & (step[None, :] > 0)
        found = exit_mask.any(dim=1)
        idx = torch.argmax(exit_mask.to(torch.uint8), dim=1)  # first True
        T = torch.exp(torch.gather(logT, 1, idx[:, None])[:, 0])
        exit_cell = torch.gather(path, 1, idx[:, None])[:, 0]
        e2 = torch.sum(E[:nc_i] * E[:nc_i], dim=1)
        alpha = scale * mesh.cell_volume[:nc_i] * e2
        rate = torch.where(found, alpha * T, 0.0)
        return rate, exit_cell, found

    def _trap_update(self, mesh, params, state, E):
        """The explicit trap update over a transient step (after the
        charge solve), with the trap-band de-trapping: trapped charge
        leaves at rate * ct and reappears as free charge at the WKB exit
        cell (a charge-conserving scatter)."""
        dt = self.options["timeStep"]
        c_new = state["charge"]
        ct = state["trapped"]
        cap = params["k_cap"] * c_new * (params["trapDensity"] - ct).clamp(
            min=0.0)
        em = self._emission_rate(params, E) * ct
        trapped = (state["trapped_N1"] + dt * (cap - em)).clamp(min=0.0)
        if self.options["trapbandtunneling_enable"]:
            nc_i = mesh.n_interior_cells
            rate, exit_cell, _ = self._tunneling_rates(mesh, params, state, E)
            dq = (rate * dt).clamp(max=1.0) * trapped[:nc_i]
            trapped = torch.cat([trapped[:nc_i] - dq, trapped[nc_i:]])
            moved = dq * mesh.cell_volume[:nc_i]
            gain = torch.zeros_like(c_new).index_add(0, exit_cell, moved)
            gain = gain / mesh.cell_volume.clamp(min=1e-300)
            state = dict(state, charge=c_new + gain)
        return dict(state, trapped=trapped)

    def _build_step(self):
        opts = self.options
        psolver = opts["electrostaticsLinearSolver"]
        csolver = opts["chargeLinearSolver"]
        enabled = bool(opts["electrostatics_enable"])
        transport = bool(opts["chargetransport_enable"])
        traps = bool(opts["trapping_enable"] and opts["transient"])
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
            E = me._field(mesh, params, maybe_sync(mesh, state["potential"]))
            aux = {"rnorm": rnorm, "E": E}
            if transport:
                Es = maybe_sync(mesh, E)
                Ac, rc = me._linearize_charge(mesh, params, state, bcvals, Es)
                aux["charge_rnorm"] = Ac.norm(rc)
                dc, _ = csolver.solve_fn(Ac, rc, torch.zeros_like(rc))
                state = dict(state, charge=state["charge"] + dc)
                if traps:
                    state = me._trap_update(mesh, params, state, Es)
            return state, aux

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
        src/fvm/test/IBM_PARALLEL).  With ``stencil`` the IB band carries
        the interpolation rows, implicitly unless ``implicit=False``."""
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
        return self._gather_cells(x)

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

    def getTrappedCharge(self):
        """Interior-cell trapped charge as a host numpy array."""
        return self._interior(self.state["trapped"])
