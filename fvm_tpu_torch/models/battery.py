"""BatteryModel: coupled species and potential transport with
Butler-Volmer interface kinetics, a Li-ion cell
(``fvm_tpu/models/battery.py``).

The reference's BatteryModel (BatteryModel.h:19, BatteryModel_impl.h:
species and potential with Butler-Volmer electrode/electrolyte interfaces,
BatteryLinearize{Species,Potential}Interface.h and the point-coupled
BatteryPCLinearizeInterface_BV.h).  As in the JAX package one mesh
carries a per-cell material id (0 anode, 1 electrolyte, 2 cathode), and
the interior faces where the material changes to or from the electrolyte
carry Butler-Volmer closures instead of the diffusive flux:

    eta = phi_electrode - phi_electrolyte - U0(material)
    i   = i0 [exp(aa F eta / RT) - exp(-ac F eta / RT)]      (per area)

solved per face together with the half-cell ohmic drops.  The potential
equation carries i as the normal current, the species equation i/F as the
Li flux.  On a double-shell mesh (``Mesh.make_interface``, the
electrolyte as the L side) the shell ghosts are per-side unknowns
(phi_L, phi_R, ce, cs) with point-coupled closure rows (``_shell_rows``).

Each outer iteration is one exact Newton step (JFNK): steady mode solves
phi at fixed c, transient mode the coupled (c, phi) with BDF1.  The exact
Jacobian action is AD of the residual (``linear.base.newton_operator`` in
``linear.base.product_mode``: a CUDA graph replay of ``torch.func.jvp`` on a
small CUDA mesh, else the backward pass of the reverse-mode product), the
diffusion matrices (Ac, Ap) give the diagonal and the Jacobi
preconditioner of the default BiCGStab(Jacobi(3), 1e-8, 300).
``solve_tangent`` and ``solve_adjoint`` (through
``sensitivity.jfnk_adjoint``: the transpose is the vjp), ``get_heat_source``
and ``getCurrentIntegral`` follow the JAX package.  BC types:
'SpecifiedPotential', 'SpecifiedCurrent' (per area, positive into the
domain), 'Symmetry'.  A partitioned mesh raises ``ConfigError`` (ROADMAP
queue 1 item 8b).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear import BiCGStab, JacobiSolver
from ..linear.base import (JFNK_EXIT_EVERY, DiagonalSurrogate,
                           MatrixFreeOperator, newton_operator, product_mode)
from ..ops import assembly, discretizations as disc
from ..ops.assembly import FaceFlux
from .base import Model, newton_advance, single_device_model

FARADAY = 96485.33
RGAS = 8.314


class BatteryBC(BoundaryCondition):
    _allowed_types = ("SpecifiedPotential", "SpecifiedCurrent", "Symmetry")
    _defaults = {
        "specifiedPotential": 0.0,
        "specifiedCurrent": 0.0,  # per area, positive into the domain
    }


class BatteryVC(BoundaryCondition):
    """Per-material parameters as length-3 sequences (anode, electrolyte,
    cathode)."""

    _defaults = {
        "conductivity": (100.0, 1.0, 100.0),
        "diffusivity": (1e-10, 1e-9, 1e-10),
        "initialConcentration": (1000.0, 1000.0, 1000.0),
        "openCircuitVoltage": (0.1, 0.0, 3.8),  # U0 per material
        # starting potentials near electrochemical equilibrium (Newton
        # diverges from a cold phi = 0 start: eta ~ -U0 saturates the exp)
        "initialPotential": (0.0, -0.1, 3.7),
        "exchangeCurrentDensity": 10.0,  # i0
        "alphaAnodic": 0.5,
        "alphaCathodic": 0.5,
        "temperature": 300.0,
        # double-shell kinetics (BatteryLinearizeSpeciesInterface.h:197-221)
        "csMax": 26390.0,  # electrode saturation concentration
        "rateConstant": 6.33e-10,  # reaction-rate constant k
        "transference": 0.363,  # t_plus; electrolyte balance weight 1 - t+
    }


class BatteryModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 1.0,
        "relativeTolerance": 1e-8,
        "absoluteTolerance": 1e-20,
        "verbose": True,
    }


def _set_rows(x, rows, values):
    """``x`` with ``x[rows] = values`` (a new tensor, differentiable)."""
    x = x.clone()
    x[rows] = values
    return x


class BatteryModel(Model):
    name = "BatteryModel"
    _supports_interfaces = True

    def __init__(self, mesh, partition=None):
        single_device_model(self.name, partition)
        super().__init__(mesh)
        self.vc = BatteryVC()
        self._material = None

    def _make_options(self):
        return BatteryModelOptions()

    def _make_bc(self):
        return BatteryBC()

    def set_material_regions(self, material_ids) -> None:
        """The material id of each interior cell (0 anode, 1 electrolyte,
        2 cathode), in the host mesh's interior order; ghosts inherit their
        owner's."""
        mesh = self.mesh
        mat = np.asarray(material_ids, dtype=np.int32)
        ids = np.zeros(mesh.n_cells, dtype=np.int32)
        ids[: len(mat)] = mat
        owner = bck.ghost_owner_cells(mesh).cpu().numpy()
        n_int = mesh.n_interior_cells
        ids[n_int: n_int + mesh.n_boundary_faces] = ids[owner]
        self._material = ids

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        if self._material is None:
            raise ConfigError("BatteryModel: call set_material_regions first")
        mat = self._material
        dt, dev = mesh.dtype, mesh.device

        def per_material(key):
            vals = np.asarray(self.vc[key], dtype=np.float64)
            return torch.from_numpy(vals[mat]).to(dev, dt)

        def scal(key):
            # the kinetic constants live in params, so that the tangent and
            # the adjoint can differentiate with respect to them
            return torch.tensor(float(self.vc[key]), dtype=dt, device=dev)

        c0 = per_material("initialConcentration")
        self.state = {"c": c0, "phi": per_material("initialPotential")}
        if self.options["transient"]:
            self.state["c_N1"] = c0
        self.params = {
            "sigma": per_material("conductivity"),
            "D": per_material("diffusivity"),
            "U0": per_material("openCircuitVoltage"),
            "mat": torch.from_numpy(mat).to(dev),
            "i0": scal("exchangeCurrentDensity"),
            "alphaA": scal("alphaAnodic"),
            "alphaC": scal("alphaCathodic"),
            "T": scal("temperature"),
            "kReact": scal("rateConstant"),
            "csMax": scal("csMax"),
        }
        # interface faces: interior faces whose two cells differ in
        # material, one of them the electrolyte
        owner = mesh.face_cell0.cpu().numpy()
        nbr = mesh.face_cell1.cpu().numpy()
        m0, m1 = mat[owner], mat[nbr]
        is_int = np.arange(mesh.n_faces) < mesh.n_interior_faces
        iface = is_int & (m0 != m1) & ((m0 == 1) | (m1 == 1))
        self.params["iface"] = torch.from_numpy(iface).to(dev)
        # +1 where the OWNER is the electrode side, -1 where the neighbour is
        self.params["elec_side"] = torch.from_numpy(np.where(
            iface & (m1 == 1), 1.0, np.where(iface, -1.0, 0.0))).to(dev, dt)

        solver = self.options.get("linearSolver")
        if solver is None:
            solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                              relative_tolerance=1e-8, max_iterations=300)
            solver.exit_every = JFNK_EXIT_EVERY
            self.options["linearSolver"] = solver
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _eta_raw(self, mesh, params, phi):
        """phi_electrode - phi_electrolyte - U0 at every face (the
        interface faces' overpotential before the ohmic drops)."""
        side = params["elec_side"] > 0
        po, pn = mesh.take_owner(phi), mesh.take_nbr(phi)
        U0 = torch.where(side, mesh.take_owner(params["U0"]),
                         mesh.take_nbr(params["U0"]))
        return torch.where(side, po, pn) - torch.where(side, pn, po) - U0

    def _bv_current(self, mesh, params, phi, c):
        """The Butler-Volmer current per area at every face (meaningful at
        the interface faces), positive from the electrode into the
        electrolyte through the face in the owner -> neighbour direction,
        with the half-cell ohmic resistance in series (the interface face
        replaces the conduction flux, so the centroid-to-face drops on both
        sides enter the closure; the reference's shell cells carry them,
        BatteryPCLinearizeInterface_BV.h)."""
        i0, aa, ac = params["i0"], params["alphaA"], params["alphaC"]
        fRT = FARADAY / (RGAS * params["T"])
        eta_raw = self._eta_raw(mesh, params, phi)

        def dist(cells):
            d = mesh.face_centroid - cells
            return torch.sqrt(torch.sum(d * d, dim=1))

        do = dist(mesh.take_owner(mesh.cell_centroid))
        dn = dist(mesh.take_nbr(mesh.cell_centroid))
        R_half = (do / mesh.take_owner(params["sigma"]).clamp(min=1e-300)
                  + dn / mesh.take_nbr(params["sigma"]).clamp(min=1e-300))

        def bv(eta):
            x1 = torch.clamp(aa * fRT * eta, -60.0, 60.0)
            x2 = torch.clamp(-ac * fRT * eta, -60.0, 60.0)
            return i0 * (torch.exp(x1) - torch.exp(x2))

        def bv_prime(eta):
            x1 = torch.clamp(aa * fRT * eta, -60.0, 60.0)
            x2 = torch.clamp(-ac * fRT * eta, -60.0, 60.0)
            return i0 * fRT * (aa * torch.exp(x1) + ac * torch.exp(x2))

        # per-face Newton on g(i) = i - bv(eta_raw - i R_half) = 0 (a
        # monotone scalar equation; six unrolled, differentiable steps)
        i = bv(eta_raw) / (1.0 + bv_prime(eta_raw) * R_half)
        for _ in range(6):
            eta = eta_raw - i * R_half
            i = i - (i - bv(eta)) / (1.0 + bv_prime(eta) * R_half)
        return i

    def _bv_shell(self, params, ce, cs, eta):
        """The concentration-dependent Butler-Volmer current density at a
        double-shell interface, per area, positive out of the electrode
        (BatteryLinearizeSpeciesInterface.h:197-221):
        i = F k ce^ac (csMax - cs)^aa cs^ac [exp(Ca eta) - exp(-Cc eta)]."""
        aa, ac = params["alphaA"], params["alphaC"]
        csMax = params["csMax"]
        Ca = aa * FARADAY / (RGAS * params["T"])
        Cc = ac * FARADAY / (RGAS * params["T"])
        eps = 1e-12 * csMax
        ce_c = torch.maximum(ce, eps)
        cs_c = torch.minimum(torch.maximum(cs, eps), csMax - eps)
        j0 = FARADAY * params["kReact"] * ce_c**ac * (csMax - cs_c) ** aa \
            * cs_c**ac
        x1 = torch.clamp(Ca * eta, -60.0, 60.0)
        x2 = torch.clamp(-Cc * eta, -60.0, 60.0)
        return j0 * (torch.exp(x1) - torch.exp(x2))

    def _shell_rows(self, mesh, params, phi, c, fphi, fc_flux, rp, rc,
                    coupled):
        """The shell-ghost residual rows of a double-shell mesh, per
        interface face (L the electrolyte, R the electrode):

          phi_L row:  F_phi(fL) + F_phi(fR) = 0        (current balance)
          phi_R row:  F_phi(fR) - i(ce, cs, eta) A = 0 (Butler-Volmer)
          c_L row:    F_c(fL) + (1 - t+) F_c(fR) = 0   (Li balance)
          c_R row:    F_c(fR) - (i / F) A = 0          (Faradaic Li flux)

        Every row is a function of the unknowns, so the AD product gives
        the exact point-coupled Newton linearization."""
        tf = 1.0 - float(self.vc["transference"])
        for _, ln, rn in mesh.interfaces:
            gLg, gRg = mesh.group_by_name(ln), mesh.group_by_name(rn)
            fL, fR = mesh.group_faces(gLg), mesh.group_faces(gRg)
            gl = mesh.ghost_cells_of_group(gLg)
            gr = mesh.ghost_cells_of_group(gRg)
            amag = mesh.face_area_mag[fL]
            vmask = amag > 0
            eta = phi[gr] - phi[gl] - params["U0"][gr]
            i_bv = self._bv_shell(params, c[gl], c[gr], eta)
            rp = _set_rows(rp, gl, torch.where(vmask, fphi.F[fL] + fphi.F[fR],
                                               0.0))
            rp = _set_rows(rp, gr, torch.where(vmask,
                                               fphi.F[fR] - i_bv * amag, 0.0))
            if coupled:
                rc = _set_rows(rc, gl, torch.where(
                    vmask, fc_flux.F[fL] + tf * fc_flux.F[fR], 0.0))
                rc = _set_rows(rc, gr, torch.where(
                    vmask, fc_flux.F[fR] - (i_bv / FARADAY) * amag, 0.0))
        return rp, rc

    def _system(self, mesh, params, state, bcvals, u):
        """(surrogate, R): steady mode solves phi alone (a steady species
        field does not exist under a sustained current with zero-flux
        walls: that subsystem is singular); transient mode couples
        u = (c, phi), (n, 2).  The surrogate is the diagonal of the
        diffusion matrices (Ac, Ap), per column (c, phi) in transient
        mode, Ap's in steady mode."""
        coupled = self.options["transient"]
        if coupled:
            c, phi = u[:, 0], u[:, 1]
        else:
            c, phi = state["c"], u
        iface = params["iface"]
        i_bv = self._bv_current(mesh, params, phi, c)
        # the current flows owner -> neighbour where the owner is electrode
        F_if = torch.where(iface, params["elec_side"] * i_bv
                           * mesh.face_area_mag, 0.0)

        # potential: conduction and the interface current
        sig_f = disc.harmonic_face_gamma(mesh, params["sigma"])
        fphi = disc.diffusion_flux(mesh, phi, sig_f)
        F_phi = torch.where(iface, F_if, fphi.F)
        dphiO = torch.where(iface, 0.0, fphi.dF_dO)
        dphiN = torch.where(iface, 0.0, fphi.dF_dN)

        # species: diffusion and the interface Li flux i / F
        D_f = disc.harmonic_face_gamma(mesh, params["D"])
        fc = disc.diffusion_flux(mesh, c, D_f)
        F_c = torch.where(iface, F_if / FARADAY, fc.F)
        dcO = torch.where(iface, 0.0, fc.dF_dO)
        dcN = torch.where(iface, 0.0, fc.dF_dN)

        # SpecifiedCurrent: a fixed conduction flux through the group's
        # faces, positive INTO the domain
        for g, bc in self._group_bcs():
            if bc.bc_type == "SpecifiedCurrent":
                sl = mesh.group_faces(g)
                I = bcvals[f"{g[1]}:specifiedCurrent"]
                F_phi = _set_rows(F_phi, sl, -I * mesh.face_area_mag[sl])
                dphiO = _set_rows(dphiO, sl, 0.0)
                dphiN = _set_rows(dphiN, sl, 0.0)

        if coupled:
            diag_c, r_c_extra = disc.transient_term(
                mesh, c, state["c_N1"], self.options["timeStep"])
        else:
            diag_c = r_c_extra = torch.zeros_like(phi)
        Ac, rc = assembly.assemble(mesh, FaceFlux(F=F_c, dF_dO=dcO,
                                                  dF_dN=dcN),
                                   r_cell=r_c_extra, diag_cell=diag_c)
        Ap, rp = assembly.assemble(mesh, FaceFlux(F=F_phi, dF_dO=dphiO,
                                                  dF_dN=dphiN))

        # BCs: a Dirichlet potential or a current flux; zero species flux
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            valid = bcvals[f"{g[1]}:__valid"]
            scale_p = sig_f[sl] * mesh.face_e_over_d[sl]
            scale_c = D_f[sl] * mesh.face_e_over_d[sl]
            if bc.bc_type == "SpecifiedPotential":
                Ap, rp = bck.dirichlet_rows(
                    mesh, Ap, rp, gc, bcvals[f"{g[1]}:specifiedPotential"],
                    phi, valid, scale_p)
            else:
                Ap, rp = bck.extrapolation_rows(mesh, Ap, rp, gc, phi, valid,
                                                scale_p)
            Ac, rc = bck.extrapolation_rows(mesh, Ac, rc, gc, c, valid,
                                            scale_c)
        if mesh.interfaces:
            rp, rc = self._shell_rows(mesh, params, phi, c, fphi, fc, rp, rc,
                                      coupled)
        Ac, rc = assembly.identity_unowned_rows(mesh, Ac, rc)
        Ap, rp = assembly.identity_unowned_rows(mesh, Ap, rp)
        if coupled:
            return (DiagonalSurrogate(torch.stack([Ac.diag, Ap.diag], dim=1)),
                    torch.stack([rc, rp], dim=1))
        return DiagonalSurrogate(Ap.diag), rp

    def _unknowns(self, state):
        if self.options["transient"]:
            return torch.stack([state["c"], state["phi"]], dim=1)
        return state["phi"]

    def _newton_op(self, mesh, params, state, bcvals, u, surrogate,
                   mode=None):
        """The exact Newton operator at u (one AD product of the residual
        per application, ``newton_operator`` in ``mode``, by default
        ``product_mode``) with the diagonal surrogate."""
        me = weakref.proxy(self)

        def R(uu):
            return me._system(mesh, params, state, bcvals, uu)[1]

        return MatrixFreeOperator(
            newton_operator(R, u, mode or product_mode(u)), surrogate)

    def _build_step(self):
        solver = self.options["linearSolver"]
        coupled = self.options["transient"]
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            u = me._unknowns(state)
            S, r = me._system(mesh, params, state, bcvals, u)
            rnorm = S.norm(r)
            op = me._newton_op(mesh, params, state, bcvals, u, S)
            du, _ = solver.solve_fn(op, r, torch.zeros_like(r))
            u2 = u + du
            if coupled:
                return dict(state, c=u2[:, 0], phi=u2[:, 1]), {"rnorm": rnorm}
            return dict(state, phi=u2), {"rnorm": rnorm}

        return step

    # --- sensitivities (the reference's Tangent atype on BatteryModel) ----

    def solve_tangent(self, param_tangents=None, bc_tangents=None):
        """Forward sensitivity of the converged unknowns from one
        exact-Jacobian tangent solve, J du = dR/dp . dp, with the Newton
        operator of the primal step.  ``param_tangents``: the per-cell
        fields 'sigma' / 'D' / 'U0' (a scalar, (n_interior,) or full
        shape) and the kinetic scalars 'i0' / 'alphaA' / 'alphaC' / 'T' /
        'kReact' / 'csMax'; ``bc_tangents`` keyed 'group:entry'.  Returns
        d(phi) (n_interior,) in steady mode, (dc, dphi) (n_interior, 2) in
        transient mode."""
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_tangent")
        mesh, params, state = self.mesh, self.params, self.state
        bcvals = self._resolve_bcvals()
        base, tans = self._tangent_inputs(param_tangents, bc_tangents, bcvals)
        u = self._unknowns(state)

        def r_of(p_sub, b_sub):
            return self._system(mesh, dict(params, **p_sub), state,
                                dict(bcvals, **b_sub), u)[1]

        _, dr = torch.func.jvp(r_of, base, tans)
        S, _ = self._system(mesh, params, state, bcvals, u)
        op = self._newton_op(mesh, params, state, bcvals, u, S)
        du, _ = self.options["linearSolver"].solve_fn(op, dr,
                                                      torch.zeros_like(dr))
        return du[: mesh.n_interior_cells].detach().cpu().numpy()

    def solve_adjoint(self, functional, param_keys=(), bc_keys=()) -> dict:
        """Reverse-mode gradient of a scalar functional of the converged
        unknowns with respect to parameter fields, kinetic scalars (as
        floats) and BC values, from one transposed Newton solve (the vjp
        of the same residual; ``sensitivity.jfnk_adjoint``).
        ``functional(u_interior)``: u is phi (n_interior,) in steady mode,
        (c, phi) (n_interior, 2) in transient mode."""
        from .sensitivity import jfnk_adjoint

        return jfnk_adjoint(self, None, self._system, functional,
                            param_keys, bc_keys,
                            w=self._unknowns(self.state))

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1):
        """Newton outer iterations; returns [(iter, rnorm), ...]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk,
                                         self._resolve_bcvals())
        return newton_advance(self, niter)

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("BatteryModel: transient option is off")
        self.state["c_N1"] = self.state["c"]

    def _interior(self, x):
        return x[: self.mesh.n_interior_cells].detach().cpu().numpy()

    def getPotential(self) -> np.ndarray:
        return self._interior(self.state["phi"])

    def getConcentration(self) -> np.ndarray:
        return self._interior(self.state["c"])

    def get_heat_source(self) -> np.ndarray:
        """Volumetric heat generation per interior cell: Joule dissipation
        sigma_f e/d (dphi)^2 on the conduction faces and |i eta| at the
        Butler-Volmer faces (the reaction and half-cell ohmic heat), split
        between a face's two cells (boundary and shell faces give all of it
        to the bulk owner), and on a double-shell mesh the reaction heat
        |i eta| of each shell closure split between its two bulk owners.
        Feed it to a ThermalModel as vc['heatSource'] (the reference's
        BatteryLinearizeThermalInterface coupling)."""
        mesh, params = self.mesh, self.params
        phi, c = self.state["phi"], self.state["c"]
        amag = mesh.face_area_mag
        sig_f = disc.harmonic_face_gamma(mesh, params["sigma"])
        dphi = mesh.take_owner(phi) - mesh.take_nbr(phi)
        q_cond = sig_f * mesh.face_e_over_d * dphi * dphi
        i_bv = self._bv_current(mesh, params, phi, c)
        q_if = torch.abs(i_bv * self._eta_raw(mesh, params, phi)) * amag
        q_face = torch.where(params["iface"], q_if, q_cond)
        bnd_f = torch.arange(mesh.n_faces, device=mesh.device) \
            >= mesh.n_interior_faces
        w_own = torch.where(bnd_f, 1.0, 0.5).to(phi.dtype)
        qc = torch.zeros_like(phi)
        qc = qc.index_add(0, mesh.face_cell0, w_own * q_face)
        qc = qc.index_add(0, mesh.face_cell1, (1.0 - w_own) * q_face)
        for _, ln, rn in mesh.interfaces:
            gLg, gRg = mesh.group_by_name(ln), mesh.group_by_name(rn)
            fL, fR = mesh.group_faces(gLg), mesh.group_faces(gRg)
            gl = mesh.ghost_cells_of_group(gLg)
            gr = mesh.ghost_cells_of_group(gRg)
            eta_i = phi[gr] - phi[gl] - params["U0"][gr]
            i_sh = self._bv_shell(params, c[gl], c[gr], eta_i)
            q_rxn = torch.abs(i_sh * eta_i) * mesh.face_area_mag[fL]
            qc = qc.index_add(0, mesh.face_cell0[fL], 0.5 * q_rxn)
            qc = qc.index_add(0, mesh.face_cell0[fR], 0.5 * q_rxn)
        return self._interior(qc / mesh.cell_volume.clamp(min=1e-300))

    def getCurrentIntegral(self, group_name) -> float:
        """The net current INTO the domain through a boundary group."""
        mesh = self.mesh
        g = self._group(group_name)
        sl = mesh.group_faces(g)
        bc = self.bc.get(g[1])
        if bc is not None and bc.bc_type == "SpecifiedCurrent":
            # the conduction flux is replaced by the injected current
            I = bc.resolve("specifiedCurrent", g[4], mesh.dtype, mesh.device)
            return float(torch.sum(I * mesh.face_area_mag[sl]))
        sig_f = disc.harmonic_face_gamma(mesh, self.params["sigma"])
        f = disc.diffusion_flux(mesh, self.state["phi"], sig_f)
        return float(-torch.sum(f.F[sl]))


def species_interface_flux(eta, csMax=26390.0, rr_constant=6.33e-10,
                           T=300.0, alpha_a=0.5, alpha_c=0.5):
    """The Butler-Volmer species closure of a double-shell interface: a
    ``flux_fn(ce, cs)`` giving the Li molar flux i / F out of the electrode
    side (R), for ``model.interface[name] = {"type": "flux", "flux_fn":
    ..., "weight_R": 1 - t_plus}`` on a SpeciesModel over a
    ``Mesh.make_interface`` mesh with the electrolyte as the L side
    (BatteryLinearizeSpeciesInterface.h:197-221):

      flux = C0 k ce^ac (csMax - cs)^aa cs^ac,
      C0 = exp(Ca eta) - exp(-Cc eta),  Ca, Cc = alpha F / (R T),

    at a fixed overpotential ``eta`` (phi_s - phi_e - U); its derivatives
    come from AD."""
    Ca = alpha_a * FARADAY / (RGAS * T)
    Cc = alpha_c * FARADAY / (RGAS * T)
    C0 = np.exp(Ca * np.asarray(eta, np.float64)) \
        - np.exp(-Cc * np.asarray(eta, np.float64))

    def flux_fn(ce, cs):
        eps = 1e-12 * csMax
        ce_c = ce.clamp(min=eps)
        cs_c = cs.clamp(min=eps, max=csMax - eps)
        c0 = torch.from_numpy(np.asarray(C0)).to(ce.device, ce.dtype)
        return (c0 * rr_constant * ce_c**alpha_c
                * (csMax - cs_c) ** alpha_a * cs_c**alpha_c)

    return flux_fn
