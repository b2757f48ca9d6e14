"""FlowModel: incompressible Navier-Stokes, segregated SIMPLE.

Counterpart of ``fvm_tpu/models/flow.py`` (the reference's FlowModel,
FlowModel.h:19, FlowModel_impl.h: solveMomentum :730, linearizeContinuity
:998, Rhie-Chow :741-768, postContinuitySolve :1263, advance :1433).

Per outer iteration:
  1. momentum predictor: one scalar ELL matrix shared by all velocity
     components (multi-RHS solve), upwind convection + viscous diffusion +
     explicit pressure force p_f * A_f as a face flux; implicit
     under-relaxation of the diagonal; aP is kept for Rhie-Chow;
  2. Rhie-Chow face mass flux
       mdot = rho*Vbar_f.A - rho*Df*[(p_N - p_O)*e_over_d - grad_p_bar . ds];
  3. pressure correction (SIMPLE or SIMPLEC): a Poisson system with face
     coefficients rho*Df; enclosed domains pin the level at cell 0;
  4. corrections: p += urf_p*p', V -= (vol/aP) grad p', mdot += dmdot.

Ghost values of V and p are refreshed explicitly from the BCs each outer
iteration, and every ghost row of the linear systems is an identity.

Ported so far: SIMPLE and SIMPLEC with ``nPressureCorrectors``, the
convection schemes, BDF transient terms, BCs 'NoSlipWall', 'SlipJump'
(Maxwell first-order slip), 'VelocityBoundary', 'PressureBoundary' and
'Symmetry', the coupled
pressure-velocity step (``advanceCoupled``), Anderson acceleration and the
JFNK Newton endgame (``advanceNewton``), the immersed boundary in the
SIMPLE step (the mask form, and the stencil form on the momentum rows; as
in the JAX package, not in ``advanceCoupled`` or the Newton residual) and
the force and flux
integrals; the sensitivities (``solve_tangent``, ``solve_tangent_force``,
``solve_adjoint``, ``solve_adjoint_force``: the tangent and adjoint fixed
points of the SIMPLE map at the converged state).  The mesh-sequencing
warm start is ``models/fmg.prolong_flow_state``.

Distributed (``FlowModel(local_mesh, partition=part)``): the SIMPLE step
on each rank's shard with its halo refreshes (``fvm_tpu/models/flow.py:
243-312, 416-642``), the momentum and continuity norms and the pressure
level summed over the ranks, the default pressure solver BiCGStab around
the shard-local AMG (``AMG(coarse_size=64)``; Jacobi(3) where no rank can
coarsen), the force and flux integrals and the getters global on every
rank.  On shards, ``advanceCoupled``, ``advanceNewton``, the
sensitivities and the immersed boundary are not ported yet (ROADMAP queue
1 item 8b): they raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
import time
import weakref

import numpy as np
import torch

from ..core.options import BoundaryCondition, ModelOptions
from ..core import bcs as bck
from ..ops import assembly
from ..ops import discretizations as disc
from ..ops.assembly import FaceFlux
from ..ops.halo import maybe_sync, gsum
from ..ops.gradients import ls_gradient_coefficients, gradient
from ..linear import (AMG, BiCGStab, GMRES, CoupledSIMPLE, Anderson,
                      JacobiSolver)
from ..linear.base import MatrixFreeOperator, newton_operator
from ..mesh.device import DeviceMesh
from ..ops import bell
from ..exceptions import ConfigError
from .base import (Model, ResidualHistory, freeze, pack, single_device_model,
                   unpack)
from .newton import NewtonInner
from .sensitivity import single_device


class FlowBC(BoundaryCondition):
    _allowed_types = (
        "NoSlipWall",
        "SlipJump",
        "VelocityBoundary",
        "PressureBoundary",
        "Symmetry",
    )
    _defaults = {
        "specifiedXVelocity": 0.0,
        "specifiedYVelocity": 0.0,
        "specifiedZVelocity": 0.0,
        "specifiedPressure": 0.0,
        "accomodationCoefficient": 1.0,
    }


class FlowVC(BoundaryCondition):
    _defaults = {
        "density": 1.0,
        "viscosity": 1.0,
        "initialXVelocity": 0.0,
        "initialYVelocity": 0.0,
        "initialZVelocity": 0.0,
        "initialPressure": 0.0,
    }


class FlowModelOptions(ModelOptions):
    """The JAX package's FlowModelOptions (fvm_tpu/models/flow.py:93-184)."""

    _defaults = {
        "momentumURF": 0.7,
        "pressureURF": 0.3,
        # "SIMPLE" (reference) or "SIMPLEC": the consistent correction
        # coefficient vol/(aP - sum_nb aNb) lets pressureURF run at ~1.0
        "algorithm": "SIMPLE",
        # >= 2: PISO-style repeated pressure correctors
        "nPressureCorrectors": 1,
        # advanceCoupled's velocity relaxation (near-Newton)
        "coupledMomentumURF": 0.95,
        "transient": False,
        "timeStep": 0.1,
        "timeDiscretizationOrder": 1,
        "convectionScheme": "upwind",
        "nonOrthogonalCorrection": True,
        "momentumTolerance": 1e-4,
        # Maxwell slip-jump wall constants (FlowModelSlipJump.h: lambda =
        # mu/p sqrt(pi R T/2), R = 8314.472/molWt)
        "operatingPressure": 101325.0,
        "operatingTemperature": 300.0,
        "molecularWeight": 28.966,
        "continuityTolerance": 1e-4,
        "absoluteTolerance": 1e-50,
        # "anderson": Anderson mixing of (V, p, mdot) over the last
        # andersonDepth outer iterates, after andersonDelay plain steps,
        # every andersonInterval-th step (linear/anderson.py)
        "acceleration": None,
        "andersonDepth": 4,
        "andersonDamping": 1.0,
        "andersonDelay": 5,
        "andersonInterval": 1,
        # advanceNewton (the JFNK endgame): inner-Krylov tolerance and cap
        "newtonKrylovTolerance": 1e-5,
        "newtonKrylovIterations": 1500,
        # > 0: the inner Krylov runs in chunks of this many iterations with
        # one host read-back each (on a CUDA mesh, graph replays)
        "newtonChunkIterations": 0,
        # "float32": the Newton state, rhs and update stay in the model
        # dtype while the inner solve runs on float32 views of (mesh,
        # params, state); needs newtonChunkIterations > 0
        "newtonInnerPrecision": None,
        # None: BiCGStab rho-breakdown restarts on iff the inner solve runs
        # at reduced precision
        "newtonStallRestart": None,
        # echo per-chunk inner progress to stderr
        "newtonVerboseInner": False,
        # "bicgstab" or "gmres" (GMRES(newtonGmresRestart))
        "newtonInnerSolver": "bicgstab",
        "newtonGmresRestart": 32,
        # refreeze momAp / massFlux at the current state before the first
        # Newton step (for a state restored from a lower-precision phase)
        "newtonRefreeze": False,
        # chunked-path forcing: "ew" (Eisenstat-Walker in
        # [newtonKrylovTolerance, newtonForcingMax]) or "fixed"
        "newtonForcing": "ew",
        "newtonForcingMax": 0.1,
        # absolute momentum-residual target: the chunked Newton loop stops
        # before the next inner solve once the entry residual is below it
        "newtonTargetResidual": None,
        "verbose": True,
    }


def _cast_floats(tree, dtype):
    """Cast every floating tensor of a state/params/bcvals dict or a
    DeviceMesh to ``dtype`` (the mixed-precision Newton views, the
    counterpart of ``fvm_tpu/models/flow.py:189-200``).  Index tables, the
    DIA metadata and the host tables are shared, so a cast mesh is a view
    of the same mesh with only its float geometry re-created; the DIA
    coefficients of every matrix assembled on it are packed in ``dtype``
    (``dia_kernel.pack_coef``, through ``ELLMatrix.prepare``)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, DeviceMesh):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(dtype)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
            and getattr(tree, f.name).is_floating_point()})
    return tree


class _FixedM:
    """A preconditioner already bound to its matrix (the Krylov operator
    is matrix-free; M was built from the assembled surrogate)."""

    def __init__(self, M):
        self._M = M

    def precond_setup(self, A):
        return self._M


class FlowModel(Model):
    name = "FlowModel"
    # the chunked Newton inner solve as CUDA graph replays on a CUDA mesh
    # (False: the same chunks eagerly, to hold a replay against)
    _newton_graphed = True

    def __init__(self, mesh, partition=None):
        super().__init__(mesh, partition)
        self.vc = FlowVC()

    def _make_options(self):
        return FlowModelOptions()

    def _make_bc(self):
        return FlowBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        vel_keys = ("initialXVelocity", "initialYVelocity",
                    "initialZVelocity")[: mesh.dim]
        vel0 = torch.stack([self._cell_field(self.vc, k) for k in vel_keys],
                           dim=-1)
        self.state = {
            "velocity": vel0,
            "pressure": self._cell_field(self.vc, "initialPressure"),
            "massFlux": self._full_faces(0.0),
            "momAp": self._full_cells(1.0),
        }
        if self.options["transient"]:
            self.state["velocity_N1"] = vel0
            if self.options["timeDiscretizationOrder"] > 1:
                self.state["velocity_N2"] = vel0

        self.params = {
            "rho": self._cell_field(self.vc, "density", extend_ghosts=True),
            "mu": self._cell_field(self.vc, "viscosity", extend_ghosts=True),
        }
        if self.options["nonOrthogonalCorrection"]:
            self.params["grad_coeff"] = ls_gradient_coefficients(mesh)
        # pressure-level pin mask: (global) interior cell 0
        if self._dist:
            pin = np.zeros(self.partition.mesh.n_cells)
            pin[0] = 1.0
            self.params["pin_mask"] = self._scatter_host_cells(pin)
        else:
            self.params["pin_mask"] = (
                torch.arange(mesh.n_cells, device=mesh.device) == 0
            ).to(mesh.dtype)

        self._has_pressure_bc = any(
            bc.bc_type == "PressureBoundary" for _, bc in self._group_bcs()
        )

        mom = self.options.get("momentumLinearSolver")
        if mom is None:
            mom = BiCGStab(relative_tolerance=1e-2, max_iterations=30)
            self.options["momentumLinearSolver"] = mom
        pres = self.options.get("pressureLinearSolver")
        if pres is None:
            if self._dist:
                # the shard-local AMG where a rank can coarsen, else Jacobi
                amg_p = AMG(coarse_size=64)
                if amg_p.setup_structure_dist(*mesh.host_cf(),
                                              mesh.n_owned_cells, mesh.group):
                    pres = BiCGStab(preconditioner=amg_p,
                                    relative_tolerance=1e-3,
                                    max_iterations=60)
                else:
                    pres = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                                    relative_tolerance=1e-3,
                                    max_iterations=200)
            else:
                pres = BiCGStab(preconditioner=AMG(),
                                relative_tolerance=1e-3, max_iterations=30)
            self.options["pressureLinearSolver"] = pres
        for s in (mom, pres):
            for ss in (s, getattr(s, "preconditioner", None)):
                if not isinstance(ss, AMG):
                    continue
                if not self._dist:
                    ss.setup_structure(*mesh.host_cf(), mesh.device)
                elif ss._dist_setup is None and not ss.setup_structure_dist(
                        *mesh.host_cf(), mesh.n_owned_cells, mesh.group):
                    raise ConfigError(
                        "FlowModel: distributed AMG setup failed (no "
                        "coarsening possible on this partition)")

        self._step = self._build_step()
        self._runners = {}
        self._step_coupled = None
        self._step_newton = None
        self._newton_pre = None
        self._newton_views = None
        self._aa = None
        self._norm0 = None
        self._initialized = True

    # ------------------------------------------------------------------

    def _bc_velocity(self, mesh, bcvals, g):
        comps = ("specifiedXVelocity", "specifiedYVelocity",
                 "specifiedZVelocity")[: mesh.dim]
        return torch.stack([bcvals[f"{g[1]}:{c}"] for c in comps], dim=1)

    @staticmethod
    def _unit_normals(mesh, sl):
        amag = mesh.face_area_mag[sl].clamp(min=1e-300)
        return mesh.face_area[sl] / amag[:, None]

    def _refresh_ghosts(self, mesh, params, state, bcvals):
        """Set ghost V and p from the BCs (explicit, before linearization)."""
        V = bck.extend_to_ghosts(mesh, state["velocity"])
        p = bck.extend_to_ghosts(mesh, state["pressure"])
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            t = bc.bc_type
            if t in ("NoSlipWall", "VelocityBoundary"):
                V[gc] = self._bc_velocity(mesh, bcvals, g)
            elif t == "SlipJump":
                V[gc] = self._slip_velocity(mesh, params, bcvals, g, V)
            elif t == "Symmetry":
                nhat = self._unit_normals(mesh, sl)
                Vo = V[mesh.face_cell0[sl]]
                # ghost is AT the face: slip wall = tangential projection
                V[gc] = Vo - (Vo * nhat).sum(dim=1, keepdim=True) * nhat
            elif t == "PressureBoundary":
                p[gc] = bcvals[f"{g[1]}:specifiedPressure"]
        return dict(state, velocity=V, pressure=p)

    def _slip_velocity(self, mesh, params, bcvals, g, V):
        """Maxwell first-order slip (FlowModelSlipJump.h:47-86): the wall
        velocity is the normal part of the specified velocity plus
        sigma lambda / (dn + sigma lambda) of the tangential cell velocity,
        relative to the moving wall."""
        sl = mesh.group_faces(g)
        owners = mesh.face_cell0[sl]
        nhat = self._unit_normals(mesh, sl)
        Vo = V[owners]
        Vo_t = Vo - (Vo * nhat).sum(dim=1, keepdim=True) * nhat
        bv = self._bc_velocity(mesh, bcvals, g)
        bvn = (bv * nhat).sum(dim=1, keepdim=True) * nhat
        bv_t = bv - bvn
        opts = self.options
        r_gas = 8314.472 / float(opts["molecularWeight"])
        lam_mfp = (params["mu"][owners] / float(opts["operatingPressure"])
                   * np.sqrt(0.5 * np.pi * r_gas
                             * float(opts["operatingTemperature"])))
        sig = bcvals[f"{g[1]}:accomodationCoefficient"]
        dn = torch.abs((mesh.face_ds[sl] * nhat).sum(dim=1))
        coeff = (sig * lam_mfp / (dn + sig * lam_mfp))[:, None]
        return bvn + bv_t + coeff * (Vo_t - bv_t)

    def _boundary_mass_flux(self, mesh, params, state, bcvals):
        """mdot on boundary faces from the BCs (fixed during continuity)."""
        V = state["velocity"]
        mdot = torch.zeros(mesh.n_faces, dtype=V.dtype, device=V.device)
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            t = bc.bc_type
            if t in ("NoSlipWall", "SlipJump", "Symmetry"):
                continue  # zero
            owners = mesh.face_cell0[sl]
            rho_f = params["rho"][owners]
            Vb = (self._bc_velocity(mesh, bcvals, g)
                  if t == "VelocityBoundary" else V[owners])
            mdot[sl] = rho_f * (Vb * mesh.face_area[sl]).sum(dim=1)
        return mdot

    def _grad(self, mesh, params, x):
        if "grad_coeff" in params:
            return gradient(mesh, params["grad_coeff"], x)
        return self._green_gauss_grad(mesh, x)

    @staticmethod
    def _green_gauss_grad(mesh, p):
        p_f = assembly.cells_to_faces_distance_weighted(mesh, p)
        contrib = p_f[:, None] * mesh.face_area  # (nf, dim)
        s = torch.where(mesh.cf_is_owner, 1.0, -1.0).to(p.dtype) * mesh.cf_mask
        g = torch.einsum("kn,knd->nd", s, mesh.take_faces(contrib))
        return g / mesh.cell_volume.clamp(min=1e-300)[:, None]

    # ------------------------------------------------------------------

    def _build_step(self, implicit=False):
        """The SIMPLE step.  ``implicit=True`` solves through
        ``solve_fn_implicit``, so ``torch.func.jvp`` of the whole step gives
        exact tangents (``solve_tangent``); ``implicit="transposable"``
        also makes its solves reverse-differentiable (``solve_adjoint``).
        The primal path keeps the plain solves (``fvm_tpu/models/flow.py:
        416-440``)."""
        opts = self.options
        urf_v = float(opts["momentumURF"])
        urf_p = float(opts["pressureURF"])
        simplec = str(opts.get("algorithm", "SIMPLE")).upper() == "SIMPLEC"
        n_corr = int(opts.get("nPressureCorrectors", 1))
        scheme = opts["convectionScheme"]
        l1_norm = str(opts.get("residualNorm", "L2")).upper() == "L1"
        mom, pres = opts["momentumLinearSolver"], opts["pressureLinearSolver"]
        if implicit:
            tr = implicit == "transposable"
            msolve = functools.partial(mom.solve_fn_implicit, transposable=tr)
            psolve = functools.partial(pres.solve_fn_implicit,
                                       transposable=tr)
        else:
            msolve, psolve = mom.solve_fn, pres.solve_fn

        # the step holds its model weakly: the model holds the step and,
        # through its runners, the CUDA graphs captured from it, so a strong
        # reference would make a cycle that only the cycle collector frees
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            n_int = mesh.n_interior_cells
            dev = mesh.device
            interior_cells = torch.arange(mesh.n_cells, device=dev) < n_int
            bnd = torch.arange(mesh.n_faces, device=dev) >= mesh.n_interior_faces

            state = dict(state, velocity=maybe_sync(mesh, state["velocity"]),
                         pressure=maybe_sync(mesh, state["pressure"]))
            state = me._refresh_ghosts(mesh, params, state, bcvals)
            V = state["velocity"]
            p = state["pressure"]
            bmdot = me._boundary_mass_flux(mesh, params, state, bcvals)
            mdot = torch.where(bnd, bmdot, state["massFlux"])

            def identity_ghost_rows(A, r):
                gh = slice(n_int, mesh.n_cells)
                diag = A.diag.clone()
                diag[gh] = 1.0
                off = A.off.clone()
                off[:, gh] = 0.0
                r = r.clone()
                r[gh] = 0.0
                return A.replace(diag=diag, off=off), r

            # ---- momentum predictor --------------------------------------
            mu_f = disc.harmonic_face_gamma(mesh, params["mu"])
            # on orthogonal meshes the velocity gradient is only needed for
            # the SOU correction (the limited schemes, as in the JAX
            # package, then run without theirs)
            needs_gradV = (not mesh.orthogonal) or scheme == "sou"
            gradV = (maybe_sync(mesh, me._grad(mesh, params, V))
                     if needs_gradV else None)
            flux = disc.diffusion_flux(mesh, V, mu_f, gradV)
            flux = flux + disc.convection_flux(mesh, V, mdot, scheme, gradV)
            p_f = assembly.cells_to_faces_distance_weighted(mesh, p)
            flux = FaceFlux(F=flux.F + p_f[:, None] * mesh.face_area,
                            dF_dO=flux.dF_dO, dF_dN=flux.dF_dN)
            diag_cell = torch.zeros(mesh.n_cells, dtype=V.dtype, device=dev)
            r_cell = torch.zeros((mesh.n_cells, mesh.dim), dtype=V.dtype,
                                 device=dev)
            if opts["transient"]:
                d2, r2 = disc.transient_term(
                    mesh, V, state["velocity_N1"], opts["timeStep"],
                    params["rho"], state.get("velocity_N2"),
                )
                diag_cell = diag_cell + d2
                r_cell = r_cell + r2
            A, r = assembly.assemble(mesh, flux, r_cell=r_cell,
                                     diag_cell=diag_cell)
            A, r = identity_ghost_rows(A, r)
            if "ib_mask" in params:
                # immersed body: pin solid/IB-band cells to the body velocity
                A, r = me._apply_ib(mesh, params, A, r, V)
            if l1_norm:
                # the reference's convergence.dat records the L1 momentum
                # residual of the first component (testFlowParallel.py)
                mom_norm = A.psum(torch.sum(torch.abs(
                    torch.where(interior_cells[:, None], r, 0.0)[:, 0])))
            else:
                mom_norm = A.norm(r)
            Aur = A.replace(diag=torch.where(interior_cells, A.diag / urf_v,
                                             A.diag))
            dV, _ = msolve(Aur, r, torch.zeros_like(r))
            V = V + dV
            aP = Aur.diag

            # ---- momentum-matrix-derived coefficients --------------------
            rho_f = assembly.cells_to_faces_distance_weighted(mesh,
                                                              params["rho"])
            vol_over_ap = maybe_sync(mesh, torch.where(
                interior_cells, mesh.cell_volume / aP, 0.0))
            voap_f = assembly.cells_to_faces_distance_weighted(
                mesh, bck.extend_to_ghosts(mesh, vol_over_ap))
            Df = rho_f * voap_f * mesh.face_e_over_d
            # correction coefficient: SIMPLE vol/aP; SIMPLEC the consistent
            # vol/(aP + sum(off)) (off-diagonals carry their negative sign).
            # Only the CORRECTION uses it; Rhie-Chow stays on vol/aP.
            if simplec:
                sum_off = torch.where(A.mask, A.off, 0.0).sum(dim=0)
                den = Aur.diag + sum_off
                corr_den = torch.where(den > 1e-300, den, aP)
                vol_corr = maybe_sync(mesh, torch.where(
                    interior_cells, mesh.cell_volume / corr_den, 0.0))
                vc_f = assembly.cells_to_faces_distance_weighted(
                    mesh, bck.extend_to_ghosts(mesh, vol_corr))
                Df_corr = rho_f * vc_f * mesh.face_e_over_d
            else:
                vol_corr = vol_over_ap
                Df_corr = Df
            pres_face = torch.zeros(mesh.n_faces, dtype=torch.bool, device=dev)
            for g, bc in me._group_bcs():
                if bc.bc_type == "PressureBoundary":
                    pres_face[mesh.group_faces(g)] = True
            Df_cont = torch.where(bnd & ~pres_face, 0.0, Df_corr)

            # ---- pressure-correction loop (1 = SIMPLE/SIMPLEC; >= 2 =
            # PISO-style correctors, each rebuilding the Rhie-Chow flux)
            cont_norm = None
            for _corr in range(n_corr):
                state2 = me._refresh_ghosts(
                    mesh, params,
                    dict(state, velocity=maybe_sync(mesh, V), pressure=p),
                    bcvals)
                V = state2["velocity"]
                Vbar = assembly.cells_to_faces_distance_weighted(mesh, V)
                gradp = maybe_sync(mesh, me._grad(mesh, params, p))
                gpbar = assembly.cells_to_faces_distance_weighted(mesh, gradp)
                dp = mesh.take_nbr(p) - mesh.take_owner(p)
                rc = Df * (dp - (gpbar * mesh.face_ds).sum(dim=1))
                mdot_int = rho_f * (Vbar * mesh.face_area).sum(dim=1) - rc
                bmdot = me._boundary_mass_flux(mesh, params, state2, bcvals)
                mdot = torch.where(bnd, bmdot, mdot_int)
                if "ib_solid_face" in params:
                    mdot = torch.where(params["ib_solid_face"], 0.0, mdot)

                cont_flux = FaceFlux(F=mdot, dF_dO=Df_cont, dF_dN=-Df_cont)
                Ap, rp = assembly.assemble(mesh, cont_flux)
                Ap, rp = identity_ghost_rows(Ap, rp)
                if "ib_solid_mask" in params:
                    # solid cells: pressure correction pinned to 0 (the Df
                    # coupling into them stays, so a fluid region sealed by
                    # the body keeps a pressure reference)
                    Ap, rp = assembly.dirichlet_cells(
                        Ap, rp, params["ib_solid_mask"], 0.0,
                        torch.zeros_like(p))
                if cont_norm is None:
                    cont_norm = Ap.norm(rp)
                if not me._has_pressure_bc:
                    Ap = Ap.replace(
                        diag=Ap.diag * (1.0 + 1e6 * params["pin_mask"]))
                pc, _ = psolve(Ap, rp, torch.zeros_like(rp))
                if not me._has_pressure_bc:
                    # subtract a consistent global level
                    num = gsum(mesh, torch.where(interior_cells, pc, 0.0).sum())
                    den = gsum(mesh, interior_cells.to(pc.dtype).sum())
                    pc = pc - num / den
                pc = torch.where(interior_cells, pc, 0.0)

                # corrections (reference postContinuitySolve :1263)
                p = p + urf_p * pc
                pc_s = maybe_sync(mesh, pc)
                gradpc = maybe_sync(mesh, me._grad(mesh, params, pc_s))
                V = V - vol_corr[:, None] * gradpc
                dmdot = -Df_corr * (mesh.take_nbr(pc_s) - mesh.take_owner(pc_s))
                mdot = torch.where(bnd & ~pres_face, mdot, mdot + dmdot)
                if "ib_solid_face" in params:
                    mdot = torch.where(params["ib_solid_face"], 0.0, mdot)

            new_state = dict(state)
            new_state["velocity"] = V
            new_state["pressure"] = p
            new_state["massFlux"] = mdot
            new_state["momAp"] = aP
            return new_state, {"mom_norm": mom_norm, "cont_norm": cont_norm}

        return step

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer SIMPLE iterations; returns [(iter, mom_norm, cont_norm)].
        With ``acceleration="anderson"`` the outer iterates are Anderson-
        mixed (after ``andersonDelay`` plain steps, every
        ``andersonInterval``-th step, ``fvm_tpu/models/flow.py:1980-2018``)."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        return self._advance_steps(niter, self._step)

    def _advance_steps(self, niter: int, step) -> ResidualHistory:
        """The outer loop over ``step`` (segregated, coupled or Newton)."""
        opts = self.options
        hist = ResidualHistory()
        bcvals = self._resolve_bcvals()
        sync = self._residual_sync()
        accel = str(opts.get("acceleration") or "").lower() == "anderson"
        if accel and self._aa is None:
            self._aa = self._build_aa_apply()
        chunk = self._chunk_size(niter)
        if chunk and sync and not accel and step is self._step:
            return self._advance_chunked(niter, chunk, bcvals)
        for it in range(niter):
            with self._phase("step"):
                self.state, aux = step(self.mesh, self.params, self.state,
                                       bcvals)
            self._last_aux = aux
            if accel:
                self._anderson_step()
            if not sync:
                hist.append((it, aux["mom_norm"], aux["cont_norm"]))
                continue
            mom_norm = float(aux["mom_norm"])
            cont_norm = float(aux["cont_norm"])
            self._guard_residual(mom_norm, it)
            if self._norm0 is None:
                self._norm0 = (max(mom_norm, 1e-300), max(cont_norm, 1e-300))
            hist.append((it, mom_norm, cont_norm))
            self._log_iteration(
                f"{self.name}: {it}: mom {mom_norm:.6e} cont {cont_norm:.6e}"
            )
            if (
                mom_norm / self._norm0[0] < opts["momentumTolerance"]
                and cont_norm / self._norm0[1] < opts["continuityTolerance"]
            ) or max(mom_norm, cont_norm) < opts["absoluteTolerance"]:
                break
        return hist

    # --- Anderson acceleration -------------------------------------------

    _AA_KEYS = ("velocity", "pressure", "massFlux")

    def _build_aa_apply(self):
        """(apply, state) of the Anderson mixing of (V, p, mdot)
        (``fvm_tpu/models/flow.py:1843-1866``)."""
        opts = self.options
        aa = Anderson(depth=int(opts.get("andersonDepth", 4)),
                      damping=float(opts.get("andersonDamping", 1.0)))
        keys = self._AA_KEYS

        def apply(astate, old_state, new_state):
            x_old = torch.cat([old_state[k].reshape(-1) for k in keys])
            g_new = torch.cat([new_state[k].reshape(-1) for k in keys])
            x_acc, astate = aa.mix(astate, x_old, g_new)
            out = dict(new_state)
            off = 0
            for k in keys:
                sz = new_state[k].numel()
                out[k] = x_acc[off:off + sz].reshape(new_state[k].shape)
                off += sz
            return out, astate

        n = sum(self.state[k].numel() for k in keys)
        return {"apply": apply,
                "state": aa.init_state(n, self.mesh.dtype, self.mesh.device),
                "iter": 0, "anchor": None}

    def _anderson_step(self):
        """After an outer step: set the anchor once the delay has passed,
        then mix every andersonInterval-th step against the anchor (the
        state at the previous mix: Anderson acts on the K-step map)."""
        opts = self.options
        aa = self._aa
        delay = int(opts.get("andersonDelay", 5))
        interval = max(int(opts.get("andersonInterval", 1)), 1)
        aa["iter"] += 1
        k = aa["iter"]
        if k == delay or (aa["anchor"] is None and k >= delay):
            aa["anchor"] = self.state
        elif k > delay and (k - delay) % interval == 0:
            self.state, aa["state"] = aa["apply"](aa["state"], aa["anchor"],
                                                  self.state)
            aa["anchor"] = self.state

    @staticmethod
    def _chunk_fn(step, mesh, params, trips: int):
        """Flow variant of ``Model._chunk_fn``: the (momentum, continuity)
        pair against its initial norms, as the JAX package's
        ``_build_chunk_step_flow`` (fvm_tpu/models/flow.py:1868-1931);
        packed = [the trips' (mom, cont) norms, count, done, m0, c0]."""

        def chunk_step(inputs, scal):
            st, bcvals = inputs["state"], inputs["bcvals"]
            count = torch.zeros((), dtype=torch.int64, device=mesh.device)
            done = torch.zeros((), dtype=torch.bool, device=mesh.device)
            hist = []
            for j in range(trips):
                st_n, aux = step(mesh, params, st, bcvals)
                mn, cn = aux["mom_norm"], aux["cont_norm"]
                if j == 0:
                    tiny = torch.finfo(mn.dtype).tiny
                    m0 = torch.where(scal["mnorm0"] > 0,
                                     scal["mnorm0"].to(mn.dtype),
                                     torch.clamp(mn, min=tiny))
                    c0 = torch.where(scal["cnorm0"] > 0,
                                     scal["cnorm0"].to(cn.dtype),
                                     torch.clamp(cn, min=tiny))
                active = (scal["nmax"] > j) & ~done
                st = freeze(active, st_n, st)
                hist.append(torch.where(active, torch.stack([mn, cn]),
                                        float("nan")))
                count = count + active
                conv = (((mn / m0 < scal["mtol"]) & (cn / c0 < scal["ctol"]))
                        | (torch.maximum(mn, cn) < scal["atol"]))
                done = done | (active & conv)
            return st, pack(hist, count, done, m0, c0)

        return chunk_step

    def _advance_chunked(self, niter: int, chunk: int, bcvals):
        """Chunked flow advance (``_advance_chunked_flow``,
        fvm_tpu/models/flow.py:1933-1972)."""
        opts = self.options
        runner = self._chunk_runner(chunk)
        hist = ResidualHistory()
        it0 = 0
        while it0 < niter:
            m0, c0 = self._norm0 or (0.0, 0.0)
            scal = {
                "nmax": min(chunk, niter - it0),
                "mtol": float(opts["momentumTolerance"]),
                "ctol": float(opts["continuityTolerance"]),
                "atol": float(opts["absoluteTolerance"]),
                "mnorm0": float(m0),
                "cnorm0": float(c0),
            }
            with self._phase("step"):
                self.state, packed = runner(
                    {"state": self.state, "bcvals": bcvals}, scal)
            rns, cnt, done, norm0 = unpack(packed, chunk, width=2)
            if self._norm0 is None:
                self._norm0 = norm0
            for j, (mn, cn) in enumerate(rns[:cnt]):
                self._guard_residual(mn, it0 + j)
                hist.append((it0 + j, mn, cn))
                self._log_iteration(
                    f"{self.name}: {it0 + j}: mom {mn:.6e} cont {cn:.6e}")
            it0 += cnt
            if done:
                break
        return hist

    # --- the coupled pressure-velocity step ---------------------------------

    def _pressure_faces(self, mesh):
        """(nf,) bool: the faces of 'PressureBoundary' groups."""
        pres_face = torch.zeros(mesh.n_faces, dtype=torch.bool,
                                device=mesh.device)
        for g, bc in self._group_bcs():
            if bc.bc_type == "PressureBoundary":
                pres_face[mesh.group_faces(g)] = True
        return pres_face

    @staticmethod
    def _block_jacobians(mesh, flux, rho_f, Df_cont, pres_face, bnd):
        """The (nf, B, B) owner/neighbour Jacobian blocks of the coupled
        system: velocity-velocity dF I, velocity-pressure d(p_f A_f)/dp,
        pressure-velocity d(mdot)/dV from the face-averaged velocity and
        pressure-pressure +-Df (``fvm_tpu/models/flow.py:773-800``).
        Returns (dO, dN, dO_p, dN_p); dO_p/dN_p are the continuity rows."""
        dim = mesh.dim
        dt = rho_f.dtype
        wo = mesh.face_wo
        I_d = torch.eye(dim, dtype=dt, device=rho_f.device)
        dO_vv = flux.dF_dO[:, None, None] * I_d
        dN_vv = flux.dF_dN[:, None, None] * I_d
        dO_vp = wo[:, None] * mesh.face_area
        dN_vp = (1.0 - wo)[:, None] * mesh.face_area
        # boundary mdot is fixed except on pressure boundaries, where
        # mdot = rho V_O . A
        one = torch.ones((), dtype=dt, device=rho_f.device)
        wV_O = torch.where(bnd, torch.where(pres_face, one, 0.0), wo)
        wV_N = torch.where(bnd, 0.0, 1.0 - wo)
        dO_pv = (rho_f * wV_O)[:, None] * mesh.face_area
        dN_pv = (rho_f * wV_N)[:, None] * mesh.face_area
        dO_p = torch.cat([dO_pv, Df_cont[:, None]], dim=1)
        dN_p = torch.cat([dN_pv, -Df_cont[:, None]], dim=1)
        dO = torch.cat([torch.cat([dO_vv, dO_vp[:, :, None]], dim=2),
                        dO_p[:, None, :]], dim=1)
        dN = torch.cat([torch.cat([dN_vv, dN_vp[:, :, None]], dim=2),
                        dN_p[:, None, :]], dim=1)
        return dO, dN, dO_p, dN_p

    @staticmethod
    def _ghost_identity(mesh, A_b):
        """Ghost block rows -> identity (delta = 0: ghosts are refreshed
        explicitly from the BCs)."""
        gh = slice(mesh.n_interior_cells, mesh.n_cells)
        B = A_b.block
        diag = A_b.diag.clone()
        diag[gh] = torch.eye(B, dtype=diag.dtype, device=diag.device)
        off = A_b.off.clone()
        off[:, gh] = 0.0
        return A_b.replace(diag=diag, off=off)

    def _pin_block(self, A_b, params):
        """Pin the pressure level at cell 0 of an enclosed domain."""
        if self._has_pressure_bc:
            return A_b
        dim = A_b.block - 1
        diag = A_b.diag.clone()
        diag[:, dim, dim] = diag[:, dim, dim] * (1.0 + 1e6 * params["pin_mask"])
        return A_b.replace(diag=diag)

    @staticmethod
    def _zero_mean_pressure(mesh, dq, interior_cells):
        """Subtract the interior mean of the pressure column of dq (J is
        exactly singular along a constant pressure in an enclosed domain)."""
        dim = mesh.dim
        pc = dq[:, dim]
        num = gsum(mesh, torch.where(interior_cells, pc, 0.0).sum())
        den = gsum(mesh, interior_cells.to(pc.dtype).sum())
        return torch.cat([dq[:, :dim], (pc - num / den)[:, None]], dim=1)

    def _build_coupled_step(self):
        """Fully coupled pressure-velocity step (the reference's
        advanceCoupled, FlowModel_impl.h:1474; ``fvm_tpu/models/flow.py:
        646-860``): one (dim+1)-block system per outer iteration with the
        pressure force implicit through the V-P column and the Rhie-Chow
        continuity row, solved by ``coupledLinearSolver``; the solution
        updates V and p directly, under ``coupledMomentumURF``."""
        opts = self.options
        urf_v = float(opts["coupledMomentumURF"])
        solver = opts["coupledLinearSolver"]
        scheme = opts["convectionScheme"]
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            dim = mesh.dim
            n_int = mesh.n_interior_cells
            dev = mesh.device
            interior_cells = torch.arange(mesh.n_cells, device=dev) < n_int
            bnd = torch.arange(mesh.n_faces,
                               device=dev) >= mesh.n_interior_faces

            state = me._refresh_ghosts(mesh, params, state, bcvals)
            V = state["velocity"]
            p = state["pressure"]
            bmdot = me._boundary_mass_flux(mesh, params, state, bcvals)
            mdot = torch.where(bnd, bmdot, state["massFlux"])

            # ---- momentum linearisation (shared scalar stencil) ----------
            mu_f = disc.harmonic_face_gamma(mesh, params["mu"])
            needs_gradV = (not mesh.orthogonal) or scheme == "sou"
            gradV = (maybe_sync(mesh, me._grad(mesh, params, V))
                     if needs_gradV else None)
            flux = disc.diffusion_flux(mesh, V, mu_f, gradV)
            flux = flux + disc.convection_flux(mesh, V, mdot, scheme, gradV)
            wo = mesh.face_wo
            p_f = wo * mesh.take_owner(p) + (1.0 - wo) * mesh.take_nbr(p)
            F_mom = flux.F + p_f[:, None] * mesh.face_area
            diag_cell = torch.zeros(mesh.n_cells, dtype=V.dtype, device=dev)
            r_cell = torch.zeros((mesh.n_cells, dim), dtype=V.dtype,
                                 device=dev)
            if opts["transient"]:
                d2, r2 = disc.transient_term(
                    mesh, V, state["velocity_N1"], opts["timeStep"],
                    params["rho"], state.get("velocity_N2"))
                diag_cell = diag_cell + d2
                r_cell = r_cell + r2
            # the scalar momentum matrix only for aP (Rhie-Chow) and the norm
            A_m, r_m = assembly.assemble(
                mesh, FaceFlux(F_mom, flux.dF_dO, flux.dF_dN),
                r_cell=r_cell, diag_cell=diag_cell)
            r_m = torch.where(interior_cells[:, None], r_m, 0.0)
            mom_norm = A_m.norm(r_m)
            aP = torch.where(interior_cells, A_m.diag / urf_v, A_m.diag)

            # ---- Rhie-Chow face mass flux (lagged velocity) --------------
            rho_f = assembly.cells_to_faces_distance_weighted(mesh,
                                                              params["rho"])
            Vbar = assembly.cells_to_faces_distance_weighted(mesh, V)
            gradp = maybe_sync(mesh, me._grad(mesh, params, p))
            vol_over_ap = torch.where(interior_cells, mesh.cell_volume / aP,
                                      0.0)
            voap_f = assembly.cells_to_faces_distance_weighted(
                mesh, bck.extend_to_ghosts(mesh, vol_over_ap))
            Df = rho_f * voap_f * mesh.face_e_over_d
            gpbar = assembly.cells_to_faces_distance_weighted(mesh, gradp)
            dp = mesh.take_nbr(p) - mesh.take_owner(p)
            rc = Df * (dp - (gpbar * mesh.face_ds).sum(dim=1))
            mdot_int = rho_f * (Vbar * mesh.face_area).sum(dim=1) - rc
            mdot = torch.where(bnd, bmdot, mdot_int)
            pres_face = me._pressure_faces(mesh)
            Df_cont = torch.where(bnd & ~pres_face, 0.0, Df)

            # ---- the block system ----------------------------------------
            dO, dN, dO_p, dN_p = me._block_jacobians(mesh, flux, rho_f,
                                                     Df_cont, pres_face, bnd)
            F_blk = torch.cat([F_mom, mdot[:, None]], dim=1)
            B = dim + 1
            diag_blk = torch.zeros((mesh.n_cells, B, B), dtype=V.dtype,
                                   device=dev)
            idx = torch.arange(dim, device=dev)
            diag_blk[:, idx, idx] = diag_cell[:, None]
            r_blk = torch.cat([r_cell, torch.zeros((mesh.n_cells, 1),
                                                   dtype=V.dtype,
                                                   device=dev)], dim=1)
            A_b, r_b = bell.assemble_block(mesh, F_blk, dO, dN, r_cell=r_blk,
                                           diag_cell=diag_blk)
            A_b = me._ghost_identity(mesh, A_b)
            r_b = torch.where(interior_cells[:, None], r_b, 0.0)
            cont_norm = torch.sqrt(torch.sum(r_b[:, dim] ** 2))
            # implicit under-relaxation of the velocity diagonal (matches
            # the aP in Df)
            diag = A_b.diag.clone()
            sub = diag[:, :dim, :dim]
            diag[:, :dim, :dim] = torch.where(
                interior_cells[:, None, None], sub / urf_v, sub)
            A_b = me._pin_block(A_b.replace(diag=diag), params)

            dq, _ = solver.solve_fn(A_b, r_b, torch.zeros_like(r_b))
            dV = dq[:, :dim]
            pc = dq[:, dim]
            if not me._has_pressure_bc:
                num = gsum(mesh, torch.where(interior_cells, pc, 0.0).sum())
                den = gsum(mesh, interior_cells.to(pc.dtype).sum())
                pc = pc - torch.where(interior_cells, num / den, 0.0)
            V = V + torch.where(interior_cells[:, None], dV, 0.0)
            p = p + torch.where(interior_cells, pc, 0.0)

            # mass-flux correction from the continuity-row linearisation
            dmdot = ((dO_p * mesh.take_owner(dq)).sum(dim=1)
                     + (dN_p * mesh.take_nbr(dq)).sum(dim=1))
            mdot = torch.where(bnd & ~pres_face, mdot, mdot + dmdot)

            new_state = dict(state)
            new_state["velocity"] = V
            new_state["pressure"] = p
            new_state["massFlux"] = mdot
            new_state["momAp"] = aP
            return new_state, {"mom_norm": mom_norm, "cont_norm": cont_norm}

        return step

    def advanceCoupled(self, niter: int = 1) -> ResidualHistory:
        """Fully coupled pressure-velocity advance (the reference's
        FlowModel_impl.h:1474 advanceCoupled; ``fvm_tpu/models/flow.py:
        1169-1201``).  The default ``coupledLinearSolver`` is BiCGStab
        (rtol 1e-3, 40 iterations) preconditioned by CoupledSIMPLE.  It
        runs the per-iteration loop (``outerChunk`` applies to the
        segregated step only)."""
        if not self._initialized:
            raise ConfigError("call init() before advanceCoupled()")
        single_device_model("FlowModel.advanceCoupled", self.partition)
        if self.options.get("coupledLinearSolver") is None:
            pre = CoupledSIMPLE(dia=self.mesh.dia)
            pre.setup_structure(*self.mesh.host_cf(), self.mesh.device)
            self.options["coupledLinearSolver"] = BiCGStab(
                preconditioner=pre, relative_tolerance=1e-3,
                max_iterations=40)
        if self._step_coupled is None:
            self._step_coupled = self._build_coupled_step()
        return self._advance_steps(niter, self._step_coupled)

    # --- the Newton endgame ------------------------------------------------

    def _newton_parts(self, mesh, params, state, bcvals):
        """The exact steady residual R(q) of q = (V, p) at a state
        (``fvm_tpu/models/flow.py:1537-1630``): momentum with the
        convection flux at the CURRENT Rhie-Chow mass flux mdot(V, p),
        continuity on that flux, and the boundary-ghost closures as rows;
        the Rhie-Chow scale vol/aP frozen at the state's momAp.  Returns a
        dict of q0 (the linearisation point), R, mdot_of, fluxes_of and the
        face data the surrogate needs."""
        opts = self.options
        me = weakref.proxy(self)
        dim = mesh.dim
        dev = mesh.device
        int_c = torch.arange(mesh.n_cells, device=dev) < mesh.n_interior_cells
        bnd = torch.arange(mesh.n_faces, device=dev) >= mesh.n_interior_faces
        scheme = opts["convectionScheme"]

        state = me._refresh_ghosts(mesh, params, state, bcvals)
        aP = state["momAp"]
        vol_over_ap = torch.where(int_c, mesh.cell_volume / aP, 0.0)
        voap_f = assembly.cells_to_faces_distance_weighted(
            mesh, bck.extend_to_ghosts(mesh, vol_over_ap))
        rho_f = assembly.cells_to_faces_distance_weighted(mesh, params["rho"])
        Df = rho_f * voap_f * mesh.face_e_over_d
        pres_face = me._pressure_faces(mesh)
        mu_f = disc.harmonic_face_gamma(mesh, params["mu"])
        needs_gradV = (not mesh.orthogonal) or scheme == "sou"
        wo = mesh.face_wo
        sgn = torch.where(mesh.cf_is_owner, 1.0,
                          -1.0).to(mesh.dtype)[:, :, None]
        cmask = mesh.cf_mask[:, :, None]

        def mdot_of(st):
            V, p = st["velocity"], st["pressure"]
            Vbar = assembly.cells_to_faces_distance_weighted(mesh, V)
            gradp = maybe_sync(mesh, me._grad(mesh, params, p))
            gpbar = assembly.cells_to_faces_distance_weighted(mesh, gradp)
            dp = mesh.take_nbr(p) - mesh.take_owner(p)
            rc = Df * (dp - (gpbar * mesh.face_ds).sum(dim=1))
            mdot_int = rho_f * (Vbar * mesh.face_area).sum(dim=1) - rc
            bmdot = me._boundary_mass_flux(mesh, params, st, bcvals)
            return torch.where(bnd, bmdot, mdot_int)

        def fluxes_of(q):
            V = q[:, :dim]
            p = q[:, dim]
            st = dict(state, velocity=V, pressure=p)
            mdot = mdot_of(st)
            gradV = (maybe_sync(mesh, me._grad(mesh, params, V))
                     if needs_gradV else None)
            flux = disc.diffusion_flux(mesh, V, mu_f, gradV)
            flux = flux + disc.convection_flux(mesh, V, mdot, scheme, gradV)
            p_f = wo * mesh.take_owner(p) + (1.0 - wo) * mesh.take_nbr(p)
            F_mom = flux.F + p_f[:, None] * mesh.face_area
            return st, mdot, flux, F_mom

        def R(q):
            st, mdot, _, F_mom = fluxes_of(q)
            F_blk = torch.cat([F_mom, mdot[:, None]], dim=1)
            r = -torch.where(cmask, sgn * mesh.take_faces(F_blk),
                             0.0).sum(dim=0)
            # ghost closure rows: ghosts are unknowns tied by their BCs
            stg = me._refresh_ghosts(mesh, params, st, bcvals)
            qg = torch.cat([stg["velocity"], stg["pressure"][:, None]],
                           dim=1)
            return torch.where(int_c[:, None], r, qg - q)

        q0 = torch.cat([state["velocity"], state["pressure"][:, None]],
                       dim=1)
        return {"state": state, "q0": q0, "R": R, "mdot_of": mdot_of,
                "fluxes_of": fluxes_of, "int_c": int_c, "bnd": bnd,
                "rho_f": rho_f, "Df": Df, "pres_face": pres_face}

    @staticmethod
    def _newton_norms(parts, r0, dim):
        int_c = parts["int_c"]
        mom = torch.sqrt(torch.sum(
            torch.where(int_c[:, None], r0[:, :dim], 0.0) ** 2))
        cont = torch.sqrt(torch.sum(torch.where(int_c, r0[:, dim], 0.0) ** 2))
        return mom, cont

    def _newton_surrogate(self, mesh, params, parts):
        """The assembled Picard block matrix at q0 (the coupled step's
        construction with urf = 1: Newton solves the unrelaxed equations),
        the preconditioner's source."""
        q0 = parts["q0"]
        _, mdot0, flux0, F_mom0 = parts["fluxes_of"](q0)
        bnd, pres_face = parts["bnd"], parts["pres_face"]
        Df_cont = torch.where(bnd & ~pres_face, 0.0, parts["Df"])
        dO, dN, _, _ = self._block_jacobians(mesh, flux0, parts["rho_f"],
                                             Df_cont, pres_face, bnd)
        F_blk0 = torch.cat([F_mom0, mdot0[:, None]], dim=1)
        A_b, _ = bell.assemble_block(mesh, F_blk0, dO, dN)
        return self._pin_block(self._ghost_identity(mesh, A_b), params)

    def _newton_finish(self, mesh, params, bcvals, parts, dq):
        """Apply a Newton increment: zero-mean pressure (enclosed domain),
        ghosts refreshed, the mass flux at the new state and the relaxed
        momAp refrozen there (the Newton root depends weakly on the frozen
        aP, so successive steps converge to the exact SIMPLE fixed point)."""
        dim = mesh.dim
        int_c = parts["int_c"]
        if not self._has_pressure_bc:
            dq = self._zero_mean_pressure(mesh, dq, int_c)
        q1 = parts["q0"] + dq
        st1 = dict(parts["state"], velocity=q1[:, :dim], pressure=q1[:, dim])
        st1 = self._refresh_ghosts(mesh, params, st1, bcvals)
        new_state = dict(st1)
        new_state["massFlux"] = parts["mdot_of"](st1)
        _, _, flux1, F_mom1 = parts["fluxes_of"](q1)
        A_m1, _ = assembly.assemble(
            mesh, FaceFlux(F_mom1, flux1.dF_dO, flux1.dF_dN))
        urf_v = float(self.options["momentumURF"])
        new_state["momAp"] = torch.where(int_c, A_m1.diag / urf_v,
                                         A_m1.diag)
        return new_state

    def _newton_solver(self, M, max_iterations, tol):
        """The inner Krylov solver (``newtonInnerSolver``) with the
        preconditioner M bound."""
        opts = self.options
        stall = opts.get("newtonStallRestart")
        if stall is None:
            stall = bool(opts.get("newtonInnerPrecision"))
        name = str(opts.get("newtonInnerSolver") or "bicgstab").lower()
        pre = _FixedM(M)
        if name == "gmres":
            solver = GMRES(preconditioner=pre, relative_tolerance=tol,
                           max_iterations=max_iterations,
                           restart=int(opts.get("newtonGmresRestart") or 32))
        elif name == "bicgstab":
            solver = BiCGStab(preconditioner=pre, relative_tolerance=tol,
                              max_iterations=max_iterations,
                              stall_restart=bool(stall))
        else:
            raise ConfigError(f"newtonInnerSolver: unknown {name!r} "
                              "(bicgstab | gmres)")
        # an eager solve stops once every later trip would be frozen (read
        # back every 25 trips; the result is the frozen form's); a graph
        # capture runs them all
        solver.exit_every = 25
        return solver

    def _newton_pre_for(self, mesh):
        """The CoupledSIMPLE preconditioner (momentum AMG: the unrelaxed
        Newton momentum block is elliptic, and a diagonal predictor makes
        no progress from 256^2 up), built once per mesh structure."""
        if self._newton_pre is None:
            pre = CoupledSIMPLE(dia=self.mesh.dia, momentum="amg")
            pre.setup_structure(*self.mesh.host_cf(), self.mesh.device)
            self._newton_pre = pre
        return self._newton_pre

    def _build_newton_step(self, mode="full"):
        """``mode``: "full" (residual, inner solve and update in one step,
        the signature of a segregated step), "resid" (step(mesh, params,
        state, bcvals) -> (r0, aux)) or "finish" (step(mesh, params, state,
        bcvals, dq) -> (new_state, aux)); the chunked inner solve is
        ``_newton_inner`` (``fvm_tpu/models/flow.py:1497-1839``)."""
        opts = self.options
        me = weakref.proxy(self)
        ktol = float(opts["newtonKrylovTolerance"])
        kit = int(opts["newtonKrylovIterations"])
        pre = self._newton_pre_for(self.mesh)

        def step(mesh, params, state, bcvals, *extra):
            dim = mesh.dim
            parts = me._newton_parts(mesh, params, state, bcvals)
            if mode == "finish":
                (dq,) = extra
                zero = torch.zeros((), dtype=dq.dtype, device=dq.device)
                return (me._newton_finish(mesh, params, bcvals, parts, dq),
                        {"mom_norm": zero, "cont_norm": zero})
            r0 = parts["R"](parts["q0"])
            mom_norm, cont_norm = me._newton_norms(parts, r0, dim)
            if mode == "resid":
                return r0, {"mom_norm": mom_norm, "cont_norm": cont_norm}
            A_b = me._newton_surrogate(mesh, params, parts)
            op = MatrixFreeOperator(newton_operator(parts["R"], parts["q0"]),
                                    A_b)
            solver = me._newton_solver(pre.precond_setup(A_b), kit, ktol)
            dq, kstats = solver.solve_fn(op, r0, torch.zeros_like(r0))
            new_state = me._newton_finish(mesh, params, bcvals, parts, dq)
            return new_state, {
                "mom_norm": mom_norm, "cont_norm": cont_norm,
                "newton_inner": kstats.iterations,
                "newton_inner_rel": kstats.residual / torch.clamp(
                    kstats.residual0, min=1e-300)}

        return step

    def _newton_inner(self, mesh_i, params_i, chunk):
        """The chunked inner solve on the (mesh, params) views, built once
        per views and chunk until the next ``init()``."""
        key = ("newton", chunk)
        inner = self._runners.get(key)
        if inner is None or inner.views[0] is not mesh_i \
                or inner.views[1] is not params_i:
            opts = self.options
            ktol = float(opts["newtonKrylovTolerance"])
            pre = self._newton_pre_for(self.mesh)
            me = weakref.proxy(self)

            def build(state, bcvals):
                parts = me._newton_parts(mesh_i, params_i, state, bcvals)
                A_b = me._newton_surrogate(mesh_i, params_i, parts)
                op = MatrixFreeOperator(
                    newton_operator(parts["R"], parts["q0"]), A_b)
                solver = me._newton_solver(pre.precond_setup(A_b), chunk,
                                           ktol)
                return op, solver

            inner = NewtonInner(build, chunk, mesh_i.device,
                                graph=self._newton_graphed)
            inner.views = (mesh_i, params_i)
            self._runners[key] = inner
        return inner

    def _views_for(self, inner_dt):
        """(mesh, params) in the inner dtype: the model's own, or float
        views cached on the identity of mesh and params."""
        if inner_dt == self.mesh.dtype:
            return self.mesh, self.params
        views = self._newton_views
        if (views is None or views[0] != inner_dt or views[1] is not self.mesh
                or views[2] is not self.params):
            views = (inner_dt, self.mesh, self.params,
                     _cast_floats(self.mesh, inner_dt),
                     _cast_floats(self.params, inner_dt))
            self._newton_views = views
        return views[3], views[4]

    def advanceNewton(self, niter: int = 3) -> ResidualHistory:
        """Exact-Newton (JFNK) endgame on the coupled steady system
        (``fvm_tpu/models/flow.py:1203-1495``).

        Solves R(V, p) = 0 (``_newton_parts``) with the exact Jacobian
        action by forward-mode AD and the assembled Picard block matrix's
        CoupledSIMPLE (momentum and pressure AMG) preconditioning the inner
        Krylov solve.  The Rhie-Chow scale vol/aP is frozen at the entry
        state's momAp and refrozen after each step, so the Newton root is
        the SIMPLE fixed point.  Run SIMPLE into the asymptotic basin
        first.

        With ``newtonChunkIterations`` > 0 the inner solve runs in chunks
        (``models/newton.py``: graph replays on a CUDA mesh) with the
        Eisenstat-Walker forcing, the no-progress and mixed-precision stall
        exits, ``newtonTargetResidual`` and ``newtonInnerPrecision``;
        otherwise each Newton step is one step of the outer loop."""
        if not self._initialized:
            raise ConfigError("call init() before advanceNewton()")
        single_device_model("FlowModel.advanceNewton", self.partition)
        opts = self.options
        if opts["transient"]:
            raise ConfigError("advanceNewton: steady states only")
        chunk = int(opts.get("newtonChunkIterations") or 0)
        if chunk > 0:
            return self._advance_newton_chunked(niter, chunk)
        if opts.get("newtonInnerPrecision"):
            raise ConfigError(
                "newtonInnerPrecision needs the chunked path (set "
                "newtonChunkIterations > 0): the one-step form computes its "
                "rhs in the inner precision")
        if self._step_newton is None:
            self._step_newton = self._build_newton_step()
        accel = opts.get("acceleration")
        opts["acceleration"] = None  # never Anderson-mix Newton
        try:
            return self._advance_steps(niter, self._step_newton)
        finally:
            opts["acceleration"] = accel

    def _advance_newton_chunked(self, niter: int, chunk: int):
        opts = self.options
        if self._runners.get("newton_resid") is None:
            self._runners["newton_resid"] = self._build_newton_step("resid")
            self._runners["newton_finish"] = self._build_newton_step("finish")
        resid = self._runners["newton_resid"]
        finish = self._runners["newton_finish"]
        kit = int(opts["newtonKrylovIterations"])
        if kit <= 0:
            raise ConfigError(
                "advanceNewton: newtonKrylovIterations must be > 0")
        bcvals = self._resolve_bcvals()
        hist = ResidualHistory()
        dtype = self.mesh.dtype
        B = self.mesh.dim + 1
        prec = opts.get("newtonInnerPrecision")
        inner_dt = getattr(torch, prec) if prec else dtype
        mixed = inner_dt != dtype
        mesh_i, params_i = self._views_for(inner_dt)
        inner = self._newton_inner(mesh_i, params_i, chunk)
        forcing = str(opts.get("newtonForcing") or "ew")
        eta_max = float(opts.get("newtonForcingMax") or 0.1)
        ktol = float(opts["newtonKrylovTolerance"])
        target_abs = opts.get("newtonTargetResidual")
        prev_norm = eta_prev = None
        self._newton_trace = []
        if opts.get("newtonRefreeze"):
            # refreeze momAp and the mass flux at the current state (a state
            # restored from a lower-precision phase carries a stale aP)
            self.state, _ = finish(self.mesh, self.params, self.state, bcvals,
                                   torch.zeros((self.mesh.n_cells, B),
                                               dtype=dtype,
                                               device=self.mesh.device))
        for it in range(niter):
            t_step = time.time()
            # the Newton rhs in the MODEL dtype: at the f32 floor the
            # residual is representation noise in f32
            r0, aux0 = resid(self.mesh, self.params, self.state, bcvals)
            mom0, cont0 = torch.stack([aux0["mom_norm"],
                                       aux0["cont_norm"]]).tolist()
            if target_abs is not None and mom0 < float(target_abs):
                hist.append((it, mom0, cont0))
                self._log_iteration(
                    f"{self.name}: newton {it}: {mom0:.6e} (target met)")
                break
            norm_k = math.sqrt(mom0 ** 2 + cont0 ** 2)
            if forcing == "ew":
                # Eisenstat-Walker choice 2 with the oversolve safeguard,
                # clipped to [ktol, eta_max]
                if prev_norm is None or prev_norm == 0.0:
                    eta = eta_max
                else:
                    eta = 0.9 * (norm_k / prev_norm) ** 2
                    if eta_prev is not None:
                        eta = max(eta, 0.9 * eta_prev ** 2)
                    eta = min(max(eta, ktol), eta_max)
                if target_abs is not None and mom0 > 0.0:
                    # the step needs only the contraction target / |r|
                    eta = min(max(eta, 0.5 * float(target_abs) / mom0),
                              eta_max)
            else:
                eta = ktol
            prev_norm, eta_prev = norm_k, eta
            if mixed:
                state_i = _cast_floats(self.state, inner_dt)
                bcvals_i = _cast_floats(bcvals, inner_dt)
                r0_i = r0.to(inner_dt)
            else:
                state_i, bcvals_i, r0_i = self.state, bcvals, r0
            inner.begin(state_i, bcvals_i, r0_i)
            tot, rel, prev_rel, stalled = 0, float("nan"), None, 0
            dq = None
            while tot < kit:
                prev_tot = tot
                dq, (tot, rel, conv) = inner.run_chunk(eta)
                if opts.get("newtonVerboseInner"):
                    print(f"# newton inner: {tot} its rel {rel:.3e}",
                          file=sys.stderr)
                if conv or not (rel == rel):
                    break
                if tot == prev_tot:
                    # the divergence guard froze the chunk: repeating it
                    # would spin on the same best iterate
                    break
                # mixed precision only: two consecutive chunks with < 10%
                # progress after real progress (rel < 0.1) -> accept; the
                # next Newton step recomputes the rhs in full precision
                if (mixed and rel < 0.1 and prev_rel is not None
                        and rel > 0.9 * prev_rel):
                    stalled += 1
                    if stalled >= 2:
                        break
                else:
                    stalled = 0
                prev_rel = rel
            self.state, _ = finish(self.mesh, self.params, self.state, bcvals,
                                   dq.to(dtype))
            self._last_aux = {"newton_inner": tot, "newton_inner_rel": rel}
            self._newton_trace.append({
                "entry_mom": mom0, "eta": eta, "inner_its": tot,
                "inner_rel": rel, "s": time.time() - t_step})
            hist.append((it, mom0, cont0))
            self._log_iteration(
                f"{self.name}: newton {it}: {mom0:.6e} (inner {tot} its to "
                f"{rel:.1e}, eta {eta:.1e})")
        return hist

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("FlowModel: transient option is off")
        if "velocity_N2" in self.state:
            self.state["velocity_N2"] = self.state["velocity_N1"]
        self.state["velocity_N1"] = self.state["velocity"]

    # --- immersed boundary and integrals (fvm_tpu/models/flow.py:2097-2222)

    def set_immersed_boundary(self, mask, velocity, solid_mask=None,
                              stencil=None) -> None:
        """Immersed body in the flow (reference: IBM flow pipeline,
        scripts/IBMSetup.py + GenericIBDiscretization.h).

        ``mask``: cells pinned to the body ``velocity`` ((dim,) or (n,
        dim)); ``solid_mask``: the strictly solid cells, whose pressure
        correction is pinned to 0 and whose faces carry no mass flux (the
        body surface the force integral sums over); ``stencil``:
        ``IBManager.interpolation_stencil()``, whose implicit rows
        constrain the IB band's MOMENTUM (the reference's
        GenericIBDiscretization on momentum), moving the effective no-slip
        surface from the pinned-cell staircase to the body surface; with
        a stencil pass ``mask = solid_mask``.  Call after ``init()``."""
        mesh = self.mesh
        v = np.asarray(velocity, dtype=np.float64)
        v = np.broadcast_to(v, (mesh.n_interior_cells, mesh.dim)).copy()
        self._set_immersed_boundary(mask, v, stencil=stencil)
        if solid_mask is None:
            return
        sm = np.zeros(mesh.n_cells, dtype=bool)
        smarr = np.asarray(solid_mask, dtype=bool)
        sm[: len(smarr)] = smarr
        so = sm[mesh.face_cell0.cpu().numpy()]
        sn = sm[mesh.face_cell1.cpu().numpy()]
        is_int = np.arange(mesh.n_faces) < mesh.n_interior_faces
        # orientation for the force integral: +A (owner -> neighbour)
        # points INTO the solid when the neighbour is solid
        sign = np.where(sn & ~so, 1.0, np.where(so & ~sn, -1.0, 0.0))
        sign = np.where(is_int, sign, 0.0)
        dev = mesh.device
        self.params["ib_solid_mask"] = torch.from_numpy(sm).to(dev)
        self.params["ib_solid_face"] = torch.from_numpy(
            (so | sn) & is_int).to(dev)
        self.params["ib_face_sign"] = torch.from_numpy(sign).to(
            dev, mesh.dtype)
        self._drop_compiled()

    def getPressureIntegralonIBFaces(self):
        """Pressure-only force on the immersed body (reference:
        FlowModel::getPressureIntegralonIBFaces)."""
        return self.getIBForceIntegral(pressure_only=True)

    def getIBForceIntegral(self, pressure_only: bool = False):
        """Force of the fluid on the immersed body, (dim,) numpy: pressure
        plus viscous momentum flux through the body faces."""
        if "ib_face_sign" not in self.params:
            raise ConfigError(
                "call set_immersed_boundary(solid_mask=...) first")

        def face_force(m, V, p, mu, sgn, grad_coeff=None):
            p_f = assembly.cells_to_faces_distance_weighted(m, p)
            F = p_f[:, None] * m.face_area
            if not pressure_only:
                mu_f = disc.harmonic_face_gamma(m, mu)
                gradV = (gradient(m, grad_coeff, V) if grad_coeff is not None
                         else None)
                F = F + disc.diffusion_flux(m, V, mu_f, gradV).F
            return torch.where(sgn[:, None] != 0.0, sgn[:, None] * F,
                               0.0).sum(dim=0)

        args = (self.state["velocity"], self.state["pressure"],
                self.params["mu"], self.params["ib_face_sign"])
        if "grad_coeff" in self.params:
            args = args + (self.params["grad_coeff"],)
        return self._map_mesh(face_force, *args).cpu().numpy()

    def getMassFluxIntegral(self, group_name) -> float:
        """Net mass flux out of the domain through a boundary group."""
        return float(self._sum_group(self._group(group_name),
                                     self.state["massFlux"]))

    @staticmethod
    def _face_force(m, V, p, mu, grad_coeff=None):
        """Per-face force, (nf, dim): pressure + viscous."""
        mu_f = disc.harmonic_face_gamma(m, mu)
        gradV = (gradient(m, grad_coeff, V) if grad_coeff is not None
                 else None)
        dflux = disc.diffusion_flux(m, V, mu_f, gradV)
        p_f = assembly.cells_to_faces_distance_weighted(m, p)
        return dflux.F + p_f[:, None] * m.face_area

    def _group_force(self, g, V, p, mu):
        """The force on boundary group ``g`` from (V, p, mu), (dim,)."""
        args = (V, p, mu)
        if "grad_coeff" in self.params:
            args = args + (self.params["grad_coeff"],)
        return self._sum_group(g, self._map_mesh(self._face_force, *args))

    def getMomentumFluxIntegral(self, group_name):
        """Force on a boundary group, (dim,) numpy: pressure + viscous
        (reference: getMomentumFluxIntegral)."""
        return self._group_force(self._group(group_name),
                                 self.state["velocity"],
                                 self.state["pressure"],
                                 self.params["mu"]).cpu().numpy()

    # --- sensitivities (the reference builds FlowModel with the Tangent
    # atype, models.cpp:10-74; here the tangent and adjoint fixed points of
    # the SIMPLE step map at the converged state, fvm_tpu/models/flow.py:
    # 861-1168) -----------------------------------------------------------

    def _step_map(self, step_t):
        """G(s, p_sub, b_sub) -> the next state, with the time levels held
        (they are inputs of the current step, not iterates)."""
        params, bcvals = self.params, self._resolve_bcvals()
        time_keys = [k for k in self.state if k.endswith(("_N1", "_N2"))]
        mesh = self.mesh

        def G(s, p_sub, b_sub):
            new_s, _ = step_t(mesh, dict(params, **p_sub), s,
                              dict(bcvals, **b_sub))
            return dict(new_s, **{k: s[k] for k in time_keys})

        return G

    def _tangent_state(self, param_tangents, bc_tangents, niter):
        """Tangent of the converged SIMPLE fixed point s* = G(s*, p): ds
        solves (I - dG/ds) ds = dG/dp . dp, reached by iterating the linear
        fixed point ds <- jvp(G)(ds, dp) ``niter`` times from 0 (it
        contracts at SIMPLE's own rate).  Each iteration runs
        ``torch.func.jvp`` through a step whose solves are implicit, so the
        tangent systems are solved by the same solvers.  Returns the whole
        tangent state."""
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_tangent")
        single_device(self, "solve_tangent")
        bcvals = self._resolve_bcvals()
        base, tans = self._tangent_inputs(param_tangents, bc_tangents, bcvals)
        G = self._step_map(self._build_step(implicit=True))
        state = self.state
        ds = {k: torch.zeros_like(v) for k, v in state.items()}
        for _ in range(niter):
            _, ds = torch.func.jvp(G, (state, base[0], base[1]),
                                   (ds, tans[0], tans[1]))
        return ds

    def solve_tangent(self, param_tangents=None, bc_tangents=None,
                      niter: int = 50) -> dict:
        """Forward sensitivity d(V, p)/d(params, BCs) . direction at the
        converged state.  ``param_tangents``: 'mu' / 'rho' (scalar,
        (n_interior,) or full shape); ``bc_tangents`` keyed
        'group:entry' (e.g. 'top:specifiedXVelocity').  ``niter``: tangent
        iterations (about SIMPLE's iterations to convergence).  Returns
        {'velocity': (n_interior, dim), 'pressure': (n_interior,)}."""
        ds = self._tangent_state(param_tangents, bc_tangents, niter)
        n = self.mesh.n_interior_cells
        return {"velocity": ds["velocity"][:n].cpu().numpy(),
                "pressure": ds["pressure"][:n].cpu().numpy()}

    def solve_tangent_force(self, group_name, param_tangents=None,
                            bc_tangents=None, niter: int = 50):
        """d(boundary force)/d(params, BCs) . direction on a group: the
        chain rule of ``getMomentumFluxIntegral`` through the state
        tangent, (dim,) numpy."""
        g = self._group(group_name)
        ds = self._tangent_state(param_tangents, bc_tangents, niter)
        _, tans = self._tangent_inputs(param_tangents, bc_tangents,
                                       self._resolve_bcvals())
        mu0 = self.params["mu"]
        dmu = tans[0].get("mu", torch.zeros_like(mu0))
        _, dF = torch.func.jvp(
            lambda V, p, mu: self._group_force(g, V, p, mu),
            (self.state["velocity"], self.state["pressure"], mu0),
            (ds["velocity"], ds["pressure"], dmu))
        return dF.cpu().numpy()

    def _adjoint_grads(self, functional, param_keys, bc_keys, niter):
        """Reverse mode at the converged fixed point s* = G(s*, p): the
        adjoint u solves (I - dG/ds^T) u = dJ/ds by the transposed fixed
        point u <- vjp(G)(u) + dJ/ds, ``niter`` times (SIMPLE's rate), and
        dJ/dp = dJ/dp|_explicit + (dG/dp)^T u: every cell of every
        requested parameter from one reverse sweep.  The step's graph is
        built once at s* and each sweep runs ``torch.autograd.grad`` over
        it (``retain_graph``); its transposable solves run the transposed
        solves.  ``functional(mesh, state, params, bcvals) -> scalar``.
        Non-owned rows are masked (none on one device) and the time levels
        held, as in the JAX package."""
        if not self._initialized:
            raise ConfigError("call init() + advance() before solve_adjoint")
        single_device(self, "solve_adjoint")
        mesh = self.mesh
        bcvals = self._resolve_bcvals()
        for k in param_keys:
            if k not in self.params:
                raise ConfigError(
                    f"FlowModel.solve_adjoint: unknown parameter {k!r}")
        for k in bc_keys:
            if k not in bcvals:
                raise ConfigError(
                    f"FlowModel.solve_adjoint: unknown BC entry {k!r}")
        G = self._step_map(self._build_step(implicit="transposable"))
        n_cells = mesh.n_cells
        owned = torch.arange(n_cells, device=mesh.device) < mesh.n_owned_cells
        # cells with no face (padding) are frozen: their cotangent is 0
        alive = mesh.cf_mask.any(dim=0)

        def mask(t, keep):
            return {k: torch.where(keep.reshape((n_cells,) + (1,) * (
                        a.ndim - 1)), a, 0.0)
                    if a.ndim >= 1 and a.shape[0] == n_cells else a
                    for k, a in t.items()}

        def grads(outs, inputs, cot):
            got = torch.autograd.grad(outs, list(inputs.values()), cot,
                                      retain_graph=True, allow_unused=True)
            return {k: torch.zeros_like(v) if g is None else g
                    for (k, v), g in zip(inputs.items(), got)}

        with torch.enable_grad():
            s_in = {k: v.detach().clone().requires_grad_(True)
                    for k, v in self.state.items()}
            p_in = {k: self.params[k].detach().clone().requires_grad_(True)
                    for k in param_keys}
            b_in = {k: bcvals[k].detach().clone().requires_grad_(True)
                    for k in bc_keys}
            J = functional(mesh, s_in, dict(self.params, **p_in),
                           dict(bcvals, **b_in))
            gJ = grads(J, {**s_in, **p_in, **b_in}, None)
            out = G(s_in, p_in, b_in)
        gs = mask({k: gJ[k] for k in s_in}, owned)
        gs.update(mask({k: gs[k] for k in ("velocity", "pressure")}, alive))
        keys = [k for k in out if out[k].requires_grad]
        outs = [out[k] for k in keys]
        u = gs
        for _ in range(niter):
            us = mask(grads(outs, s_in, [u[k] for k in keys]), owned)
            u = {k: us[k] + gs[k] for k in gs}
        upb = grads(outs, {**p_in, **b_in}, [u[k] for k in keys])
        res = {k: bck.fold_ghosts(mesh, upb[k] + gJ[k]).cpu().numpy()
               for k in param_keys}
        res.update({k: (upb[k] + gJ[k]).cpu().numpy() for k in bc_keys})
        return res

    def solve_adjoint(self, functional, param_keys=("mu",), bc_keys=(),
                      niter: int = 50) -> dict:
        """Reverse-mode gradient of ``functional(V_interior, p_interior)``
        with respect to parameter fields ('mu' / 'rho', on interior cells)
        and BC values ('group:entry', per face) at the converged state,
        from one adjoint sweep (the reference's Tangent atype is forward
        only).  ``niter`` about SIMPLE's iteration count."""
        n = self.mesh.n_interior_cells
        return self._adjoint_grads(
            lambda m, s, p, b: functional(s["velocity"][:n],
                                          s["pressure"][:n]),
            param_keys, bc_keys, niter)

    def solve_adjoint_force(self, group_name, direction=None,
                            param_keys=("mu",), bc_keys=(),
                            niter: int = 50) -> dict:
        """Reverse-mode d(F . direction)/d(params, BCs) of the force on a
        boundary group: the gradient of the drag with respect to the whole
        viscosity field and every BC knob from one adjoint sweep."""
        g = self._group(group_name)
        mesh = self.mesh
        if direction is None:
            direction = [1.0] + [0.0] * (mesh.dim - 1)
        dvec = torch.as_tensor(np.asarray(direction, np.float64)).to(
            mesh.device, mesh.dtype)

        def functional(m, s, params, b):
            args = (s["velocity"], s["pressure"], params["mu"])
            if "grad_coeff" in params:
                args = args + (params["grad_coeff"],)
            F = self._face_force(m, *args)
            return (self._sum_group(g, F) * dvec).sum()

        return self._adjoint_grads(functional, param_keys, bc_keys, niter)

    def getVelocity(self):
        """Interior-cell velocities as a host numpy (n, dim) array (global
        numbering, from every rank, when distributed)."""
        return self._gather_cells(self.state["velocity"])

    def getPressure(self):
        """Interior-cell pressures as a host numpy array (global numbering,
        from every rank, when distributed)."""
        return self._gather_cells(self.state["pressure"])

    def dumpContinuityMatrix(self, prefix: str) -> None:
        """Write the current pressure-correction system as MatrixMarket
        files ``<prefix>.mtx`` / ``<prefix>_rhs.mtx`` (reference:
        FlowModel_impl.h:1560 dumpContinuityMatrix; read back with
        ``io.read_matrix_market``): the Rhie-Chow scale vol/aP frozen at the
        state's momAp, ghost rows identity with zero right side."""
        from ..io.matrixmarket import write_matrix_market

        mesh = self.mesh
        dev = mesh.device
        interior_cells = torch.arange(mesh.n_cells, device=dev) \
            < mesh.n_interior_cells
        bnd = torch.arange(mesh.n_faces, device=dev) >= mesh.n_interior_faces
        rho_f = assembly.cells_to_faces_distance_weighted(mesh,
                                                          self.params["rho"])
        vol_over_ap = torch.where(interior_cells,
                                  mesh.cell_volume / self.state["momAp"], 0.0)
        voap_f = assembly.cells_to_faces_distance_weighted(
            mesh, bck.extend_to_ghosts(mesh, vol_over_ap))
        Df = rho_f * voap_f * mesh.face_e_over_d
        pres_face = torch.zeros(mesh.n_faces, dtype=torch.bool, device=dev)
        for g, bc in self._group_bcs():
            if bc.bc_type == "PressureBoundary":
                pres_face[mesh.group_faces(g)] = True
        Df_cont = torch.where(bnd & ~pres_face, 0.0, Df)
        Ap, rp = assembly.assemble(mesh, FaceFlux(
            F=self.state["massFlux"], dF_dO=Df_cont, dF_dN=-Df_cont))
        n_int = mesh.n_interior_cells
        diag, off, rp = Ap.diag.clone(), Ap.off.clone(), rp.clone()
        diag[n_int:] = 1.0
        off[:, n_int:] = 0.0
        rp[n_int:] = 0.0
        write_matrix_market(prefix + ".mtx", Ap.replace(diag=diag, off=off),
                            rp)
