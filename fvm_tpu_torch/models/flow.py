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

Ported so far: SIMPLE and SIMPLEC with ``nPressureCorrectors``, upwind
convection, BDF transient terms, BCs 'NoSlipWall', 'VelocityBoundary',
'PressureBoundary' and 'Symmetry'.  'SlipJump', immersed boundaries, the
coupled/Newton/Anderson/FMG paths, tangents and adjoints come later.
"""

from __future__ import annotations

import weakref

import torch

from ..core.options import BoundaryCondition, ModelOptions
from ..core import bcs as bck
from ..ops import assembly
from ..ops import discretizations as disc
from ..ops.assembly import FaceFlux
from ..ops.halo import maybe_sync, gsum
from ..ops.gradients import ls_gradient_coefficients, gradient
from ..linear import AMG, BiCGStab
from ..exceptions import ConfigError
from .base import Model, ResidualHistory, freeze, pack, unpack


class FlowBC(BoundaryCondition):
    _allowed_types = (
        "NoSlipWall",
        "VelocityBoundary",
        "PressureBoundary",
        "Symmetry",
    )
    _defaults = {
        "specifiedXVelocity": 0.0,
        "specifiedYVelocity": 0.0,
        "specifiedZVelocity": 0.0,
        "specifiedPressure": 0.0,
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
    _defaults = {
        "momentumURF": 0.7,
        "pressureURF": 0.3,
        # "SIMPLE" (reference) or "SIMPLEC": the consistent correction
        # coefficient vol/(aP - sum_nb aNb) lets pressureURF run at ~1.0
        "algorithm": "SIMPLE",
        # >= 2: PISO-style repeated pressure correctors
        "nPressureCorrectors": 1,
        "transient": False,
        "timeStep": 0.1,
        "timeDiscretizationOrder": 1,
        "convectionScheme": "upwind",
        "nonOrthogonalCorrection": True,
        "momentumTolerance": 1e-4,
        "continuityTolerance": 1e-4,
        "absoluteTolerance": 1e-50,
        "verbose": True,
    }


class FlowModel(Model):
    name = "FlowModel"

    def __init__(self, mesh):
        super().__init__(mesh)
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
        # pressure-level pin mask: interior cell 0
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
            pres = BiCGStab(preconditioner=AMG(), relative_tolerance=1e-3,
                            max_iterations=30)
            self.options["pressureLinearSolver"] = pres
        for s in (mom, pres):
            for ss in (s, getattr(s, "preconditioner", None)):
                if isinstance(ss, AMG):
                    ss.setup_structure(*mesh.host_cf(), mesh.device)

        self._step = self._build_step()
        self._runners = {}
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
            elif t == "Symmetry":
                nhat = self._unit_normals(mesh, sl)
                Vo = V[mesh.face_cell0[sl]]
                # ghost is AT the face: slip wall = tangential projection
                V[gc] = Vo - (Vo * nhat).sum(dim=1, keepdim=True) * nhat
            elif t == "PressureBoundary":
                p[gc] = bcvals[f"{g[1]}:specifiedPressure"]
        return dict(state, velocity=V, pressure=p)

    def _boundary_mass_flux(self, mesh, params, state, bcvals):
        """mdot on boundary faces from the BCs (fixed during continuity)."""
        V = state["velocity"]
        mdot = torch.zeros(mesh.n_faces, dtype=V.dtype, device=V.device)
        for g, bc in self._group_bcs():
            sl = mesh.group_faces(g)
            t = bc.bc_type
            if t in ("NoSlipWall", "Symmetry"):
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

    def _build_step(self):
        opts = self.options
        urf_v = float(opts["momentumURF"])
        urf_p = float(opts["pressureURF"])
        simplec = str(opts.get("algorithm", "SIMPLE")).upper() == "SIMPLEC"
        n_corr = int(opts.get("nPressureCorrectors", 1))
        scheme = opts["convectionScheme"]
        l1_norm = str(opts.get("residualNorm", "L2")).upper() == "L1"
        msolve = opts["momentumLinearSolver"].solve_fn
        psolve = opts["pressureLinearSolver"].solve_fn

        # the step holds its model weakly: the model holds the step and,
        # through its runners, the CUDA graphs captured from it, so a strong
        # reference would make a cycle that only the cycle collector frees
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            n_int = mesh.n_interior_cells
            dev = mesh.device
            interior_cells = torch.arange(mesh.n_cells, device=dev) < n_int
            bnd = torch.arange(mesh.n_faces, device=dev) >= mesh.n_interior_faces

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
            if l1_norm:
                # the reference's convergence.dat records the L1 momentum
                # residual of the first component (testFlowParallel.py)
                mom_norm = torch.sum(torch.abs(
                    torch.where(interior_cells[:, None], r, 0.0)[:, 0]))
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
            vol_over_ap = torch.where(interior_cells, mesh.cell_volume / aP,
                                      0.0)
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
                vol_corr = torch.where(interior_cells,
                                       mesh.cell_volume / corr_den, 0.0)
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
                    mesh, params, dict(state, velocity=V, pressure=p), bcvals)
                V = state2["velocity"]
                Vbar = assembly.cells_to_faces_distance_weighted(mesh, V)
                gradp = maybe_sync(mesh, me._grad(mesh, params, p))
                gpbar = assembly.cells_to_faces_distance_weighted(mesh, gradp)
                dp = mesh.take_nbr(p) - mesh.take_owner(p)
                rc = Df * (dp - (gpbar * mesh.face_ds).sum(dim=1))
                mdot_int = rho_f * (Vbar * mesh.face_area).sum(dim=1) - rc
                bmdot = me._boundary_mass_flux(mesh, params, state2, bcvals)
                mdot = torch.where(bnd, bmdot, mdot_int)

                cont_flux = FaceFlux(F=mdot, dF_dO=Df_cont, dF_dN=-Df_cont)
                Ap, rp = assembly.assemble(mesh, cont_flux)
                Ap, rp = identity_ghost_rows(Ap, rp)
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

            new_state = dict(state)
            new_state["velocity"] = V
            new_state["pressure"] = p
            new_state["massFlux"] = mdot
            new_state["momAp"] = aP
            return new_state, {"mom_norm": mom_norm, "cont_norm": cont_norm}

        return step

    # ------------------------------------------------------------------

    def advance(self, niter: int = 1) -> ResidualHistory:
        """Outer SIMPLE iterations; returns [(iter, mom_norm, cont_norm)]."""
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        opts = self.options
        hist = ResidualHistory()
        bcvals = self._resolve_bcvals()
        sync = self._residual_sync()
        chunk = self._chunk_size(niter)
        if chunk and sync:
            return self._advance_chunked(niter, chunk, bcvals)
        for it in range(niter):
            with self._phase("step"):
                self.state, aux = self._step(self.mesh, self.params,
                                             self.state, bcvals)
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

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("FlowModel: transient option is off")
        if "velocity_N2" in self.state:
            self.state["velocity_N2"] = self.state["velocity_N1"]
        self.state["velocity_N1"] = self.state["velocity"]

    def getVelocity(self):
        """Interior-cell velocities as a host numpy (n, dim) array."""
        return self.state["velocity"][: self.mesh.n_interior_cells].cpu().numpy()

    def getPressure(self):
        """Interior-cell pressures as a host numpy array."""
        return self.state["pressure"][: self.mesh.n_interior_cells].cpu().numpy()
