"""MEMS dielectric charging: electrode tunneling and trap kinetics
(``fvm_tpu/models/charging.py``).

The reference's dielectric-charging pipeline (ElectricModel_impl.h:1133
calculateEquilibriumParameters, :1097 generateBandDiagram, :929 advance;
TunnelingDiscretization.h, InjectionDiscretization.h,
EmissionDiscretization.h:120-146, CaptureDiscretization.h:98-117,
TrapBandTunnelingDiscretization.h:96-235, DriftDiscretization.h:82-112;
the test script test/DIALECTRIC_CHARGING/testDielectricCharging.py and its
golden totalCharges.dat).

The unknown is a per-cell charge vector x = (x_trap[0..nTrap-1], x_band)
in 1/m^3.  Traps fill by electrode tunneling and band capture and empty by
Poole-Frenkel emission, trap-band tunneling and back-tunneling; the band
charge drifts in the field (upwind, zero Dirichlet ghosts) and is fed by
Fowler-Nordheim injection.  The trapped space charge feeds back into the
Poisson solve (``space_charge``, ``_solve_potential``), which makes the
charging self-limiting.

As in the JAX package the walk topology is static (it depends on the mesh
and the charging axis alone): the ascending cell chains are built once on
the host (``_walk_up``), and the WKB transmissions, the energy integrals
over the electrode's 801-point energy grid, the trap-band exits and the
drift fluxes are one array program of (phi, E) on the device
(``_make_coeffs``: cumsums, argmax exits and gathers over (energy, face,
level) arrays).  The transient BE step is an exact Newton solve: the
Jacobian action is AD of the residual (``linear.base.newton_operator`` in
``linear.base.product_mode``), preconditioned by the residual's diagonal in
BiCGStab(Jacobi(2)) at 1e-12, capped at 2 n + 200 trips and stopped early
every 10 (the same result).  The electrostatics is an internal
``ElectricModel`` on the mesh's device mesh (its default BiCGStab(AMG),
``dia_stencil`` launches on a CUDA mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..exceptions import ConfigError
from ..linear import BiCGStab, JacobiSolver
from ..linear.base import (JFNK_EXIT_EVERY, DiagonalSurrogate,
                           MatrixFreeOperator, newton_operator, product_mode)
from ..mesh import build_device_mesh, compute_geometry
from .electric import ElectricModel

# physics constants, the reference's values (PhysicsConstant.h:10-22)
QE = 1.60217646e-19  # C
ME = 9.10938188e-31  # kg
K_SI = 1.3806503e-23  # J/K
H_SI = 6.626068e-34  # J s
HBAR_SI = H_SI / (2.0 * np.pi)
E0_SI = 8.854187826e-12  # F/m


def fermi(energy, fermilevel, temperature):
    """Fermi-Dirac occupancy, energies in eV
    (ElectricUtilityFunctions.h:19-22)."""
    return 1.0 / (1.0 + np.exp(QE * (energy - fermilevel)
                               / (K_SI * temperature)))


def electron_supply(energy, fermilevel, temperature):
    """The electrode supply function [J], energies in eV
    (ElectricUtilityFunctions.h:25-43; its small-exponent series is dead
    code, overwritten by the trailing else: the live branches are kT power
    for power >= 10 and kT log1p(exp(power)) below)."""
    power = -QE * (energy - fermilevel) / (K_SI * temperature)
    return K_SI * temperature * np.where(
        power >= 10.0, power, np.log1p(np.exp(np.minimum(power, 10.0))))


def _reference_energy_grid(fermilevel):
    """The reference's accumulating energy loop ``for (en = EF-4; en <=
    EF+4; en += 0.01)`` (TunnelingDiscretization.h:154), with the same
    double accumulation, so the grid's end points match."""
    ens = []
    en = fermilevel - 4.0
    while en <= fermilevel + 4.0:
        ens.append(en)
        en += 0.01
    return np.asarray(ens)


class DielectricChargingConstants(dict):
    """The reference's ElectricModelConstants with its test script's defaults
    (testDielectricCharging.py:70-105)."""

    _defaults = {
        "dielectric_constant": 7.9,
        "dielectric_thickness": 200e-9,
        "dielectric_ionization": 3.0,  # eV
        "dielectric_bandgap": 5.0,  # eV
        "substrate_workfunction": 5.0,  # eV
        "membrane_workfunction": 5.0,  # eV
        "substrate_voltage": 0.0,
        "membrane_voltage": 100.0,
        "optical_dielectric_constant": 4.0,
        "OP_temperature": 300.0,
        "electron_effmass": 0.5,  # relative to ME
        "electron_trapdepth": (1.5, 1.5),  # eV, one per trap
        "electron_trapdensity": (3e25, 3e25),  # 1/m^3
        "poole_frenkel_emission_frequency": 1e11,  # 1/s
        "electron_capture_cross": 1e-22,  # m^2 (electrode tunneling)
        "electron_mobility": 50.0e-4,  # m^2/Vs
        "electron_saturation_velocity": 1.0e5,  # m/s
        "normal_direction": 2,
        "nLevel": 1000,
        "nMaxTBT": 200,  # reference nMax (TrapBandTunneling...h:84)
    }

    def __init__(self, **overrides):
        super().__init__(self._defaults)
        for k, v in overrides.items():
            if k not in self._defaults:
                raise ConfigError(f"unknown charging constant {k!r}")
            self[k] = v


class DielectricChargingModel:
    """Transient dielectric charging on one dielectric mesh.

    ``substrate`` / ``membrane``: the boundary groups of the injecting
    (grounded) and the biased electrode; every other group is Symmetry.
    ``advance_transient`` is the reference script's growing-timestep BE
    loop and returns the totalCharges history (time, avg trapped, avg
    band), the quantity of DIALECTRIC_CHARGING/GOLDEN/totalCharges.dat.
    The model runs in float64 on ``device`` (default "cuda")."""

    def __init__(self, mesh, substrate: str, membrane: str,
                 constants: DielectricChargingConstants | None = None,
                 space_charge: str | None = "accumulate", device=None):
        """``mesh``: the host Mesh (the chains are built on the host; the
        potential solve gets the device mesh built here)."""
        if not hasattr(mesh, "face_groups"):
            raise ConfigError("DielectricChargingModel takes the host Mesh")
        if space_charge not in ("accumulate", "instant", None):
            raise ConfigError("space_charge: 'accumulate', 'instant' or None")
        self._host = mesh
        self._geom = compute_geometry(mesh)
        self.mesh = build_device_mesh(mesh, self._geom, dtype="float64",
                                      device=device)
        self.constants = constants or DielectricChargingConstants()
        self.substrate = substrate
        self.membrane = membrane
        self.space_charge = space_charge
        self.state: dict = {}
        self.solve_stats: list = []
        self._initialized = False

    # ------------------------------------------------------------------
    def _t(self, a):
        """A host array as a float64 tensor on the model's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
            self.mesh.device)

    def _i(self, a):
        """A host index array as an int64 tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.mesh.device)

    def init(self) -> None:
        c = self.constants
        m0, geom = self._host, self._geom
        n_int = m0.n_interior_cells
        nT = len(c["electron_trapdepth"])
        if len(c["electron_trapdensity"]) != nT:
            raise ConfigError("trap depth/density size mismatch "
                              "(reference: 'wrong trapdepth size!')")
        self._nT, self._n_int = nT, n_int

        # ---- the internal electrostatics model
        em = ElectricModel(self.mesh)
        em.options["verbose"] = False
        em.vc["dielectric_constant"] = float(c["dielectric_constant"])
        for g in m0.boundary_groups:
            if g.name in (self.substrate, self.membrane):
                em.bc[g.name].bc_type = "SpecifiedPotential"
                em.bc[g.name]["specifiedPotential"] = float(c[
                    "substrate_voltage" if g.name == self.substrate
                    else "membrane_voltage"])
            else:
                em.bc[g.name].bc_type = "Symmetry"
        em.init()
        em.advance(3)
        self._electric = em

        # ---- the equilibrium (calculateEquilibriumParameters :1133)
        T = float(c["OP_temperature"])
        normal = int(c["normal_direction"])
        zc = geom.cell_centroid[:n_int, normal].astype(np.float64)
        wf_s = float(c["substrate_workfunction"])
        wf_m = float(c["membrane_workfunction"])
        thickness = float(c["dielectric_thickness"])
        effefield = (wf_m - wf_s) / thickness
        EF_eq = -wf_s + effefield * zc
        ion = float(c["dielectric_ionization"])
        depth = np.asarray(c["electron_trapdepth"], np.float64)
        Nt = np.asarray(c["electron_trapdensity"], np.float64)
        x0 = np.zeros((n_int, nT + 1))
        for i in range(nT):
            x0[:, i] = Nt[i] * fermi(-ion - depth[i], EF_eq, T)
            x0[:, nT] += Nt[i] * fermi(-ion, EF_eq, T)
        # the frozen detailed-balance capture cross sections
        nu = float(c["poole_frenkel_emission_frequency"])
        eps_opt = float(c["optical_dielectric_constant"])
        alpha_pf = np.sqrt(QE / (np.pi * E0_SI * eps_opt))
        m_rel = float(c["electron_effmass"])
        velocity = np.sqrt(8.0 * K_SI * T / (np.pi * ME * m_rel))
        cross_eq = np.zeros((n_int, nT))
        for i in range(nT):
            beta = np.exp(-(depth[i] - alpha_pf * np.sqrt(abs(effefield)))
                          * QE / (K_SI * T))
            cross_eq[:, i] = (x0[:, i] * nu * beta
                              / (velocity * (Nt[i] - x0[:, i]) * x0[:, nT]))
        self.state["charge"] = self._t(x0)
        self.state["chargeN1"] = self._t(x0)
        # the accumulated space charge (the JAX package's attribute)
        self.state["_rho_acc"] = torch.zeros(n_int, dtype=torch.float64,
                                             device=self.mesh.device)

        # ---- the static chains (ascending-axis walks)
        g = next(gg for gg in m0.boundary_groups if gg.name == self.substrate)
        sub_faces = np.arange(g.faces.start, g.faces.stop)
        owners = m0.face_cells[sub_faces, 0]
        nLevel = int(c["nLevel"])
        nMax = int(c["nMaxTBT"])
        sub_paths = self._walk_up(owners, nLevel - 1, zc)  # (nf, nLevel)
        tbt_paths = self._walk_up(np.arange(n_int), nMax, zc)
        z_ghost = geom.face_centroid[sub_faces, normal]
        self._sub = dict(
            paths=self._i(sub_paths),
            z_path=self._t(np.concatenate([z_ghost[:, None],
                                           zc[sub_paths]], axis=1)),
            phi_ghost=float(c["substrate_voltage"]))
        self._tbt_paths = self._i(tbt_paths)
        self._tbt_z = self._t(zc[tbt_paths])

        # ---- the coefficient program's static tables and scalars
        EF = -wf_s - float(c["substrate_voltage"])
        ens = _reference_energy_grid(EF)
        self._tbl = dict(
            ens=self._t(ens),
            supply=self._t(electron_supply(ens, EF, T)),
            ff=self._t(fermi(ens, EF, T)),
            depth=self._t(depth),
            Nt=self._t(Nt),
            vol=self._t(geom.cell_volume[:n_int]),
            cap=self._t(geom.cell_volume[:n_int, None] * velocity * cross_eq),
            alpha_sup=4.0 * np.pi * (m_rel * ME) / H_SI**3,
            wkb=-2.0 / HBAR_SI * np.sqrt(2.0 * m_rel * ME * QE),
            kT=K_SI * T,
            estep=0.01,
            alpha_pf=alpha_pf,
            nu=nu,
            stcap=float(c["electron_capture_cross"]),
            dX_inj=thickness / nLevel,
            ion=ion,
        )

        # ---- the drift geometry (static; the flux follows E)
        fc = m0.face_cells
        nf_i = m0.n_interior_faces
        area = geom.face_area
        bnd_zero = np.zeros(m0.n_faces - nf_i, bool)
        for gg in m0.boundary_groups:
            if gg.name not in (self.substrate, self.membrane):
                bnd_zero[gg.faces.start - nf_i: gg.faces.stop - nf_i] = True
        self._drift = dict(
            fo=self._i(fc[:nf_i, 0]), fn=self._i(fc[:nf_i, 1]),
            area_i=self._t(area[:nf_i]),
            bo=self._i(fc[nf_i:, 0]),
            area_b=self._t(area[nf_i:]),
            bnd_zero=torch.from_numpy(bnd_zero).to(self.mesh.device),
            mob=float(c["electron_mobility"]),
            vsat=float(c["electron_saturation_velocity"]),
        )

        # Krylov information travels about one cell per product along the
        # upwind drift chain, so the cap must cover the longest substrate
        # -> membrane path (the JAX package measured 400 trips leaving the
        # first steps' band profile unconverged on the 1000-cell column)
        self._solver = BiCGStab(preconditioner=JacobiSolver(sweeps=2),
                                relative_tolerance=1e-12,
                                absolute_tolerance=1e-300,
                                max_iterations=2 * n_int + 200)
        self._solver.exit_every = JFNK_EXIT_EVERY
        self._initialized = True

    # ------------------------------------------------------------------
    def _walk_up(self, start, n_steps, zc):
        """Ascending-axis cell chains (the reference's neighborUp walk,
        TunnelingDiscretization.h:200-216): from each start cell, step to
        the interior neighbour with the largest coordinate gain; repeat the
        last cell at the top boundary.  (n_start, n_steps + 1), host."""
        n_int = self._host.n_interior_cells
        cc = self._host.cell_cells
        rp, col = np.asarray(cc.row_ptr), np.asarray(cc.col)
        counts = rp[1: n_int + 1] - rp[:n_int]
        rows = np.repeat(np.arange(n_int), counts)
        pad = np.full((n_int, counts.max()), -1, np.int64)
        pad[rows, np.arange(len(rows)) - rp[rows]] = col[: rp[n_int]]
        valid = (pad >= 0) & (pad < n_int)
        dz = np.where(valid, zc[np.clip(pad, 0, n_int - 1)] - zc[:, None],
                      -np.inf)
        best = pad[np.arange(n_int), np.argmax(dz, axis=1)]
        has_up = np.isfinite(dz.max(axis=1)) & (dz.max(axis=1) > 0)
        up = np.where(has_up, best, np.arange(n_int))
        path = np.empty((len(start), n_steps + 1), np.int64)
        path[:, 0] = start
        for k in range(1, n_steps + 1):
            path[:, k] = up[path[:, k - 1]]
        return path

    # ------------------------------------------------------------------
    def _coeffs(self, phi, E):
        """The phi-dependent kernel coefficients as one array program:
        electrode tunneling in and out and injection (energy-integrated
        WKB along the substrate chains), the trap-band tunneling exits,
        Poole-Frenkel emission and the drift face fluxes."""
        t, sub, dr = self._tbl, self._sub, self._drift
        tbt_paths, tbt_z = self._tbt_paths, self._tbt_z
        n_int = self._n_int
        Ec = -(t["ion"] + phi)  # (n_int,) eV
        Emag = torch.sqrt(torch.sum(E * E, dim=1))
        ens = t["ens"]
        nE = ens.shape[0]
        depth = t["depth"]

        # --- electrode tunneling and injection
        paths, z_path = sub["paths"], sub["z_path"]
        dX = (z_path[:, 1:] - z_path[:, :-1]).abs()  # (nf, nLevel)
        Ec_path = Ec[paths]
        Ec_ghost = -(t["ion"] + sub["phi_ghost"])
        Ec_full = torch.cat([torch.full_like(Ec_path[:, :1], Ec_ghost),
                             Ec_path], dim=1)
        # tunneling: the barrier at 'me' only (TunnelingDiscretization.h:
        # 192-196)
        b_me = (Ec_path[None] - ens[:, None, None]).clamp(min=0.0)
        logT_tun = torch.cumsum(t["wkb"] * torch.sqrt(b_me) * dX[None], dim=2)
        del b_me
        # injection: the (me + low) / 2 barrier average
        # (InjectionDiscretization.h:146-151)
        b_full = (Ec_full[None] - ens[:, None, None]).clamp(min=0.0)
        avg = 0.5 * (b_full[:, :, 1:] + b_full[:, :, :-1])
        del b_full
        logT_inj = torch.cumsum(t["wkb"] * torch.sqrt(avg) * dX[None], dim=2)
        del avg

        # per-cell transmission (along a chain's repeated top cell the
        # values are equal, so the write order does not matter)
        trans = torch.zeros((nE, n_int), dtype=phi.dtype, device=phi.device)
        trans[:, paths.reshape(-1)] = torch.exp(logT_tun).reshape(nE, -1)
        del logT_tun
        cond = (ens[:, None] - Ec[None, :]) < 0.0
        base = (t["alpha_sup"] * (t["stcap"] * t["vol"])[None, :] * trans
                * (t["estep"] * QE) * cond)
        del trans
        endiff = ens[:, None, None] - (Ec[None, :, None] - depth[None, None])
        sc = torch.exp(-QE * endiff.abs() / t["kT"])
        w_in = (t["supply"] * t["ff"])[:, None, None]
        w_out = (t["supply"] * (1 - t["ff"]))[:, None, None]
        tun_in = torch.sum(base[:, :, None] * w_in
                           * torch.where(endiff < 0, sc, 1.0), dim=0)
        tun_out = torch.sum(base[:, :, None] * w_out
                            * torch.where(endiff > 0, sc, 1.0), dim=0)
        del sc, endiff, base

        # injection: the first chain cell whose band edge drops below en
        # (InjectionDiscretization.h:195-206)
        enters = ens[:, None, None] > Ec_path[None]  # (nE, nf, nLevel)
        found = enters.any(dim=2)
        first = torch.argmax(enters.to(torch.uint8), dim=2)
        del enters
        # exp of the gathered log equals the gather of the exp
        Tsel = torch.exp(torch.gather(logT_inj, 2, first[:, :, None])[:, :, 0])
        del logT_inj
        cells = paths[torch.arange(paths.shape[0], device=phi.device)[None],
                      first]
        coeff = (t["alpha_sup"] * Tsel
                 * (t["supply"] * t["ff"])[:, None] * t["estep"] * QE
                 * t["vol"][cells] / t["dX_inj"]) * found
        inj = torch.zeros(n_int, dtype=phi.dtype, device=phi.device
                          ).index_add(0, cells.reshape(-1), coeff.reshape(-1))

        # --- trap-band tunneling (TrapBandTunnelingDiscretization.h:96-235)
        dXt = (tbt_z[:, 1:] - tbt_z[:, :-1]).abs()
        Ec_t = Ec[tbt_paths]  # (n_int, nMax + 1)
        en_t = Ec[:, None] - depth[None, :]  # (n_int, nT)
        bt = (Ec_t[:, None, :] - en_t[:, :, None]).clamp(min=0.0)
        avg_t = 0.5 * (bt[:, :, 1:] + bt[:, :, :-1])
        del bt
        logTt = torch.cumsum(t["wkb"] * torch.sqrt(avg_t) * dXt[:, None, :],
                             dim=2)
        del avg_t
        exits = (en_t[:, :, None] - Ec_t[:, None, 1:]) > 0.0
        found_t = exits.any(dim=2)
        first_t = torch.argmax(exits.to(torch.uint8), dim=2)
        del exits
        Tt = torch.exp(torch.gather(logTt, 2, first_t[:, :, None])[:, :, 0])
        del logTt
        # the reference divides by the RELATIVE effmass and by the trap
        # depth in eV verbatim (TrapBandTunneling...h:216-217)
        alpha_t = (t["vol"][:, None] * QE * (Emag**2)[:, None] * t["stcap"]
                   / (16.0 * np.pi**2 * HBAR_SI
                      * float(self.constants["electron_effmass"])
                      * depth[None, :]))
        tbt = torch.where(found_t, alpha_t * Tt, 0.0)
        tgt = torch.where(found_t, torch.gather(tbt_paths[:, 1:], 1, first_t),
                          0)

        # --- Poole-Frenkel emission (EmissionDiscretization.h:126-146)
        expt = ((depth[None, :] - t["alpha_pf"] * torch.sqrt(Emag)[:, None])
                * QE / t["kT"])
        em_c = torch.where(expt > 0.0, t["vol"][:, None] * t["nu"]
                           * torch.exp(-expt.clamp(max=700.0)), 0.0)

        # --- drift fluxes (ElectricModel_impl.h:1023-1095)
        vel = -dr["mob"] * E
        vmag = torch.sqrt(torch.sum(vel * vel, dim=1))
        scale = torch.where(vmag >= dr["vsat"],
                            dr["vsat"] / vmag.clamp(min=1e-300), 1.0)
        vel = vel * scale[:, None]
        conv_i = 0.5 * (torch.einsum("fd,fd->f", vel[dr["fo"]], dr["area_i"])
                        + torch.einsum("fd,fd->f", vel[dr["fn"]],
                                       dr["area_i"]))
        conv_b = torch.where(dr["bnd_zero"], 0.0, torch.einsum(
            "fd,fd->f", vel[dr["bo"]], dr["area_b"]))
        return dict(tun_in=tun_in, tun_out=tun_out, inj=inj, tbt=tbt,
                    tbt_tgt=tgt, em=em_c, conv_i=conv_i, conv_b=conv_b)

    # ------------------------------------------------------------------
    def _residual(self, x, xN1, dt, k):
        """The BE residual of the charge system (zero at the solution)."""
        t, dr, nT = self._tbl, self._drift, self._nT
        Nt, vol, cap = t["Nt"], t["vol"], t["cap"]
        fo, fn, bo = dr["fo"], dr["fn"], dr["bo"]
        xt, xb = x[:, :nT], x[:, nT]
        free = Nt[None, :] - xt
        # electrode tunneling in and out (TunnelingDiscretization.h:240-263),
        # Poole-Frenkel emission, capture (bilinear), trap-band tunneling
        crate = cap * xb[:, None] * free
        trate = k["tbt"] * xt
        r_t = (k["tun_in"] * free - k["tun_out"] * xt - k["em"] * xt + crate
               - trate)
        # the band: emission in, capture out, trap-band arrivals at the
        # exit cells, injection, upwind drift with zero-Dirichlet ghosts
        r_b = torch.sum(k["em"] * xt, dim=1) - torch.sum(crate, dim=1)
        r_b = r_b.index_add(0, k["tbt_tgt"].reshape(-1), trate.reshape(-1))
        r_b = r_b + k["inj"]
        up = torch.where(k["conv_i"] > 0, xb[fo], xb[fn])
        vflux = k["conv_i"] * up
        r_b = r_b.index_add(0, fo, -vflux).index_add(0, fn, vflux)
        r_b = r_b.index_add(0, bo, -torch.where(k["conv_b"] > 0,
                                                k["conv_b"] * xb[bo], 0.0))
        r = torch.cat([r_t, r_b[:, None]], dim=1)
        # the backward-Euler transient
        return r - (vol / dt)[:, None] * (x - xN1)

    def _diag(self, x, dt, k):
        """The residual's diagonal (the Jacobi preconditioner)."""
        t, dr, nT = self._tbl, self._drift, self._nT
        Nt, cap = t["Nt"], t["cap"]
        fo, fn, bo = dr["fo"], dr["fn"], dr["bo"]
        xt, xb = x[:, :nT], x[:, nT]
        d_t = k["tun_in"] + k["tun_out"] + k["em"] + k["tbt"] \
            + cap * xb[:, None]
        d_b = torch.sum(cap * (Nt[None, :] - xt), dim=1)
        d_b = d_b.index_add(0, fo, k["conv_i"].clamp(min=0.0))
        d_b = d_b.index_add(0, fn, (-k["conv_i"]).clamp(min=0.0))
        d_b = d_b.index_add(0, bo, k["conv_b"].clamp(min=0.0))
        return torch.cat([d_t, d_b[:, None]], dim=1) \
            + (t["vol"] / dt)[:, None]

    def _step(self, x, xN1, dt, k, niter):
        """``niter`` exact Newton iterations of the BE step from x."""
        self.solve_stats = []
        for _ in range(niter):
            def R(xx, xN1=xN1, dt=dt, k=k):
                return self._residual(xx, xN1, dt, k)

            r = R(x)
            op = MatrixFreeOperator(newton_operator(R, x, product_mode(x)),
                                    DiagonalSurrogate(self._diag(x, dt, k)))
            dx, stats = self._solver.solve_fn(op, r, torch.zeros_like(r))
            self.solve_stats.append(stats)
            x = x + dx
        return x

    # ------------------------------------------------------------------
    def _solve_potential(self, niter: int = 2):
        """The electrostatics at the current space charge (the reference's
        solveElectroStatics per advance); returns the interior (phi, E).

        space_charge "accumulate" is the behaviour that generated the
        DIALECTRIC_CHARGING golden: updateTime accumulates totalcharge +=
        sum(x) (-QE) EVERY step (ElectricModel_impl.h:350-357, since
        commented out of the shipped code, but the only variant that
        matches GOLDEN/totalCharges.dat); "instant" takes the physical
        rho = -QE sum(x); None decouples."""
        em = self._electric
        if self.space_charge == "accumulate":
            rho = self.state["_rho_acc"] = self.state["_rho_acc"] - QE * \
                torch.sum(self.state["charge"], dim=1)
        elif self.space_charge == "instant":
            rho = -QE * torch.sum(self.state["charge"], dim=1)
        else:
            rho = None
        if rho is not None:
            full = torch.zeros(self.mesh.n_cells, dtype=rho.dtype,
                               device=rho.device)
            full[: self._n_int] = rho
            em.state["charge"] = full
        em.advance(niter)
        n = self._n_int
        return em.state["potential"][:n], em._E[:n]

    def calculateTotalCharges(self):
        """(avg trapped, avg band) per cell (the script's
        calculateTotalCharges, testDielectricCharging.py:146-157)."""
        x = self.state["charge"].cpu().numpy()
        return (float(x[:, : self._nT].sum(1).mean()),
                float(x[:, self._nT].mean()))

    def advance_transient(self, n_steps: int, dt0: float,
                          time_scale: float = 1.0,
                          iters_per_step: int = 3) -> np.ndarray:
        """The script's unsteadyAdvance loop (testDielectricCharging.py:
        113-144): record totalCharges, take one BE step (the potential
        solve, the coefficients and ``iters_per_step`` Newton iterations
        of the charge system), grow dt.  Returns (n_steps, 3) = (time, avg
        trapped, avg band)."""
        if not self._initialized:
            raise ConfigError("call init() before advance_transient()")
        t, dt = 0.0, float(dt0)
        hist = np.empty((n_steps, 3))
        for n in range(n_steps):
            sumT, sumC = self.calculateTotalCharges()
            hist[n] = (t, sumT, sumC)
            phi, E = self._solve_potential()
            k = self._coeffs(phi, E)
            x = self._step(self.state["charge"], self.state["chargeN1"],
                           dt, k, iters_per_step)
            self.state["charge"] = x
            self.state["chargeN1"] = x  # updateTime (BDF1)
            t += dt
            dt *= float(time_scale)
        return hist
