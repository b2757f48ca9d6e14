"""Phonon Boltzmann transport, gray or non-gray, relaxation-time
approximation (counterpart of ``fvm_tpu/kinetic/phonon.py``).

The reference's phononbase PhononModel (PhononModel.h:32: ``advance`` :530
sweeps the BTE per direction and mode, ``updateTL`` :302 recovers the
lattice temperature) and its COMET point-coupled solve (COMETModel.h:22).
Per direction d, with group velocity vg and relaxation time tau,

    d e''/dt + vg s_d . grad e'' = (e0 - e'') / tau,

with the isotropic equilibrium e0 = C (T - T_ref) / (4 pi) fixed by the
lattice temperature.  Non-gray transport passes ``bands``, per-band (C_b,
vg_b, tau_b), and the directional energies become one (n_cells, D*B)
tensor, direction-major; every band relaxes toward one lattice temperature
fixed by total energy conservation.  The implicit advection + relaxation
solve is the ES-BGK model's matrix-free ``_KineticOperator``.

``solver="sweep"`` is the Picard iteration (Jacobi(2)-preconditioned
BiCGStab on the plain operator).  ``solver="COMET"`` (default) is JFNK:
the residual carries the lattice-temperature feedback, the ghost closures
and (with ``scattering_matrix``) the full collision operator; the exact
Jacobian product is AD of it (``linear.base.newton_operator`` in
``linear.base.product_mode``), preconditioned by the per-cell
Sherman-Morrison inverse of the rank-1 temperature coupling (the ES-BGK
``_WoodburyPrecond`` at rank 1) and, by default, the diffusion synthetic
acceleration (``coarseAcceleration``, ``kinetic/dsa.py``: two condensed
AMG V-cycles whose products, residuals and Jacobi sweeps launch
``dia_stencil`` on a CUDA mesh).  The operator, the ghost closures and the
scattering product are plain PyTorch, as they are plain ``jnp`` in the JAX
package.

Float64 only: the closures floor divisors at 1e-300.  A partitioned mesh
and ordinate sharding raise ``ConfigError`` (ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear.base import (JFNK_EXIT_EVERY, TRANSPOSE_EXIT_EVERY,
                           TransposedOperator, product_mode)
from ..linear.krylov import BiCGStab, JacobiSolver
from ..mesh.device import gather_rows
from ..models.base import Model, newton_advance
from ..models.chunk import Runner
from .esbgk import _JVPOperator, _KineticOperator, _WoodburyPrecond
from .quadrature import reflection_tables, sn_directions

FOUR_PI = 4.0 * np.pi


def rta_scattering_matrix(tau, D: int, B: int = 1) -> np.ndarray:
    """The RTA limit of the full scattering operator: diag(1/tau_db) over
    the direction-band axis (d-major, the layout of e)."""
    tau = np.atleast_1d(np.asarray(tau, float))
    if tau.size == 1:
        tau = np.full(B, float(tau.reshape(())))
    return np.diag(np.tile(1.0 / tau, D))


def detailed_balance_correct(M: np.ndarray, w, B: int = 1) -> np.ndarray:
    """Project a linearized collision matrix onto exact energy
    conservation (reference: phononbase/ScatteringKernel.h:1721
    correctDetailedBalance): V M (e0 - e) conserves energy iff w^T M = 0
    (w the direction-major direction-band weights); the rank-1 projection
    M - w (w^T M) / (w^T w) removes the defect."""
    M = np.asarray(M, float)
    wdb = np.repeat(np.asarray(w, float), B)
    col = wdb @ M  # (DB,)
    return M - np.outer(wdb, col) / float(wdb @ wdb)


class PhononBC(BoundaryCondition):
    """Isothermal, Symmetry (specular), Adiabatic (diffuse) and Reflecting
    (reference: phononbase/PhononModel.h:246-260; PhononBoundary.h:69-155
    applyReflectingWall): the incoming ghost slots carry refl x the
    specular mirror plus (1 - refl) x the per-band flux-conserving diffuse
    redistribution, ``specifiedReflection`` the blend."""

    _allowed_types = ("Isothermal", "Symmetry", "Adiabatic", "Reflecting")
    _defaults = {
        "specifiedTemperature": 300.0,
        "specifiedReflection": 1.0,
    }


class PhononVC(BoundaryCondition):
    _defaults = {
        "initialTemperature": 300.0,
        "referenceTemperature": 300.0,
        "specificHeat": 1.0,  # C, volumetric
        "groupVelocity": 1.0,  # vg
        "relaxationTime": 0.1,  # tau
    }


class PhononModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.05,
        "relativeTolerance": 1e-7,
        "absoluteTolerance": 1e-14,
        "innerIterations": 80,
        "innerTolerance": 1e-8,
        # "COMET": JFNK with the exact Jacobian (lattice-temperature
        # feedback and closures; the linear BTE converges in 1-2 outers)
        # and the rank-1 Woodbury preconditioner (reference:
        # phononbase/COMETModel.h:22); "sweep": the Picard iteration
        # (PhononModel.h:530)
        "solver": "COMET",
        # the temperature-mode diffusion synthetic acceleration
        # (k_eff = sum C vg^2 tau / 3, kinetic/dsa.py; COMETModel.h:1080);
        # COMET on uniform materials without a scattering matrix
        "coarseAcceleration": True,
        "verbose": True,
    }


class PhononModel(Model):
    name = "PhononModel"
    # double-shell interfaces (Mesh.make_interface) carry the two-material
    # transmission closure; per interface name in self.interface:
    # {"t_LR": per-band L->R transmissivity, "t_RL": ...}, absent entries
    # the diffuse-mismatch (DMM) split with detailed balance
    _supports_interfaces = True

    def __init__(self, mesh, n_polar=4, n_azimuthal=8, bands=None,
                 partition=None, ordinate_shards=None,
                 scattering_matrix=None):
        """``bands``: (C_b, vg_b, tau_b) per band (scalars, or per-cell
        arrays over the interior cells for several materials); default one
        band from the VC.  ``scattering_matrix``: the (D*B, D*B) linearized
        full collision operator M (``rta_scattering_matrix`` is the RTA;
        run measured matrices through ``detailed_balance_correct``); COMET,
        uniform materials.  ``partition`` and ``ordinate_shards`` raise
        ``ConfigError``: the distributed branches are ROADMAP queue 1 item
        8b."""
        if partition is not None or ordinate_shards:
            raise ConfigError(
                "PhononModel: a partitioned mesh and ordinate sharding (the "
                "distributed branches) are not ported yet (ROADMAP queue 1 "
                "item 8b)")
        if mesh.dtype != torch.float64:
            raise ConfigError(
                "PhononModel: the phonon model runs in float64 only (its "
                f"ghost closures floor divisors at 1e-300); got {mesh.dtype}")
        super().__init__(mesh)
        self.vc = PhononVC()
        s, w = sn_directions(n_polar, n_azimuthal)
        self.s = s  # (D, 3)
        self.w = w  # (D,)
        self.D = len(w)
        self.bands = bands
        self.scattering_matrix = scattering_matrix

    def _make_options(self):
        return PhononModelOptions()

    def _make_bc(self):
        return PhononBC()

    # ------------------------------------------------------------------

    def _extend_cells(self, v):
        """(n_interior,) (or shorter) cell values -> (n_cells,): each ghost
        carries its owner's value (the owner's material), padding the
        first value."""
        mesh = self.mesh
        v = np.asarray(v, float)
        out = np.full(mesh.n_cells, float(v.flat[0]))
        n = min(v.shape[0], mesh.n_cells)
        out[:n] = v[:n]
        if v.shape[0] < mesh.n_cells:
            nif = mesh.n_interior_faces
            fc0 = mesh.face_cell0.cpu().numpy()[nif:]
            gh = mesh.n_interior_cells + np.arange(mesh.n_faces - nif)
            out[gh] = out[fc0]
        return out

    def _band_arrays(self):
        """Per-band (C, vg, tau), host numpy: each (B,) for uniform
        materials, or (n_cells, B) when any band entry is per cell."""
        cached = getattr(self, "_bands_cache", None)
        if cached is not None:
            return cached
        if self.bands is None:
            self.bands = [(float(self.vc["specificHeat"]),
                           float(self.vc["groupVelocity"]),
                           float(self.vc["relaxationTime"]))]

        def col(i):
            vals = [b[i] for b in self.bands]
            if any(np.ndim(v) > 0 for v in vals):
                return np.stack([
                    self._extend_cells(
                        np.broadcast_to(np.asarray(v, float),
                                        (self.mesh.n_interior_cells,))
                        if np.ndim(v) == 0 else v)
                    for v in vals], axis=-1)
            return np.array([float(v) for v in vals])

        self._bands_cache = (col(0), col(1), col(2))
        return self._bands_cache

    def _tile_d(self, x):
        """(..., B) -> (..., D*B): the same per-band value in every
        direction (direction-major)."""
        return x.unsqueeze(-2).expand(*x.shape[:-1], self.D, x.shape[-1]) \
            .reshape(*x.shape[:-1], self.D * x.shape[-1])

    def _e0_of_T(self, T, C=None):
        """Per-band equilibrium (..., B) of the lattice temperature; ``C``
        (a tensor) overrides the specific heats (ghost rows of per-cell
        materials)."""
        if C is None:
            C = self._C_t
        Tref = float(self.vc["referenceTemperature"])
        if C.ndim > 1 and C.shape[0] != T.shape[-1]:
            C = C[: T.shape[-1]]
        return (T[..., None] - Tref) * C / FOUR_PI

    def temperature(self, e=None):
        """Lattice temperature from the total energy (reference
        updateTL), per row of ``e`` (default the state)."""
        if e is None:
            e = self.state["e"]
        Tref = float(self.vc["referenceTemperature"])
        etot = e @ self._wB
        Csum = self._Csum
        if Csum.ndim:
            Csum = Csum[: e.shape[0]]
        return Tref + etot / Csum

    def getTemperature(self) -> np.ndarray:
        return self.temperature()[: self.mesh.n_interior_cells].cpu().numpy()

    def heat_flux(self) -> np.ndarray:
        """q = sum_b vg_b sum_d w_d s_d e''_bd, (n_interior, 3) numpy."""
        e = self.state["e"]
        eb = e.reshape(e.shape[0], self.D, self.B)
        vg = self._vg_t
        ws = self._w_t[:, None] * self._s_t  # (D, 3)
        if vg.ndim > 1:
            q = torch.einsum("cdb,cb,di->ci", eb, vg[: e.shape[0]], ws)
        else:
            q = torch.einsum("cdb,b,di->ci", eb, vg, ws)
        return q[: self.mesh.n_interior_cells].cpu().numpy()

    def getHeatFluxIntegral(self, group_name: str) -> float:
        """Net energy flux out through a boundary or interface group,
        sum_f sum_db w_db (vg s . A)_f e_upwind (reference:
        PhononModel.h:623 HeatFluxIntegral)."""
        mesh = self.mesh
        e = self._refresh_ghosts(mesh, self.params, self.state["e"],
                                 self._resolve_bcvals())
        g = mesh.group_by_name(group_name)
        sl = mesh.group_faces(g)
        gc = mesh.ghost_cells_of_group(g)
        eo = gather_rows(e, mesh.face_cell0[sl])
        flux = self.params["dO"][sl] * eo + self.params["dN"][sl] * e[gc]
        return float(torch.sum(self._wB * flux))

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        dtype, dev = mesh.dtype, mesh.device
        C, vg, tau = self._band_arrays()
        B = C.shape[-1]
        self.B = B
        D = self.D

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

        self._per_cell = C.ndim > 1 or np.ndim(vg) > 1 or np.ndim(tau) > 1
        self._scat = None
        if self.scattering_matrix is not None:
            M = np.asarray(self.scattering_matrix, float)
            if M.shape != (D * B, D * B):
                raise ConfigError(
                    f"PhononModel: scattering_matrix must be ({D * B}, "
                    f"{D * B})")
            if self._per_cell:
                raise ConfigError("PhononModel: scattering_matrix is "
                                  "single-device, uniform-material only")
            if str(self.options["solver"]).upper() != "COMET":
                raise ConfigError(
                    "PhononModel: scattering_matrix requires the COMET "
                    "solver (the sweep path Picard-lags only the RTA term)")
            if np.diag(M).min() <= 0.0:
                raise ConfigError("PhononModel: scattering_matrix needs a "
                                  "positive diagonal (relaxation rates)")
            self._scat = t(M)
        # the constants the closures and the step close over, on the
        # device once (nothing is copied from the host inside a capture)
        self._s_t, self._w_t = t(self.s), t(self.w)
        self._wB = t(np.repeat(self.w, B))
        self._C_t, self._vg_t = t(C), t(vg)
        self._Csum = t(C.sum(axis=-1)) if C.ndim > 1 else t(float(C.sum()))
        T0 = self._cell_field(self.vc, "initialTemperature")
        self.state = {"e": self._tile_d(self._e0_of_T(T0)).contiguous()}
        if self.options["transient"]:
            self.state["e_N1"] = self.state["e"]
        if np.ndim(tau) > 1:
            self._tau_db = t(np.tile(tau[:, None, :], (1, D, 1)).reshape(
                mesh.n_cells, -1))
        else:
            self._tau_db = t(np.tile(np.asarray(tau, float)[None, :],
                                     (D, 1)).reshape(-1))
        sA = torch.einsum("fd,nd->fn", mesh.face_area,
                          self._s_t[:, : mesh.dim])
        if np.ndim(vg) > 1:
            # the face group velocity is the owner's (interface faces are
            # split into per-side groups whose owners are their own side)
            vgO = gather_rows(self._vg_t, mesh.face_cell0)
            mdot = (sA[:, :, None] * vgO[:, None, :]).reshape(-1, D * B)
        else:
            mdot = (sA[:, :, None] * self._vg_t[None, None, :]) \
                .reshape(-1, D * B)
        self.params = {"dO": torch.clamp(mdot, min=0.0),
                       "dN": torch.clamp(mdot, max=0.0)}
        # specular reflection tables at any wall orientation, host numpy
        fa = mesh.face_area.cpu().numpy()
        for g, bc in self._group_bcs():
            if bc.bc_type not in ("Symmetry", "Reflecting"):
                continue
            fa_g = fa[mesh.group_faces(g)]
            n3 = np.zeros((fa_g.shape[0], 3))
            n3[:, : mesh.dim] = fa_g
            idx, wgt = reflection_tables(self.s, n3, weights=self.w)
            self.params[f"refl_idx:{g[1]}"] = torch.from_numpy(
                idx.astype(np.int64)).to(dev)
            self.params[f"refl_w:{g[1]}"] = t(wgt)
        self._walls = {}
        for g, _ in self._group_bcs():
            self._walls[g[1]] = self._side_tables(g)
        self._init_interfaces(C, vg)
        self._dsa = None
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    def _side_tables(self, g):
        """(sn_d (count, D), incoming (count, D*B)) of a group's faces:
        s_d . nhat and the directions that enter the domain."""
        mesh = self.mesh
        sl = mesh.group_faces(g)
        amag = torch.clamp(mesh.face_area_mag[sl], min=1e-300)
        nhat = torch.cat([mesh.face_area[sl] / amag[:, None],
                          torch.zeros((g[4], 3 - mesh.dim), dtype=mesh.dtype,
                                      device=mesh.device)], dim=1)
        sn_d = torch.einsum("nd,fd->fn", self._s_t, nhat)
        incoming = torch.repeat_interleave(sn_d, self.B, dim=1) < 0
        return sn_d, incoming

    def _init_interfaces(self, C, vg):
        """Per-interface transmissivity tables (see ``_interface_ghosts``):
        (1, B) constants for uniform materials, per-face (count, B) tables
        from each side's owner material for per-cell ones."""
        mesh = self.mesh
        self._ifc = {}
        for nm, _, _ in getattr(mesh, "interfaces", ()):
            gL, gR = mesh.interface(nm)
            opts = self.interface.get(nm) or {}
            Cv = np.asarray(C, float) * np.asarray(vg, float)
            if self._per_cell:
                fc0 = mesh.face_cell0.cpu().numpy()
                oL = fc0[mesh.group_faces(gL)]
                oR = fc0[mesh.group_faces(gR)]
                CvL, CvR = Cv[oL], Cv[oR]  # (count, B)
                vgb = np.broadcast_to(np.asarray(vg, float), Cv.shape)
                vgL, vgR = vgb[oL], vgb[oR]
            else:
                CvL = CvR = Cv[None, :]  # (1, B)
                vgL = vgR = np.asarray(vg, float)[None, :]
            t12 = opts.get("t_LR")
            t21 = opts.get("t_RL")
            if t12 is None and t21 is None:
                # DMM: t_{L->R} = C_R vg_R / (C_L vg_L + C_R vg_R)
                t12 = CvR / (CvL + CvR)
                t21 = CvL / (CvL + CvR)
            elif t21 is None:
                t12 = np.broadcast_to(np.asarray(t12, float), CvL.shape)
                t21 = np.clip(t12 * CvL / CvR, 0.0, 1.0)
            elif t12 is None:
                t21 = np.broadcast_to(np.asarray(t21, float), CvR.shape)
                t12 = np.clip(t21 * CvR / CvL, 0.0, 1.0)
            else:
                t12 = np.broadcast_to(np.asarray(t12, float), CvL.shape)
                t21 = np.broadcast_to(np.asarray(t21, float), CvR.shape)
            self._ifc[nm] = tuple(
                torch.as_tensor(np.array(a, np.float64)).to(mesh.device,
                                                            mesh.dtype)
                for a in (t12, t21, vgL, vgR)) + (
                self._side_tables(gL), self._side_tables(gR))

    def _refresh_ghosts(self, mesh, params, e, bcvals):
        """The ghost energies of every boundary group and interface from the
        owner values (out-of-place: AD runs through them)."""
        D, B = self.D, self.B
        w = self._w_t
        e = bck.extend_to_ghosts(mesh, e)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            L = g[4]
            sn_d, incoming = self._walls[g[1]]
            eo = gather_rows(e, mesh.face_cell0[sl])
            t = bc.bc_type
            if t == "Isothermal":
                Tw = bcvals[f"{g[1]}:specifiedTemperature"]
                C = self._C_t
                ewb = self._e0_of_T(Tw, C=C[gc] if C.ndim > 1 else None)
                val = torch.where(incoming, self._tile_d(ewb), eo)
            elif t == "Adiabatic":
                # diffuse reflection with zero net energy flux (per band)
                sn = torch.repeat_interleave(sn_d, B, dim=1)
                out_flux = torch.sum(
                    torch.where(~incoming, eo * self._wB * sn, 0.0), dim=1)
                in_unit = torch.sum(
                    torch.where(incoming, self._wB * sn, 0.0), dim=1)
                e_refl = out_flux / torch.clamp(-in_unit, min=1e-300)
                val = torch.where(incoming, e_refl[:, None], eo)
            elif t == "Reflecting":
                # refl x the specular mirror + (1 - refl) x the per-band
                # flux-conserving diffuse redistribution on the incoming
                # slots; the outgoing slots upwinded
                refl = bcvals[f"{g[1]}:specifiedReflection"][:, None]
                eoB = eo.reshape(L, D, B)
                eg_spec = self._mirror(params, g[1], eo).reshape(L, D * B)
                wpos = w[None, :] * torch.clamp(sn_d, min=0.0)  # (count, D)
                out_b = torch.einsum("fd,fdb->fb", wpos, eoB)
                in_unit = torch.clamp(-sn_d, min=0.0) @ w
                e_diff = out_b / torch.clamp(in_unit, min=1e-300)[:, None]
                blend = refl * eg_spec + (1.0 - refl) * self._tile_d(e_diff)
                val = torch.where(incoming, blend, eo)
            else:  # Symmetry: specular at any orientation
                val = self._mirror(params, g[1], eo).reshape(L, D * B)
            e = torch.slice_scatter(e, val, dim=0, start=gc.start,
                                    end=gc.stop)
        for nm, _, _ in getattr(mesh, "interfaces", ()):
            e = self._interface_ghosts(mesh, params, e, nm)
        return e

    def _mirror(self, params, name, eo):
        """The specular mirror of the owner energies (L, D*B) through the
        reflection tables: sum_k w_k eo[idx_k] per band, (L, D, B)."""
        idx = params[f"refl_idx:{name}"]  # (L, D, k)
        wgt = params[f"refl_w:{name}"]
        L, D, k = idx.shape
        B = self.B
        eoB = eo.reshape(L, D, B)
        gath = eoB[torch.arange(L, device=eo.device)[:, None, None], idx]
        return torch.einsum("fnk,fnkb->fnb", wgt, gath)

    def _interface_ghosts(self, mesh, params, e, nm):
        """Two-material interface closure (reference:
        phononbase/COMETInterface.h:44 makeDMMcoeffs): each side's incoming
        ghost slots carry its own reflected incident flux plus the
        partner's transmitted one, redistributed diffusely per band and
        normalized so the emitted energy flux is r Phi_self + t_partner
        Phi_partner (energy conserved to round-off for r + t = 1).  The
        outgoing slots are upwinded.  The i-th face of ``nm:L`` pairs with
        the i-th face of ``nm:R``."""
        t12, t21, vgL, vgR, (snL, incL), (snR, incR) = self._ifc[nm]
        gL, gR = mesh.interface(nm)
        D, B = self.D, self.B
        w = self._w_t

        def side(g, sn_d):
            sl = mesh.group_faces(g)
            eo = gather_rows(e, mesh.face_cell0[sl])  # (count, D*B)
            eoB = eo.reshape(g[4], D, B)
            # incident flux per unit area and band (without vg)
            phi_u = torch.einsum(
                "fd,fdb->fb", w[None, :] * torch.clamp(sn_d, min=0.0), eoB)
            inorm = torch.clamp(-sn_d, min=0.0) @ w
            return eo, phi_u, inorm

        eoL, phiL, inormL = side(gL, snL)
        eoR, phiR, inormR = side(gR, snR)
        for g, inc, eo, e_in in (
                (gL, incL, eoL,
                 ((1.0 - t12) * vgL * phiL + t21 * vgR * phiR)
                 / (vgL * torch.clamp(inormL, min=1e-300)[:, None])),
                (gR, incR, eoR,
                 ((1.0 - t21) * vgR * phiR + t12 * vgL * phiL)
                 / (vgR * torch.clamp(inormR, min=1e-300)[:, None]))):
            gc = mesh.ghost_cells_of_group(g)
            val = torch.where(inc, self._tile_d(e_in), eo)
            e = torch.slice_scatter(e, val, dim=0, start=gc.start,
                                    end=gc.stop)
        return e

    # ------------------------------------------------------------------

    def _dsa_tuple(self):
        """The DSA coarse-correction tuple (M_T, wE, pcoef, alive), built
        once per ``init`` and shared by the primal step: two condensed AMG
        V-cycles of the synthetic diffusion operator with k_eff = sum C vg^2
        tau / 3, restriction wE = w per band, prolongation C_b / 4 pi."""
        if self._dsa is None:
            from .dsa import build_scalar_diffusion_cycles

            mesh0 = self.mesh
            dtype, dev = mesh0.dtype, mesh0.device
            Cb, vgb, taub = self._band_arrays()
            k_eff = float((Cb * vgb**2 * taub).sum() / 3.0)
            M_T = build_scalar_diffusion_cycles(self, k_eff, ("Isothermal",))
            wE = torch.as_tensor(np.repeat(self.w, self.B)).to(dev, dtype)
            pcoef = torch.as_tensor(
                np.tile(np.asarray(Cb, float)[None, :], (self.D, 1))
                .reshape(-1) / FOUR_PI).to(dev, dtype)
            alive = torch.arange(mesh0.n_cells, device=dev) \
                < mesh0.n_interior_cells
            self._dsa = (M_T, wE, pcoef, alive)
        return self._dsa

    def _rate(self):
        """The relaxation rates (1, D*B) or (n_cells, D*B): diag(M) with a
        scattering matrix (it plays 1/tau in the implicit diagonal and the
        Woodbury preconditioner), else 1/tau."""
        if self._scat is not None:
            return torch.diagonal(self._scat)[None, :]
        tau = self._tau_db
        return 1.0 / (tau if tau.ndim == 2 else tau[None, :])

    def _woodbury(self, op_plain, V, rate):
        """The per-cell Sherman-Morrison inverse of the rank-1 coupling
        d e0_db / d e_d'b' = C_b w_d' / (4 pi sum C) (ghost rows carry
        none)."""
        mesh = self.mesh
        D, B = self.D, self.B
        alive = op_plain.interior[:, 0]
        C = self._C_t
        if C.ndim > 1:  # per-cell material
            u = self._tile_d(C) / (FOUR_PI * C.sum(dim=-1)[:, None])
        else:
            u = (self._tile_d(C) / (FOUR_PI * self._Csum))[None, :] \
                .expand(mesh.n_cells, D * B)
        U = torch.where(alive[:, None, None], u[:, :, None], 0.0)
        kappa = torch.where(alive[:, None], V * rate, 0.0)
        return _WoodburyPrecond(op_plain.with_lowrank(
            (kappa, U, self._wB[:, None])))

    def _build_step(self, product=None):
        """The outer step; ``product`` fixes the COMET Jacobian-product mode
        (default: ``product_mode`` of the state)."""
        opts = self.options
        inner_it = int(opts["innerIterations"])
        inner_tol = float(opts["innerTolerance"])
        comet = str(opts["solver"]).upper() == "COMET"
        transient = bool(opts["transient"])
        dt = float(opts["timeStep"])
        scat = self._scat
        # per-cell materials skip the DSA (its prolongation C / 4 pi is
        # uniform), as does the full scattering operator
        dsa = None
        if comet and bool(opts.get("coarseAcceleration", True)) and \
                not self._per_cell and scat is None:
            dsa = self._dsa_tuple()
        rate = self._rate()
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            e = me._refresh_ghosts(mesh, params, state["e"], bcvals)
            # all bands relax toward the one lattice temperature
            e0 = me._tile_d(me._e0_of_T(me.temperature(e)))
            V = mesh.cell_volume[:, None]
            diag_extra = V * rate
            b = V * rate * e0
            if transient:
                diag_extra = diag_extra + V / dt
                b = b + V / dt * state["e_N1"]
            op_plain = _KineticOperator(mesh, params["dO"], params["dN"],
                                        diag_extra)
            b = torch.where(op_plain.interior, b, e)
            r0 = b - op_plain.mv(e)
            rnorm = op_plain.norm(torch.where(op_plain.interior, r0, 0.0))

            if comet:
                def R(ev):
                    eg = me._refresh_ghosts(mesh, params, ev, bcvals)
                    e0v = me._tile_d(me._e0_of_T(me.temperature(ev)))
                    if scat is not None:
                        # V M (e0 - e); op_plain.mv applies V diag(M) e
                        bv = V * ((e0v - ev) @ scat.T) + V * rate * ev
                    else:
                        bv = V * rate * e0v
                    if transient:
                        bv = bv + (V / dt) * state["e_N1"]
                    res = bv - op_plain.mv(ev)
                    return torch.where(op_plain.interior, res, eg - ev)

                op = _JVPOperator(op_plain, R, e, product or product_mode(e))
                precond = me._woodbury(op_plain, V, rate)
                if dsa is not None:
                    from .dsa import DSAPrecond

                    precond = DSAPrecond(precond, *dsa)
                r0 = R(e)
                if scat is not None:
                    # the full-scattering residual, not the diagonal one
                    rnorm = op_plain.norm(
                        torch.where(op_plain.interior, r0, 0.0))
            else:
                op = op_plain
                precond = JacobiSolver(sweeps=2)

            solver = BiCGStab(preconditioner=precond,
                              relative_tolerance=inner_tol,
                              max_iterations=inner_it,
                              # see the ES-BGK COMET inner solve
                              stall_restart=True)
            solver.exit_every = JFNK_EXIT_EVERY
            de, st = solver.solve_fn(op, r0, torch.zeros_like(e))
            return dict(state, e=e + de), {"rnorm": rnorm,
                                           "trips": st.iterations}

        return step

    def _drop_compiled(self) -> None:
        """``Model._drop_compiled``, the DSA hierarchy included."""
        self._dsa = None
        super()._drop_compiled()

    def _chunk_runner(self, chunk: int) -> Runner:
        """``Model._chunk_runner`` on a step whose COMET products are
        forward-mode (no nested capture inside the chunk's graph)."""
        runner = self._runners.get(("chunk", chunk))
        if runner is None:
            runner = Runner(functools.partial(
                self._chunk_fn, self._build_step("forward"), self.mesh,
                self.params), chunk, self.mesh.device)
            self._runners[("chunk", chunk)] = runner
        return runner

    def advance(self, niter: int = 1):
        if not self._initialized:
            raise ConfigError("call init() before advance()")
        chunk = self._chunk_size(niter)
        if chunk:
            return self._advance_chunked(niter, chunk,
                                         self._resolve_bcvals())
        return newton_advance(self, niter)

    def updateTime(self):
        if not self.options["transient"]:
            raise ConfigError("PhononModel: transient option is off")
        self.state["e_N1"] = self.state["e"]

    # --- sensitivities (the reference's Tangent atype, models.cpp:10-74) ---

    def _sens_check(self, what: str) -> None:
        opts = self.options
        if not self._initialized:
            raise ConfigError(f"call init() + advance() before {what}")
        if str(opts["solver"]).upper() != "COMET":
            raise ConfigError(f"{what} requires the COMET solver")
        if opts["transient"]:
            raise ConfigError(f"{what}: steady states only")
        if self._scat is not None:
            raise ConfigError(
                f"{what}: full scattering-matrix states not supported")

    def _comet_R_of(self, mesh, params_all, bcvals):
        """The steady COMET residual as a function of (the direction-band
        tau, BC overrides, the full energy density with its ghosts): its
        jvp is the tangent linearization, its vjp the adjoint's."""
        V = mesh.cell_volume[:, None]
        me = weakref.proxy(self)

        def R_of(tau_db, b_sub, ev):
            bcv = dict(bcvals, **b_sub)
            tau = tau_db if tau_db.ndim == 2 else tau_db[None, :]
            op = _KineticOperator(mesh, params_all["dO"], params_all["dN"],
                                  V / tau)
            eg = me._refresh_ghosts(mesh, params_all, ev, bcv)
            e0v = me._tile_d(me._e0_of_T(me.temperature(ev)))
            res = V / tau * e0v - op.mv(ev)
            return torch.where(op.interior, res, eg - ev)

        return R_of

    def _sens_operator(self, R_of, e_st, mode):
        """(the Jacobi point operator, the exact Jacobian's operator) at the
        converged state."""
        V = self.mesh.cell_volume[:, None]
        tau0 = self._tau_db
        op_plain = _KineticOperator(
            self.mesh, self.params["dO"], self.params["dN"],
            V / (tau0 if tau0.ndim == 2 else tau0[None, :]))
        return _JVPOperator(op_plain, lambda ev: R_of(tau0, {}, ev), e_st,
                            mode)

    def solve_tangent(self, param_tangents=None, bc_tangents=None,
                      max_iterations: int = 2000,
                      relative_tolerance: float = 1e-10):
        """Forward sensitivity d(e)/d(tau, BCs) . direction at the converged
        steady COMET state: J de = dR/dp . dp with the primal's exact
        Jacobian, Jacobi(2)-preconditioned BiCGStab (the primal's
        Woodbury/DSA composition stagnates on the boundary-concentrated
        right sides of BC tangents, as in the JAX package).
        ``param_tangents``: "tau" (a scalar, (B,) per band or (D*B,) per
        direction-band); ``bc_tangents``: "group:entry".  Returns d(e) on
        the interior cells, (n_interior, D*B) numpy."""
        de = self._tangent(param_tangents, bc_tangents, max_iterations,
                           relative_tolerance)
        return de[: self.mesh.n_interior_cells].cpu().numpy()

    def _tangent(self, param_tangents, bc_tangents, max_iterations,
                 relative_tolerance):
        self._sens_check("solve_tangent")
        mesh, D, B = self.mesh, self.D, self.B
        bcvals = self._resolve_bcvals()
        e_st = self.state["e"].detach()
        tau0 = self._tau_db
        dtau = torch.zeros_like(tau0)
        for k, v in (param_tangents or {}).items():
            if k != "tau":
                raise ConfigError(f"phonon solve_tangent: unknown param {k!r}")
            if self._per_cell:
                raise ConfigError(
                    "phonon solve_tangent: tau tangents not supported with "
                    "per-cell material properties")
            v = np.atleast_1d(np.asarray(v, float))
            if v.size == 1:
                v = np.full(D * B, float(v.reshape(())))
            elif v.size == B:
                v = np.tile(v[None, :], (D, 1)).reshape(-1)
            dtau = torch.as_tensor(v).to(tau0.device, tau0.dtype)
        base_b, tan_b = {}, {}
        for k, v in (bc_tangents or {}).items():
            if k not in bcvals:
                raise ConfigError(f"phonon solve_tangent: unknown BC entry "
                                  f"{k!r}")
            base_b[k] = bcvals[k]
            tan_b[k] = torch.as_tensor(np.asarray(v, np.float64)).to(
                bcvals[k].device, bcvals[k].dtype).expand(
                bcvals[k].shape).clone()
        R_of = self._comet_R_of(mesh, self.params, bcvals)
        _, dr = torch.func.jvp(lambda t, b: R_of(t, b, e_st),
                               (tau0, base_b), (dtau, tan_b))
        op = self._sens_operator(R_of, e_st, product_mode(e_st))
        solver = BiCGStab(preconditioner=JacobiSolver(sweeps=2),
                          relative_tolerance=relative_tolerance,
                          max_iterations=max_iterations)
        solver.exit_every = JFNK_EXIT_EVERY
        de, self.tangent_stats = solver.solve_fn(op, dr,
                                                 torch.zeros_like(e_st))
        return de

    def solve_tangent_temperature(self, param_tangents=None,
                                  bc_tangents=None):
        """d(lattice T)/d(tau, BCs) . direction: the chain rule of
        ``temperature()`` through ``solve_tangent``, (n_interior,) numpy."""
        n = self.mesh.n_interior_cells
        de = self._tangent(param_tangents, bc_tangents, 2000, 1e-10)[:n]
        e_i = self.state["e"][:n]
        _, dT = torch.func.jvp(lambda e: self.temperature(e), (e_i,), (de,))
        return dT.cpu().numpy()

    def solve_adjoint(self, functional, param_keys=("tau",), bc_keys=(),
                      max_iterations: int = 2000,
                      relative_tolerance: float = 1e-10):
        """Reverse-mode gradients of a scalar functional of the converged
        steady COMET energy density with respect to the direction-band
        relaxation times and BC values, from ONE transposed solve.

        ``functional(e_interior) -> scalar tensor`` ((n_interior, D*B); it
        may call ``self.temperature``).  Returns {"tau": (D*B,)} and a
        per-face array per "group:entry" BC key.  The transposed system
        runs BiCGStab on ``TransposedOperator`` of the COMET Jacobian (one
        reverse-mode product per application) with Jacobi(2) on that
        transposed operator, as the JAX package does (the primal's
        Woodbury/DSA composition stagnates on the boundary-concentrated
        right sides adjoints share with BC tangents)."""
        self._sens_check("solve_adjoint")
        for k in param_keys:
            if k != "tau":
                raise ConfigError(f"phonon solve_adjoint: unknown param {k!r}")
        mesh = self.mesh
        bcvals = self._resolve_bcvals()
        b_keys = list(bc_keys)
        for k in b_keys:
            if k not in bcvals:
                raise ConfigError(
                    f"phonon solve_adjoint: unknown BC entry {k!r}")
        e_st = self.state["e"].detach()
        n_int = mesh.n_interior_cells
        with torch.enable_grad():
            ej = e_st.clone().requires_grad_(True)
            (gJ,) = torch.autograd.grad(functional(ej[:n_int]), ej)
        # dead padded cells are frozen: zero functional cotangent
        alive = mesh.cf_mask.any(dim=0)
        gJ = torch.where(alive[:, None], gJ, 0.0)
        R_of = self._comet_R_of(mesh, self.params, bcvals)
        op = self._sens_operator(R_of, e_st, "forward")
        solver = BiCGStab(preconditioner=JacobiSolver(sweeps=2),
                          relative_tolerance=relative_tolerance,
                          max_iterations=max_iterations)
        solver.exit_every = TRANSPOSE_EXIT_EVERY
        lam, self.adjoint_stats = solver.solve_fn(
            TransposedOperator(op), gJ, torch.zeros_like(e_st))
        with torch.enable_grad():
            tau = self._tau_db.detach().clone().requires_grad_(True)
            base_b = {k: bcvals[k].detach().clone().requires_grad_(True)
                      for k in b_keys}
            r = R_of(tau, base_b, e_st)
            leaves = [tau] + list(base_b.values())
            grads = torch.autograd.grad(r, leaves, lam, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves, grads)]
        out = {}
        if "tau" in param_keys:
            out["tau"] = grads[0].cpu().numpy()
        for k, g in zip(b_keys, grads[1:]):
            out[k] = g.cpu().numpy()
        return out
