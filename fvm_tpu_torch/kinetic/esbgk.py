"""ES-BGK discrete-velocity Boltzmann solver (counterpart of
``fvm_tpu/kinetic/esbgk.py``).

The reference's esbgkbase KineticModel (KineticModel.h:51: Maxwellian and
ES-BGK equilibria at :907/:1112/:1216, per-ordinate advection sweeps in
advance :3360, the conservation check :2954; BCs in
KineticBoundaryConditions.h; DistFunctFields.h stores one Field per
ordinate).  As in the JAX package the distribution function is ONE
(n_cells, N) tensor and the direction-by-direction sweeps are one batched
implicit solve over all ordinates: upwind advection plus implicit BGK
relaxation, matrix-free BiCGStab over the combined system.  The ghost
distributions are refreshed per outer iteration by the ten boundary
closures (``_refresh_ghosts``): DiffuseWall, FarField, Periodic,
SpecularWall, Symmetry, RealWall, ZeroGradient, PressureInlet, Inlet and
PressureOutlet.

``solver="sweep"`` is the Picard iteration (Jacobi(2)-preconditioned
BiCGStab on the plain operator).  ``solver="COMET"`` (default) is JFNK:
the residual carries the collision feedback and the ghost closures, the
exact Jacobian action is AD of it (``linear.base.newton_operator`` in
``linear.base.product_mode``), and the inner BiCGStab is preconditioned by
the per-cell Woodbury inverse of the rank-5 collision coupling
(``_WoodburyPrecond``), optionally plus the temperature-mode diffusion
synthetic acceleration (``coarseAcceleration``, ``kinetic/dsa.py``: two
condensed AMG V-cycles whose products, residuals and Jacobi sweeps launch
``dia_stencil`` on a CUDA mesh).  The kinetic operator itself is gathers
and elementwise products, as in the JAX package, outside any kernel.

Float64 only: the ghost closures floor divisors at 1e-300.  A partitioned
mesh and ordinate sharding raise ``ConfigError`` (ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import functools
import math
import weakref

import numpy as np
import torch

from ..core import bcs as bck
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError
from ..linear.base import (JFNK_EXIT_EVERY, TRANSPOSE_EXIT_EVERY,
                           TransposedOperator, TransposedPrecond,
                           newton_operator, product_mode)
from ..linear.krylov import BiCGStab, JacobiSolver
from ..mesh.device import gather_rows
from ..models.base import Model, newton_advance
from ..models.chunk import Runner
from ..ops.bell import small_inv
from .quadrature import Quadrature, reflection_tables

# cells per vmap chunk of the collision Jacobian, times the ordinates: the
# forward-mode Jacobian holds 5 tangents of (cells, N, 3) at once
JACOBIAN_CHUNK_ENTRIES = 1 << 22


class KineticBC(BoundaryCondition):
    _allowed_types = (
        "DiffuseWall", "FarField", "SpecularWall", "Symmetry", "Periodic",
        "RealWall", "ZeroGradient", "PressureInlet", "PressureOutlet",
        "Inlet",
    )
    _defaults = {
        "specifiedTemperature": 1.0,
        "specifiedXVelocity": 0.0,
        "specifiedYVelocity": 0.0,
        "specifiedZVelocity": 0.0,
        "specifiedDensity": 1.0,
        # RealWall (Maxwell accommodation): 1 = fully diffuse, 0 = specular
        "accommodationCoefficient": 1.0,
        # PressureInlet / PressureOutlet (reduced units, P = rho T)
        "specifiedPressure": 1.0,
        # Inlet: inward mass flux per unit area (positive into the domain)
        "specifiedMassFlowRate": 0.0,
    }


class KineticVC(BoundaryCondition):
    _defaults = {
        "initialDensity": 1.0,
        "initialTemperature": 1.0,
        "initialXVelocity": 0.0,
        "initialYVelocity": 0.0,
        "relaxationTime": 0.1,  # tau (constant; Kn control)
    }


class KineticModelOptions(ModelOptions):
    _defaults = {
        "transient": False,
        "timeStep": 0.05,
        "collisionModel": "BGK",  # or "ESBGK"
        "prandtl": 2.0 / 3.0,
        # ratio of specific heats of the PressureOutlet acoustic relation
        # (reference: COMETBoundaryConditions.h SpHeatRatio)
        "SpHeatRatio": 5.0 / 3.0,
        "relativeTolerance": 1e-7,
        "absoluteTolerance": 1e-14,
        "innerIterations": 60,
        "innerTolerance": 1e-8,
        # "COMET": Newton with the exact rank-5 collision Jacobian and the
        # per-cell Woodbury preconditioner (reference:
        # esbgkbase/COMETModel.h:51); "sweep": the Picard iteration
        # (reference: KineticModel.h:3360)
        "solver": "COMET",
        # temperature-mode diffusion synthetic acceleration for thick
        # regimes (kinetic/dsa.py); COMET only, off by default as in the
        # JAX package (it can destabilize small inner budgets)
        "coarseAcceleration": False,
        "verbose": True,
    }


def _psi_weights(q, like):
    """Vt (N, 5): quadrature weights times the collision invariants
    psi = (1, c, |c|^2)."""
    c, w = q.tensors(like)
    psi = torch.cat([torch.ones((q.N, 1), dtype=c.dtype, device=c.device),
                     c, torch.sum(c * c, 1, keepdim=True)], dim=1)
    return w[:, None] * psi


def batched_small_solve(A, b):
    """Solve (..., B, B) x = (..., B) for a small static B, batched: the
    JAX package's unrolled Gauss-Jordan without pivoting
    (``fvm_tpu/linear/dense.py:56-72``; the callers' systems are
    near-identity), the same B elimination steps on tensors.  No host
    read-back: a CUDA graph captures it."""
    B = A.shape[-1]
    Ab = torch.cat([A, b[..., None]], dim=-1)  # (..., B, B+1)
    for k in range(B):
        piv = Ab[..., k, :] / Ab[..., k, k:k + 1]
        fac = Ab[..., :, k:k + 1]
        Ab = Ab - fac * piv[..., None, :]
        Ab = torch.cat([Ab[..., :k, :], piv[..., None, :], Ab[..., k + 1:, :]],
                       dim=-2)
    return Ab[..., B]


class _WoodburyPrecond:
    """Exact per-cell inverse of D - kappa U Vt^T, batched over cells (the
    reference's per-cell ArrowHeadMatrix solve, esbgkbase/ArrowHeadMatrix.h:
    21): the rank-5 ordinate coupling through the collision invariants is
    inverted by the Sherman-Morrison-Woodbury identity with a batched 5 x 5
    solve (``batched_small_solve``)."""

    def __init__(self, op):
        """U, the largest operand (cells x N x 5), is overwritten by
        kappa U / D (the JAX package's products in its order) and no
        reference to it is kept: ``op`` is spent."""
        D = torch.where(op.interior, op.diag, 1.0)
        self.D = torch.where(D.abs() > 0.0, D, 1.0)
        self.coupled = op.lowrank is not None
        if self.coupled:
            kappa, U, Vt = op.lowrank
            self.DinvUk = U.mul_(kappa[..., None]).div_(self.D[..., None])
            S = -torch.einsum("na,cnb->cab", Vt, self.DinvUk)
            self.S = S + torch.eye(Vt.shape[1], dtype=S.dtype, device=S.device)
            self.Vt = Vt

    def precond_setup(self, op):
        def M(r):
            z = r / self.D
            if self.coupled:
                t = z @ self.Vt
                y = batched_small_solve(self.S, t)
                z = z + torch.einsum("cna,ca->cn", self.DinvUk, y)
            return z

        return M

    def precond_setup_T(self, op):
        """The exact transpose, closed form: M = Dinv + DinvUk S^-1 Vt^T
        Dinv per cell, so M^T = Dinv + Dinv Vt S^-T DinvUk^T (the adjoint's
        transposed-Jacobian solves)."""

        def MT(r):
            z = r
            if self.coupled:
                t = torch.einsum("cna,cn->ca", self.DinvUk, r)
                y = batched_small_solve(self.S.transpose(1, 2), t)
                z = z + y @ self.Vt.T
            return z / self.D

        return MT


class _KineticOperator:
    """Matrix-free operator of the batched advection + relaxation system.

    With ``lowrank=(kappa, U, Vt)`` it includes the exact linearization of
    the collision term's equilibrium feedback,

        A df = advection(df) + (V/tau + V/dt) df - kappa U (Vt^T df),

    U = d feq / d moments (nc, N, 5), Vt = w psi (N, 5): the COMET
    coupling (reference: esbgkbase/COMETModel.h:51) as a rank-5 update.
    Ghost rows are identity, and so are pinned (immersed-solid) rows.  On
    one device every cell is owned, so the JAX package's owned-row mask is
    the identity here.  The slot sums run slot by slot (the JAX package's
    sum over the slot axis, without the (K, cells, N) temporary)."""

    def __init__(self, mesh, dO, dN, diag_extra, lowrank=None, pin=None,
                 diag=None):
        self.mesh = mesh
        self.dO = dO  # (nf, N) = max(mdot, 0)
        self.dN = dN  # (nf, N) = min(mdot, 0)
        self.diag_extra = diag_extra  # (nc, 1) or (nc, N)
        self.lowrank = lowrank
        self.pin = pin  # (nc, 1) bool
        n_int = mesh.n_interior_cells
        self.interior = (torch.arange(mesh.n_cells, device=mesh.device)
                         < n_int)[:, None]
        if diag is None:
            def pick(k):
                fk = mesh.cf_face[k]
                return torch.where(mesh.cf_is_owner[k][:, None],
                                   gather_rows(dO, fk), gather_rows(dN, fk))

            diag = self._slot_sum(pick) + diag_extra
            if pin is not None:
                diag = torch.where(pin, 1.0, diag)
        self.diag = diag

    def with_lowrank(self, lowrank):
        """The same operator with the collision coupling (the diagonal
        shared)."""
        return _KineticOperator(self.mesh, self.dO, self.dN, self.diag_extra,
                                lowrank=lowrank, pin=self.pin, diag=self.diag)

    def _slot_sum(self, per_slot):
        """sum over the K slots of s * per_slot(k) on valid slots (s = +1
        on the owner side, -1 on the neighbour side)."""
        mesh = self.mesh
        y = None
        for k in range(mesh.cf_face.shape[0]):
            v = per_slot(k)
            s = torch.where(mesh.cf_is_owner[k], 1.0, -1.0).to(v.dtype)
            t = torch.where(mesh.cf_mask[k][:, None], s[:, None] * v, 0.0)
            y = t if y is None else y + t
        return y

    def prepare(self):
        return self

    def mv(self, f):
        mesh = self.mesh
        F = self.dO * mesh.take_owner(f) + self.dN * mesh.take_nbr(f)
        y = self._slot_sum(lambda k: gather_rows(F, mesh.cf_face[k]))
        y = y + self.diag_extra * f
        if self.lowrank is not None:
            kappa, U, Vt = self.lowrank
            mom = f @ Vt
            y = y - kappa * torch.einsum("cna,ca->cn", U, mom)
        y = torch.where(self.interior, y, f)
        if self.pin is not None:
            y = torch.where(self.pin, f, y)
        return y

    def residual(self, x, b):
        return b - self.mv(x)

    def dot(self, a, b):
        return _sum2(a * b)

    def norm(self, x):
        return torch.sqrt(_sum2(x * x))

    def diag_solve(self, r):
        d = torch.where(self.interior, self.diag, 1.0)
        d = torch.where(d.abs() > 0.0, d, 1.0)
        return r / d

    def jacobi_step(self, x, b, omega=1.0):
        return x + omega * self.diag_solve(b - self.mv(x))


def _sum2(x):
    """The sum of a (cells, N) tensor over ordinates, then over cells: the
    same rounding whatever the number of CPU threads (a one-pass sum over
    all entries splits among the threads)."""
    return torch.sum(torch.sum(x, dim=1))


class _JVPOperator:
    """The exact Jacobian A v = -dR/df . v (``newton_operator`` in
    ``mode``), its reductions and diagonal from a base operator (JFNK);
    ``transposed()`` gives A^T u = -(dR/df)^T u, one reverse-mode product
    per application (the JAX package's ``jax.linear_transpose``)."""

    def __init__(self, base, Rfun, f0, mode):
        self.base = base
        self._R = Rfun
        self._f0 = f0
        self._mv = newton_operator(Rfun, f0, mode)

    def prepare(self):
        return self

    def mv(self, v):
        return self._mv(v)

    def residual(self, x, b):
        return b - self.mv(x)

    def dot(self, a, b):
        return self.base.dot(a, b)

    def norm(self, x):
        return self.base.norm(x)

    def diag_solve(self, r):
        return self.base.diag_solve(r)

    def jacobi_step(self, x, b, omega=1.0):
        return x + omega * self.diag_solve(b - self.mv(x))

    def transposed(self):
        return _VJPOperator(self._R, self._f0)


class _VJPOperator:
    """u -> -(dR/df)^T u at f0: R's graph built once, one backward pass per
    application."""

    def __init__(self, Rfun, f0):
        with torch.enable_grad():
            self._x = f0.detach().requires_grad_(True)
            self._r = Rfun(self._x)

    def prepare(self):
        return self

    def mv(self, u):
        return -torch.autograd.grad(self._r, self._x, u, retain_graph=True)[0]

    def residual(self, x, b):
        return b - self.mv(x)


class KineticModel(Model):
    name = "KineticModel"

    def __init__(self, mesh, quadrature: Quadrature | None = None,
                 partition=None, ordinate_shards: int | None = None):
        """``partition`` and ``ordinate_shards`` (the JAX package's spatial
        and velocity-ordinate sharding) raise ``ConfigError``: the
        distributed branches are ROADMAP queue 1 item 8b."""
        if partition is not None or ordinate_shards:
            raise ConfigError(
                "KineticModel: a partitioned mesh and ordinate sharding "
                "(the distributed branches) are not ported yet (ROADMAP "
                "queue 1 item 8b)")
        if mesh.dtype != torch.float64:
            raise ConfigError(
                "KineticModel: the kinetic model runs in float64 only (its "
                f"ghost closures floor divisors at 1e-300); got {mesh.dtype}")
        super().__init__(mesh)
        self.vc = KineticVC()
        self.quadrature = quadrature or Quadrature(8, 8, 8)

    def _make_options(self):
        return KineticModelOptions()

    def _make_bc(self):
        return KineticBC()

    # ------------------------------------------------------------------

    def init(self) -> None:
        mesh = self.mesh
        q = self.quadrature
        dtype, dev = mesh.dtype, mesh.device
        rho0 = self._cell_field(self.vc, "initialDensity")
        T0 = self._cell_field(self.vc, "initialTemperature")
        T0 = torch.where(T0 > 0, T0, 1.0)
        u0 = torch.stack([self._cell_field(self.vc, "initialXVelocity"),
                          self._cell_field(self.vc, "initialYVelocity"),
                          torch.zeros_like(rho0)], dim=-1)
        f0 = q.maxwellian(rho0, u0, T0)
        self.state = {"f": f0}
        if self.options["transient"]:
            self.state["f_N1"] = f0
        tau = self._cell_field(self.vc, "relaxationTime")
        self.params = {"tau": torch.where(tau > 0, tau, 1.0)}
        # per-face, per-ordinate advection speeds mdot = c . A (the mesh's
        # spatial components advect; the rest are internal ordinates)
        c, _ = q.tensors(mesh.cell_volume)
        mdot = torch.einsum("fd,nd->fn", mesh.face_area, c[:, : mesh.dim])
        self.params["dO"] = torch.clamp(mdot, min=0.0)
        self.params["dN"] = torch.clamp(mdot, max=0.0)
        for g, bc in self._group_bcs():
            if bc.bc_type == "Periodic":
                self.params[f"periodic_src:{g[1]}"] = \
                    self._periodic_group_src(g)
        # reflection tables of the walls that reflect (specular, symmetry;
        # RealWall's specular part; Inlet's reflected outgoing stream),
        # host-side at any wall orientation
        fa = mesh.face_area.cpu().numpy()
        for g, bc in self._group_bcs():
            if bc.bc_type not in ("SpecularWall", "Symmetry", "RealWall",
                                  "Inlet"):
                continue
            fa_g = fa[mesh.group_faces(g)]
            n3 = np.zeros((fa_g.shape[0], 3))
            n3[:, : mesh.dim] = fa_g
            idx, wgt = reflection_tables(q.c, n3, weights=q.w)
            self.params[f"refl_idx:{g[1]}"] = torch.from_numpy(
                idx.astype(np.int64)).to(dev)
            self.params[f"refl_w:{g[1]}"] = torch.from_numpy(wgt).to(dev,
                                                                      dtype)
        self._dsa = None
        self._step = self._build_step()
        self._runners = {}
        self._initial_norm = None
        self._initialized = True

    # ------------------------------------------------------------------

    def moments(self, f=None):
        """(rho, u, T) with u the 3-velocity; T in reduced units."""
        if f is None:
            f = self.state["f"]
        rho, mom, e = self.quadrature.moments(f)
        rho_s = torch.clamp(rho, min=1e-30)
        u = mom / rho_s[..., None]
        T = (2.0 * e / rho_s - torch.sum(u * u, dim=-1)) / 3.0
        return rho, u, torch.clamp(T, min=1e-30)

    def _interior_f(self, f):
        return self.state["f"][: self.mesh.n_interior_cells] if f is None \
            else f

    def stress(self, f=None):
        """Peculiar-velocity stress tensor per interior cell, P_ij = sum_n
        w_n (c_n - u)_i (c_n - u)_j f_n, components (xx, yy, zz, xy, xz,
        yz) (reference: MacroFields.h:37 ``Stress``, KineticModel.h:495)."""
        f = self._interior_f(f)
        _, u, _ = self.moments(f)
        c, w = self.quadrature.tensors(f)
        du = c[None, :, :] - u[..., None, :]
        P = torch.einsum("cni,cnj->cij", (f * w)[..., None] * du, du)
        comps = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
        return torch.stack([P[..., i, j] for i, j in comps], dim=-1)

    def heat_flux(self, f=None):
        """q_i = 1/2 sum_n w_n |c_n - u|^2 (c_n - u)_i f_n per interior
        cell (the translational heat-flux vector)."""
        f = self._interior_f(f)
        _, u, _ = self.moments(f)
        c, w = self.quadrature.tensors(f)
        du = c[None, :, :] - u[..., None, :]
        a = f * w * torch.sum(du * du, dim=-1)
        return 0.5 * torch.einsum("cn,cni->ci", a, du)

    def getMomentumFluxIntegral(self, group_name):
        """Net momentum flux (the force the gas exerts ON the boundary),
        F_i = sum_faces A_f sum_n w_n c_{n,i} (c_n . nhat) f_face,n with
        f_face upwinded per ordinate (owner value for outgoing ordinates,
        the ghost for incoming).  For an equilibrium gas p A nhat.  The
        wall-stress output of the reference's damping driver
        (scripts/DampingESBGK.py; COMETModel.h:2996).  A length-3 numpy
        vector."""
        g = self._group(group_name)
        q = self.quadrature

        def face_mom(m, f):
            c, w = q.tensors(f)
            amag = torch.clamp(m.face_area_mag, min=1e-300)
            nhat3 = torch.cat([m.face_area / amag[:, None],
                               torch.zeros((m.face_area.shape[0], 3 - m.dim),
                                           dtype=f.dtype, device=f.device)],
                              dim=1)
            cn = nhat3 @ c.T
            fface = torch.where(cn > 0, m.take_owner(f), m.take_nbr(f))
            return ((fface * w * cn) @ c) * amag[:, None]

        F = self._map_mesh(face_mom, self.state["f"])
        return self._sum_group(g, F).cpu().numpy()

    def _equilibrium(self, f):
        q = self.quadrature
        rho, u, T = self.moments(f)
        if self.options["collisionModel"] == "BGK":
            return q.maxwellian(rho, u, T)
        # ES-BGK: anisotropic Gaussian, Lambda = T/Pr I + (1 - 1/Pr) Theta,
        # Theta = P / rho (contracted pairwise: no (nc, N, 3, 3) temporary)
        pr = float(self.options["prandtl"])
        c, w = q.tensors(f)
        du = c[None, :, :] - u[:, None, :]  # (nc, N, 3)
        P = torch.einsum("cni,cnj->cij", (f * w)[..., None] * du, du)
        Theta = P / torch.clamp(rho, min=1e-30)[:, None, None]
        eye = torch.eye(3, dtype=f.dtype, device=f.device)
        Lam = (T / pr)[:, None, None] * eye + (1.0 - 1.0 / pr) * Theta
        Lam_inv = small_inv(Lam)
        det = _det3(Lam)
        quad = torch.sum(torch.einsum("cni,cij->cnj", du, Lam_inv) * du, -1)
        return (rho[:, None]
                / torch.sqrt((2.0 * math.pi) ** 3 * det)[:, None]
                * torch.exp(-0.5 * quad))

    def _refresh_ghosts(self, mesh, params, f, bcvals):
        """The ghost distributions of every boundary group from the owner
        values (out-of-place updates: AD runs through them)."""
        q = self.quadrature
        c, w = q.tensors(f)
        f = bck.extend_to_ghosts(mesh, f)
        for g, bc in self._group_bcs():
            gc = mesh.ghost_cells_of_group(g)
            sl = mesh.group_faces(g)
            t = bc.bc_type
            name = g[1]
            nf = g[4]
            amag = torch.clamp(mesh.face_area_mag[sl], min=1e-300)
            nhat3 = torch.cat([mesh.face_area[sl] / amag[:, None],
                               torch.zeros((nf, 3 - mesh.dim), dtype=f.dtype,
                                           device=f.device)], dim=1)
            cn = nhat3 @ c.T  # (nfaces, N)
            incoming = cn < 0  # into the domain
            fo = gather_rows(f, mesh.face_cell0[sl])
            # invalid (padded) face slots would carry T = 0: floor them
            valid = bcvals.get(f"{name}:__valid")

            def tsafe(T, valid=valid):
                return T if valid is None else torch.where(valid, T, 1.0)

            def vel(prefix=name):
                return torch.stack(
                    [bcvals[f"{prefix}:specified{a}Velocity"]
                     for a in ("X", "Y", "Z")], dim=1)

            def reflected(fo=fo, name=name):
                idx = params[f"refl_idx:{name}"]
                wgt = params[f"refl_w:{name}"]
                L, N, k = idx.shape
                gath = torch.gather(fo, 1, idx.reshape(L, N * k))
                return torch.sum(wgt * gath.reshape(L, N, k), dim=2)

            def unit_wall(T, u):
                fw = q.maxwellian(torch.ones(nf, dtype=f.dtype,
                                             device=f.device), u, T)
                in_flux = torch.sum(
                    torch.where(incoming, fw * w * cn, 0.0), dim=1)
                return fw, in_flux

            fg = None
            if t == "DiffuseWall":
                fw, in_flux = unit_wall(
                    tsafe(bcvals[f"{name}:specifiedTemperature"]), vel())
                # zero net mass flux: the incoming wall Maxwellian scaled
                out_flux = torch.sum(
                    torch.where(~incoming, fo * w * cn, 0.0), dim=1)
                rho_w = out_flux / torch.clamp(-in_flux, min=1e-300)
                fg = torch.where(incoming, rho_w[:, None] * fw, fo)
            elif t == "FarField":
                finf = q.maxwellian(
                    bcvals[f"{name}:specifiedDensity"], vel(),
                    tsafe(bcvals[f"{name}:specifiedTemperature"]))
                fg = torch.where(incoming, finf, fo)
            elif t == "Periodic":
                fg = gather_rows(f, params[f"periodic_src:{name}"])
            elif t in ("SpecularWall", "Symmetry"):
                # flux-exact reflected-ordinate redistribution (the mirror
                # permutation on axis-aligned walls)
                fg = torch.where(incoming, reflected(), fo)
            elif t == "RealWall":
                # Maxwell accommodation (KineticBoundaryConditions.h:158):
                # alpha rho_w M(u_w, T_w) + (1 - alpha) reflected outgoing
                fw, in_flux = unit_wall(
                    tsafe(bcvals[f"{name}:specifiedTemperature"]), vel())
                alpha = bcvals[f"{name}:accommodationCoefficient"][:, None]
                out_flux = torch.sum(
                    torch.where(~incoming, fo * w * cn, 0.0), dim=1)
                rho_w = out_flux / torch.clamp(-in_flux, min=1e-300)
                fb = alpha * rho_w[:, None] * fw + (1.0 - alpha) * reflected()
                fg = torch.where(incoming, fb, fo)
            elif t == "ZeroGradient":
                # (:385) the ghost copies the owner: extend_to_ghosts did
                pass
            elif t == "PressureInlet":
                # (:408) incoming <- resting Maxwellian at (P/T, T)
                Tin = tsafe(bcvals[f"{name}:specifiedTemperature"])
                Pin = bcvals[f"{name}:specifiedPressure"]
                fin = q.maxwellian(Pin / Tin, torch.zeros(
                    (nf, 3), dtype=f.dtype, device=f.device), Tin)
                fg = torch.where(incoming, fin, fo)
            elif t == "Inlet":
                # (:522) incoming <- rho_in M(u_in, T_in) + reflected
                # outgoing, rho_in scaling the inward flux to the target
                fw, in_flux = unit_wall(
                    tsafe(bcvals[f"{name}:specifiedTemperature"]), vel())
                mdot_in = bcvals[f"{name}:specifiedMassFlowRate"]
                rho_in = mdot_in / torch.clamp(-in_flux, min=1e-300)
                fg = torch.where(incoming, rho_in[:, None] * fw + reflected(),
                                 fo)
            elif t == "PressureOutlet":
                fg = torch.where(incoming, self._outlet_ghost(
                    fo, c, w, nhat3, bcvals[f"{name}:specifiedPressure"]), fo)
            if fg is not None:
                f = torch.slice_scatter(f, fg, dim=0, start=gc.start,
                                        end=gc.stop)
        return f

    def _outlet_ghost(self, fo, c, w, nhat3, Pout):
        """The PressureOutlet's exit Maxwellian (reference:
        COMETBoundaryConditions.h:258 applyPressureOutletBC): when the owner
        pressure exceeds P_out, the exit density relaxes by the acoustic
        relation drho = dP / a^2 and the exit velocity gains the
        characteristic dP / (sqrt(2) a rho) along the outward normal;
        otherwise the owner state is extrapolated."""
        gamma = float(self.options.get("SpHeatRatio", 5.0 / 3.0))
        c2 = torch.sum(c * c, dim=-1)
        rho0 = torch.sum(fo * w, dim=1)
        rho0s = torch.clamp(rho0, min=1e-30)
        u0 = ((fo * w) @ c) / rho0s[:, None]
        e0 = 0.5 * ((fo * w) @ c2)
        T0 = torch.clamp((2.0 * e0 / rho0s - torch.sum(u0 * u0, dim=-1))
                         / 3.0, min=1e-30)
        P0 = rho0 * T0
        a2 = gamma * P0 / rho0s
        choked = P0 > Pout
        rho_out = torch.where(choked, rho0 - (P0 - Pout) / a2, rho0)
        rho_out = torch.clamp(rho_out, min=1e-30)
        du_char = torch.where(
            choked, (P0 - Pout) / (torch.sqrt(2.0 * a2) * rho0s), 0.0)
        u_out = u0 + du_char[:, None] * nhat3
        T_out = torch.where(choked, Pout / rho_out, T0)
        return self.quadrature.maxwellian(rho_out, u_out, T_out)

    # ------------------------------------------------------------------

    def _feq_of_moments(self, m):
        """Discrete Maxwellian of one cell's conserved moments m (5,) =
        (rho, momentum, sum w f |c|^2); its forward-mode Jacobian is the
        exact rank-5 collision Jacobian d feq / d m."""
        c, _ = self.quadrature.tensors(m)
        rho = m[0]
        u = m[1:4] / rho
        T = (m[4] / rho - torch.dot(u, u)) / 3.0
        du = c - u[None, :]
        c2 = torch.sum(du * du, dim=-1)
        return rho / (2.0 * math.pi * T) ** 1.5 * torch.exp(-c2 / (2.0 * T))

    def _collision_jacobian(self, m_safe):
        """U (nc, N, 5) = d feq / d m per cell
        (``torch.func.vmap(torch.func.jacfwd(...))``, in chunks of cells)."""
        chunk = max(1, JACOBIAN_CHUNK_ENTRIES // self.quadrature.N)
        return torch.func.vmap(torch.func.jacfwd(self._feq_of_moments),
                               chunk_size=chunk)(m_safe)

    def _dsa_tuple(self):
        """The DSA coarse-correction tuple (M_T, wE, pcoef, alive), built
        once per ``init`` and shared by the primal step and the
        sensitivities: an AMG-cycled synthetic heat-diffusion correction on
        the equilibrium subspace, restriction wE = w (c^2/2 - 3 T0/2) and
        prolongation dM/dT at the reference state (the esbgk analogue of
        the reference's coarse model, COMETModel.h:1080)."""
        if self._dsa is None:
            from .dsa import build_scalar_diffusion_cycles

            q0, mesh0 = self.quadrature, self.mesh
            dtype0, dev = mesh0.dtype, mesh0.device
            tau_int = self.params["tau"][: mesh0.n_interior_cells] \
                .cpu().numpy()
            tau_ref = float(np.mean(tau_int)) if tau_int.size else 0.1
            T0 = float(self.vc["initialTemperature"])
            rho0 = float(self.vc["initialDensity"])
            k_eff = 2.5 * rho0 * T0 * tau_ref  # BGK kappa = (5/2) p tau
            M_T = build_scalar_diffusion_cycles(
                self, k_eff, ("DiffuseWall", "FarField"))
            c2 = (np.asarray(q0.c) ** 2).sum(axis=1)
            wE = torch.as_tensor(np.asarray(q0.w) * (c2 / 2.0 - 1.5 * T0)) \
                .to(dev, dtype0)
            M0 = rho0 / (2.0 * np.pi * T0) ** 1.5 * np.exp(-c2 / (2.0 * T0))
            pcoef = torch.as_tensor(M0 * (c2 / (2.0 * T0**2) - 1.5 / T0)) \
                .to(dev, dtype0)
            alive_T = torch.arange(mesh0.n_cells, device=dev) \
                < mesh0.n_interior_cells
            self._dsa = (M_T, wE, pcoef, alive_T)
        return self._dsa

    def _woodbury(self, op_plain, f, V, tau, pin=None):
        """The per-cell Woodbury preconditioner of the collision coupling
        at f (cells with no mass, ghost and pinned rows carry none)."""
        q = self.quadrature
        Vt = _psi_weights(q, f)
        m = f @ Vt
        alive = (m[:, 0] > 1e-12) & op_plain.interior[:, 0]
        if pin is not None:
            alive = alive & ~pin[:, 0]
        m_safe = torch.where(alive[:, None], m, q.rest_moments(m))
        U = self._collision_jacobian(m_safe)
        U.masked_fill_(~alive[:, None, None], 0.0)
        kappa = torch.where(alive[:, None], V / tau, 0.0)
        return _WoodburyPrecond(op_plain.with_lowrank((kappa, U, Vt)))

    def _build_step(self, product=None):
        """The outer step; ``product`` fixes the COMET Jacobian-product
        mode (default: ``product_mode`` of the distribution)."""
        opts = self.options
        inner_it = int(opts["innerIterations"])
        inner_tol = float(opts["innerTolerance"])
        comet = str(opts["solver"]).upper() == "COMET"
        transient = bool(opts["transient"])
        dt = float(opts["timeStep"])
        dsa = None
        if comet and bool(opts.get("coarseAcceleration", True)):
            dsa = self._dsa_tuple()
        # the step holds its model weakly (see ThermalModel._build_step)
        me = weakref.proxy(self)

        def step(mesh, params, state, bcvals):
            f = me._refresh_ghosts(mesh, params, state["f"], bcvals)
            feq = me._equilibrium(f)
            V = mesh.cell_volume[:, None]
            tau = params["tau"][:, None]
            diag_extra = V / tau
            b = V / tau * feq
            if transient:
                diag_extra = diag_extra + V / dt
                b = b + V / dt * state["f_N1"]
            has_ib = "ib_pin" in params
            pin = params["ib_pin"] if has_ib else None
            op_plain = _KineticOperator(mesh, params["dO"], params["dN"],
                                        diag_extra, pin=pin)
            del feq
            # ghost rows keep the current ghost values
            b = torch.where(op_plain.interior, b, f)
            if has_ib:
                # immersed-solid rows: the diffuse closure (lagged on the
                # Picard path, exact under COMET)
                b = torch.where(pin, me._ib_target(params, f), b)
            r0 = b - op_plain.mv(f)
            rnorm = op_plain.norm(torch.where(op_plain.interior, r0, 0.0))
            del b

            if comet:
                def R(fv):
                    fg = me._refresh_ghosts(mesh, params, fv, bcvals)
                    bv = V / tau * me._equilibrium(fv)
                    if transient:
                        bv = bv + (V / dt) * state["f_N1"]
                    res = bv - op_plain.mv(fv)
                    res = torch.where(op_plain.interior, res, fg - fv)
                    if has_ib:
                        res = torch.where(pin, me._ib_target(params, fv) - fv,
                                          res)
                    return res

                op = _JVPOperator(op_plain, R, f, product or product_mode(f))
                precond = me._woodbury(op_plain, f, V, tau, pin)
                if dsa is not None and not has_ib:
                    # the synthetic diffusion hierarchy is built on the
                    # un-pinned pattern
                    from .dsa import DSAPrecond

                    precond = DSAPrecond(precond, *dsa)
                r0 = R(f)
            else:
                op = op_plain
                precond = JacobiSolver(sweeps=2)

            solver = BiCGStab(preconditioner=precond,
                              relative_tolerance=inner_tol,
                              max_iterations=inner_it,
                              # the COMET inner residual turns orthogonal
                              # to r0 near convergence: restart the shadow
                              stall_restart=True)
            solver.exit_every = JFNK_EXIT_EVERY
            df, st = solver.solve_fn(op, r0, torch.zeros_like(f))
            f_new = torch.clamp(f + df, min=0.0)
            if comet and not transient:
                f_new = me._mass_projection(mesh, op_plain, f, df, f_new, pin)
            return dict(state, f=f_new), {"rnorm": rnorm,
                                          "trips": st.iterations}

        return step

    def _mass_projection(self, mesh, op_plain, f, df, f_new, pin):
        """The steady wall-bounded problem fixes its total mass only through
        its history (f -> s f is an exact solution family): project the
        Newton iterate back onto the incoming mass, with the overshoot guard
        (a full step whose positivity clip destroys most of the mass falls
        back to a quarter step)."""
        w = self.quadrature.tensors(f)[1]
        Vc = torch.where(op_plain.interior[:, 0], mesh.cell_volume, 0.0)
        if pin is not None:
            # solid cells' fictitious mass floats with sigma
            Vc = torch.where(pin[:, 0], 0.0, Vc)
        m_old = torch.sum(Vc * (f @ w))
        m_new = torch.sum(Vc * (f_new @ w))
        f_dmp = torch.clamp(f + 0.25 * df, min=0.0)
        m_dmp = torch.sum(Vc * (f_dmp @ w))
        ok = m_new > 0.5 * m_old
        f_new = torch.where(ok, f_new, f_dmp)
        m_eff = torch.where(ok, m_new, m_dmp)
        return f_new * (m_old / torch.clamp(m_eff, min=1e-300))

    def _drop_compiled(self) -> None:
        """``Model._drop_compiled``, the DSA hierarchy included (new params
        may carry another tau)."""
        self._dsa = None
        super()._drop_compiled()

    def _chunk_runner(self, chunk: int) -> Runner:
        """``Model._chunk_runner`` on a step whose COMET products are
        forward-mode: a captured step carries its products inside the one
        graph (no nested capture, as ``product_mode``'s "graph" would be)."""
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
            raise ConfigError("KineticModel: transient option is off")
        self.state["f_N1"] = self.state["f"]

    def conservation_error(self):
        """Largest moments of the collision term over the interior cells
        (vanish for BGK; reference: KineticModel.h:2954)."""
        n = self.mesh.n_interior_cells
        f = self.state["f"][:n]
        feq = self._equilibrium(self.state["f"])[:n]
        drho, dmom, de = self.quadrature.moments(feq - f)
        return (float(drho.abs().max()), float(dmom.abs().max()),
                float(de.abs().max()))

    # ------------------------------------------------------------------

    def set_immersed_boundary(self, solid_mask, wall_velocity=(0.0, 0.0, 0.0),
                              wall_temperature=1.0, pad_faces=None) -> None:
        """Diffuse-wall immersed boundary (reference: the esbgk IBM
        pipeline of scripts/IB-ESBGKSteady.py: computeSolidFaceDsf and
        ConservationofMFSolid).  Solid cells' rows become the closure
        f_solid = sigma M(u_w, T_w), sigma per solid cell such that the net
        upwind mass flux through its fluid-facing faces vanishes; the upwind
        transport then reflects diffusely at the immersed surface.  Under
        COMET the closure is a residual row (exact Jacobian); on the Picard
        path sigma lags one outer iteration.  Call after ``init()``.

        Moving bodies: pass ``pad_faces`` >= the largest IB-face count the
        motion produces; a call that keeps every table's shape writes the
        new tables into the old ones, so the step (and a captured chunk)
        stays as it is.  Padded rows carry zero advection and are inert."""
        if not self._initialized:
            raise ConfigError("call init() before set_immersed_boundary()")
        mesh = self.mesh
        q = self.quadrature
        dtype, dev = mesh.dtype, mesh.device
        nc = mesh.n_cells
        sm = np.zeros(nc, dtype=bool)
        marr = np.asarray(solid_mask, dtype=bool)
        sm[: len(marr)] = marr
        # interior faces with exactly one solid side
        n_if = mesh.n_interior_faces
        owner = mesh.face_cell0.cpu().numpy()[:n_if]
        nbr = mesh.face_cell1.cpu().numpy()[:n_if]
        so, sn = sm[owner], sm[nbr]
        ibf = np.nonzero(so ^ sn)[0]
        if len(ibf) == 0:
            raise ConfigError("kinetic IBM: solid_mask has no IB faces")
        solid_cell = np.where(sn[ibf], nbr[ibf], owner[ibf])
        fluid_cell = np.where(sn[ibf], owner[ibf], nbr[ibf])
        # face area oriented INTO the solid
        fa = mesh.face_area.cpu().numpy()[ibf]
        fa = np.where(sn[ibf, None], fa, -fa)
        c = np.asarray(q.c, dtype=np.float64)
        mdot_s = fa @ c[:, : mesh.dim].T  # (nfib, N): c.A into the solid
        if pad_faces is not None:
            n_ib = len(ibf)
            if int(pad_faces) < n_ib:
                raise ConfigError(
                    f"kinetic IBM: pad_faces={pad_faces} < {n_ib} IB faces")
            pad = int(pad_faces) - n_ib
            solid_cell = np.pad(solid_cell, (0, pad))
            fluid_cell = np.pad(fluid_cell, (0, pad))
            mdot_s = np.pad(mdot_s, ((0, pad), (0, 0)))
        u_w = np.zeros(3)
        u_w[: len(np.atleast_1d(wall_velocity))] = np.atleast_1d(wall_velocity)
        Mw = q.maxwellian(torch.ones(1, dtype=torch.float64),
                          torch.as_tensor(u_w[None, :]),
                          torch.full((1,), float(wall_temperature),
                                     dtype=torch.float64))[0]
        new = {"ib_pin": torch.from_numpy(sm[:, None]).to(dev),
               "ib_solid_cell": torch.from_numpy(solid_cell.astype(np.int64))
               .to(dev),
               "ib_fluid_cell": torch.from_numpy(fluid_cell.astype(np.int64))
               .to(dev),
               "ib_mdot_s": torch.from_numpy(mdot_s).to(dev, dtype),
               "ib_Mw": Mw.to(dev, dtype)}
        same = all(k in self.params and self.params[k].shape == v.shape
                   for k, v in new.items())
        for k, v in new.items():
            if same:
                self.params[k].copy_(v)
            else:
                self.params[k] = v
        if not same:
            self._drop_compiled()
        # the solid cells start on the wall Maxwellian (density from the
        # current local moments, so that the initial sigma is O(1))
        f = self.state["f"]
        rho = f @ q.tensors(f)[1]
        self.state = dict(self.state, f=torch.where(
            self.params["ib_pin"], rho[:, None] * self.params["ib_Mw"], f))

    def _ib_target(self, params, fv):
        """sigma M_w with sigma from zero net mass flux per solid cell
        (reference: KineticModel.h ConservationofMFSolid)."""
        w = self.quadrature.tensors(fv)[1]
        mdot_s = params["ib_mdot_s"]  # (nfib, N), positive INTO the solid
        Mw = params["ib_Mw"]
        fl = gather_rows(fv, params["ib_fluid_cell"])
        phi_in = torch.sum(torch.clamp(mdot_s, min=0.0) * fl * w[None, :], 1)
        phi_out = torch.sum(torch.clamp(mdot_s, max=0.0) * Mw[None, :]
                            * w[None, :], 1)  # unit-density outgoing flux
        sc = params["ib_solid_cell"]
        zero = torch.zeros(fv.shape[0], dtype=fv.dtype, device=fv.device)
        phi_in_c = zero.index_add(0, sc, phi_in)
        phi_out_c = zero.index_add(0, sc, phi_out)
        solid = phi_out_c < -1e-300
        # the divisor is 1 where unused: reverse mode then sees no 0/0
        den = torch.where(solid, -phi_out_c, 1.0)
        sigma = torch.where(solid, phi_in_c / den, 1.0)
        return sigma[:, None] * Mw[None, :]

    def getIBForceIntegral(self) -> np.ndarray:
        """Momentum flux carried into the immersed body by the upwind
        transport through the IB faces (the IB-face force of the
        reference's FSI drivers, scripts/IB-ESBGKSteady.py)."""
        if "ib_pin" not in self.params:
            raise ConfigError("call set_immersed_boundary() first")
        params = self.params
        f = self.state["f"]
        c, w = self.quadrature.tensors(f)
        mdot_s = params["ib_mdot_s"]
        fl = gather_rows(f, params["ib_fluid_cell"])
        fs = gather_rows(f, params["ib_solid_cell"])
        # into the solid carries the fluid value, out of it the solid's
        flux = torch.clamp(mdot_s, min=0.0) * fl \
            + torch.clamp(mdot_s, max=0.0) * fs
        F = torch.sum(flux * w, 0) @ c[:, : self.mesh.dim]
        return F.cpu().numpy()

    # --- sensitivities (the reference's Tangent atype, models.cpp:10-74) ---

    def _comet_sens_check(self, what: str) -> None:
        opts = self.options
        if not self._initialized:
            raise ConfigError(f"call init() + advance() before {what}")
        if str(opts["solver"]).upper() != "COMET":
            raise ConfigError(f"{what} requires the COMET solver")
        if opts["transient"]:
            raise ConfigError(f"{what}: steady states only")
        if "ib_pin" in self.params:
            raise ConfigError(
                f"{what}: not supported with an immersed boundary (the "
                "sensitivity operator lacks the pinned closure rows)")

    def _comet_R_of(self, mesh, params_all, bcvals):
        """The steady COMET residual as a function of (param overrides, BC
        overrides, the full distribution with its ghosts): its jvp and vjp
        are the exact tangent and adjoint linearizations."""
        V = mesh.cell_volume[:, None]
        me = weakref.proxy(self)

        def R_of(p_sub, b_sub, fv):
            params = dict(params_all, **p_sub)
            bcv = dict(bcvals, **b_sub)
            tau = params["tau"][:, None]
            op = _KineticOperator(mesh, params["dO"], params["dN"], V / tau)
            fg = me._refresh_ghosts(mesh, params, fv, bcv)
            res = V / tau * me._equilibrium(fv) - op.mv(fv)
            return torch.where(op.interior, res, fg - fv)

        return R_of

    def _comet_precond(self, mesh, params_all, op_plain, f0, dsa):
        """The primal step's Woodbury preconditioner at the converged
        state, with the DSA correction when given (shared by the tangent
        and, transposed, the adjoint)."""
        V = mesh.cell_volume[:, None]
        precond = self._woodbury(op_plain, f0, V, params_all["tau"][:, None])
        if dsa is not None:
            from .dsa import DSAPrecond

            precond = DSAPrecond(precond, *dsa)
        return precond

    def _sens_parts(self):
        """(bcvals, f*, the DSA tuple or None, R_of, the plain operator)."""
        mesh, params = self.mesh, self.params
        bcvals = self._resolve_bcvals()
        dsa = self._dsa_tuple() if bool(
            self.options.get("coarseAcceleration", True)) else None
        R_of = self._comet_R_of(mesh, params, bcvals)
        V = mesh.cell_volume[:, None]
        op_plain = _KineticOperator(mesh, params["dO"], params["dN"],
                                    V / params["tau"][:, None])
        return bcvals, self.state["f"].detach(), dsa, R_of, op_plain

    def _mass_weights(self, op_plain, f):
        w = self.quadrature.tensors(f)[1]
        Vc = torch.where(op_plain.interior[:, 0], self.mesh.cell_volume, 0.0)
        return w, Vc

    def solve_adjoint(self, functional, param_keys=(), bc_keys=(),
                      max_iterations: int = 400,
                      relative_tolerance: float = 1e-10):
        """Reverse-mode gradients of a scalar functional of the converged
        steady COMET distribution with respect to parameter fields and BC
        values, from ONE transposed solve.

        ``functional(f_interior) -> scalar tensor`` ((n_interior, N)).
        ``param_keys``: keys of ``self.params`` (per-cell fields come back
        on the interior cells); ``bc_keys``: "group:entry" (per face).
        The transpose of the tangent's fixed-total-mass projection is
        applied to the functional's gradient, so <grad, dp> equals
        dJ(tangent(dp)) on the singular wall-bounded mass family.  The
        transposed system runs BiCGStab on ``TransposedOperator`` of the
        COMET operator (one reverse-mode product of the residual per
        application) with the primal's Woodbury(+DSA) preconditioner
        transposed (``TransposedPrecond``)."""
        self._comet_sens_check("solve_adjoint")
        mesh = self.mesh
        bcvals, f_st, dsa, R_of, op_plain = self._sens_parts()
        p_keys, b_keys = list(param_keys), list(bc_keys)
        for k in p_keys:
            if k not in self.params:
                raise ConfigError(f"solve_adjoint: unknown param {k!r}")
        for k in b_keys:
            if k not in bcvals:
                raise ConfigError(f"solve_adjoint: unknown BC entry {k!r}")
        n_int = mesh.n_interior_cells
        with torch.enable_grad():
            fj = f_st.clone().requires_grad_(True)
            (gJ,) = torch.autograd.grad(functional(fj[:n_int]), fj)
        alive = mesh.cf_mask.any(dim=0)
        gJ = torch.where(alive[:, None], gJ, 0.0)
        w, Vc = self._mass_weights(op_plain, f_st)
        vw = Vc[:, None] * w[None, :]
        m0 = torch.clamp(torch.sum(Vc * (f_st @ w)), min=1e-300)
        gJp = gJ - (torch.sum(gJ * f_st) / m0) * vw
        op = _JVPOperator(op_plain, lambda fv: R_of({}, {}, fv), f_st,
                          "forward")
        precond = self._comet_precond(mesh, self.params, op_plain, f_st, dsa)
        solver = BiCGStab(preconditioner=TransposedPrecond(precond),
                          relative_tolerance=relative_tolerance,
                          max_iterations=max_iterations,
                          # as the primal's: near convergence the residual
                          # turns orthogonal to the shadow r0 (without the
                          # restart a 1e-16 change to the transposed
                          # products can stop the solve near 3e-9,
                          # scripts/kinetic_duality.py)
                          stall_restart=True)
        solver.exit_every = TRANSPOSE_EXIT_EVERY
        lam, self.adjoint_stats = solver.solve_fn(TransposedOperator(op), gJp,
                                                  torch.zeros_like(f_st))
        with torch.enable_grad():
            base_p = {k: self.params[k].detach().clone().requires_grad_(True)
                      for k in p_keys}
            base_b = {k: bcvals[k].detach().clone().requires_grad_(True)
                      for k in b_keys}
            r = R_of(base_p, base_b, f_st)
            leaves = list(base_p.values()) + list(base_b.values())
            grads = torch.autograd.grad(r, leaves, lam, allow_unused=True) \
                if leaves else []
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves, grads)]
        out = {}
        for k, g in zip(p_keys + b_keys, grads):
            if k in p_keys and g.ndim >= 1 and g.shape[0] == mesh.n_cells:
                g = g[:n_int]
            out[k] = g.cpu().numpy()
        return out

    def solve_tangent(self, param_tangents=None, bc_tangents=None,
                      max_iterations: int = 400,
                      relative_tolerance: float = 1e-10):
        """Forward sensitivity d(f)/d(params, BCs) . direction at the
        converged steady COMET state (reference: the esbgk KineticModel
        with the Tangent atype, models.cpp:10-74): J df = dR/dp . dp with
        the primal step's exact Jacobian and Woodbury(+DSA) preconditioner,
        projected onto the fixed-total-mass manifold.  ``param_tangents``:
        keys of ``self.params`` ((n_interior,) arrays are zero-padded);
        ``bc_tangents``: "group:entry".  Returns d(f) on the interior
        cells, (n_interior, N) numpy."""
        self._comet_sens_check("solve_tangent")
        df = self._tangent(param_tangents, bc_tangents, max_iterations,
                           relative_tolerance)
        return df[: self.mesh.n_interior_cells].cpu().numpy()

    def _tangent(self, param_tangents, bc_tangents, max_iterations,
                 relative_tolerance):
        mesh, params = self.mesh, self.params
        bcvals, f_st, dsa, R_of, op_plain = self._sens_parts()

        def pad_param(key, v):
            ref = params[key]
            v = torch.as_tensor(np.asarray(v, dtype=np.float64)) \
                if not isinstance(v, torch.Tensor) else v
            v = v.to(ref.device, ref.dtype)
            if v.shape != ref.shape:
                v = torch.zeros_like(ref).index_copy(
                    0, torch.arange(v.shape[0], device=ref.device), v)
            return v

        base_p, tan_p, base_b, tan_b = {}, {}, {}, {}
        for k, v in (param_tangents or {}).items():
            if k not in params:
                raise ConfigError(f"solve_tangent: unknown param {k!r}")
            base_p[k] = params[k]
            tan_p[k] = pad_param(k, v)
        for k, v in (bc_tangents or {}).items():
            if k not in bcvals:
                raise ConfigError(f"solve_tangent: unknown BC entry {k!r}")
            ref = bcvals[k]
            base_b[k] = ref
            tan_b[k] = torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
                ref.device, ref.dtype).expand(ref.shape).clone()
        _, dr = torch.func.jvp(lambda p, b: R_of(p, b, f_st),
                               (base_p, base_b), (tan_p, tan_b))
        op = _JVPOperator(op_plain, lambda fv: R_of({}, {}, fv), f_st,
                          product_mode(f_st))
        precond = self._comet_precond(mesh, params, op_plain, f_st, dsa)
        solver = BiCGStab(preconditioner=precond,
                          relative_tolerance=relative_tolerance,
                          max_iterations=max_iterations)
        solver.exit_every = JFNK_EXIT_EVERY
        df, self.tangent_stats = solver.solve_fn(op, dr,
                                                 torch.zeros_like(f_st))
        # the mass-family null direction projected out, as the primal does
        w, Vc = self._mass_weights(op_plain, f_st)
        dm = torch.sum(Vc * (df @ w))
        m0 = torch.sum(Vc * (f_st @ w))
        return df - (dm / torch.clamp(m0, min=1e-300)) * f_st

    def solve_tangent_moments(self, param_tangents=None, bc_tangents=None):
        """d(rho, u, T)/d(params, BCs) . direction: the chain rule of
        ``moments()`` through ``solve_tangent``, per interior cell."""
        self._comet_sens_check("solve_tangent")
        n = self.mesh.n_interior_cells
        df = self._tangent(param_tangents, bc_tangents, 400, 1e-10)[:n]
        f0 = self.state["f"][:n]
        _, dmom = torch.func.jvp(lambda f: self.moments(f), (f0,), (df,))
        return tuple(d.cpu().numpy() for d in dmom)


def _det3(M):
    """Determinants of (..., 3, 3) blocks by cofactors along the first
    row."""
    m = M
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))
