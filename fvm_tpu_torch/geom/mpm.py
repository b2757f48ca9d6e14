"""Material-point method: particle container, explicit solver, FVM coupling
(counterpart of ``fvm_tpu/geom/mpm.py``).

  - ``MPM``: the particle container and its file I/O (reference:
    MPM_Particles.h:15, MPM_Particles.cpp Impl/read*); files are
    byte-identical to the JAX package's;
  - ``MPMSolver``: the material-point solve the reference delegates to an
    external program over MPI ports, in-process here: explicit MLS-MPM
    (quadratic B-splines, APIC transfer, Neo-Hookean stress) on a
    structured background grid.  A substep is P2G (``index_add_`` over the
    3^dim stencil offsets), the grid update with the sticky box, G2P and
    the advection, plain PyTorch on the state's device (the JAX package
    computes it in XLA, no Pallas kernel).  ``advance`` runs its fixed
    number of substeps eagerly on the CPU and as one CUDA graph replay on
    a GPU (``models/chunk.Runner``), captured once per substep count;
  - ``MPMCoupling``: the updateMPM/acceptMPM exchange (reference:
    MPMCoupling.h:18) as in-process calls: the FVM side marks solid/IB
    cells from the particle cloud (``geom.ibm.cell_mark_particles``) and
    the particles sample the FVM fields at their positions.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..config import as_dtype, resolve_device
from ..models.chunk import Runner
from ..ops.bell import small_inv


# ---------------------------------------------------------------------------
# particle container (reference: MPM_Particles.h)


class MPM:
    """Particle cloud: coordinates, velocities, types, temperatures.

    File format (reference MPM_Particles.cpp setandwriteParticles /
    read{Coordinates,Velocities,Types,Temperatures}): a text file holding
    ``count``, then count coordinate triplets, count velocity triplets,
    count integer types (1 = surface, 0 = interior) and count
    temperatures.  Trailing sections may be absent (zeros are assumed).
    """

    def __init__(self, filename: str | None = None):
        self._coordinates = np.zeros((0, 3))
        self._velocities = np.zeros((0, 3))
        self._types = np.zeros(0, dtype=np.int32)
        self._temperatures = np.zeros(0)
        if filename is not None:
            self.Impl(filename)

    def Init(self, coordinates, velocities, types, temperatures):
        self._coordinates = np.asarray(coordinates,
                                       dtype=np.float64).reshape(-1, 3)
        n = len(self._coordinates)

        def _take(a, shape, dtype):
            if a is None:
                return np.zeros(shape, dtype=dtype)
            return np.asarray(a, dtype=dtype).reshape(shape)

        self._velocities = _take(velocities, (n, 3), np.float64)
        self._types = _take(types, (n,), np.int32)
        self._temperatures = _take(temperatures, (n,), np.float64)

    def getParticles(self) -> int:
        return len(self._coordinates)

    def getCoordinates(self):
        return self._coordinates

    def getVelocities(self):
        return self._velocities

    def getTypes(self):
        return self._types

    def getTemperatures(self):
        return self._temperatures

    def Impl(self, filename: str) -> None:
        with open(filename) as f:
            tokens = f.read().split()
        n = int(tokens[0])
        flat = np.array(tokens[1:], dtype=np.float64)
        out, pos = [], 0
        for k in (3 * n, 3 * n, n, n):
            if pos + k <= len(flat):
                out.append(flat[pos: pos + k])
                pos += k
            else:
                out.append(None)
        vel = out[1].reshape(n, 3) if out[1] is not None else None
        self.Init(out[0].reshape(n, 3), vel, out[2], out[3])

    def setandwriteParticles(self, filename: str) -> None:
        n = self.getParticles()
        with open(filename, "w") as f:
            f.write(f"{n}\n")
            for a in (self._coordinates, self._velocities):
                for row in a:
                    f.write("%.6f\t%.6f\t%.6f\n" % tuple(row))
            for t in self._types:
                f.write(f"{int(t)}\n")
            for t in self._temperatures:
                f.write("%.6f\n" % t)


# ---------------------------------------------------------------------------
# explicit MLS-MPM solver


STATE_KEYS = ("x", "v", "F", "C", "m", "V0")


class MPMSolver:
    """Explicit material-point solver on a structured background grid.

    Quadratic B-spline shape functions, APIC particle <-> grid transfer and
    Neo-Hookean elasticity (MLS-MPM force form).  The grid is the box
    [origin, origin + dims * h]; its outermost node layers are sticky
    (zero velocity).  The state (``x``, ``v``, ``F``, ``C``, ``m``,
    ``V0``) lives on ``device`` (``"cuda"`` unless given) in ``dtype``
    (the configured default unless given).
    """

    def __init__(self, origin, h: float, dims, dim: int | None = None,
                 youngs: float = 1e4, poisson: float = 0.3,
                 density: float = 1000.0, gravity=None,
                 particles_per_cell: int = 4, device=None, dtype=None):
        self.dim = int(dim if dim is not None else len(dims))
        self.origin = np.asarray(origin, dtype=np.float64)[: self.dim]
        self.h = float(h)
        self.dims = tuple(int(d) for d in dims)[: self.dim]  # cells per axis
        self.nodes = tuple(d + 1 for d in self.dims)
        self.E = float(youngs)
        self.nu = float(poisson)
        self.mu0 = self.E / (2 * (1 + self.nu))
        self.lam0 = self.E * self.nu / ((1 + self.nu) * (1 - 2 * self.nu))
        self.rho = float(density)
        g = np.zeros(self.dim)
        if gravity is not None:
            g[:] = np.asarray(gravity, dtype=np.float64)[: self.dim]
        self.gravity = g
        self.ppc = int(particles_per_cell)
        self.device = resolve_device(device)
        self.dtype = as_dtype(dtype)
        self.state = None
        self.time = 0.0
        self._runners: dict = {}

    # -- seeding -----------------------------------------------------------

    def seed_box(self, lo, hi, velocity=None):
        """Fill a box with ppc particles per cell (a regular sub-lattice)."""
        lo = np.asarray(lo, dtype=np.float64)[: self.dim]
        hi = np.asarray(hi, dtype=np.float64)[: self.dim]
        per_axis = max(1, int(round(self.ppc ** (1.0 / self.dim))))
        sub = (np.arange(per_axis) + 0.5) / per_axis * self.h
        axes = []
        for d in range(self.dim):
            base = np.arange(lo[d], hi[d] - 1e-12, self.h)
            axes.append((base[:, None] + sub[None, :]).ravel())
        grids = np.meshgrid(*axes, indexing="ij")
        x = np.stack([g.ravel() for g in grids], axis=1)
        x = x[np.all((x >= lo) & (x < hi), axis=1)]
        v = np.zeros_like(x)
        if velocity is not None:
            v[:] = np.asarray(velocity, dtype=np.float64)[: self.dim]
        self.add_particles(x, v)
        return len(x)

    def add_particles(self, x, v=None, mass=None):
        x = np.asarray(x, dtype=np.float64).reshape(-1, self.dim)
        n = len(x)
        v = (np.zeros((n, self.dim)) if v is None
             else np.asarray(v, dtype=np.float64).reshape(n, self.dim))
        vol = self.h**self.dim / self.ppc
        m = np.full(n, self.rho * vol) if mass is None else np.asarray(mass)
        F = np.broadcast_to(np.eye(self.dim), (n, self.dim, self.dim))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64)
                                   ).to(self.device, self.dtype)

        new = {"x": t(x), "v": t(v), "F": t(F),
               "C": t(np.zeros((n, self.dim, self.dim))), "m": t(m),
               "V0": t(np.full(n, vol))}
        if self.state is None:
            self.state = new
        else:
            self.state = {k: torch.cat([self.state[k], new[k]]) for k in new}

    # -- reference-container interop ---------------------------------------

    @classmethod
    def from_particles(cls, mpm: MPM, h: float, origin, dims, **kw):
        """A solver seeded from an MPM container's cloud."""
        solver = cls(origin, h, dims, **kw)
        dim = solver.dim
        solver.add_particles(mpm.getCoordinates()[:, :dim],
                             mpm.getVelocities()[:, :dim])
        return solver

    def export_particles(self, mpm: MPM) -> None:
        """Write the solver's state back into a reference-style container."""
        n = self.state["x"].shape[0]
        coords = np.zeros((n, 3))
        vel = np.zeros((n, 3))
        coords[:, : self.dim] = self.state["x"].cpu().numpy()
        vel[:, : self.dim] = self.state["v"].cpu().numpy()
        same = mpm.getParticles() == n
        types = mpm.getTypes() if same else np.zeros(n, dtype=np.int32)
        temps = mpm.getTemperatures() if same else np.zeros(n)
        mpm.Init(coords, vel, types, temps)

    # -- stepping ------------------------------------------------------------

    def cfl_dt(self, safety: float = 0.3) -> float:
        """Elastic-wave CFL: dt <= safety h / c, c = sqrt(E / rho)."""
        c = np.sqrt(self.E / self.rho) + 1e-12
        vmax = float(torch.linalg.vector_norm(self.state["v"], dim=1).max())
        return safety * self.h / max(c, vmax, 1e-12)

    def _runner(self, substeps: int) -> Runner:
        runner = self._runners.get(substeps)
        if runner is None:
            consts = _grid_constants(self.dim, self.h, self.origin,
                                     self.nodes, self.gravity, self.device,
                                     self.dtype)
            runner = Runner(functools.partial(
                _advance_fn, consts, self.mu0, self.lam0), substeps,
                self.device)
            self._runners[substeps] = runner
        return runner

    def advance(self, dt: float, substeps: int | None = None):
        """Advance by ``dt`` in CFL-bounded substeps of dt / substeps."""
        if substeps is None:
            substeps = max(1, int(np.ceil(dt / self.cfl_dt())))
        self.state = self._runner(int(substeps))(
            {"state": self.state}, {"sdt": dt / substeps})
        self.time += dt
        return substeps

    def kinetic_energy(self) -> float:
        s = self.state
        return float(0.5 * torch.sum(s["m"][:, None] * s["v"] ** 2))

    def momentum(self) -> np.ndarray:
        s = self.state
        return torch.sum(s["m"][:, None] * s["v"], dim=0).cpu().numpy()


def _bspline_weights(fx):
    """Quadratic B-spline weights of offsets 0, 1, 2 about the base node;
    fx in [0.5, 1.5) is the position minus the base node in grid units.
    Returns (3, n, dim)."""
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    return torch.stack([w0, w1, w2])


def _grid_constants(dim, h, origin, nodes, gravity, device, dtype):
    """The substep's static tensors, made before any capture (a tensor
    made from host values inside a capture would be a host copy)."""
    nn = int(np.prod(nodes))
    strides = np.cumprod((1,) + nodes[::-1][:-1])[::-1].copy()  # C order
    offsets = list(itertools.product(range(3), repeat=dim))
    idx_nd = np.stack(np.unravel_index(np.arange(nn), nodes), axis=1)
    boundary = np.zeros(nn, dtype=bool)
    for d in range(dim):
        boundary |= (idx_nd[:, d] <= 0) | (idx_nd[:, d] >= nodes[d] - 1)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device, dt)

    return {
        "dim": dim, "h": h, "nn": nn, "offsets": offsets,
        "org": t(np.asarray(origin, dtype=np.float64)),
        "grav": t(np.asarray(gravity, dtype=np.float64)),
        "strides": t(strides.astype(np.int64), torch.int64),
        "flat_off": [int(np.dot(o, strides)) for o in offsets],
        "off_t": [t(np.asarray(o, dtype=np.float64)) for o in offsets],
        "boundary": t(boundary, torch.bool),
        "eye": torch.eye(dim, dtype=dtype, device=device),
    }


def _substep(c, mu0, lam0, st, sdt):
    """One MLS-MPM substep (``fvm_tpu/geom/mpm.py:270-363``)."""
    x, v, F, C, m, V0 = (st[k] for k in STATE_KEYS)
    dim, h = c["dim"], c["h"]
    gx = (x - c["org"]) / h
    base = torch.floor(gx - 0.5).to(torch.int64)  # (np, dim)
    fx = gx - base
    w = _bspline_weights(fx)  # (3, np, dim)

    # Neo-Hookean first Piola-Kirchhoff stress, MLS-MPM force coefficient
    if dim == 2:
        J = F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]
    else:
        J = (F[:, 0, 0] * (F[:, 1, 1] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 1])
             - F[:, 0, 1] * (F[:, 1, 0] * F[:, 2, 2]
                             - F[:, 1, 2] * F[:, 2, 0])
             + F[:, 0, 2] * (F[:, 1, 0] * F[:, 2, 1]
                             - F[:, 1, 1] * F[:, 2, 0]))
    FinvT = small_inv(F).transpose(-1, -2)
    P = mu0 * (F - FinvT) + lam0 * torch.log(
        torch.clamp(J, min=1e-6))[:, None, None] * FinvT
    stress = (-sdt * V0 * 4.0 / (h * h))[:, None, None] * torch.einsum(
        "nij,nkj->nik", P, F)
    affine = stress + m[:, None, None] * C

    def weight(off):
        wgt = torch.ones_like(m)
        for d in range(dim):
            wgt = wgt * w[off[d], :, d]
        return wgt

    # P2G
    grid_mv = torch.zeros((c["nn"], dim), dtype=x.dtype, device=x.device)
    grid_m = torch.zeros(c["nn"], dtype=x.dtype, device=x.device)
    flat_base = (base * c["strides"]).sum(dim=1)
    for off, foff, off_t in zip(c["offsets"], c["flat_off"], c["off_t"]):
        wgt = weight(off)
        dpos = (off_t[None, :] - fx) * h
        idx = flat_base + foff
        mv = wgt[:, None] * (m[:, None] * v
                             + torch.einsum("nij,nj->ni", affine, dpos))
        grid_mv.index_add_(0, idx, mv)
        grid_m.index_add_(0, idx, wgt * m)

    gv = grid_mv / torch.clamp(grid_m, min=1e-30)[:, None]
    gv = gv + sdt * c["grav"][None, :]
    # sticky box: zero velocity on the outermost node layers
    gv = torch.where(c["boundary"][:, None], 0.0, gv)
    gv = torch.where(grid_m[:, None] > 0, gv, 0.0)

    # G2P
    v_new = torch.zeros_like(v)
    C_new = torch.zeros_like(C)
    for off, foff, off_t in zip(c["offsets"], c["flat_off"], c["off_t"]):
        wgt = weight(off)
        dpos = (off_t[None, :] - fx) * h
        gvi = gv[flat_base + foff]
        v_new = v_new + wgt[:, None] * gvi
        C_new = C_new + (4.0 / (h * h)) * wgt[:, None, None] * torch.einsum(
            "ni,nj->nij", gvi, dpos)
    x_new = x + sdt * v_new
    F_new = torch.einsum("nij,njk->nik", c["eye"] + sdt * C_new, F)
    return dict(st, x=x_new, v=v_new, F=F_new, C=C_new)


def _advance_fn(consts, mu0, lam0, trips: int):
    """``trips`` substeps: the fixed-trip loop ``models/chunk.Runner``
    captures (the JAX package's ``lax.scan``)."""

    def run(inputs, scal):
        st = inputs["state"]
        sdt = scal["sdt"].to(st["x"].dtype)
        for _ in range(trips):
            st = _substep(consts, mu0, lam0, st, sdt)
        return st

    return run


# ---------------------------------------------------------------------------
# FVM coupling (reference: MPMCoupling.h updateMPM/acceptMPM)


class MPMCoupling:
    """In-process MPM <-> FVM exchange (the reference couples a separate
    MPM executable over MPI ports):

      updateMPM(dt): advance the material points by the FVM time step and
        refresh the container (the positions and velocities the FVM side
        reads);
      acceptMPM(mesh): mark the FVM mesh's cells covered by the particle
        cloud as solid / IB (``geom.ibm.cell_mark_particles``), for the
        model's ``set_immersed_boundary``.
    """

    def __init__(self, mpm: MPM, solver: MPMSolver):
        self.mpm = mpm
        self.solver = solver
        self.timeMPM = 0.0

    def updateMPM(self, dt: float) -> None:
        self.solver.advance(dt)
        self.solver.export_particles(self.mpm)
        self.timeMPM = self.solver.time

    def acceptMPM(self, host_mesh, radius: float | None = None) -> np.ndarray:
        """The per-cell ibType array (``geom.ibm.IBType``) of the host mesh
        under the particle cloud."""
        from .ibm import cell_mark_particles

        r = self.solver.h if radius is None else radius
        coords = self.mpm.getCoordinates()[:, : host_mesh.dim]
        return cell_mark_particles(host_mesh, coords, r)

    def sample_particle_field(self, host_mesh, cell_values) -> np.ndarray:
        """An FVM cell field at the particle positions (nearest cell, by
        the geometry search tree): the data the reference ships back over
        the MPM port."""
        from ..mesh.metrics import compute_geometry
        from .search import KSearchTree

        cc = compute_geometry(host_mesh).cell_centroid[
            : host_mesh.n_interior_cells]
        pts = self.mpm.getCoordinates()[:, : host_mesh.dim]
        _, idx = KSearchTree(cc).query_batch(pts, 1)
        return np.asarray(cell_values)[np.asarray(idx).reshape(-1)]
