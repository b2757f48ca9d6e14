"""Model base class (counterpart of ``fvm_tpu/models/base.py``).

The reference's ``Model`` (Model.h:13-26) plus the conventions all of
its models share: per-boundary BC maps keyed by group name and ident, a VC
dict, a ModelOptions dict, ``init()`` / ``advance(n)``, double-shell
interface closures (``interface``) and persistence
(``getPersistenceData`` / ``restart``).

All mutable state lives in ``self.state`` and ``self.params``, plain dicts
of tensors on the mesh's device (the JAX package's pytrees).  ``advance``
runs one linearize+solve step per outer iteration; with the option
``residualSync`` False (and ``verbose`` off) the residual norms stay
device tensors and no convergence check reads them back.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from ..core import rlog
from ..core.options import BoundaryCondition, ModelOptions
from ..exceptions import ConfigError, SolverError
from ..ops import assembly
from .chunk import Runner


class Model:
    name = "Model"

    def __init__(self, mesh):
        self.mesh = mesh
        self.state: dict = {}
        self.params: dict = {}
        self.options = self._make_options()
        # bc map keyed by both group name and ident (reference scripts use
        # ids, bc[zone.ident]; the generators use names)
        self.bc: dict = {}
        for g in mesh.boundary_groups():
            bc = self._make_bc()
            self.bc[g[1]] = bc
            self.bc[g[0]] = bc
        # double-shell interface closures (Mesh.make_interface): per
        # interface name an options dict (core/interfaces.py), e.g.
        # {"type": "jump", "A_coeff": a, "B_coeff": b}; an absent entry is
        # the continuous interface (A = 1, B = 0)
        self.interface: dict = {}
        ifaces = getattr(mesh, "interfaces", ())
        if ifaces and not getattr(self, "_supports_interfaces", False):
            raise ConfigError(
                f"{self.name}: mesh has double-shell interfaces "
                f"({[i[0] for i in ifaces]}) but this model does not "
                "support them")
        self._initialized = False
        # chunk (and coupled-loop) runners, dropped by init()
        self._runners: dict = {}

    # --- field helpers ----------------------------------------------------

    def _cell_field(self, vcdict, key, extend_ghosts=False):
        """Resolve a VC entry to an (nc,) cell tensor on the mesh's device."""
        from ..core import bcs as bck

        mesh = self.mesh
        arr = vcdict.resolve(key, mesh.n_cells, mesh.dtype, mesh.device)
        if extend_ghosts:
            arr = bck.extend_to_ghosts(mesh, arr)
        return arr

    def _full_cells(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_cells,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _full_faces(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_faces,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _resolve_bcvals(self):
        """BC value dict: ``"<group>:<key>"`` -> per-face tensor."""
        mesh = self.mesh
        vals = {}
        for g, bc in self._group_bcs():
            for key in bc:
                vals[f"{g[1]}:{key}"] = bc.resolve(key, g[4], mesh.dtype,
                                                   mesh.device)
            vals[f"{g[1]}:__valid"] = torch.ones(g[4], dtype=torch.bool,
                                                 device=mesh.device)
        return vals

    # --- subclass hooks ---------------------------------------------------

    def _make_options(self) -> ModelOptions:
        return ModelOptions()

    def _make_bc(self) -> BoundaryCondition:
        return BoundaryCondition()

    def init(self) -> None:
        raise NotImplementedError

    def advance(self, niter: int = 1):
        raise NotImplementedError

    # --- common helpers ---------------------------------------------------

    def _guard_residual(self, rnorm, it) -> None:
        """trapNonfinite option: raise SolverError on a NaN/Inf outer
        residual (the reference's SIGFPE -> CException, baseExt.i:25-30)."""
        if self.options.get("trapNonfinite") and not math.isfinite(rnorm):
            raise SolverError(
                f"{self.name}: non-finite residual {rnorm!r} at outer "
                f"iteration {it} (trapNonfinite)"
            )

    def _log_iteration(self, msg: str) -> None:
        """Per-iteration residual line: printed when verbose, else sent to
        the 'model' rlog channel (reference: rlog info channel and
        printNormalizedResiduals)."""
        if self.options.get("verbose"):
            print(msg)
        else:
            rlog.model(msg)

    def _phase(self, name: str):
        """Phase tracing context for advance loops, active when the model
        option ``profile`` is set (reference: per-solver timing dumps)."""
        if self.options.get("profile"):
            return rlog.tracer.phase(f"{self.name}/{name}")
        return contextlib.nullcontext()

    # --- post-processing helpers (single device) --------------------------

    def _map_mesh(self, fn, *args):
        """``fn(mesh, *args)`` (the JAX package vmaps it over shards when
        distributed, ``fvm_tpu/models/base.py:221``)."""
        return fn(self.mesh, *args)

    def _sum_group(self, g, F):
        """Sum a per-face quantity (nf, ...) over a boundary group's faces
        (``fvm_tpu/models/base.py:229``)."""
        return F[self.mesh.group_faces(g)].sum(dim=0)

    def _group(self, group_name):
        """A boundary group's tuple, by name or as given."""
        return (self.mesh.group_by_name(group_name)
                if isinstance(group_name, str) else group_name)

    # --- immersed boundary, mask form (fvm_tpu/models/base.py:287-342,
    # 462-505; the reference's GenericIBDiscretization.h consumers) --------

    def _set_immersed_boundary(self, mask, value, stencil=None,
                               implicit=True) -> None:
        """Pin the cells of ``mask`` (per cell, interior ordering) to
        ``value`` (a scalar or per-cell (n,) / (n, m) body value), padded to
        the device mesh's cells.  Call after ``init()``, which rebuilds the
        params.  The step and its captured graphs are dropped, so the next
        advance runs (and captures) the step with the IB rows."""
        if not self._initialized:
            # init() rebuilds self.params and would silently wipe the masks
            raise ConfigError("call init() before set_immersed_boundary()")
        if stencil is not None:
            raise ConfigError(
                f"{self.name}: the stencil form of the immersed boundary "
                "(IBManager interpolation rows) is not ported yet (ROADMAP "
                "queue 1 item 9); pass the mask form")
        mesh = self.mesh
        nc = mesh.n_cells
        m = np.zeros(nc, dtype=bool)
        marr = np.asarray(mask, dtype=bool)
        m[: len(marr)] = marr  # the device mesh appends ghost/padding cells
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        v = torch.as_tensor(np.asarray(value, dtype=np.float64)).to(
            mesh.dtype)
        if v.ndim == 0:
            v = v.expand(nc).clone()
        elif v.shape[0] != nc:
            vv = torch.zeros((nc,) + tuple(v.shape[1:]), dtype=mesh.dtype)
            vv[: v.shape[0]] = v
            v = vv
        self.params["ib_mask"] = torch.from_numpy(m).to(mesh.device)
        self.params["ib_value"] = v.to(mesh.device)
        self._drop_compiled()

    def _drop_compiled(self) -> None:
        """Rebuild the step and drop the runners (and their CUDA graphs)
        after a change of params keys: a graph freezes the params it was
        captured with, as the JAX package's jitted step retraces on a new
        params pytree."""
        self._step = self._build_step()
        self._runners = {}

    def _apply_ib(self, mesh, params, A, r, phi):
        """Immersed-boundary rows: the masked cells pinned to their value
        (``assembly.dirichlet_cells``)."""
        if "ib_mask" in params:
            A, r = assembly.dirichlet_cells(A, r, params["ib_mask"],
                                            params["ib_value"], phi)
        return A, r

    # --- sensitivity plumbing (fvm_tpu/models/base.py:508-570; the
    # reference instantiates every model with the Tangent atype,
    # models.cpp:10-74): the tangent inputs are dicts fed to torch.func.jvp

    def _pad_cell_tangent(self, ref, v):
        """A per-cell value (a scalar, or an (n_interior,) or full-shape
        array) at ``ref``'s shape, interior arrays zero-padded and
        ghost-extended like the primal parameters: the tangents' and
        adjoints' parameter directions and the Monte-Carlo samples
        (``models/sensitivity.py``)."""
        from ..core import bcs as bck

        v = as_tensor_like(v, ref)
        if v.shape == ref.shape:
            return v
        if v.ndim == 0:
            return torch.full(ref.shape, float(v), dtype=ref.dtype,
                              device=ref.device)
        out = torch.zeros(ref.shape, dtype=ref.dtype, device=ref.device)
        out[: v.shape[0]] = v
        return bck.extend_to_ghosts(self.mesh, out)

    def _map_param_tangents(self, t: dict) -> dict:
        """Hook: translate derived tangent keys (e.g. Young's modulus) into
        tangents of ``self.params`` entries.  Default: identity."""
        return t

    def _tangent_inputs(self, param_tangents, bc_tangents, bcvals):
        """((p_base, b_base), (p_tan, b_tan)): sub-dicts holding only the
        perturbed entries; the jvp runs over these with the rest of params
        and bcvals held fixed."""
        t = self._map_param_tangents(dict(param_tangents or {}))
        p_base, p_tan = {}, {}
        for k, v in t.items():
            if k not in self.params:
                raise ConfigError(
                    f"{self.name}.solve_tangent: unknown parameter {k!r} "
                    f"(have {sorted(self.params)})")
            p_base[k] = self.params[k]
            p_tan[k] = self._pad_cell_tangent(self.params[k], v)
        b_base, b_tan = {}, {}
        for k, v in (bc_tangents or {}).items():
            if k not in bcvals:
                raise ConfigError(
                    f"{self.name}.solve_tangent: unknown BC entry {k!r}")
            ref = bcvals[k]
            b_base[k] = ref
            b_tan[k] = as_tensor_like(v, ref).expand(ref.shape).clone()
        return (p_base, b_base), (p_tan, b_tan)

    # --- chunked outer loop ----------------------------------------------
    #
    # outerChunk > 1 runs up to that many outer (linearize/solve/update)
    # iterations per dispatch with the convergence test on the device, and
    # reads one residual block back per chunk instead of one scalar per
    # outer iteration (the JAX package's lax.while_loop,
    # fvm_tpu/models/base.py:604-747; the reference's advance loops, e.g.
    # ThermalModel_impl.h:424-454, pay no per-iteration host sync either).
    # The chunk is a fixed number of trips in the frozen form; on a CUDA
    # mesh it is one CUDA graph replay (models/chunk.py).

    def _chunk_size(self, niter: int) -> int:
        """The active outer-chunk size for advance(niter) (0: the classic
        per-iteration loop)."""
        chunk = int(self.options.get("outerChunk") or 0)
        return chunk if chunk > 1 and niter > 1 else 0

    def _chunk_runner(self, chunk: int) -> Runner:
        """The chunk of ``chunk`` trips, built (and on a CUDA mesh
        captured) once per chunk size until the next ``init()``."""
        runner = self._runners.get(("chunk", chunk))
        if runner is None:
            # built from the step, mesh and params, not from the model,
            # which holds the runner
            runner = Runner(functools.partial(
                self._chunk_fn, self._step, self.mesh, self.params), chunk,
                self.mesh.device)
            self._runners[("chunk", chunk)] = runner
        return runner

    @staticmethod
    def _chunk_fn(step, mesh, params, trips: int):
        """``trips`` outer steps with the atol/rtol test on ``rnorm``
        against the initial norm (``scal["norm0"]``, or the first step's
        norm when it is 0); returns (state, packed) with packed = [the
        trips' norms (NaN where frozen), count, done, norm0], float64."""

        def chunk_step(inputs, scal):
            st, bcvals = inputs["state"], inputs["bcvals"]
            count = torch.zeros((), dtype=torch.int64, device=mesh.device)
            done = torch.zeros((), dtype=torch.bool, device=mesh.device)
            hist = []
            for j in range(trips):
                st_n, aux = step(mesh, params, st, bcvals)
                rn = aux["rnorm"]
                if j == 0:
                    n0 = torch.where(scal["norm0"] > 0,
                                     scal["norm0"].to(rn.dtype), rn)
                    n0t = torch.clamp(n0, min=torch.finfo(rn.dtype).tiny)
                active = (scal["nmax"] > j) & ~done
                st = freeze(active, st_n, st)
                hist.append(torch.where(active, rn, float("nan")))
                count = count + active
                done = done | (active & ((rn < scal["atol"])
                                         | (rn / n0t < scal["rtol"])))
            return st, pack(hist, count, done, n0)

        return chunk_step

    def _advance_chunked(self, niter: int, chunk: int, bcvals):
        """Chunked advance: ceil(niter / chunk) dispatches at most, the
        same residual history and early exit as the per-iteration loop."""
        opts = self.options
        runner = self._chunk_runner(chunk)
        hist = ResidualHistory()
        it0 = 0
        while it0 < niter:
            scal = {
                "nmax": min(chunk, niter - it0),
                "atol": float(opts["absoluteTolerance"]),
                "rtol": float(opts["relativeTolerance"]),
                "norm0": float(self._initial_norm or 0.0),
            }
            with self._phase("step"):
                self.state, packed = runner(
                    {"state": self.state, "bcvals": bcvals}, scal)
            rns, cnt, done, (n0,) = unpack(packed, chunk)
            if self._initial_norm is None or self._initial_norm == 0.0:
                self._initial_norm = n0
            for j, rn in enumerate(rns[:cnt]):
                self._guard_residual(rn, it0 + j)
                hist.append((it0 + j, rn))
                self._log_iteration(f"{self.name}: {it0 + j}: {rn:.6e}")
            it0 += cnt
            if done:
                break
        return hist

    def _periodic_group_src(self, g):
        """The partner owner cell of each ghost of a 'Periodic' group."""
        mesh = self.mesh
        if mesh.periodic_ghost is None:
            raise ConfigError(
                f"group {g[1]!r}: bc_type 'Periodic' needs "
                "mesh.make_periodic() before build_device_mesh()")
        lut = dict(zip(mesh.periodic_ghost.tolist(),
                       mesh.periodic_src.tolist()))
        gc = mesh.ghost_cells_of_group(g)
        try:
            src = [lut[c] for c in range(gc.start, gc.stop)]
        except KeyError as e:
            raise ConfigError(
                f"group {g[1]!r}: not all faces are periodic-paired") from e
        return torch.tensor(src, dtype=torch.int64, device=mesh.device)

    def _group_bcs(self):
        """Yield (group_tuple, bc) for each boundary group; double-shell
        interface groups are skipped (their ghost rows carry the balance
        and closure equations of core/interfaces.py, not BCs)."""
        for g in self.mesh.boundary_groups():
            if g[2] == "interface":
                continue
            bc = self.bc[g[1]]
            if bc.bc_type is None:
                raise ConfigError(
                    f"{self.name}: boundary group {g[1]!r} has no bc_type set"
                )
            yield g, bc

    def _residual_sync(self) -> bool:
        """Whether advance reads each outer residual back to the host."""
        opts = self.options
        return bool(opts.get("residualSync", True)) or bool(opts["verbose"])

    def updateTime(self):
        """Shift time levels (reference: <Model>_impl updateTime)."""
        raise NotImplementedError(f"{self.name} is not transient")

    # --- persistence (reference: Model.h:23-26) ---------------------------

    def getPersistenceData(self) -> dict:
        """The state as host numpy arrays."""
        return {k: v.detach().cpu().numpy() for k, v in self.state.items()}

    def restart(self, data: dict) -> None:
        """Load the entries of ``data`` that the state has, each as a new
        tensor of the state's type on its device.  A captured chunk runner
        copies the state into its graph's buffers on every call
        (``models/chunk.Runner``), so the next replay starts from it."""
        for k, v in data.items():
            if k in self.state:
                old = self.state[k]
                self.state[k] = torch.as_tensor(v, dtype=old.dtype).to(
                    old.device, copy=True)


def as_tensor_like(v, ref) -> torch.Tensor:
    """``v`` (a number, numpy array or tensor) as a tensor of ``ref``'s
    dtype on its device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
        device=ref.device, dtype=ref.dtype)


class ResidualHistory(list):
    """Convergence history; printable like the reference's per-iteration
    '<n>: <residual>' lines (ThermalModel_impl.h:443)."""


def freeze(active, new: dict, old: dict) -> dict:
    """The frozen form's state update: ``new`` where ``active`` (a 0-d
    bool tensor), else ``old``, entry by entry."""
    return {k: v if v is old[k] else torch.where(active, v, old[k])
            for k, v in new.items()}


def pack(hist, count, done, *norms):
    """One float64 tensor of a chunk's results, read back in one copy:
    the stacked norms, then count, done and the initial norms."""
    tail = [count, done, *norms]
    return torch.cat([torch.stack(hist).double().reshape(-1),
                      torch.stack([t.double() for t in tail])])


def unpack(packed, trips, width=1):
    """``pack``'s tensor read back to the host: (the norms of each trip,
    as floats or ``width``-tuples; count; done; the initial norms)."""
    vals = packed.cpu().tolist()
    n = trips * width
    rows = vals[:n] if width == 1 else [tuple(vals[i:i + width])
                                        for i in range(0, n, width)]
    return rows, int(vals[n]), bool(vals[n + 1]), tuple(vals[n + 2:])
