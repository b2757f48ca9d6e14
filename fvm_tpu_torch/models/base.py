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

Distributed (``fvm_tpu/models/base.py:43-285``): a model built on a
rank's local mesh (``Partition.local_mesh(rank, device, group)``) with
``partition=`` runs the rank-local step; each rank holds its own row of
the JAX package's stacked state, its reductions all-reduce and its halo
slots refresh through the mesh's exchange tables.  Host inputs (VC
arrays, BC values) are global and scattered to the rank's cells and
padded group slots; the getters gather the global field on every rank.
A distributed model runs eager on every device: its collectives (gloo's
among them) cannot be captured in a CUDA graph, so ``outerChunk`` runs
the per-step loop, whose history and early exit are the chunked form's
(the stop test reads the all-reduced residual, the same on every rank),
and ``chunk.Runner`` refuses a distributed mesh.
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

    def __init__(self, mesh, partition=None):
        """``mesh``: a DeviceMesh, or a rank's local mesh of ``partition``
        (``Partition.local_mesh``)."""
        self.mesh = mesh
        self.partition = partition
        self._dist = getattr(mesh, "group", None) is not None
        if self._dist and partition is None:
            raise ConfigError(f"{self.name}: a rank's local mesh needs "
                              "partition=")
        if partition is not None and not self._dist:
            raise ConfigError(
                f"{self.name}: partition= needs the rank's local mesh "
                "(Partition.local_mesh(rank, device, group))")
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
        """Resolve a VC entry to an (nc,) cell tensor on the mesh's device
        (the rank's local cells when distributed)."""
        from ..core import bcs as bck

        mesh = self.mesh
        if self._dist:
            return self._scatter_host_cells(vcdict[key], extend_ghosts)
        arr = vcdict.resolve(key, mesh.n_cells, mesh.dtype, mesh.device)
        if extend_ghosts:
            arr = bck.extend_to_ghosts(mesh, arr)
        return arr

    def _scatter_host_cells(self, v, extend_ghosts=False):
        """A global cell value or array (interior or all cells) -> this
        rank's local cells, optionally owner-copied into the ghosts it
        leaves uncovered (the distributed ``extend_to_ghosts``)."""
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v, dtype=np.float64)
        hm = self.partition.mesh
        if arr.ndim == 0:
            host = np.full(hm.n_cells, float(arr))
        else:
            host = np.zeros((hm.n_cells,) + arr.shape[1:])
            host[: len(arr)] = arr
            if extend_ghosts and len(arr) < hm.n_cells:
                gh = np.arange(max(len(arr), hm.n_interior_cells), hm.n_cells)
                own = hm.face_cells[
                    hm.n_interior_faces + (gh - hm.n_interior_cells), 0]
                host[gh] = host[own]
        loc = self.partition.scatter_cells(host, self.mesh.group.rank)
        return torch.from_numpy(loc).to(self.mesh.device, self.mesh.dtype)

    def _gather_cells(self, x) -> np.ndarray:
        """The global interior cell array of a local cell tensor: every
        rank's rows gathered on every rank (distributed); else x's
        interior rows."""
        if not self._dist:
            return x[: self.mesh.n_interior_cells].detach().cpu().numpy()
        from ..ops.halo import all_gather

        stacked = all_gather(x, self.mesh.group).cpu().numpy()
        return self.partition.gather_cells(stacked)

    def _full_cells(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_cells,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _full_faces(self, value, trailing=()):
        mesh = self.mesh
        return torch.full((mesh.n_faces,) + tuple(trailing), value,
                          dtype=mesh.dtype, device=mesh.device)

    def _resolve_bcvals(self):
        """BC value dict: ``"<group>:<key>"`` -> per-face tensor (the
        rank's padded group slots when distributed, with ``__valid``
        marking the real ones)."""
        mesh = self.mesh
        vals = {}
        for g, bc in self._group_bcs():
            for key in bc:
                vals[f"{g[1]}:{key}"] = self._group_bc_values(g, bc, key)
            if self._dist:
                valid = torch.from_numpy(self.partition.group_valid_mask(
                    g[1], mesh.group.rank)).to(mesh.device)
            else:
                valid = torch.ones(g[4], dtype=torch.bool,
                                   device=mesh.device)
            vals[f"{g[1]}:__valid"] = valid
        return vals

    def _group_bc_values(self, g, bc, key):
        """Per-face BC values of a group: (L,) tensor (the rank's padded
        slots of the global group's values when distributed)."""
        mesh = self.mesh
        if not self._dist:
            return bc.resolve(key, g[4], mesh.dtype, mesh.device)
        n_global = self.partition.global_group_count(g[1])
        glob = bc.resolve(key, n_global, torch.float64, "cpu").numpy()
        loc = self.partition.scatter_bc(g[1], glob, mesh.group.rank)
        t = torch.from_numpy(loc).to(mesh.device)
        return t.to(mesh.dtype) if t.is_floating_point() else t

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

    # --- post-processing helpers ----------------------------------------

    def _map_mesh(self, fn, *args):
        """``fn(mesh, *args)`` on this rank's mesh (the JAX package vmaps
        it over the stacked shards, ``fvm_tpu/models/base.py:221``)."""
        return fn(self.mesh, *args)

    def _sum_group(self, g, F):
        """Sum a per-face quantity (nf, ...) over a boundary group's faces
        (``fvm_tpu/models/base.py:229``); distributed, over the rank's real
        group slots, then over the ranks (the reference's per-rank integral
        and allreduce in get<Var>FluxIntegral)."""
        from ..ops.halo import gsum

        Fg = F[self.mesh.group_faces(g)]
        if not self._dist:
            return Fg.sum(dim=0)
        valid = torch.from_numpy(self.partition.group_valid_mask(
            g[1], self.mesh.group.rank)).to(Fg.device)
        valid = valid.reshape(valid.shape + (1,) * (Fg.ndim - 1))
        return gsum(self.mesh, torch.where(valid, Fg, 0.0).sum(dim=0))

    def _group(self, group_name):
        """A boundary group's tuple, by name or as given."""
        return (self.mesh.group_by_name(group_name)
                if isinstance(group_name, str) else group_name)

    # --- immersed boundary (fvm_tpu/models/base.py:287-505; the
    # reference's IBManager consumers and GenericIBDiscretization.h) -------

    def _set_immersed_boundary(self, mask, value, stencil=None,
                               implicit=True) -> None:
        """Shared IB parameter set-up.  ``mask``: per cell (interior
        ordering) the cells pinned to ``value`` (a scalar or a per-cell
        (n,) / (n, m) body value), padded to the device mesh's cells;
        ``stencil``: ``IBManager.interpolation_stencil()``, whose rows
        constrain the IB band, with ``implicit=True`` inside the matrix
        through appended ELL slots (``assembly.ib_stencil_rows_implicit``,
        as GenericIBDiscretization.h), with ``implicit=False`` as pinned
        rows lagged by one outer iteration.  Call after ``init()``, which
        rebuilds the params.  The step and its captured graphs are
        dropped, so the next advance runs (and captures) the new rows."""
        if not self._initialized:
            # init() rebuilds self.params and would silently wipe the masks
            raise ConfigError("call init() before set_immersed_boundary()")
        if getattr(self, "partition", None) is not None:
            raise ConfigError(
                f"{self.name}: the distributed immersed boundary (the "
                "per-shard stencil tables) is not ported yet (ROADMAP queue "
                "1 item 8b)")
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
        if stencil is not None:
            self._set_ib_stencil(stencil, implicit)
        self._drop_compiled()

    def _set_ib_stencil(self, stencil, implicit) -> None:
        """The stencil's tables as params and, in the implicit form, the
        widened static structure: ``k`` appended ELL slots carrying each
        IB row's fluid-cell couplings (``fvm_tpu/models/base.py:340-388``)."""
        from ..linear import AMG
        from ..ops.dia import DIAInfo, index_tensor

        mesh = self.mesh
        dev = mesh.device
        ib_cells, fluid_idx, fluid_w, wall_w = stencil
        ib_np = np.asarray(ib_cells, dtype=np.int64)
        fi_np = np.asarray(fluid_idx, dtype=np.int64)
        fw_np = np.asarray(fluid_w, dtype=np.float64)
        self.params["ibs_cells"] = index_tensor(ib_np, dev)
        self.params["ibs_fluid"] = index_tensor(fi_np, dev)
        self.params["ibs_fw"] = torch.from_numpy(fw_np).to(dev, mesh.dtype)
        self.params["ibs_ww"] = torch.from_numpy(np.asarray(
            wall_w, dtype=np.float64)).to(dev, mesh.dtype)
        if not implicit:
            self._ib_ext = None
            return
        nc = mesh.n_cells
        cols_np, mask_np = mesh.host_cf()
        K = cols_np.shape[1]
        k = fi_np.shape[1]
        cols_ext = np.concatenate(
            [cols_np, np.tile(np.arange(nc, dtype=cols_np.dtype)[:, None],
                              (1, k))], axis=1)
        mask_ext = np.concatenate(
            [np.asarray(mask_np), np.zeros((nc, k), dtype=bool)], axis=1)
        cols_ext[ib_np, K:] = fi_np
        mask_ext[ib_np, K:] = fw_np > 0
        # the device tables are slot-leading (K + k, n); the DIA form of the
        # widened pattern carries the couplings off its offsets as fallback
        # entries (None: too unstructured, the gather-ELL products)
        self._ib_ext = (index_tensor(cols_ext.T, dev),
                        torch.from_numpy(np.ascontiguousarray(
                            mask_ext.T)).to(dev),
                        DIAInfo.build(cols_ext, mask_ext, dev))
        # AMG hierarchies of the widened pattern, BESIDE the existing ones
        # (a flow model's pressure matrix keeps the mesh's pattern; a solve
        # finds its hierarchy by its pattern)
        for key in ("linearSolver", "pressureLinearSolver",
                    "momentumLinearSolver"):
            s = self.options.get(key)
            for ss in (s, getattr(s, "preconditioner", None)):
                if isinstance(ss, AMG):
                    ss.setup_structure(cols_ext, mask_ext, dev)

    def _drop_compiled(self) -> None:
        """Rebuild the step and drop the runners (and their CUDA graphs)
        after a change of params keys: a graph freezes the params it was
        captured with, as the JAX package's jitted step retraces on a new
        params pytree."""
        self._step = self._build_step()
        self._runners = {}

    def _apply_ib(self, mesh, params, A, r, phi):
        """Immersed-boundary rows: the stencil band (implicit: widened
        matrix; lagged: pinned to the interpolation of the current
        iterate), then the masked cells pinned to their value."""
        if "ibs_cells" in params:
            ib = params["ibs_cells"]
            fluid = params["ibs_fluid"]
            w_f, w_w = params["ibs_fw"], params["ibs_ww"]
            val = params["ib_value"]
            ext = getattr(self, "_ib_ext", None)
            if ext is not None:
                A, r = assembly.ib_stencil_rows_implicit(
                    A, r, ib, fluid, w_f, w_w, val, phi, *ext)
            else:
                W = w_w + w_f.sum(dim=1)
                if phi.ndim == 1:
                    num = w_w * val[ib] + (w_f * phi[fluid]).sum(dim=1)
                    vals = num / W
                else:
                    num = w_w[:, None] * val[ib] + torch.einsum(
                        "ik,ikm->im", w_f, phi[fluid])
                    vals = num / W[:, None]
                full_vals = torch.zeros_like(phi).index_copy(0, ib, vals)
                band = torch.zeros(mesh.n_cells, dtype=torch.bool,
                                   device=phi.device).index_fill(0, ib, True)
                A, r = assembly.dirichlet_cells(A, r, band, full_vals, phi)
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
        # a distributed model runs eager: the per-step loop (module
        # docstring)
        return chunk if chunk > 1 and niter > 1 and not self._dist else 0

    def _chunk_runner(self, chunk: int) -> Runner:
        """The chunk of ``chunk`` trips, built (and on a CUDA mesh
        captured) once per chunk size until the next ``init()``."""
        runner = self._runners.get(("chunk", chunk))
        if runner is None:
            # built from the step, mesh and params, not from the model,
            # which holds the runner
            runner = Runner(functools.partial(
                self._chunk_fn, self._step, self.mesh, self.params), chunk,
                self.mesh.device, self.mesh)
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

    def update_time(self):
        """Alias of ``updateTime``."""
        self.updateTime()

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


def zero_float_tangent(tree):
    """A zero tangent of a nest of dicts, lists and tuples of tensors (or
    arrays): zeros for floating leaves, None for the others, which
    ``torch.func.jvp`` takes no tangent for and a caller holds fixed (the
    JAX package gives them jax's symbolic float0 zeros)."""
    if isinstance(tree, dict):
        return {k: zero_float_tangent(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zero_float_tangent(v) for v in tree)
    x = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
        np.asarray(tree))
    if x.is_floating_point() or x.is_complex():
        return torch.zeros_like(x)
    return None


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

    def converged(self, tol: float) -> bool:
        return len(self) > 0 and self[-1][1] <= tol


def single_device_model(name: str, partition) -> None:
    """Raise for a partitioned mesh: the models' distributed branches are
    not ported yet."""
    if partition is not None:
        raise ConfigError(
            f"{name}: a partitioned mesh (the distributed branch) is not "
            "ported yet (ROADMAP queue 1 item 8b)")


def newton_advance(model, niter: int) -> ResidualHistory:
    """The JFNK models' outer loop (the reference's advance loops): one
    step per iteration with the absolute and relative tests on the
    residual norm against the first one."""
    opts = model.options
    hist = ResidualHistory()
    hist.trips = []  # the inner solve's trips per step, if the step gives them
    bcvals = model._resolve_bcvals()
    for it in range(niter):
        with model._phase("step"):
            model.state, aux = model._step(model.mesh, model.params,
                                           model.state, bcvals)
        rnorm = float(aux["rnorm"])
        if "trips" in aux:
            hist.trips.append(int(aux["trips"]))
        model._guard_residual(rnorm, it)
        if model._initial_norm is None or model._initial_norm == 0.0:
            model._initial_norm = rnorm
        hist.append((it, rnorm))
        model._log_iteration(f"{model.name}: {it}: {rnorm:.6e}")
        if rnorm < opts["absoluteTolerance"]:
            break
        if rnorm / max(model._initial_norm, 1e-300) < opts[
                "relativeTolerance"]:
            break
    return hist


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
