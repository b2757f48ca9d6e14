#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fvm_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each or a short table (a failing phase raises and the
script exits non-zero before the last line):

  1. device   - requires CUDA; prints the card, the device count and
                ``nvidia-smi --query-gpu=name,power.limit``;
  2. build    - builds the ``dia_stencil`` CUDA kernel's two variants
                (wide, narrow) from the repository's sources, four nvcc
                runs in parallel (ptxas register/spill summary), and the
                host aggregation helper of the greedy AMG (``c++``);
  3. kernel   - each variant against the plain PyTorch version on the
                card, max abs error 0 required: 3 modes x {f32, f64} x
                {(n,), (n, 2)} at every smoothed level of the AMG hierarchy
                the main path builds (the condensed fine level first) and
                at a multi-block case; x and b views at unaligned bases
                with n not a multiple of 4, m up to 3;
  4. slice    - the coupled flow+thermal step at 64^2 in float64 on the card
                and on the CPU (plain versions): residual histories agree;
  5. main     - the main path at full size: the 1024^2 float32 coupled
                cavity of ``bench.py:main()``, warm-up + 10 timed outer
                steps, with the kernel's launch counts per mode, variant and
                level, and the device profile of two steps;
  6. timing   - the kernel, its plain version and the library call (mv:
                ``torch.sparse.mm``, residual: ``torch.addmv``, both on a
                CSR copy) at the fine level, beside the bound; then each AMG
                level's Jacobi and residual device time per launch;
  7. slice3d  - the coupled 3D cavity (``coupled_cavity_3d``) at 16^3 in
                float64 on the card and on the CPU: histories agree;
  8. setup3d  - the 128^3 float32 coupled 3D cavity built, host seconds per
                stage (mesh, metrics, device mesh with its cf tables and
                DIA analysis, models with their LS coefficients and greedy
                AMG hierarchies: aggregation, level tables; first step),
                and the live hierarchy: rows, DIA offsets and fallback, or
                gather-ELL;
  9. kernel3d - both variants against the plain version, max abs error 0,
                at every DIA level of that hierarchy: 3 modes x {f32, f64}
                x {(n,), (n, 3)}, and on levels with fallback entries the
                fused op with its fallback applied;
 10. main3d   - the 3D main path: warm-up + 10 timed outer steps of the
                128^3 cavity, launches per step by mode, variant and level,
                gather-ELL products by level, and the device profile;
 11. timing3d - phase 6 at the 3D fine level (mv on (n, 3)), then each
                level's Jacobi and residual: ``dia_stencil`` against its
                bound, or the gather-ELL products' device time and launches;
then the ``kernels`` JSON line and, last, the device JSON line.

It imports nothing of JAX and nothing of the JAX package ``fvm_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

# the bench configuration (bench.py:44-46): 1024^2 cells in float32
MAIN_N = 1024
MAIN_DTYPE = "float32"
WARMUP_STEPS = 2
TIMED_STEPS = 10
SLICE_N = 64
SLICE_STEPS = 5
SLICE_RTOL = 1e-8
# the 3D counterpart: a 128^3 hex cavity (2,097,152 cells) in float32
MAIN3D_N = 128
SLICE3D_N = 16
# kernel timing: calls per measurement, and operand copies cycled through
# (4 x ~36 MB at the 2D fine level, beyond the 50 MB L2)
TIMING_REPS = 200
LEVEL_REPS = 100
TIMING_COPIES = 4
# the library call timed beside each mode, and its agreement with the plain
# version (float32, another summation order)
LIBRARY_CALL = {"mv": "torch.sparse.mm", "residual": "torch.addmv"}
LIBRARY_RTOL = 1e-5
TPU_KERNEL = "fvm_tpu/ops/pallas_kernels.py:125"
KERNEL_SOURCE = "fvm_tpu_torch/csrc/dia_stencil.cu"
HOST_SOURCE = "fvm_tpu_torch/csrc/hostlib.cpp"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def deterministic():
    """Deterministic PyTorch algorithms (``index_add`` on CUDA sorts its
    indices instead of adding with atomics), so two fallback scatter-adds
    on equal inputs give equal outputs."""
    import torch

    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


@contextlib.contextmanager
def stage_clock(secs, targets):
    """While open, add the host seconds of every call of each target
    (owner, attribute name, label) to ``secs[label]``; a call nested in a
    call of the same label counts once."""
    saved, depth = [], {}
    for owner, attr, label in targets:
        fn = vars(owner)[attr]
        static = isinstance(fn, staticmethod)
        raw = fn.__func__ if static else fn

        def timed(*args, _raw=raw, _label=label, **kw):
            depth[_label] = depth.get(_label, 0) + 1
            t0 = time.perf_counter()
            try:
                return _raw(*args, **kw)
            finally:
                depth[_label] -= 1
                if depth[_label] == 0:
                    secs[_label] = (secs.get(_label, 0.0)
                                    + time.perf_counter() - t0)

        setattr(owner, attr, staticmethod(timed) if static else timed)
        saved.append((owner, attr, fn))
    try:
        yield secs
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def kernel_vs_plain(label, n, offsets, device, errors, nrhs=(1, 2),
                    views=False, dia=None):
    """Both variants against the plain version at one shape, bit for bit;
    max abs errors go into ``errors`` by variant and mode.  With ``views``
    x and b are views at unaligned bases.  With a ``dia`` that has fallback
    entries, the fused op with its fallback applied (random values at the
    level's own fallback rows and columns) is held against the plain
    version with the same fallback too.  One log line per shape."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops.dia import apply_fallback
    from fvm_tpu_torch.tools.kernel_bench import random_operator, random_vectors

    fb = dia is not None and dia.fb_rows.shape[0] > 0
    checks, worst = 0, 0.0
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        coef, diag = random_operator(n, offsets, dtype, device, seed=1)
        if fb:
            g = torch.Generator(device="cpu").manual_seed(5)
            fb_vals = torch.randn(dia.fb_rows.shape[0], generator=g,
                                  dtype=torch.float64).to(device, dtype)
        for m in nrhs:
            x, b = random_vectors(n, m, dtype, device, seed=2 + m)
            if views:
                xs = torch.zeros(n * m + 5, dtype=dtype, device=device)
                bs = torch.zeros(n * m + 5, dtype=dtype, device=device)
                x = xs[1:1 + n * m].view(x.shape).copy_(x)
                b = bs[3:3 + n * m].view(b.shape).copy_(b)
                if x.data_ptr() % 16 == 0 or b.data_ptr() % 16 == 0:
                    raise AssertionError("the views are aligned")
            for mode in dk.MODES:
                omega = 0.7 if mode == "jacobi" else None
                bb = None if mode == "mv" else b
                y_ref = dk.dia_stencil_plain(offsets, mode, coef, diag, x,
                                             b=bb, omega=omega)
                for variant in dk.VARIANTS:
                    y = dk._launch(offsets, mode, coef, diag, x, bb, omega,
                                   variant=variant)
                    pairs = [(y, y_ref)]
                    if fb:
                        with deterministic():
                            pairs.append(tuple(
                                apply_fallback(t, mode, diag, x, omega,
                                               dia.fb_rows, dia.fb_cols,
                                               fb_vals)
                                for t in (y, y_ref)))
                    torch.cuda.synchronize()
                    for got, want in pairs:
                        err = float((got - want).abs().max())
                        if not (bool(torch.isfinite(got).all())
                                and err == 0.0):
                            raise AssertionError(
                                f"dia_stencil {variant} disagrees: {label} "
                                f"{dtype_name} m={m} {mode}: max abs err "
                                f"{err:.3e}")
                        key = (variant, mode)
                        errors[key] = max(errors.get(key, 0.0), err)
                        worst = max(worst, err)
                        checks += 1
    log("kernel", f"{label}: n={n} offsets={tuple(offsets)}"
        + (f" + {int(dia.fb_rows.shape[0])} fallback entries" if fb else "")
        + f": {checks} checks (variants x dtypes x m x modes"
        + (" x {stencil, with fallback}" if fb else "")
        + f"), max abs err {worst:g} (need 0) ok")


def coupled_history(make, n, steps, device, dtype):
    """Residual history of ``steps`` coupled outer steps on ``device``."""
    from fvm_tpu_torch.cases import coupled_step

    flow, thermal = make(n, device=device, dtype=dtype)
    return [[float(v) for v in coupled_step(flow, thermal)]
            for _ in range(steps)]


def slice_phase(phase, make, n, label, device):
    """The coupled step at a small size in float64 on the card and on the
    CPU: the residual histories must agree to ``SLICE_RTOL``."""
    t0 = time.time()
    h_gpu = coupled_history(make, n, SLICE_STEPS, device, "float64")
    h_cpu = coupled_history(make, n, SLICE_STEPS, "cpu", "float64")
    worst = max(abs(a - c) / max(abs(c), 1e-300)
                for rg, rc in zip(h_gpu, h_cpu) for a, c in zip(rg, rc))
    log(phase, f"{label} float64, {SLICE_STEPS} coupled steps: cuda "
        f"{h_gpu[-1]} vs cpu {h_cpu[-1]}; max rel diff {worst:.3e} "
        f"(tol {SLICE_RTOL:g}) in {time.time() - t0:.1f} s")
    if not worst <= SLICE_RTOL:
        raise AssertionError(f"{phase}: cuda and cpu slices disagree")


def time_events(fns, reps):
    """Mean ms per call of ``reps`` eager back-to-back calls between two
    CUDA events, cycling through ``fns``: each works on its own copy of the
    operands, and the copies together exceed the 50 MB L2, so every call
    reads its operands from device memory as the main path does.  This
    includes the host's launch rate where it is slower than the device."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(fns, reps):
    """Mean ms per call of the same ``reps`` calls captured in one CUDA
    graph and replayed between two CUDA events: back-to-back on the device,
    with no host in the way."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def csr_copy(offsets, coef, diag):
    """The same DIA matrix as a torch CSR tensor (for ``library_ms``)."""
    import torch

    n = diag.shape[0]
    rows = [torch.arange(n, device=diag.device)]
    cols = [torch.arange(n, device=diag.device)]
    vals = [diag]
    for j, d in enumerate(offsets):
        i = torch.arange(max(0, -d), min(n, n - d), device=diag.device)
        rows.append(i)
        cols.append(i + d)
        vals.append(coef[j, i])
    with warnings.catch_warnings():
        # torch's notes that sparse invariant checks are off and that CSR
        # support is in beta
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
            (n, n)).coalesce()
        return coo.to_sparse_csr()


def library_call(mode, csr, x, b):
    """One PyTorch call computing ``mode`` on the CSR matrix: A x, or
    b - A x as ``addmv`` with alpha -1."""
    import torch

    if mode == "mv":
        return lambda: torch.sparse.mm(csr, x)
    return lambda: torch.addmv(b, csr, x, alpha=-1)


def profile_steps(flow, thermal, step_ms, steps=2):
    """Device time of ``steps`` coupled steps by kernel (torch.profiler):
    the device-busy share of the unprofiled step time, the kernel launches
    per step, the ``dia_stencil`` kernels' device ms per step, and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch.cases import coupled_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(steps):
            coupled_step(flow, thermal)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device events only: an aten op's entry repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    if not rows:
        log("profile", "torch.profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log("profile", f"device busy {busy:.3f} ms of a {step_ms:.3f} ms step "
        f"({100 * busy / step_ms:.1f}% busy, "
        f"{100 - 100 * busy / step_ms:.1f}% idle), "
        f"{sum(r[1] for r in rows):g} kernel launches per step")
    for variant in ("wide", "narrow"):
        mine = [r for r in rows if f"dia_{variant}_kernel" in r[2]]
        log("profile", f"dia_stencil {variant}: "
            f"{sum(r[0] for r in mine):.4f} ms/step over "
            f"{sum(r[1] for r in mine):g} launches/step")
    dia = [r for r in rows if "dia_" in r[2] and "_kernel" in r[2]]
    log("profile", f"dia_stencil device time per step: "
        f"{sum(r[0] for r in dia):.4f} ms over {sum(r[1] for r in dia):g} "
        f"launches")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log("profile", f"  {ms:8.3f} ms/step {n:7.1f} calls/step  {key[:90]}")
    # the PyTorch ops that issued those kernels (device time of each op's
    # kernels, nested ops counted in their callers too)
    ops = sorted(((e.device_time_total / 1e3 / steps, e.count / steps, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::") and e.device_time_total > 0),
                 reverse=True)
    for ms, n, key in ops[:8]:
        log("profile", f"  {ms:8.3f} ms/step {n:7.1f} calls/step  op {key}")


def timed_steps(flow, thermal, phase, cells, label):
    """WARMUP_STEPS - 1 more warm-up steps (the first ran at set-up), then
    TIMED_STEPS timed coupled steps with every launch counter reset just
    before; returns (ms per step, residuals, dia_stencil launches by mode,
    by (variant, mode, rows), gather-ELL products by (mode, rows))."""
    import torch
    from fvm_tpu_torch.cases import coupled_step
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell

    for _ in range(WARMUP_STEPS - 1):
        coupled_step(flow, thermal)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        res = coupled_step(flow, thermal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dk.dia_stencil.launches)
    by_shape = dict(dk.dia_stencil.shapes)
    gathers = dict(ell.gather_ell_ops)
    by_variant = dk.variant_launches()
    resids = [float(v) for v in res]
    log(phase, f"{label}: {TIMED_STEPS} coupled steps in {dt:.4f} s: "
        f"{cells * TIMED_STEPS / dt:.6e} cells/s, "
        f"{1e3 * dt / TIMED_STEPS:.3f} ms/step")
    log(phase, "dia_stencil launches per step: " + ", ".join(
        f"{m} {launches[m] / TIMED_STEPS:g}" for m in dk.MODES) + "; " +
        ", ".join(f"{v} {by_variant[v] / TIMED_STEPS:g}"
                  for v in dk.VARIANTS))
    log(phase, f"final residuals (mom, cont, thermal): {resids}")
    log(phase, f"max memory allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    V = flow.state["velocity"]
    if tuple(V.shape) != (flow.mesh.n_cells, flow.mesh.dim) or not bool(
            torch.isfinite(V).all()):
        raise AssertionError("velocity field is not finite or misshapen")
    if not all(v == v and abs(v) != float("inf") for v in resids):
        raise AssertionError(f"non-finite residuals {resids}")
    missing = [m for m in dk.MODES if launches[m] == 0]
    if missing:
        raise AssertionError(f"dia_stencil never launched: {missing}")
    return 1e3 * dt / TIMED_STEPS, launches, by_shape, by_variant, gathers


def time_modes(tag, n, offsets, cases, launches, errors, dtype_name):
    """The kernel, its plain version and the library call at one level,
    per (mode, m) of ``cases``, beside the bound; returns the ``kernels``
    JSON entries (``tag`` is appended to their names)."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    dtype = getattr(torch, dtype_name)
    item = torch.empty((), dtype=dtype).element_size()
    device = torch.device("cuda", 0)
    out = []
    for mode, m in cases:
        kw_extra = {"omega": 0.7} if mode == "jacobi" else {}
        sets = []
        for k in range(TIMING_COPIES):
            coef, diag = kb.random_operator(n, offsets, dtype, device,
                                            seed=10 + k)
            x, b = kb.random_vectors(n, m, dtype, device, seed=20 + k)
            kw = dict(kw_extra) if mode == "mv" else dict(kw_extra, b=b)
            sets.append((coef, diag, x, kw))

        def kernel_call(c):
            coef, diag, x, kw = c
            return lambda: dk.dia_stencil(offsets, mode, coef, diag, x, **kw)

        def plain_call(c):
            coef, diag, x, kw = c
            return lambda: dk.dia_stencil_plain(offsets, mode, coef, diag, x,
                                                **kw)

        kern = [kernel_call(c) for c in sets]
        plain = [plain_call(c) for c in sets]
        ms = kb.time_device(kern, TIMING_REPS)
        graph_ms = time_graph(kern, TIMING_REPS)
        eager_ms = time_events(kern, TIMING_REPS)
        plain_ms = kb.time_device(plain, TIMING_REPS)
        # one PyTorch call computing the same function on a CSR copy of the
        # same matrix (the port never calls it); damped Jacobi has none:
        # x + omega (b - A x) / diag needs a product and two more passes
        library_ms = library_eager_ms = None
        if mode in LIBRARY_CALL:
            libs = [library_call(mode, csr_copy(offsets, c[0], c[1]),
                                 c[2], c[3].get("b")) for c in sets]
            got, want = libs[0](), plain[0]()
            err = float((got - want).abs().max()) / float(want.abs().max())
            if not err <= LIBRARY_RTOL:
                raise AssertionError(f"{LIBRARY_CALL[mode]} disagrees with "
                                     f"the plain {mode}: rel err {err:.3e}")
            library_ms = kb.time_device(libs, TIMING_REPS)
            library_eager_ms = time_events(libs, TIMING_REPS)
            del libs, got, want
        del sets, kern, plain
        bound_ms, bound_by, nbytes, nops = kb.bound(n, m, len(offsets), mode,
                                                   item)
        variant = "wide" if n >= dk.WIDE_MIN_ROWS else "narrow"
        log("timing", f"dia_stencil {mode}{tag} ({variant}) n={n} m={m} "
            f"D={len(offsets)} {dtype_name}: device {ms:.5f} ms (graph "
            f"replay {graph_ms:.5f}, eager {eager_ms:.5f}), bound "
            f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B at 3.35 TB/s; "
            f"{nops} flop at 67 TFLOP/s), {100 * bound_ms / ms:.1f}% of "
            f"bound; plain device {plain_ms:.5f} ms; "
            + ("library: none for jacobi (no single call)"
               if library_ms is None else
               f"{LIBRARY_CALL[mode]} CSR device {library_ms:.5f} ms "
               f"(eager {library_eager_ms:.5f})"))
        out.append({
            "name": f"dia_stencil.{mode}{tag}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode],
            "max_abs_err": max(v for (_, md), v in errors.items()
                               if md == mode),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
    return out


def gather_ell_timing(shape, dtype, device, mode):
    """Device ms and kernel launches per gather-ELL product on a level's
    own graph (random values made from a seed), by torch.profiler."""
    import torch
    from fvm_tpu_torch.ops.ell import ELLMatrix
    from fvm_tpu_torch.tools import kernel_bench as kb

    cols, mask = shape.graph
    g = torch.Generator(device="cpu").manual_seed(7)
    K, n = cols.shape
    A = ELLMatrix(
        diag=(torch.rand(n, generator=g, dtype=torch.float64) + 4.0).to(
            device, dtype),
        off=torch.randn((K, n), generator=g, dtype=torch.float64).to(
            device, dtype),
        cols=cols, mask=mask)
    x, b = kb.random_vectors(n, 1, dtype, device, seed=8)
    fn = ((lambda: A.jacobi_step(x, b, 0.7)) if mode == "jacobi"
          else (lambda: A.residual(x, b)))
    fn()
    events = kb._profile(lambda: [fn() for _ in range(LEVEL_REPS)])
    ms = sum(e.self_device_time_total for e in events) / 1e3 / LEVEL_REPS
    return ms, sum(e.count for e in events) / LEVEL_REPS


def level_table(shapes, by_shape, gathers, dtype_name):
    """Every smoothed level: Jacobi and residual per launch beside the
    bound (the variant the dispatch takes) and launches x (time - bound)
    per step; on gather-ELL levels the products' device time, kernel
    launches per product and products per step."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    dtype = getattr(torch, dtype_name)
    item = torch.empty((), dtype=dtype).element_size()
    device = torch.device("cuda", 0)
    log("levels", "lvl rows route | jacobi: per step, ms, bound, share | "
        "residual: per step, ms, bound, share | excess ms/step")
    total = {"ms": 0.0, "bound": 0.0, "gather": 0.0, "gather_bound": 0.0,
             "gather_launches": 0.0}
    for lvl, s in enumerate(shapes):
        n = s.rows
        if s.offsets is None:
            cells_ = []
            K = s.graph[0].shape[0]
            for mode in ("jacobi", "residual"):
                ms, kernels = gather_ell_timing(s, dtype, device, mode)
                bnd = kb.gather_ell_bound(n, K, mode, item)[0]
                per = gathers.get((mode, n), 0) / TIMED_STEPS
                total["gather"] += per * ms
                total["gather_bound"] += per * bnd
                total["gather_launches"] += per * kernels
                cells_.append(f"{per:5g} {ms:.5f} {bnd:.5f} "
                              f"{100 * bnd / ms:5.1f}% ({kernels:g} kernels)")
            log("levels", f"L{lvl:<2d} {n:8d} gather-ELL K={K} | {cells_[0]} "
                f"| {cells_[1]}")
            continue
        variant = "wide" if n >= dk.WIDE_MIN_ROWS else "narrow"
        cells_ = []
        excess = 0.0
        for mode in ("jacobi", "residual"):
            ops = []
            for k in range(TIMING_COPIES):
                coef, diag = kb.random_operator(n, s.offsets, dtype, device,
                                                seed=30 + k)
                x, b = kb.random_vectors(n, 1, dtype, device, seed=40 + k)
                ops.append((coef, diag, x, b))
            omega = 0.7 if mode == "jacobi" else None
            t = kb.time_device(
                [lambda o=o: dk.dia_stencil(s.offsets, mode, o[0], o[1], o[2],
                                            b=o[3], omega=omega)
                 for o in ops], LEVEL_REPS)
            bnd = kb.bound(n, 1, len(s.offsets), mode, item)[0]
            per = by_shape.get((variant, mode, n), 0) / TIMED_STEPS
            excess += per * (t - bnd)
            total["ms"] += per * t
            total["bound"] += per * bnd
            cells_.append(f"{per:5g} {t:.5f} {bnd:.5f} {100 * bnd / t:5.1f}%")
            del ops
        log("levels", f"L{lvl:<2d} {n:8d} {variant} D={len(s.offsets)} "
            f"fb={s.fallback} | {cells_[0]} | {cells_[1]} | {excess:.4f}")
    log("levels", f"jacobi + residual over the levels: dia_stencil "
        f"{total['ms']:.4f} ms/step of kernel time against a bound of "
        f"{total['bound']:.4f}; gather-ELL {total['gather']:.4f} ms/step "
        f"against a bound of {total['gather_bound']:.4f}, "
        f"{total['gather_launches']:g} kernel launches/step")


def describe(shapes):
    return "; ".join(
        f"L{i} {s.rows} rows " + (
            "gather-ELL" if s.offsets is None else
            f"DIA D={len(s.offsets)} fb={s.fallback}")
        for i, s in enumerate(shapes))


def main() -> int:
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch import hostlib
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.cases import (cavity_models, coupled_cavity,
                                     coupled_cavity_3d, coupled_step)
    from fvm_tpu_torch.linear import amg as amg_mod
    from fvm_tpu_torch.mesh import build_device_mesh, compute_geometry
    from fvm_tpu_torch.mesh import device as device_mod
    from fvm_tpu_torch.mesh.generate import hex_3d
    from fvm_tpu_torch.models import flow as flow_mod
    from fvm_tpu_torch.models import thermal as thermal_mod
    from fvm_tpu_torch.ops.dia import DIAInfo
    from fvm_tpu_torch.tools import kernel_bench as kb

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{kind}, {count} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    dk.build(verbose=True)
    log("build", f"dia_stencil wide and narrow built from {KERNEL_SOURCE} in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    hostlib.build()
    log("build", f"host aggregation helper built from {HOST_SOURCE} in "
        f"{time.time() - t0:.1f} s")

    # ---- 3. kernel vs plain on the card -----------------------------------
    # the main path's case, one warm-up step to build its AMG hierarchies
    t0 = time.time()
    flow, thermal = coupled_cavity(MAIN_N, device=device, dtype=MAIN_DTYPE)
    coupled_step(flow, thermal)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    shapes = kb.level_shapes(flow.options["pressureLinearSolver"], flow.mesh)
    log("kernel", f"the {MAIN_N}^2 pressure hierarchy: {describe(shapes)}")
    n_main, main_offsets = shapes[0].rows, shapes[0].offsets
    errors = {}
    for lvl, s in enumerate(shapes):
        kernel_vs_plain(f"AMG level {lvl}" + (
            f" (cavity {MAIN_N}^2 condensed fine level)" if lvl == 0
            else ""), s.rows, s.offsets, device, errors)
    kernel_vs_plain("multi-block", 3 * 512 * 128 + 777,
                    (-640, -128, -1, 1, 128, 640), device, errors)
    kernel_vs_plain("unaligned x/b views", 200_003, (-448, -1, 1, 448),
                    device, errors, nrhs=(1, 2, 3), views=True)

    # ---- 4. slice on the card vs slice on the CPU --------------------------
    slice_phase("slice", coupled_cavity, SLICE_N, f"{SLICE_N}^2", device)

    # ---- 5. main path at full size ----------------------------------------
    log("main", f"{MAIN_N}^2 {MAIN_DTYPE} coupled cavity set up and first "
        f"step in {setup_s:.1f} s ({flow.mesh.n_cells} rows)")
    step_ms, launches, by_shape, by_variant, _ = timed_steps(
        flow, thermal, "main", MAIN_N * MAIN_N, f"{MAIN_N}^2 {MAIN_DTYPE}")
    missing = [v for v in dk.VARIANTS if by_variant[v] == 0]
    if missing:
        raise AssertionError(f"dia_stencil never launched: {missing}")
    profile_steps(flow, thermal, step_ms)
    del flow, thermal

    # ---- 6. kernel timing at the main path's shapes ------------------------
    # momentum BiCGStab mv on (n, 2); AMG residual and Jacobi on (n,)
    kernels = time_modes("", n_main, main_offsets,
                         (("mv", 2), ("residual", 1), ("jacobi", 1)),
                         launches, errors, MAIN_DTYPE)
    level_table(shapes, by_shape, {}, MAIN_DTYPE)

    # ---- 7. the 3D slice on the card vs on the CPU -------------------------
    slice_phase("slice3d", coupled_cavity_3d, SLICE3D_N, f"{SLICE3D_N}^3",
                device)

    # ---- 8. the 3D main path set up ----------------------------------------
    secs, mesh_parts, init_parts = {}, {}, {}
    t0 = time.perf_counter()
    hmesh = hex_3d(MAIN3D_N, MAIN3D_N, MAIN3D_N)
    secs["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    geom = compute_geometry(hmesh)
    secs["metrics"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with stage_clock(mesh_parts, [
            (device_mod, "_cf_tables", "cf tables"),
            (DIAInfo, "build", "DIA analysis and condensation")]):
        dmesh = build_device_mesh(hmesh, geom, dtype=MAIN_DTYPE,
                                  device=device)
        torch.cuda.synchronize()
    secs["device mesh"] = time.perf_counter() - t0
    n_faces_host = hmesh.n_faces
    del hmesh, geom
    t0 = time.perf_counter()
    with stage_clock(init_parts, [
            (flow_mod, "ls_gradient_coefficients", "LS gradient coefficients"),
            (thermal_mod, "ls_gradient_coefficients",
             "LS gradient coefficients"),
            (amg_mod.AMG, "setup_structure",
             "AMG hierarchies (pressure and thermal)"),
            (amg_mod, "aggregate", "aggregation"),
            (amg_mod._Level, "__init__", "_Level tables"),
            (DIAInfo, "build", "DIA analysis and condensation")]):
        flow, thermal = cavity_models(dmesh)
        torch.cuda.synchronize()
    secs["models init"] = time.perf_counter() - t0
    pres = flow.options["pressureLinearSolver"]
    therm = thermal.options["linearSolver"]
    t0 = time.perf_counter()
    coupled_step(flow, thermal)
    torch.cuda.synchronize()
    secs["first step"] = time.perf_counter() - t0
    cells3 = MAIN3D_N ** 3

    def parts(d):
        return ", ".join(f"{k} {v:.2f}" for k, v in d.items())

    log("setup3d", f"hex_3d({MAIN3D_N}^3) {MAIN_DTYPE}: {cells3} cells, "
        f"{n_faces_host} faces, {dmesh.n_cells} rows, K = "
        f"{dmesh.max_faces_per_cell}; host seconds: {parts(secs)}; total "
        f"{sum(secs.values()):.2f}")
    log("setup3d", f"of device mesh: {parts(mesh_parts)}")
    log("setup3d", f"of models init: {parts(init_parts)} (the hierarchies "
        f"hold the _Level tables, which hold their aggregation and the "
        f"coarse levels' DIA analysis)")
    shapes3 = kb.level_shapes(pres, dmesh)
    if [(s.rows, s.offsets) for s in shapes3] != [
            (s.rows, s.offsets) for s in kb.level_shapes(therm, dmesh)]:
        raise AssertionError("pressure and thermal hierarchies differ")
    log("setup3d", f"the greedy hierarchy: {describe(shapes3)}")

    # ---- 9. kernel vs plain at the 3D hierarchy's DIA levels --------------
    errors3 = {}
    for lvl, s in enumerate(shapes3):
        if s.offsets is not None:
            kernel_vs_plain(f"3D level {lvl}", s.rows, s.offsets, device,
                            errors3, nrhs=(1, 3), dia=s.dia)

    # ---- 10. the 3D main path ---------------------------------------------
    step3_ms, launches3, by_shape3, _, gathers3 = timed_steps(
        flow, thermal, "main3d", cells3, f"{MAIN3D_N}^3 {MAIN_DTYPE}")
    per_level = []
    for lvl, s in enumerate(shapes3):
        kinds = [f"{k[0]}/{k[1]} {v / TIMED_STEPS:g}"
                 for k, v in sorted(by_shape3.items()) if k[2] == s.rows]
        kinds += [f"gather-ELL {k[0]} {v / TIMED_STEPS:g}"
                  for k, v in sorted(gathers3.items()) if k[1] == s.rows]
        per_level.append(f"L{lvl} {s.rows}: " + ", ".join(kinds))
    log("main3d", "launches per step by level (dia_stencil variant/mode; "
        "gather-ELL products): " + "; ".join(per_level))
    if any(s.offsets is None for s in shapes3) and not gathers3:
        raise AssertionError("the gather-ELL products never ran")
    profile_steps(flow, thermal, step3_ms)
    del flow, thermal, dmesh

    # ---- 11. kernel timing at the 3D shapes -------------------------------
    # momentum BiCGStab mv on (n, 3); AMG residual and Jacobi on (n,)
    kernels += time_modes(" (3d)", shapes3[0].rows, shapes3[0].offsets,
                          (("mv", 3), ("residual", 1), ("jacobi", 1)),
                          launches3, errors3, MAIN_DTYPE)
    level_table(shapes3, by_shape3, gathers3, MAIN_DTYPE)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
