#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fvm_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each or a short table (a failing phase raises and the
script exits non-zero before the last line):

  1. device   - requires CUDA; prints the card, the device count and
                ``nvidia-smi --query-gpu=name,power.limit``;
  2. build    - builds the ``dia_stencil`` CUDA kernel's two variants
                (wide, narrow) from the repository's sources, four nvcc
                runs in parallel (ptxas register/spill summary);
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
then the ``kernels`` JSON line and, last, the device JSON line.

It imports nothing of JAX and nothing of the JAX package ``fvm_tpu``.
"""

from __future__ import annotations

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
# kernel timing: calls per measurement, and operand copies cycled through
# (4 x ~36 MB at the fine level, beyond the 50 MB L2)
TIMING_REPS = 200
LEVEL_REPS = 100
TIMING_COPIES = 4
# the library call timed beside each mode, and its agreement with the plain
# version (float32, another summation order)
LIBRARY_CALL = {"mv": "torch.sparse.mm", "residual": "torch.addmv"}
LIBRARY_RTOL = 1e-5
TPU_KERNEL = "fvm_tpu/ops/pallas_kernels.py:125"
KERNEL_SOURCE = "fvm_tpu_torch/csrc/dia_stencil.cu"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def kernel_vs_plain(label, n, offsets, device, errors, nrhs=(1, 2),
                    views=False):
    """Both variants against the plain version at one shape, bit for bit;
    max abs errors go into ``errors`` by variant and mode.  With ``views``
    x and b are views at unaligned bases.  One log line per shape."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools.kernel_bench import random_operator, random_vectors

    checks, worst = 0, 0.0
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        coef, diag = random_operator(n, offsets, dtype, device, seed=1)
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
                    torch.cuda.synchronize()
                    err = float((y - y_ref).abs().max())
                    if not (bool(torch.isfinite(y).all()) and err == 0.0):
                        raise AssertionError(
                            f"dia_stencil {variant} disagrees: {label} "
                            f"{dtype_name} m={m} {mode}: max abs err {err:.3e}")
                    key = (variant, mode)
                    errors[key] = max(errors.get(key, 0.0), err)
                    worst = max(worst, err)
                    checks += 1
    log("kernel", f"{label}: n={n} offsets={tuple(offsets)}: {checks} checks "
        f"(variants x dtypes x m x modes), max abs err {worst:g} (need 0) ok")


def coupled_history(n, steps, device, dtype):
    """Residual history of ``steps`` coupled outer steps on ``device``."""
    from fvm_tpu_torch.cases import coupled_cavity, coupled_step

    flow, thermal = coupled_cavity(n, device=device, dtype=dtype)
    return [[float(v) for v in coupled_step(flow, thermal)]
            for _ in range(steps)]


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


def level_shapes(flow):
    """(rows, offsets) of every smoothed level of the pressure AMG's
    hierarchy, as the main path built it: the condensed fine level, then
    each structured coarse level but the coarsest (solved densely)."""
    amg = flow.options["pressureLinearSolver"]
    levels = next(iter(amg._levels_by_cols.values()))[1]
    dia = flow.mesh.dia
    fine = dia.cond_plan.dia2 if dia.cond_plan else dia
    return ([(flow.mesh.n_cells, tuple(fine.offsets))]
            + [(lev.nC, tuple(lev.coarse_offsets)) for lev in levels[:-1]])


def main() -> int:
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.cases import coupled_cavity, coupled_step
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

    # ---- 3. kernel vs plain on the card -----------------------------------
    # the main path's case, one warm-up step to build its AMG hierarchies
    t0 = time.time()
    flow, thermal = coupled_cavity(MAIN_N, device=device, dtype=MAIN_DTYPE)
    coupled_step(flow, thermal)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    shapes = level_shapes(flow)
    if ([(n, sorted(o)) for n, o in shapes]
            != [(n, sorted(o)) for n, o in kb.cavity_level_shapes(MAIN_N)]):
        raise AssertionError(f"AMG levels {shapes} differ from "
                             f"kernel_bench.cavity_level_shapes")
    n_main, main_offsets = shapes[0]
    errors = {}
    for lvl, (n, offsets) in enumerate(shapes):
        kernel_vs_plain(f"AMG level {lvl}" + (
            f" (cavity {MAIN_N}^2 condensed fine level)" if lvl == 0
            else ""), n, offsets, device, errors)
    kernel_vs_plain("multi-block", 3 * 512 * 128 + 777,
                    (-640, -128, -1, 1, 128, 640), device, errors)
    kernel_vs_plain("unaligned x/b views", 200_003, (-448, -1, 1, 448),
                    device, errors, nrhs=(1, 2, 3), views=True)

    # ---- 4. slice on the card vs slice on the CPU --------------------------
    t0 = time.time()
    h_gpu = coupled_history(SLICE_N, SLICE_STEPS, device, "float64")
    h_cpu = coupled_history(SLICE_N, SLICE_STEPS, "cpu", "float64")
    worst = max(abs(a - c) / max(abs(c), 1e-300)
                for rg, rc in zip(h_gpu, h_cpu) for a, c in zip(rg, rc))
    log("slice", f"{SLICE_N}^2 float64, {SLICE_STEPS} coupled steps: cuda "
        f"{h_gpu[-1]} vs cpu {h_cpu[-1]}; max rel diff {worst:.3e} "
        f"(tol {SLICE_RTOL:g}) in {time.time() - t0:.1f} s")
    if not worst <= SLICE_RTOL:
        raise AssertionError("cuda and cpu slices disagree")

    # ---- 5. main path at full size ----------------------------------------
    log("main", f"{MAIN_N}^2 {MAIN_DTYPE} coupled cavity set up and first "
        f"step in {setup_s:.1f} s ({flow.mesh.n_cells} rows)")
    for _ in range(WARMUP_STEPS - 1):
        coupled_step(flow, thermal)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        res = coupled_step(flow, thermal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dk.dia_stencil.launches)
    by_shape = dict(dk.dia_stencil.shapes)
    by_variant = dk.variant_launches()
    resids = [float(v) for v in res]
    cells = MAIN_N * MAIN_N
    log("main", f"{TIMED_STEPS} coupled steps in {dt:.4f} s: "
        f"{cells * TIMED_STEPS / dt:.6e} cells/s, "
        f"{1e3 * dt / TIMED_STEPS:.3f} ms/step")
    log("main", "dia_stencil launches per step: " + ", ".join(
        f"{m} {launches[m] / TIMED_STEPS:g}" for m in dk.MODES) + "; " +
        ", ".join(f"{v} {by_variant[v] / TIMED_STEPS:g}"
                  for v in dk.VARIANTS))
    log("main", f"final residuals (mom, cont, thermal): {resids}")
    log("main", f"max memory allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    V = flow.state["velocity"]
    if tuple(V.shape) != (flow.mesh.n_cells, 2) or not bool(
            torch.isfinite(V).all()):
        raise AssertionError("velocity field is not finite or misshapen")
    if not all(v == v and abs(v) != float("inf") for v in resids):
        raise AssertionError(f"non-finite residuals {resids}")
    missing = [m for m in dk.MODES if launches[m] == 0]
    missing += [v for v in dk.VARIANTS if by_variant[v] == 0]
    if missing:
        raise AssertionError(f"dia_stencil never launched: {missing}")
    profile_steps(flow, thermal, 1e3 * dt / TIMED_STEPS)
    del flow, thermal, res, V

    def per_step(variant, mode, n):
        return by_shape.get((variant, mode, n), 0) / TIMED_STEPS

    # ---- 6. kernel timing at the main path's shapes ------------------------
    dtype = getattr(torch, MAIN_DTYPE)
    item = torch.empty((), dtype=dtype).element_size()
    D = len(main_offsets)
    kernels = []
    # momentum BiCGStab mv on (n, 2); AMG residual and Jacobi on (n,)
    for mode, m in (("mv", 2), ("residual", 1), ("jacobi", 1)):
        kw_extra = {"omega": 0.7} if mode == "jacobi" else {}
        sets = []
        for k in range(TIMING_COPIES):
            coef, diag = kb.random_operator(n_main, main_offsets, dtype,
                                            device, seed=10 + k)
            x, b = kb.random_vectors(n_main, m, dtype, device, seed=20 + k)
            kw = dict(kw_extra) if mode == "mv" else dict(kw_extra, b=b)
            sets.append((coef, diag, x, kw))

        def kernel_call(c):
            coef, diag, x, kw = c
            return lambda: dk.dia_stencil(main_offsets, mode, coef, diag, x,
                                          **kw)

        def plain_call(c):
            coef, diag, x, kw = c
            return lambda: dk.dia_stencil_plain(main_offsets, mode, coef,
                                                diag, x, **kw)

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
            libs = [library_call(mode, csr_copy(main_offsets, c[0], c[1]),
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
        bound_ms, bound_by, nbytes, nops = kb.bound(n_main, m, D, mode, item)
        variant = "wide" if n_main >= dk.WIDE_MIN_ROWS else "narrow"
        log("timing", f"dia_stencil {mode} ({variant}) n={n_main} m={m} "
            f"{MAIN_DTYPE}: device {ms:.5f} ms (graph replay "
            f"{graph_ms:.5f}, eager {eager_ms:.5f}), bound {bound_ms:.5f} ms "
            f"by {bound_by} ({nbytes} B at 3.35 TB/s; {nops} flop at 67 "
            f"TFLOP/s), {100 * bound_ms / ms:.1f}% of bound; plain device "
            f"{plain_ms:.5f} ms; "
            + ("library: none for jacobi (no single call)"
               if library_ms is None else
               f"{LIBRARY_CALL[mode]} CSR device {library_ms:.5f} ms "
               f"(eager {library_eager_ms:.5f})"))
        kernels.append({
            "name": f"dia_stencil.{mode}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode],
            "max_abs_err": max(v for (_, md), v in errors.items()
                               if md == mode),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })

    # every smoothed AMG level: Jacobi and residual device ms per launch
    # (the variant the dispatch takes), the bound, and launches x (time -
    # bound) per step
    log("levels", "lvl rows variant | jacobi: launches/step ms bound share "
        "| residual: launches/step ms bound share | excess ms/step")
    total = {"ms": 0.0, "bound": 0.0}
    for lvl, (n, offsets) in enumerate(shapes):
        variant = "wide" if n >= dk.WIDE_MIN_ROWS else "narrow"
        cells_ = []
        excess = 0.0
        for mode in ("jacobi", "residual"):
            ops = []
            for k in range(TIMING_COPIES):
                coef, diag = kb.random_operator(n, offsets, dtype, device,
                                                seed=30 + k)
                x, b = kb.random_vectors(n, 1, dtype, device, seed=40 + k)
                ops.append((coef, diag, x, b))
            omega = 0.7 if mode == "jacobi" else None
            t = kb.time_device(
                [lambda o=o: dk.dia_stencil(offsets, mode, o[0], o[1], o[2],
                                            b=o[3], omega=omega)
                 for o in ops], LEVEL_REPS)
            bnd = kb.bound(n, 1, len(offsets), mode, item)[0]
            per = per_step(variant, mode, n)
            excess += per * (t - bnd)
            total["ms"] += per * t
            total["bound"] += per * bnd
            cells_.append(f"{per:5g} {t:.5f} {bnd:.5f} {100 * bnd / t:5.1f}%")
            del ops
        log("levels", f"L{lvl:<2d} {n:8d} {variant:6s} | {cells_[0]} | "
            f"{cells_[1]} | {excess:.4f}")
    log("levels", f"jacobi + residual over the levels: {total['ms']:.4f} "
        f"ms/step of kernel time against a bound of {total['bound']:.4f}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
