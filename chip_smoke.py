#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fvm_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits non-zero
before the last line):

  1. device   - requires CUDA; prints the card, the device count and
                ``nvidia-smi --query-gpu=name,power.limit``;
  2. build    - builds the ``dia_stencil`` CUDA kernel from the repository's
                sources (nvcc, ptxas register/spill report);
  3. kernel   - the kernel against its plain PyTorch version on the card:
                3 modes x {f32, f64} x {(n,), (n, 2)} at the 1024^2 cavity's
                condensed fine-level operator and at a multi-block case;
  4. slice    - the coupled flow+thermal step at 64^2 in float64 on the card
                and on the CPU (plain versions): residual histories agree;
  5. main     - the main path at full size: the 1024^2 float32 coupled
                cavity of ``bench.py:main()``, 2 warm-up + 10 timed outer
                steps, with the kernel's launch counts;
  6. timing   - the kernel, its plain version and the library call (mv:
                ``torch.sparse.mm``, residual: ``torch.addmv``, both on a
                CSR copy) at the main path's shapes, beside the bound;
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
# kernel vs plain: summation-order tolerance, relative to max |y|
KERNEL_RTOL = {"float32": 1e-6, "float64": 1e-13}
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# kernel timing: calls per measurement, and operand copies cycled through
# (4 x ~36 MB, beyond the 50 MB L2)
TIMING_REPS = 200
TIMING_COPIES = 4
# the library call timed beside each mode, and its agreement with the plain
# version (float32, another summation order)
LIBRARY_CALL = {"mv": "torch.sparse.mm", "residual": "torch.addmv"}
LIBRARY_RTOL = 1e-5
TPU_KERNEL = "fvm_tpu/ops/pallas_kernels.py:125"
KERNEL_SOURCE = "fvm_tpu_torch/csrc/dia_stencil.cu"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def random_operator(n, offsets, dtype, device, seed):
    """Random DIA operator with the out-of-range coefficients zeroed (as
    ``analyze_offsets`` guarantees for real matrices) and a dominant
    diagonal, made from a seed."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    coef = torch.randn((len(offsets), n), generator=g, dtype=torch.float64)
    idx = torch.arange(n)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = torch.rand(n, generator=g, dtype=torch.float64) + 4.0
    return coef.to(device, dtype), diag.to(device, dtype)


def random_vectors(n, m, dtype, device, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (n,) if m == 1 else (n, m)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    b = torch.randn(shape, generator=g, dtype=torch.float64)
    return x.to(device, dtype), b.to(device, dtype)


def kernel_vs_plain(label, n, offsets, device, errors):
    """All modes x dtypes x nrhs at one shape; records max abs errors of the
    float32 checks per mode into ``errors``."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk

    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        coef, diag = random_operator(n, offsets, dtype, device, seed=1)
        for m in (1, 2):
            x, b = random_vectors(n, m, dtype, device, seed=2 + m)
            for mode in dk.MODES:
                kw = {} if mode == "mv" else {"b": b}
                if mode == "jacobi":
                    kw["omega"] = 0.7
                y = dk.dia_stencil(offsets, mode, coef, diag, x, **kw)
                y_ref = dk.dia_stencil_plain(offsets, mode, coef, diag, x, **kw)
                torch.cuda.synchronize()
                scale = float(y_ref.abs().max())
                err = float((y - y_ref).abs().max())
                rel = err / scale
                ok = bool(torch.isfinite(y).all()) and rel <= KERNEL_RTOL[dtype_name]
                log("kernel", f"{label} n={n} D={len(offsets)} {dtype_name} "
                    f"m={m} {mode}: max rel err {rel:.3e} "
                    f"(tol {KERNEL_RTOL[dtype_name]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"dia_stencil disagrees: {label} "
                                         f"{dtype_name} m={m} {mode}")
                if dtype_name == MAIN_DTYPE:
                    errors[mode] = max(errors.get(mode, 0.0), err)


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


def time_device(fns, reps):
    """Mean device ms per call of ``reps`` eager calls: the self device
    time of every kernel they launched (torch.profiler), summed, over
    ``reps``.  Gaps between kernels do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(reps):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / reps


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
    the device-busy share of the unprofiled step time and the kernels that
    take the most device time."""
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
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile", "torch.profiler recorded no device time: not measured")
        return
    log("profile", f"device busy {busy:.3f} ms of a {step_ms:.3f} ms step "
        f"({100 * busy / step_ms:.1f}% busy, "
        f"{100 - 100 * busy / step_ms:.1f}% idle)")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        log("profile", f"  {ms:8.3f} ms/step {n:7.1f} calls/step  {key[:90]}")


def main() -> int:
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.cases import coupled_cavity, coupled_step
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d

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
    log("build", f"dia_stencil built from {KERNEL_SOURCE} in "
        f"{time.time() - t0:.1f} s")

    # ---- 3. kernel vs plain on the card -----------------------------------
    host = quad_2d(MAIN_N, MAIN_N)
    dmesh = build_device_mesh(host, dtype=MAIN_DTYPE, device=device)
    dia = dmesh.dia.cond_plan.dia2 if dmesh.dia.cond_plan else dmesh.dia
    main_offsets = dia.offsets
    n_main = dmesh.n_cells
    errors = {}
    kernel_vs_plain(f"cavity {MAIN_N}^2 condensed fine level", n_main,
                    main_offsets, device, errors)
    kernel_vs_plain("multi-block", 3 * 512 * 128 + 777,
                    (-640, -128, -1, 1, 128, 640), device, {})
    del dmesh

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
    t0 = time.time()
    flow, thermal = coupled_cavity(MAIN_N, device=device, dtype=MAIN_DTYPE)
    torch.cuda.synchronize()
    log("main", f"{MAIN_N}^2 {MAIN_DTYPE} coupled cavity set up in "
        f"{time.time() - t0:.1f} s ({flow.mesh.n_cells} rows)")
    for _ in range(WARMUP_STEPS):
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
    resids = [float(v) for v in res]
    cells = MAIN_N * MAIN_N
    log("main", f"{TIMED_STEPS} coupled steps in {dt:.4f} s: "
        f"{cells * TIMED_STEPS / dt:.6e} cells/s, "
        f"{1e3 * dt / TIMED_STEPS:.3f} ms/step")
    log("main", "dia_stencil launches per step: " + ", ".join(
        f"{m} {launches[m] / TIMED_STEPS:g}" for m in dk.MODES))
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
    if missing:
        raise AssertionError(f"dia_stencil modes never launched: {missing}")
    profile_steps(flow, thermal, 1e3 * dt / TIMED_STEPS)

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
            coef, diag = random_operator(n_main, main_offsets, dtype, device,
                                         seed=10 + k)
            x, b = random_vectors(n_main, m, dtype, device, seed=20 + k)
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
        ms = time_device(kern, TIMING_REPS)
        graph_ms = time_graph(kern, TIMING_REPS)
        eager_ms = time_events(kern, TIMING_REPS)
        plain_ms = time_device(plain, TIMING_REPS)
        plain_graph_ms = time_graph(plain, TIMING_REPS)
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
            library_ms = time_device(libs, TIMING_REPS)
            library_eager_ms = time_events(libs, TIMING_REPS)
            del libs, got, want
        del sets, kern, plain
        # each input read once, the output written once; operations per
        # element: diag product + D multiply-adds (+1 residual, +4 Jacobi)
        vec = n_main * m
        nbytes = item * (n_main * (D + 1) + vec * (2 if mode == "mv" else 3))
        nops = vec * (2 * D + 1 + {"mv": 0, "residual": 1, "jacobi": 4}[mode])
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / FP32_OPS_PER_S
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log("timing", f"dia_stencil {mode} n={n_main} m={m} {MAIN_DTYPE}: "
            f"device {ms:.4f} ms (graph replay {graph_ms:.4f}, eager "
            f"{eager_ms:.4f}), bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} B at 3.35 TB/s; {nops} flop at 67 TFLOP/s), "
            f"{100 * bound_ms / ms:.1f}% of bound; plain device "
            f"{plain_ms:.4f} ms (graph replay {plain_graph_ms:.4f}); "
            + ("library: none for jacobi (no single call)"
               if library_ms is None else
               f"{LIBRARY_CALL[mode]} CSR device {library_ms:.4f} ms "
               f"(eager {library_eager_ms:.4f})"))
        kernels.append({
            "name": f"dia_stencil.{mode}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode], "max_abs_err": errors[mode],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
