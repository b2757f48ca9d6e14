#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fvm_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each or a short table (a failing phase raises and the
script exits non-zero before the last line):

  1. device   - requires CUDA; prints the card, the device count and
                ``nvidia-smi --query-gpu=name,power.limit``;
  2. build    - builds the ``dia_stencil`` CUDA kernel's two variants
                (wide, narrow) in f32 and f64 and its bfloat16 variant
                (narrow) from the repository's sources, five nvcc runs in
                parallel (ptxas register/spill summary), and the host
                aggregation helper of the greedy AMG (``c++``);
  3. kernel   - each variant against the plain PyTorch version on the
                card, max abs error 0 required: 3 modes x {f32, f64, bf16}
                x {(n,), (n, 2)} at every smoothed level of the AMG
                hierarchy the main path builds (the condensed fine level
                first) and at a multi-block case; x and b views at
                unaligned bases with n not a multiple of 4, m up to 3;
  4. slice    - the coupled flow+thermal step at 64^2 in float64 on the card
                and on the CPU (plain versions): residual histories agree;
                and ``coupled_steps`` (one CUDA graph replay of 5 steps)
                against the eager loop on the card, bit for bit; the
                float64 kernel against its plain version at the slice's
                fine level;
  5. main     - the main path at full size: the 1024^2 float32 coupled
                cavity of ``bench.py:main()``, warm-up + 10 timed outer
                steps, with the kernel's launch counts per mode, variant and
                level, and the device profile of two steps; then the same
                10 steps from the same state as one CUDA graph replay
                (``coupled_steps``, bench's fused loop): residuals equal to
                the eager loop's, ms per step, launches per step from the
                capture, and the profile of a replay;
  6. timing   - the kernel, its plain version and the library call (mv:
                ``torch.sparse.mm``, residual: ``torch.addmv``, both on a
                CSR copy) at the fine level, beside the bound; then each AMG
                level's Jacobi and residual device time per launch; and the
                float64 kernel at the same fine-level shape (its launches
                from the 64^2 float64 slice);
  7. slice3d  - the coupled 3D cavity (``coupled_cavity_3d``) at 16^3 in
                float64 on the card and on the CPU: histories agree; the
                graph replay equals the eager loop bit for bit under
                deterministic algorithms;
  8. setup3d  - the 128^3 float32 coupled 3D cavity built, host seconds per
                stage (mesh, metrics, device mesh with its cf tables and
                DIA analysis, models with their LS coefficients and greedy
                AMG hierarchies: aggregation, level tables; first step),
                and the live hierarchy: rows, DIA offsets and fallback, or
                gather-ELL;
  9. kernel3d - every variant against the plain version, max abs error 0,
                at every DIA level of that hierarchy: 3 modes x {f32, f64,
                bf16} x {(n,), (n, 3)}, and on levels with fallback entries
                the fused op with its fallback applied;
 10. main3d   - the 3D main path: warm-up + 10 timed outer steps of the
                128^3 cavity, launches per step by mode, variant and level,
                gather-ELL products by level, and the device profile; then
                the graph replay of 10 steps as in phase 5 (residuals within
                ``GRAPH3D_RTOL`` of the eager loop's: the greedy levels add
                with atomics);
 11. timing3d - phase 6 at the 3D fine level (mv on (n, 3)), then each
                level's Jacobi and residual: ``dia_stencil`` against its
                bound, or the gather-ELL products' device time and launches;
                and on the level with fallback entries the kernel beside
                its plain version and ``torch.addmv``;
 12. options  - the cavity path's options on the 64^2 float64 slice, cuda
                against cpu: AMG W and F cycles, Jacobi-preconditioned CG
                for the pressure, GMRES for the momentum, flow ``sou`` with
                thermal ``vanLeer``, ``residualNorm="L1"``, the flow and
                thermal ``outerChunk`` advance (graph replays on the card)
                and both AMG solvers in bfloat16; then the 1024^2 float32
                cavity with both AMG solvers at ``precision="bf16"``
                (bench's ``FVM_BENCH_AMG_PREC=bf16``): 10 graph-replayed
                steps, bf16 ``dia_stencil`` launches per step, and the
                bf16 kernel against its plain version and its bound at the
                fine level (and the library's bf16 CSR mv, or its error
                beside the float32 call at the same shape);
 13. newton   - the Newton endgame (``advanceNewton(4)``) from the 32^2
                float64 bench cavity after 60 SIMPLE outers, cuda against
                cpu: one program, chunked (25), chunked with the float32
                inner solve, chunked GMRES(30); entry residuals to 1e-8 in
                the float64 modes, the same fixed point in the mixed one;
                the chunk's graph replays bit for bit against the eager
                chunks under deterministic algorithms; ``advanceCoupled(20)``
                and 60 Anderson-accelerated SIMPLE outers;
 14. converge - ``cases.converge_cavity(1024)``, bench's converge mode:
                float32 SIMPLE replays to the stall, promotion to float64,
                the mixed-precision Newton endgame (inner solves as graph
                replays), thermal; seconds per phase, one line per Newton
                step, ms per inner iteration, ``dia_stencil`` launches per
                inner iteration, the idle share of a profiled chunk, peak
                memory and the time to 1e-6;
 15. homocase - bench's homoCase thermal case on its stand-in
                (``cases.homocase_standin``, hex_3d for the absent
                homoCase-10000.cas): cuda against cpu at 8^3 in float64,
                then the 22^3 float32 run (20 outers as one graph replay):
                cells/s, the final residual, launches per outer;
 16. channel  - bench's heated channel (``cases.heated_channel``, the
                immersed slab and the ZeroGradient outflow): cuda against
                cpu at 48 x 16 in float64 (flow, handoff, thermal), the
                ``outerChunk`` replays against the eager loops bit for bit,
                then the 384 x 128 float32 run to bench's tolerances
                (``cases.channel_to_tol``): seconds, outers per phase,
                mom_rel, thermal_rel, converged, ms per replayed outer,
                launches per outer from the captures, the idle share of a
                profiled chunk, the IB force and heat-flux integrals;
 17. electro  - bench's electrostatics solve on the prism stand-ins for
                the absent cav_tetra.cas (``cases.electrostatics_standin``):
                the 7,680-prism one cuda against cpu (iterations, the
                solution to 1e-8) and timed; the 1,048,576-prism one: host
                set-up by stage, its level (DIA or gather-ELL), kernel
                against plain at its shape, iterations and
                cell-iterations/s; then the model's default BiCGStab(AMG)
                on it, whose greedy levels take the gather-ELL products:
                the per-level table with bounds;
 18. family   - bench's 1024^2 float32 cavity with the pressure and thermal
                solves of the golden families ILU0 and SPIKE
                (``cases.cavity_models`` with ``cases.family_solver``, one
                device mesh for both): eager outers, ms per outer,
                pressure iterations per outer, ``dia_stencil`` launches by
                mode and by (type, variant, mode, rows, D) (the ILU sweeps
                are the D 2 residual launches), the kernels of a profiled
                ILU0 outer; one application of each preconditioner timed
                (graph-replayed, eager) and its share of a graph-replayed
                outer, whose time gives the eager outers' idle share;
                the ILU apply's kernel path against its plain version at
                full width (max abs err 0); the ILU
                sweep against its bound, its plain version and
                ``torch.addmv``; one outer as a graph replay (bit for bit
                against the eager outer); cuda against cpu at 64^2
                float64 over 10 outers with tight inner solves (the CPU
                run in a child process beside the card's);
 19. plate    - the two-material plate (``cases.two_material_plate``: a
                contact-resistance interface and periodic walls) cuda
                against cpu at 64 x 16, the closure inside ``outerChunk``
                replays against the eager outers; at 1,048,576 cells in
                float64: host set-up by stage, the hierarchy, outers and
                seconds to a 1e-10 relative residual, the max abs error
                against the exact series profile, the Mixed variant's
                energy balance, the fine level's kernel rows;
 20. small    - the slip-wall Couette flow cuda against cpu (60 outers), and
                a restart after ``outerChunk`` replays against the
                uninterrupted run, bit for bit;
 21. sens     - the sensitivities of the variable-conductivity slab
                (``cases.sensitivity_slab``) at quad_2d(1024, 1024) in
                float64: converged, three ``solve_tangent`` directions and
                ``solve_adjoint`` of the mean temperature, seconds per
                tangent and per adjoint, ``dia_stencil`` launches by shape
                and by scope (primal solves, the tangent's dA x products on
                its coefficients and its solves, the transposed solve on
                A^T), the transposed solve's iterations and residual, the
                duality gap, peak memory; the first tangent against central
                differences, <A^T u, v> against <u, A v>, and the duality
                gate (at 1024^2 where the transposed solve converges, and
                at ``SENS_GATE_N``^2); the kernel at the slab's shape and
                its transpose's against the plain version, its rows;
 22. cavsens  - the cavity's sensitivities (``cases.cavity_sensitivities``):
                at 32^2 float64 with tightened inner solves, cuda against
                cpu and the truncated duality; then bench's 1024^2 float32
                cavity from phase 5's state: ``solve_tangent_force("top",
                {"mu": 1})`` (5 iterations) and ``solve_adjoint_force``
                (4 sweeps), ms per tangent and adjoint iteration, launches
                per iteration by shape and scope, the transposed solves'
                iterations, the kernel ops outside the solves, peak memory
                and the (ungated) duality gap;
Kernel rows are timed as graph replays (``replay_ms``).  Then the
``kernels`` JSON line (with the converge path's launches in the
``(converge)`` rows and the suite's in the ``(suite)`` rows, timed at the
channel's and the card-size prisms' fine levels; the ILU sweep and the
plate's fine level in their own rows; the sensitivities' in the
``(sensitivity, f64)`` and ``(cavity sensitivities)`` rows) and, last, the
device JSON line.

It imports nothing of JAX and nothing of the JAX package ``fvm_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# the bench configuration (bench.py:44-46): 1024^2 cells in float32
MAIN_N = 1024
MAIN_DTYPE = "float32"
WARMUP_STEPS = 2
TIMED_STEPS = 10
SLICE_N = 64
SLICE_STEPS = 5
SLICE_RTOL = 1e-8
# the 3D graph replay against the eager loop without deterministic
# algorithms: the greedy levels' index_add atomics reorder sums, and two
# eager runs differed by up to 3.5e-6 relative (PERF.md, 128^3 float32)
GRAPH3D_RTOL = 3.5e-6
# bfloat16 unit round-off; the options phase holds its bf16 run cuda
# against cpu to BF16_RTOL: each outer's pressure and thermal corrections
# carry the bf16 cycle's error (a few u of the correction, rounded in
# another order on each device), which the next residual reflects
U_BF16 = 2.0 ** -8
BF16_RTOL = 8 * U_BF16
OPTION_STEPS = 3
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
LIBRARY_RTOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 8 * U_BF16}
TPU_KERNEL = "fvm_tpu/ops/pallas_kernels.py:125"
KERNEL_SOURCE = "fvm_tpu_torch/csrc/dia_stencil.cu"
KERNEL_SOURCE_BF16 = "fvm_tpu_torch/csrc/dia_stencil_bf16.cu"
HOST_SOURCE = "fvm_tpu_torch/csrc/hostlib.cpp"
# the Newton endgame, cuda against cpu: the bench cavity at 32^2 float64
# after 60 SIMPLE outers (at 64^2 the CPU reference's inner solves take
# minutes per mode).  The
# inner solves run to 1e-8 (fixed forcing in the chunked BiCGStab): at
# looser inner tolerances the history moves with the round-off of each
# device (tests/test_torch_newton.py).  Each run stops on the model's own
# tests once the entry residual is at round-off (a tight inner solve from
# there only spends its cap): the outer loop's absoluteTolerance (one
# program, checked after a step), newtonTargetResidual (chunked, checked
# before one)
NEWTON_N = 32
NEWTON_SIMPLE = 60
NEWTON_STEPS = 4
NEWTON_BASE = {"newtonKrylovTolerance": 1e-8, "newtonKrylovIterations": 300,
               "newtonTargetResidual": 1e-9}
NEWTON_MODES = [
    ("one program", {"residualSync": True, "absoluteTolerance": 1e-6}),
    ("chunked (25)", {"newtonChunkIterations": 25, "newtonForcing": "fixed"}),
    # five steps to 1e-11 (test_flow.py:552 runs six): after four, the two
    # float32 inner paths left the CPU's state at 1e-10 of the first
    # residual and the velocities 8.8e-10 apart (measured), at the edge of
    # the 1e-9 the check asks for
    ("chunked (25), float32 inner solve", {
        "newtonChunkIterations": 25, "newtonInnerPrecision": "float32",
        "newtonKrylovTolerance": 1e-3, "newtonKrylovIterations": 1500,
        "newtonTargetResidual": 1e-11, "steps": 5}),
    ("chunked (25), GMRES(30)", {
        "newtonChunkIterations": 25, "newtonInnerSolver": "gmres",
        "newtonGmresRestart": 30}),
]
NEWTON_RTOL = 1e-8
NEWTON_ATOL = 1e-12  # as tests/test_golden_histories.py: round-off floors
COUPLED_STEPS = 20
ANDERSON_STEPS = 60
# the converge path at 1024^2 in phase 14: the float32 phase and the first
# Newton step (the whole sequence to 1e-6 took 243 s of the card and five
# Newton steps, measured: scripts/converge_run.py runs it; the phase ran
# two steps until the sensitivities' phases 21-22 needed its minute); the
# run must end below the float32 floor it started the endgame from
CONVERGE_NEWTON = 1
CONVERGE_REACH = None


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
                    views=False, dia=None,
                    dtypes=("float32", "float64", "bfloat16")):
    """Every variant against the plain version at one shape, bit for bit;
    max abs errors go into ``errors`` by (dtype, variant, mode).  With ``views``
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
    for dtype_name in dtypes:
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
                for variant in dk.variants(dtype):
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
                        key = (dtype_name, variant, mode)
                        errors[key] = max(errors.get(key, 0.0), err)
                        worst = max(worst, err)
                        checks += 1
    log("kernel", f"{label}: n={n} offsets={tuple(offsets)}"
        + (f" + {int(dia.fb_rows.shape[0])} fallback entries" if fb else "")
        + f": {checks} checks (dtypes x their variants x m x modes"
        + (" x {stencil, with fallback}" if fb else "")
        + f"), max abs err {worst:g} (need 0) ok")


def coupled_history(make, n, steps, device, dtype):
    """Residual history of ``steps`` coupled outer steps on ``device``."""
    from fvm_tpu_torch.cases import coupled_step

    flow, thermal = make(n, device=device, dtype=dtype)
    return [[float(v) for v in coupled_step(flow, thermal)]
            for _ in range(steps)]


def max_rel(h, ref):
    return max(abs(a - c) / max(abs(c), 1e-300)
               for rg, rc in zip(h, ref) for a, c in zip(rg, rc))


def slice_phase(phase, make, n, label, device, exact=contextlib.nullcontext):
    """The coupled step at a small size in float64 on the card and on the
    CPU: the residual histories must agree to ``SLICE_RTOL``.  Then the
    same steps as one CUDA graph replay (``coupled_steps``) on the card:
    equal to the eager loop on the card bit for bit (both run under
    ``exact()``), and to the CPU to ``SLICE_RTOL``.  Returns the float64
    ``dia_stencil`` launches of the card's runs by mode (counters reset
    just before them) and the fine level of the slice's pressure
    hierarchy."""
    import torch
    from fvm_tpu_torch.cases import coupled_steps
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    t0 = time.time()
    dk.reset_launches()
    with exact():
        h_gpu = coupled_history(make, n, SLICE_STEPS, device, "float64")
        flow, thermal = make(n, device=device, dtype="float64")
        h_graph = coupled_steps(flow, thermal, SLICE_STEPS).tolist()
        torch.cuda.synchronize()
    launches = dk.type_launches(torch.float64)
    fine = kb.level_shapes(flow.options["pressureLinearSolver"],
                           flow.mesh)[0]
    h_cpu = coupled_history(make, n, SLICE_STEPS, "cpu", "float64")
    worst = max_rel(h_gpu, h_cpu)
    log(phase, f"{label} float64, {SLICE_STEPS} coupled steps: cuda "
        f"{h_gpu[-1]} vs cpu {h_cpu[-1]}; max rel diff {worst:.3e} "
        f"(tol {SLICE_RTOL:g}) in {time.time() - t0:.1f} s")
    if not worst <= SLICE_RTOL:
        raise AssertionError(f"{phase}: cuda and cpu slices disagree")
    runner = flow._runners[("coupled", thermal, SLICE_STEPS)]
    same = h_graph == h_gpu
    log(phase, f"{label} coupled_steps({SLICE_STEPS}) as one CUDA graph "
        f"replay ({sum(runner.captured[0].values())} dia_stencil launches "
        f"captured): {'bit-identical to' if same else 'DIFFERS from'} the "
        f"eager loop on the card; max rel diff to the cpu "
        f"{max_rel(h_graph, h_cpu):.3e}")
    if not same or not max_rel(h_graph, h_cpu) <= SLICE_RTOL:
        raise AssertionError(f"{phase}: the graph replay disagrees: "
                             f"{h_graph} vs eager {h_gpu}")
    return launches, fine


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


def replay_ms(fns, bound_ms, label, reps=TIMING_REPS):
    """Device ms per call of a kernels row: the ``reps`` calls as one
    graph replay between CUDA events (``time_graph``), held to
    ``bound_ms``, the least time the card can take for the work.  Not
    torch.profiler's summed kernel time: its sessions on the H100 lose
    device events (the kernels they record are no multiple of the calls
    made) and then read too little, below the bound at times.  A replay
    loses nothing; it counts the gaps between launches, up to a
    microsecond each.  A replay below the bound fails."""
    ms = time_graph(fns, reps)
    if not ms >= bound_ms:
        raise AssertionError(f"{label}: {ms:.5f} ms is below the bound "
                             f"{bound_ms:.5f} ms")
    return ms


def csr_copy(offsets, coef, diag):
    """The same DIA matrix as a torch CSR tensor (for ``library_ms``);
    ``diag`` None: the off-diagonal part alone."""
    import torch

    n, dev = coef.shape[1], coef.device
    rows, cols, vals = [], [], []
    if diag is not None:
        rows.append(torch.arange(n, device=dev))
        cols.append(torch.arange(n, device=dev))
        vals.append(diag)
    for j, d in enumerate(offsets):
        i = torch.arange(max(0, -d), min(n, n - d), device=dev)
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
    """One PyTorch call computing ``mode`` on the CSR matrix: A x (``mv``
    for a vector, ``sparse.mm`` for (n, m)), or b - A x as ``addmv`` with
    alpha -1."""
    import torch

    if mode == "mv":
        if x.ndim == 1:
            return lambda: torch.mv(csr, x)
        return lambda: torch.sparse.mm(csr, x)
    return lambda: torch.addmv(b, csr, x, alpha=-1)


def library_name(mode, m):
    return "torch.mv" if mode == "mv" and m == 1 else LIBRARY_CALL[mode]


def profile_steps(flow, thermal, step_ms, steps=2, run=None, tag="profile"):
    """Device time of ``steps`` coupled steps by kernel (torch.profiler):
    the device-busy share of the unprofiled step time, the kernel launches
    per step, the ``dia_stencil`` kernels' device ms per step, and the
    kernels that take the most device time.  ``run`` replaces the per-step
    loop (a graph replay of ``steps`` steps).  Returns (busy ms per step,
    kernel launches per step), or None when nothing was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch.cases import coupled_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        if run is not None:
            run()
        else:
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
        log(tag, "torch.profiler recorded no device time: not measured")
        return None
    busy = sum(r[0] for r in rows)
    kernels = sum(r[1] for r in rows)
    log(tag, f"device busy {busy:.3f} ms of a {step_ms:.3f} ms step "
        f"({100 * busy / step_ms:.1f}% busy, "
        f"{100 - 100 * busy / step_ms:.1f}% idle), "
        f"{kernels:g} kernel launches per step")
    for variant in ("wide", "narrow", "bf16"):
        mine = [r for r in rows if f"dia_{variant}_kernel" in r[2]]
        log(tag, f"dia_stencil {variant}: "
            f"{sum(r[0] for r in mine):.4f} ms/step over "
            f"{sum(r[1] for r in mine):g} launches/step")
    dia = [r for r in rows if "dia_" in r[2] and "_kernel" in r[2]]
    log(tag, f"dia_stencil device time per step: "
        f"{sum(r[0] for r in dia):.4f} ms over {sum(r[1] for r in dia):g} "
        f"launches")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log(tag, f"  {ms:8.3f} ms/step {n:7.1f} calls/step  {key[:90]}")
    # the PyTorch ops that issued those kernels (device time of each op's
    # kernels, nested ops counted in their callers too)
    ops = sorted(((e.device_time_total / 1e3 / steps, e.count / steps, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::") and e.device_time_total > 0),
                 reverse=True)
    for ms, n, key in ops[:8]:
        log(tag, f"  {ms:8.3f} ms/step {n:7.1f} calls/step  op {key}")
    return busy, kernels


def timed_steps(flow, thermal, phase, cells, label):
    """TIMED_STEPS timed coupled steps (after the caller's warm-up) with
    every launch counter reset just before; returns (ms per step,
    dia_stencil launches by mode, by (variant, mode, rows) and by variant,
    gather-ELL products by (mode, rows), the (steps, 3) residuals)."""
    import torch
    from fvm_tpu_torch.cases import coupled_step
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    t0 = time.perf_counter()
    hist = []
    for _ in range(TIMED_STEPS):
        res = coupled_step(flow, thermal)
        hist.append(res)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hist = torch.stack([torch.stack(r) for r in hist]).tolist()
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
    return (1e3 * dt / TIMED_STEPS, launches, by_shape, by_variant, gathers,
            hist)


def snapshot(flow, thermal):
    """Copies of both models' states, to start two loops from one state."""
    return ({k: v.clone() for k, v in flow.state.items()},
            {k: v.clone() for k, v in thermal.state.items()})


def restore(flow, thermal, snap):
    flow.state = {k: v.clone() for k, v in snap[0].items()}
    thermal.state = {k: v.clone() for k, v in snap[1].items()}
    thermal.state["massFlux"] = flow.state["massFlux"]


def graph_steps(flow, thermal, phase, cells, label, eager_hist, rtol,
                eager_ms):
    """bench's fused loop on the card: ``TIMED_STEPS`` coupled steps as one
    CUDA graph replay (``cases.coupled_steps``) from the state the eager
    timed loop started from.  The first call captures (a one-step warm-up,
    the capture, the replay); its residuals must equal ``eager_hist`` to
    ``rtol`` (0: bit for bit).  Then two timed replays, launches per step
    from the capture, and the profile of a third.  Returns (ms per step,
    the capture's per-replay launch counts)."""
    import torch
    from fvm_tpu_torch.cases import coupled_steps
    from fvm_tpu_torch.ops import dia_kernel as dk

    k = TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = coupled_steps(flow, thermal, k)
    hist = res.tolist()
    capture_s = time.perf_counter() - t0
    runner = flow._runners[("coupled", thermal, k)]
    worst = max_rel(hist, eager_hist)
    log(phase, f"{label}: coupled_steps({k}) captured and replayed in "
        f"{capture_s:.2f} s; residuals vs the eager loop from the same "
        f"state: max rel diff {worst:.3e} (tol {rtol:g}); max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if not worst <= rtol:
        raise AssertionError(f"{phase}: graph {hist} vs eager {eager_hist}")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = coupled_steps(flow, thermal, k)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / k)
    resids = res[-1].tolist()
    if not all(v == v and abs(v) != float("inf") for v in resids):
        raise AssertionError(f"non-finite residuals {resids}")
    ms = min(times)
    cap = runner.captured
    log(phase, f"{label} graph replay: {k} coupled steps per replay, "
        + ", ".join(f"{t:.3f}" for t in times) + f" ms/step "
        f"({cells / ms * 1e3:.6e} cells/s at the best; eager loop "
        f"{eager_ms:.3f} ms/step)")
    log(phase, "captured per step: dia_stencil " + ", ".join(
        f"{m} {cap[0].get(m, 0) / k:g}" for m in dk.MODES) + "; by type "
        + ", ".join(f"{dk.type_tag(t)}/{m} {v / k:g}" for t in (
            torch.float32, torch.float64, torch.bfloat16)
            for m, v in dk.type_launches(t, cap[1]).items() if v)
        + f"; gather-ELL products {sum(cap[2].values()) / k:g}")
    log(phase, f"final residuals (mom, cont, thermal): {resids}")
    profile_steps(flow, thermal, ms, steps=k, tag="profile-graph",
                  run=lambda: coupled_steps(flow, thermal, k))
    return ms, cap


def time_modes(tag, n, offsets, cases, launches, errors, dtype_name,
               rows=True):
    """The kernel, its plain version and the library call at one level,
    per (mode, m) of ``cases``, beside the bound; returns the ``kernels``
    JSON entries (``tag`` is appended to their names) of the modes with a
    count in ``launches`` (none without ``rows``: timings only)."""
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
        bound_ms, bound_by, nbytes, nops = kb.bound(n, m, len(offsets), mode,
                                                   item)
        label = f"dia_stencil {mode}{tag} n={n} m={m} {dtype_name}"
        ms = replay_ms(kern, bound_ms, label)
        eager_ms = time_events(kern, TIMING_REPS)
        plain_ms = replay_ms(plain, bound_ms, f"plain {label}")
        # one PyTorch call computing the same function on a CSR copy of the
        # same matrix (the port never calls it); damped Jacobi has none:
        # x + omega (b - A x) / diag needs a product and two more passes
        library_ms = library_eager_ms = None
        library_note = "none for jacobi (no single call)"
        if mode in LIBRARY_CALL:
            try:
                libs = [library_call(mode, csr_copy(offsets, c[0], c[1]),
                                     c[2], c[3].get("b")) for c in sets]
                got = libs[0]()
            except RuntimeError as e:  # a type the library does not take
                libs, library_note = None, f"{library_name(mode, m)} " \
                    f"failed: {str(e).splitlines()[0][:160]}"
                if dtype_name == "bfloat16":
                    # the float32 call at the same shape beside it, labelled
                    f32 = [library_call(mode, csr_copy(
                        offsets, c[0].float(), c[1].float()), c[2].float(),
                        None if c[3].get("b") is None else c[3]["b"].float())
                        for c in sets]
                    library_note += (
                        f"; the float32 {library_name(mode, m)} at the same "
                        f"shape (float32, not a bf16 call): "
                        f"{replay_ms(f32, bound_ms, label):.5f} ms")
                    del f32
                torch.cuda.empty_cache()
            if libs is not None:
                want = plain[0]()
                err = float((got - want).abs().max()) / float(
                    want.abs().max())
                if not err <= LIBRARY_RTOL[dtype_name]:
                    raise AssertionError(
                        f"{library_name(mode, m)} disagrees with the plain "
                        f"{mode}: rel err {err:.3e}")
                library_ms = replay_ms(libs, bound_ms, f"library {label}")
                library_eager_ms = time_events(libs, TIMING_REPS)
                del got, want
            del libs
        del sets, kern, plain
        variant = dk.dispatch(n, dtype)
        log("timing", f"dia_stencil {mode}{tag} ({variant}) n={n} m={m} "
            f"D={len(offsets)} {dtype_name}: graph replay {ms:.5f} ms "
            f"(eager {eager_ms:.5f}), bound "
            f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B at 3.35 TB/s; "
            f"{nops} flop at 67 TFLOP/s), {100 * bound_ms / ms:.1f}% of "
            f"bound; plain {plain_ms:.5f} ms; "
            + (f"library: {library_note}" if library_ms is None else
               f"{library_name(mode, m)} CSR {library_ms:.5f} ms "
               f"(eager {library_eager_ms:.5f})"))
        if not rows:
            continue
        if not launches.get(mode):
            log("timing", f"dia_stencil {mode}{tag}: not launched on this "
                f"path, so no kernels row")
            continue
        out.append({
            "name": f"dia_stencil.{mode}{tag}", "route": "cuda",
            "source": KERNEL_SOURCE_BF16 if dtype_name == "bfloat16"
            else KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode],
            "max_abs_err": max(v for (dt, _, md), v in errors.items()
                               if md == mode and dt == dtype_name),
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


def level_table(shapes, by_shape, gathers, dtype_name, steps=TIMED_STEPS):
    """Every smoothed level: Jacobi and residual per launch (graph
    replays) beside the bound (the variant the dispatch takes) and
    launches x (time - bound) per step (the counts are over ``steps``
    steps or solves); on gather-ELL levels the products' device time,
    kernel launches per product and products per step."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    dtype = getattr(torch, dtype_name)
    tag = dk.type_tag(dtype)
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
                per = gathers.get((mode, n), 0) / steps
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
            bnd = kb.bound(n, 1, len(s.offsets), mode, item)[0]
            # a graph replay (``replay_ms``), not held to the HBM bound: a
            # middle level's copies can stay in the 50 MB L2
            t = time_graph(
                [lambda o=o: dk.dia_stencil(s.offsets, mode, o[0], o[1], o[2],
                                            b=o[3], omega=omega)
                 for o in ops], LEVEL_REPS)
            per = sum(v for k, v in by_shape.items()
                      if k[:4] == (tag, variant, mode, n)) / steps
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


OPTION_CHUNK = 3


def _amg(**kw):
    from fvm_tpu_torch.linear import AMG

    return AMG(coarse_size=256, relative_tolerance=1e-3, max_iterations=6,
               **kw)


def _set(model, key, value):
    model.options[key] = value


def option_cases():
    """(label, configure(flow, thermal), chunked, tolerance) of the options
    phase, each on the bench cavity's models."""
    from fvm_tpu_torch.linear import CG, GMRES, JacobiSolver

    return [
        ("AMG W cycle (pressure)", lambda f, t: _set(
            f, "pressureLinearSolver", _amg(cycle="W")), False, SLICE_RTOL),
        ("AMG F cycle (pressure)", lambda f, t: _set(
            f, "pressureLinearSolver", _amg(cycle="F")), False, SLICE_RTOL),
        ("CG + Jacobi (pressure)", lambda f, t: _set(
            f, "pressureLinearSolver", CG(
                preconditioner=JacobiSolver(sweeps=3),
                relative_tolerance=1e-3, max_iterations=100)),
         False, SLICE_RTOL),
        ("GMRES(10) (momentum)", lambda f, t: _set(
            f, "momentumLinearSolver", GMRES(
                restart=10, relative_tolerance=1e-2, max_iterations=10)),
         False, SLICE_RTOL),
        ("flow sou + thermal vanLeer", lambda f, t: (
            _set(f, "convectionScheme", "sou"),
            _set(t, "convectionScheme", "vanLeer")), False, SLICE_RTOL),
        ('residualNorm="L1"', lambda f, t: _set(f, "residualNorm", "L1"),
         False, SLICE_RTOL),
        (f"outerChunk {OPTION_CHUNK} (flow, then thermal)",
         lambda f, t: None, True, SLICE_RTOL),
        ('AMG precision="bf16" (pressure and thermal)', lambda f, t: (
            _set(f, "pressureLinearSolver", _amg(precision="bf16")),
            _set(t, "linearSolver", _amg(precision="bf16"))),
         False, BF16_RTOL),
    ]


def run_option(configure, chunked, device):
    """The 64^2 float64 bench cavity with one option: OPTION_STEPS coupled
    steps, or (``chunked``) the flow then the thermal model advanced
    2 OPTION_CHUNK outers in chunks of OPTION_CHUNK (one CUDA graph replay
    per chunk on the card).  Returns (history, graph runners or None)."""
    from fvm_tpu_torch.cases import coupled_cavity, coupled_step

    flow, thermal = coupled_cavity(SLICE_N, device=device, dtype="float64")
    configure(flow, thermal)
    flow.init()
    thermal.init()
    if not chunked:
        return [[float(v) for v in coupled_step(flow, thermal)]
                for _ in range(OPTION_STEPS)], None
    for m in (flow, thermal):
        m.options["residualSync"] = True
        m.options["outerChunk"] = OPTION_CHUNK
    hist = [list(h[1:]) for h in flow.advance(2 * OPTION_CHUNK)]
    thermal.state["massFlux"] = flow.state["massFlux"]
    hist += [[h[1]] for h in thermal.advance(2 * OPTION_CHUNK)]
    return hist, [m._runners[("chunk", OPTION_CHUNK)] for m in (flow, thermal)]


def options_phase(device):
    """Each option of the cavity path on the card against the CPU."""
    for label, configure, chunked, tol in option_cases():
        t0 = time.time()
        h_gpu, runners = run_option(configure, chunked, device)
        h_cpu, _ = run_option(configure, chunked, "cpu")
        if len(h_gpu) != len(h_cpu):
            raise AssertionError(f"options: {label}: {len(h_gpu)} outers on "
                                 f"the card, {len(h_cpu)} on the cpu")
        worst = max_rel(h_gpu, h_cpu)
        extra = ""
        if runners is not None:
            if not all(r.graph is not None and r.replays == 2
                       for r in runners):
                raise AssertionError(f"options: {label}: not replayed")
            extra = (f"; {sum(r.replays for r in runners)} graph replays, "
                     f"dia_stencil launches captured per chunk "
                     + "/".join(str(sum(r.captured[0].values()))
                                for r in runners))
        log("options", f"{label}: {SLICE_N}^2 float64, {len(h_gpu)} outers: "
            f"cuda {h_gpu[-1]} vs cpu {h_cpu[-1]}; max rel diff "
            f"{worst:.3e} (tol {tol:g}){extra} in {time.time() - t0:.1f} s")
        if not worst <= tol:
            raise AssertionError(f"options: {label}: cuda and cpu disagree")


def bf16_main_phase(device, n_fine, offsets, errors):
    """bench's FVM_BENCH_AMG_PREC=bf16 configuration at full width: the
    1024^2 float32 cavity with both AMG cycles in bfloat16, warm-up, then
    TIMED_STEPS coupled steps as one CUDA graph replay (counters reset
    just before the first call, read just after), two timed replays; then
    the bf16 kernel at the fine level beside its bound.  Returns the
    ``kernels`` rows of the bf16 modes this path launches."""
    import torch
    from fvm_tpu_torch.cases import coupled_cavity, coupled_step, coupled_steps
    from fvm_tpu_torch.ops import dia_kernel as dk

    k = TIMED_STEPS
    t0 = time.time()
    flow, thermal = coupled_cavity(MAIN_N, device=device, dtype=MAIN_DTYPE,
                                   amg_precision="bf16")
    for _ in range(WARMUP_STEPS):
        coupled_step(flow, thermal)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    dk.reset_launches()
    t0 = time.perf_counter()
    hist = coupled_steps(flow, thermal, k).tolist()
    capture_s = time.perf_counter() - t0
    launches = dk.type_launches(torch.bfloat16)
    cap = flow._runners[("coupled", thermal, k)].captured
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = coupled_steps(flow, thermal, k)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / k)
    resids = res[-1].tolist()
    log("bf16", f"{MAIN_N}^2 {MAIN_DTYPE} cavity, both AMG cycles in "
        f"bfloat16: set up and {WARMUP_STEPS} eager steps in {setup_s:.1f} "
        f"s; coupled_steps({k}) captured and replayed in {capture_s:.2f} s; "
        f"replays " + ", ".join(f"{t:.3f}" for t in times) + " ms/step ("
        f"{MAIN_N * MAIN_N / min(times) * 1e3:.6e} cells/s at the best)")
    log("bf16", "bf16 dia_stencil launches per step (capture): " + ", ".join(
        f"{m} {v / k:g}" for m, v in
        dk.type_launches(torch.bfloat16, cap[1]).items())
        + "; in the counted run (warm-up step + one replay): " + ", ".join(
            f"{m} {v}" for m, v in launches.items()))
    log("bf16", f"residuals of the first replay, first and last step: "
        f"{hist[0]}, {hist[-1]}; after the timed replays: {resids}")
    if not all(v == v and abs(v) != float("inf")
               for row in hist + [resids] for v in row):
        raise AssertionError(f"bf16: non-finite residuals {resids}")
    if not launches["jacobi"] or not launches["residual"]:
        raise AssertionError("bf16: the bfloat16 kernel never launched")
    del flow, thermal
    gc.collect()
    return time_modes(" (bf16)", n_fine, offsets,
                      (("mv", 1), ("residual", 1), ("jacobi", 1)),
                      launches, errors, "bfloat16")


# ---- 13. the Newton endgame, cuda against cpu -------------------------------

def newton_entry():
    """The CPU bench cavity at NEWTON_N^2 float64 after NEWTON_SIMPLE SIMPLE
    outers: (host snapshot of the flow state, the first outer's momentum
    residual)."""
    from fvm_tpu_torch.cases import coupled_cavity
    from fvm_tpu_torch.models.fmg import snapshot_state

    flow, _ = coupled_cavity(NEWTON_N, device="cpu", dtype="float64")
    hist = flow.advance(NEWTON_SIMPLE)
    return snapshot_state(flow), float(hist[0][1])


def newton_model(snap, device, graphed=True, **opts):
    """A NEWTON_N^2 float64 bench cavity flow on ``device`` at the entry
    state, with the Newton options of ``NEWTON_BASE`` and ``opts``."""
    from fvm_tpu_torch.cases import coupled_cavity
    from fvm_tpu_torch.models.fmg import restore_state

    flow, _ = coupled_cavity(NEWTON_N, device=device, dtype="float64")
    restore_state(flow, snap)
    flow.options.update(NEWTON_BASE)
    flow.options.update(opts)
    flow._newton_graphed = graphed
    return flow


def newton_run(snap, device, graphed=True, steps=NEWTON_STEPS, **opts):
    """advanceNewton(steps) from the entry state: (entry residual history,
    the flow model)."""
    import torch

    flow = newton_model(snap, device, graphed, **opts)
    hist = [[float(v) for v in h[1:]] for h in flow.advanceNewton(steps)]
    if flow.mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return hist, flow


def close(a, b, rtol, atol):
    """Entry by entry |a - b| <= atol + rtol |b|."""
    return len(a) == len(b) and all(
        abs(x - y) <= atol + rtol * abs(y)
        for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def newton_phase(device):
    """advanceNewton(NEWTON_STEPS) in each mode on the card and on the CPU
    from one entry state; the chunk's graph replay against the eager
    chunk; advanceCoupled and Anderson-accelerated SIMPLE."""
    import torch
    from fvm_tpu_torch.cases import coupled_cavity
    from fvm_tpu_torch.ops import dia_kernel as dk

    t0 = time.time()
    snap, n0 = newton_entry()
    log("newton", f"entry: the {NEWTON_N}^2 float64 bench cavity after "
        f"{NEWTON_SIMPLE} SIMPLE outers on the cpu (first residual "
        f"{n0:.6e}) in {time.time() - t0:.1f} s")
    for label, opts in NEWTON_MODES:
        t0 = time.time()
        opts = dict(opts)
        steps = opts.pop("steps", NEWTON_STEPS)
        dk.reset_launches()
        h_gpu, f_gpu = newton_run(snap, device, steps=steps, **opts)
        t_gpu = time.time() - t0
        launches = dk.type_launches(torch.float32 if opts.get(
            "newtonInnerPrecision") else torch.float64)
        h_cpu, f_cpu = newton_run(snap, "cpu", steps=steps, **opts)
        trace = [(t["inner_its"], f"{t['inner_rel']:.2e}")
                 for t in getattr(f_gpu, "_newton_trace", [])]
        after = [float(f.advance(1)[0][1]) / n0 for f in (f_gpu, f_cpu)]
        V = [f.getVelocity() for f in (f_gpu, f_cpu)]
        dv = float(abs(V[0] - V[1]).max() / abs(V[1]).max())
        mixed = bool(opts.get("newtonInnerPrecision"))
        log("newton", f"{label}: entry residuals cuda "
            + ", ".join(f"{h[0]:.6e}" for h in h_gpu) + " / cpu "
            + ", ".join(f"{h[0]:.6e}" for h in h_cpu)
            + f" (advanceNewton({steps})); card inner its/rel {trace}; one "
            f"SIMPLE step after: "
            f"{after[0]:.3e} / {after[1]:.3e} of the first residual; "
            f"velocities {dv:.3e} apart; card dia_stencil launches "
            + ", ".join(f"{m} {v}" for m, v in launches.items())
            + f"; card {t_gpu:.1f} s, {time.time() - t0:.1f} s in all")
        if mixed:
            ok = max(after) < 1e-8 and dv < 1e-9
        else:
            ok = close(h_gpu, h_cpu, NEWTON_RTOL, NEWTON_ATOL)
        if not ok:
            raise AssertionError(f"newton: {label}: cuda and cpu disagree")
        if device.type == "cuda" and not sum(launches.values()):
            raise AssertionError(f"newton: {label}: dia_stencil never "
                                 f"launched on the card")
        del f_gpu, f_cpu
        gc.collect()

    # a chunk's graph replay against the same chunks run eagerly
    label, opts = NEWTON_MODES[1]
    with deterministic():
        runs = [newton_run(snap, device, graphed, steps=2, **opts)
                for graphed in (True, False)]
    (h_g, f_g), (h_e, f_e) = runs
    inner = f_g._runners[("newton", opts["newtonChunkIterations"])]
    same = h_g == h_e and all(torch.equal(f_g.state[k], f_e.state[k])
                              for k in f_g.state)
    log("newton", f"{label}, 2 steps under deterministic algorithms: graph "
        f"replays ({inner.trips_per_replay} iterations per replay, "
        f"{inner.replays} replays) "
        f"{'bit-identical to' if same else 'DIFFER from'}"
        f" the eager chunks: {h_g} vs {h_e}")
    if not same:
        raise AssertionError("newton: the chunk's replay differs from the "
                             "eager chunk")
    del runs, f_g, f_e, inner
    gc.collect()

    # advanceCoupled and Anderson-accelerated SIMPLE
    for label, run in (
            (f"advanceCoupled({COUPLED_STEPS})",
             lambda f: f.advanceCoupled(COUPLED_STEPS)),
            (f"Anderson-accelerated SIMPLE, {ANDERSON_STEPS} outers",
             lambda f: f.advance(ANDERSON_STEPS))):
        t0 = time.time()
        hs = []
        for dev in (device, "cpu"):
            flow, _ = coupled_cavity(NEWTON_N, device=dev, dtype="float64")
            if "Anderson" in label:
                flow.options["acceleration"] = "anderson"
            hs.append([[float(v) for v in h[1:]] for h in run(flow)])
        worst = max_rel(*hs)
        log("newton", f"{label} at {NEWTON_N}^2 float64: cuda {hs[0][-1]} vs "
            f"cpu {hs[1][-1]}; max rel diff {worst:.3e} (tol {SLICE_RTOL:g})"
            f" in {time.time() - t0:.1f} s")
        if len(hs[0]) != len(hs[1]) or not worst <= SLICE_RTOL:
            raise AssertionError(f"newton: {label}: cuda and cpu disagree")


# ---- 14. time to a converged residual at 1024^2 ----------------------------

def converge_phase(device, kernels, result=None):
    """``cases.converge_cavity(MAIN_N)`` on the card with at most
    ``CONVERGE_NEWTON`` Newton steps: bench's converge mode (float32 SIMPLE
    to the stall, promotion, the mixed-precision Newton endgame, 20 float64
    thermal steps), counters reset just before it; it must reach
    ``CONVERGE_REACH`` (None: below the float32 floor it promoted at).
    Returns the ``kernels`` rows of the modes it
    launched, the timing numbers taken from ``kernels`` (phase 6's
    measurements at the same shapes); ``result`` (a dict) receives
    converge_cavity's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch.cases import NEWTON_CHUNK, converge_cavity
    from fvm_tpu_torch.ops import dia_kernel as dk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    models = {}
    t0 = time.time()
    res = converge_cavity(MAIN_N, device=device, newton_steps=CONVERGE_NEWTON,
                          models=models,
                          log=lambda msg: log("converge", msg))
    wall = time.time() - t0
    if result is not None:
        result.update(res)
    launches = {t: dk.type_launches(t) for t in (torch.float32,
                                                  torch.float64)}
    by_shape = dict(dk.dia_stencil.shapes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ph = res["phases"]
    flow = models["flow"]
    inner = flow._runners[("newton", NEWTON_CHUNK)]
    its = sum(t["inner_its"] for t in ph["newton"])
    newton_s = sum(t["s"] for t in ph["newton"])
    log("converge", f"phases: f32 {ph['f32_steps']} outers in "
        f"{ph['f32_s']:.3f} s (floor rel {ph.get('f32_floor_rel', 0):.3e}), "
        f"polish set-up {ph['polish_setup_s']:.3f} s, Newton "
        f"{len(ph['newton'])} steps in {newton_s:.3f} s, {its} inner "
        f"iterations; {wall:.1f} s in all with the prefix")
    for k, t in enumerate(ph["newton"]):
        log("converge", f"newton {k}: entry rel {t['entry_rel']:.6e}, eta "
            f"{t['eta']:.3e}, inner its {t['inner_its']}, inner rel "
            f"{t['inner_rel']:.3e}, {t['s']:.3f} s")
    if its:
        log("converge", f"inner iterations: {1e3 * newton_s / its:.3f} ms "
            f"each (Newton seconds over inner iterations), "
            f"{its / newton_s:.2f} per second")
    cap = inner.trips.captured
    per = inner.trips_per_replay
    log("converge", f"dia_stencil launches per inner iteration (the trips "
        f"graph, {per} iterations per replay): {sum(cap[0].values()) / per:g}"
        " by (type, variant, mode, rows, D): " + ", ".join(
            f"{k[0]}/{k[1]}/{k[2]}/{k[3]}/D{k[4]} {v / per:g}"
            for k, v in sorted(cap[1].items())))
    log("converge", "dia_stencil launches in the converge run: " + "; ".join(
        f"{dk.type_tag(t)} " + ", ".join(f"{m} {v}" for m, v in d.items())
        for t, d in launches.items()))
    # the device idle share of one chunk replay, profiled
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inner.run_chunk(0.1)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        inner.run_chunk(0.1)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)[:8]
    idle = (f"{busy:.3f} ms in a profiled one "
            f"({100 - 100 * busy / chunk_ms:.1f}% idle; the profiler's own "
            f"cost can make this negative)" if busy else
            "not measured (no device events)")
    log("converge", f"one chunk ({inner.chunk} iterations, "
        f"{inner.n_replays} replays): {chunk_ms:.3f} ms unprofiled, device "
        f"busy {idle}")
    for ms, n, key in top:
        log("converge", f"  {ms:9.3f} ms {n:7d} calls  {key[:90]}")
    log("converge", f"peak device memory {peak:.3f} GiB")
    line = json.dumps({k: v for k, v in res.items() if k != "phases"})
    log("converge", f"time_to_rel_residual: {line}")
    V = flow.state["velocity"]
    reach = CONVERGE_REACH or ph.get("f32_floor_rel", 0.0)
    if not (res["reached_rel"] < reach and bool(torch.isfinite(V).all())):
        raise AssertionError(f"converge: reached {res['reached_rel']:.3e}, "
                             f"not below {reach:.3e}")
    if not its or not sum(launches[torch.float32].values()):
        raise AssertionError("converge: no inner iterations / no launches")
    del flow, inner, models
    gc.collect()
    rows = []
    for t, tag in ((torch.float32, ""), (torch.float64, " (f64)")):
        for mode, n in launches[t].items():
            src = next((r for r in kernels
                        if r["name"] == f"dia_stencil.{mode}{tag}"), None)
            if n and src is not None:
                rows.append(dict(src, name=f"dia_stencil.{mode}{tag} "
                                 "(converge)", launches=n))
    return rows


# ---- 15-17. the suite of bench.py --suite -----------------------------------

# phase 15: the homoCase stand-in, cuda against cpu at 8^3 in float64 (the
# chunk of HOMO_OUTERS with zero tolerances, histories to SLICE_RTOL), then
# bench's 22^3 float32 run (its residual below cases.HOMOCASE_RTOL of the
# first outer's, the temperature within HOMO_RTOL of the linear profile)
HOMO_SLICE_N = 8
HOMO_OUTERS = 6
HOMO_RTOL = 1e-5
# phase 16: the channel at 48 x 16 (the slab below y = 0.25, float64),
# cuda against cpu to CHANNEL_RTOL: 60 flow outers, the handoff and 8
# thermal outers, as tests/test_torch_channel.py holds the CPU against
# fvm_tpu (whose own histories move by 9.9e-13 and 9.5e-10 under round-off
# there); then bench's 384 x 128 float32 run to tolerance
CHANNEL_SLICE = (48, 16)
CHANNEL_OUTERS, CHANNEL_TOUTERS = 60, 8
CHANNEL_RTOL = 1e-8
CHANNEL_REPLAY = (10, 30)  # (outerChunk, outers) of the replay vs eager
CHANNEL_TIMED_CHUNKS = 3
# phase 17: bench's electrostatics solve on the prism stand-ins; the
# reference size cuda against cpu (the solution to PRISM_RTOL of its
# largest entry; both solve to 1e-10)
PRISM_RTOL = 1e-8


def suite_counts():
    """dia_stencil launches by (type tag, mode), from the counters."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk

    return {(dk.type_tag(t), m): v for t in (torch.float32, torch.float64)
            for m, v in dk.type_launches(t).items()}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def per_outer(captured, trips):
    """A runner's captured dia_stencil launches per outer, by mode."""
    from fvm_tpu_torch.ops import dia_kernel as dk

    return ", ".join(f"{m} {captured[0].get(m, 0) / trips:g}"
                     for m in dk.MODES)


def profile_run(tag, label, fn, wall_ms, top=6):
    """Profile one ``fn()`` (torch.profiler): device busy time against the
    unprofiled ``wall_ms``, the idle share, and the kernels that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        log(tag, f"{label}: device busy not measured (no device events)")
        return
    log(tag, f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"unprofiled ({100 - 100 * busy / wall_ms:.1f}% idle; the "
        f"profiler's own cost can make this negative), "
        f"{sum(r[1] for r in rows)} kernels")
    for ms, n, key in rows[:top]:
        log(tag, f"  {ms:9.3f} ms {n:7d} calls  {key[:90]}")


def homocase_phase(device, suite, smi):
    """15: the homoCase stand-in (``cases.homocase_standin``, hex_3d in
    place of the absent homoCase-10000.cas)."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    hs = {}
    for dev in (device, "cpu"):
        t = cases.homocase_standin(HOMO_SLICE_N, device=dev, dtype="float64")
        t.options["outerChunk"] = HOMO_OUTERS
        t.options["absoluteTolerance"] = 0.0
        t.options["relativeTolerance"] = 0.0
        hs[str(dev)] = [[h[1]] for h in t.advance(HOMO_OUTERS)]
    worst = max_rel(hs[str(device)], hs["cpu"])
    log("homocase", f"stand-in hex_3d({HOMO_SLICE_N}^3) float64, "
        f"{HOMO_OUTERS} outers as one chunk: cuda {hs[str(device)][-1][0]:.6e}"
        f" vs cpu {hs['cpu'][-1][0]:.6e}; max rel diff {worst:.3e} (tol "
        f"{SLICE_RTOL:g})")
    if not worst <= SLICE_RTOL:
        raise AssertionError("homocase: cuda and cpu disagree")
    t0 = time.perf_counter()
    t = cases.homocase_standin(device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shapes = kb.level_shapes(t.options["linearSolver"], t.mesh)
    log("homocase", f"stand-in hex_3d({cases.HOMOCASE_N}^3) float32 "
        f"(homoCase-10000.cas is absent): {t.mesh.n_interior_cells} cells, "
        f"set up in {setup_s:.2f} s; hierarchy {describe(shapes)}")
    dk.reset_launches()
    r = cases.homocase_run(t)
    counts = suite_counts()
    add_counts(suite, counts)
    runner = t._runners[("chunk", cases.HOMOCASE_ITERS)]
    # what comes out: the linear profile between the plates
    n_int = t.mesh.n_interior_cells
    T = t.state["T"][:n_int].double()
    z = t.mesh.cell_centroid[:n_int, 2].double()
    err = float((T - (300.0 + 100.0 * z)).abs().max()) / 400.0
    log("homocase", f"{cases.HOMOCASE_ITERS} outers as one graph replay in "
        f"{r['seconds']:.6f} s: {r['value']:.6e} cells/s, final residual "
        f"{r['residual']:.6e} ({r['residual_rel']:.3e} of the first; "
        f"converged {r['converged']}), T off the linear profile by "
        f"{err:.3e} of its largest; dia_stencil "
        f"launches per outer (capture): "
        f"{per_outer(runner.captured, cases.HOMOCASE_ITERS)}; in the run "
        + ", ".join(f"{k[0]}/{k[1]} {v}" for k, v in counts.items() if v)
        + f" [{smi}]")
    if not (err <= HOMO_RTOL and r["converged"]):
        raise AssertionError(f"homocase: residual {r['residual_rel']!r}, "
                             f"profile {err!r}")
    profile_run("homocase", f"one replay of {cases.HOMOCASE_ITERS} outers",
                lambda: t.advance(cases.HOMOCASE_ITERS), 1e3 * r["seconds"])
    return {k: v for k, v in r.items() if k != "histories"}


def channel_phase(device, suite, errors, smi):
    """16: bench's heated channel (``cases.heated_channel``); returns the
    result and the channel's fine level (its LevelShape)."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    nx, ny = CHANNEL_SLICE
    hist, models = {}, {}
    for dev in (device, "cpu"):
        f, th = cases.heated_channel(device=dev, dtype="float64", nx=nx,
                                     ny=ny)
        hf = [list(h[1:]) for h in f.advance(CHANNEL_OUTERS)]
        th.state["massFlux"] = f.state["massFlux"]
        ht = [[h[1]] for h in th.advance(CHANNEL_TOUTERS)]
        hist[str(dev)] = (hf, ht)
        models[str(dev)] = f
    wf = max_rel(hist[str(device)][0], hist["cpu"][0])
    wt = max_rel(hist[str(device)][1], hist["cpu"][1])
    F = [models[k].getIBForceIntegral() for k in (str(device), "cpu")]
    log("channel", f"{nx}x{ny} float64: {CHANNEL_OUTERS} flow outers max rel "
        f"diff cuda vs cpu {wf:.3e}, {CHANNEL_TOUTERS} thermal outers after "
        f"the handoff {wt:.3e} (tol {CHANNEL_RTOL:g}); IB force cuda "
        f"{F[0].tolist()} vs cpu {F[1].tolist()}")
    if not (wf <= CHANNEL_RTOL and wt <= CHANNEL_RTOL):
        raise AssertionError("channel: cuda and cpu disagree")
    # the outerChunk graph replays against the eager loop, bit for bit
    chunk, outers = CHANNEL_REPLAY
    f, th = cases.heated_channel(device=device, dtype="float64", nx=nx,
                                 ny=ny)
    f.options["outerChunk"] = chunk
    hc = [list(h[1:]) for h in f.advance(outers)]
    th.options["outerChunk"] = 4
    th.state["massFlux"] = models[str(device)].state["massFlux"]
    htc = [[h[1]] for h in th.advance(CHANNEL_TOUTERS)]
    runner = f._runners[("chunk", chunk)]
    same = (hc == hist[str(device)][0][:outers]
            and htc == hist[str(device)][1])
    log("channel", f"{nx}x{ny}: flow outerChunk {chunk} ({runner.replays} "
        f"replays) and thermal outerChunk 4 "
        f"{'bit-identical to' if same else 'DIFFER from'} the eager loops "
        f"on the card")
    if not same or runner.graph is None:
        raise AssertionError("channel: the graph replay disagrees")
    del f, th, models
    gc.collect()

    # bench's run at full size, float32
    t0 = time.perf_counter()
    flow, thermal = cases.heated_channel(device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shapes = kb.level_shapes(flow.options["pressureLinearSolver"], flow.mesh)
    log("channel", f"{cases.CHANNEL_NX}x{cases.CHANNEL_NY} float32: "
        f"{flow.mesh.n_interior_cells} cells, slab of "
        f"{int(flow.params['ib_mask'].sum())} cells, set up in {setup_s:.2f} "
        f"s; pressure hierarchy {describe(shapes)}")
    fine = shapes[0]
    kernel_vs_plain("channel fine level", fine.rows, fine.offsets, device,
                    errors, dtypes=("float32",))
    dk.reset_launches()
    r = cases.channel_to_tol(flow, thermal)
    hf, ht = r.pop("histories")
    counts = suite_counts()
    add_counts(suite, counts)
    fr = flow._runners[("chunk", cases.CHANNEL_CHUNK)]
    tr = thermal._runners[("chunk", cases.CHANNEL_TCHUNK)]
    log("channel", f"time to tolerance {r['value']:.4f} s: flow "
        f"{r['flow_outers']} outers (mom_rel {r['mom_rel']:.6e}, cont rel "
        f"{hf[-1][2] / hf[0][2]:.6e}), thermal {r['thermal_outers']} outers "
        f"(thermal_rel {r['thermal_rel']:.6e}); converged {r['converged']} "
        f"[{smi}]")
    log("channel", "dia_stencil launches per outer (captures): flow "
        f"{per_outer(fr.captured, cases.CHANNEL_CHUNK)}; thermal "
        f"{per_outer(tr.captured, cases.CHANNEL_TCHUNK)}; gather-ELL "
        f"products per flow outer "
        f"{sum(fr.captured[2].values()) / cases.CHANNEL_CHUNK:g}; in the "
        "run " + ", ".join(f"{k[0]}/{k[1]} {v}" for k, v in counts.items()
                           if v))
    # ms per replayed outer: whole flow chunks (the frozen form computes
    # every trip), then the device idle share of one, profiled
    times = []
    for _ in range(CHANNEL_TIMED_CHUNKS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flow.advance(cases.CHANNEL_CHUNK)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    chunk_ms = min(times)
    log("channel", f"one flow chunk of {cases.CHANNEL_CHUNK} outers: "
        + ", ".join(f"{t:.3f}" for t in times) + f" ms ("
        f"{chunk_ms / cases.CHANNEL_CHUNK:.4f} ms per replayed outer at the "
        f"best)")
    profile_run("channel", "one flow chunk",
                lambda: flow.advance(cases.CHANNEL_CHUNK), chunk_ms, top=8)
    Fib = flow.getIBForceIntegral()
    q = thermal.getHeatFluxIntegral("bottom")
    m_in, m_out = (flow.getMassFluxIntegral(g) for g in ("left", "right"))
    log("channel", f"IB force on the slab {Fib.tolist()}, pressure part "
        f"{flow.getPressureIntegralonIBFaces().tolist()}; heat into the "
        f"bottom {q:.6e}; mass flux in {m_in:.6e} out {m_out:.6e}")
    V = flow.state["velocity"]
    if not (bool(torch.isfinite(V).all()) and np_finite(Fib)
            and r["converged"]):
        raise AssertionError(f"channel: not converged: {r}")
    r["ms_per_replayed_outer"] = chunk_ms / cases.CHANNEL_CHUNK
    return r, fine


def np_finite(a):
    return all(v == v and abs(v) != float("inf") for v in a.tolist())


def electrostatics_phase(device, suite, errors, smi):
    """17: bench's electrostatics solve on the prism stand-ins for the
    absent cav_tetra.cas (``cases.electrostatics_standin``); returns the
    card-size result and its fine level."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.linear import AMG, BiCGStab
    from fvm_tpu_torch.mesh import compute_geometry
    from fvm_tpu_torch.mesh import device as device_mod
    from fvm_tpu_torch.models import electric as electric_mod
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell
    from fvm_tpu_torch.ops.dia import DIAInfo
    from fvm_tpu_torch.tools import kernel_bench as kb

    res = {}
    dk.reset_launches()
    for dev in ("cpu", device):
        em = cases.electrostatics_standin("reference", device=dev)
        res[str(dev)] = cases.electrostatics_run(
            em, reps=1 if dev == "cpu" else cases.ELECTRO_REPS)
    add_counts(suite, suite_counts())
    xg, xc = (res[k].pop("x").cpu() for k in (str(device), "cpu"))
    err = float((xg - xc).abs().max() / xc.abs().max())
    rg, rc = res[str(device)], res["cpu"]
    log("electro", f"reference-size stand-in extrude(tri_2d(16,16), 15) "
        f"({em.mesh.n_interior_cells} prisms; cav_tetra.cas is absent): "
        f"iterations cuda {rg['iterations_to_tol']} / cpu "
        f"{rc['iterations_to_tol']}, rel residual {rg['residual_rel']:.3e} / "
        f"{rc['residual_rel']:.3e}; solutions differ by {err:.3e} of the "
        f"largest (tol {PRISM_RTOL:g})")
    if not (rg["converged"] and rc["converged"] and err <= PRISM_RTOL):
        raise AssertionError("electro: reference size: cuda and cpu differ")
    log("electro", f"reference size on the card: {rg['solve_seconds']:.6f} s "
        f"per solve, {rg['value']:.6e} cell-iterations/s [{smi}]")

    # the card-size stand-in: host set-up by stage
    secs, parts = {}, {}
    t0 = time.perf_counter()
    mesh = cases.prism_mesh("card")
    secs["mesh (extrude)"] = time.perf_counter() - t0
    with stage_clock(parts, [
            (device_mod, "compute_geometry", "metrics"),
            (device_mod, "_cf_tables", "cf tables"),
            (DIAInfo, "build", "DIA analysis and condensation"),
            (electric_mod, "ls_gradient_coefficients",
             "LS gradient coefficients")]):
        t0 = time.perf_counter()
        em = cases.electrostatics_standin(mesh=mesh, device=device)
        torch.cuda.synchronize()
        secs["device mesh and model"] = time.perf_counter() - t0
    n_faces = mesh.n_faces
    del mesh
    dm = em.mesh
    dia2 = dm.dia.cond_plan.dia2 if dm.dia.cond_plan else dm.dia
    fine = kb._shape(dm.n_cells, dia2)
    log("electro", f"card-size stand-in extrude(tri_2d(128,128), 32): "
        f"{dm.n_interior_cells} prisms, {n_faces} faces, {dm.n_cells} rows; "
        f"host seconds " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + "; of which " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"; the solve's one level: {describe([fine])} (Jacobi "
        "preconditioner: no hierarchy)")
    kernel_vs_plain("prism fine level", fine.rows, fine.offsets, device,
                    errors, nrhs=(1,), dia=fine.dia, dtypes=("float64",))
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    r = cases.electrostatics_run(em)
    counts = suite_counts()
    add_counts(suite, counts)
    x = r.pop("x")
    solves = cases.ELECTRO_REPS + 1
    its = r["iterations_to_tol"]
    log("electro", f"bench's solve: {its} iterations (converged "
        f"{r['converged']}, rel residual {r['residual_rel']:.3e}), "
        f"{r['solve_seconds']:.6f} s per solve, {r['value']:.6e} "
        f"cell-iterations/s [{smi}]; dia_stencil launches per iteration "
        + ", ".join(f"{k[1]} {v / solves / max(its, 1):.3g}"
                    for k, v in counts.items() if v)
        + f"; gather-ELL products {sum(ell.gather_ell_ops.values())}")
    if not (bool(torch.isfinite(x).all()) and its > 0):
        raise AssertionError(f"electro: card size: {r}")
    A, b = em._linearize_potential(dm, em.params, em.state,
                                   em._resolve_bcvals())
    solver = em.options["electrostaticsLinearSolver"]
    profile_run("electro", "one of bench's solves",
                lambda: solver.solve_fn(A, b, torch.zeros_like(b)),
                1e3 * r["solve_seconds"])
    # queue 2 item b: the gather-ELL products on prisms, in the greedy
    # hierarchy of the model's default solver (BiCGStab with AMG), one solve
    amg = AMG()
    t0 = time.perf_counter()
    amg.setup_structure(*dm.host_cf(), dm.device)
    amg_s = time.perf_counter() - t0
    shapes = kb.level_shapes(amg, dm)
    log("electro", f"greedy AMG on the prisms (the model's default solver): "
        f"set up in {amg_s:.2f} s; hierarchy {describe(shapes)}")
    solver = BiCGStab(preconditioner=amg, relative_tolerance=1e-10,
                      max_iterations=50)
    solver.exit_every = cases.ELECTRO_EXIT_EVERY
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xa, st = solver.solve_fn(A, b, torch.zeros_like(b))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_shape, gathers = dict(dk.dia_stencil.shapes), dict(ell.gather_ell_ops)
    diff = float((xa - x).abs().max() / x.abs().max())
    log("electro", f"BiCGStab(AMG) solve: {int(st.iterations)} iterations, "
        f"rel residual {float(st.residual / st.residual0):.3e}, {dt:.4f} s; "
        f"its solution differs from bench's by {diff:.3e} of the largest")
    if not bool(torch.isfinite(xa).all()) or not gathers:
        raise AssertionError("electro: the AMG solve ran no gather-ELL")
    level_table(shapes, by_shape, gathers, "float64", steps=1)
    return r, fine


# ---- 18-20. the linear extras and the boundary physics ----------------------

# phase 18: bench's 1024^2 float32 cavity with the pressure and thermal
# solves of the golden families ILU0 and SPIKE (cases.cavity_models on one
# device mesh): FAMILY_OUTERS[family] eager coupled outers after one
# warm-up outer (a SPIKE outer takes seconds), then one outer as a CUDA
# graph replay (bit for bit against the eager outer under deterministic
# algorithms: the condensation's index_add adds with atomics)
FAMILY_OUTERS = {"ILU0": 2, "SPIKE": 1}
FAMILY_PROFILED = ("ILU0",)
FAMILY_PROFILE_REPS = 20
# cuda against cpu at 64^2 float64 over 10 outers with the inner solves
# tightened to 1e-10 (cases.tighten_family), held at
# cases.FAMILY_TIGHT_RTOL
FAMILY_SLICE_N = 64
FAMILY_SLICE_OUTERS = 10
# phase 19: the plate at card size to a 1e-10 relative residual; its max
# abs error against the exact series profile (K, temperatures of 300-400)
# and the Mixed variant's energy balance (the heat flows over all groups
# summed, over the largest)
PLATE_ATOL = 1e-6
PLATE_BALANCE = 1e-8
PLATE_SLICE = (64, 16)
PLATE_SLICE_RTOL = 1e-8
# phase 20: the slip-wall Couette flow of tests/test_flow.py:105, its first
# 60 outers (they move by 6e-13 under a 1e-15 change of the viscosity on
# the CPU; the slip profile itself takes ~300 outers, held on the CPU by
# tests/test_torch_bc_extras.py)
SLIP_OUTERS = 60
SLIP_RTOL = 1e-8


def record_solves(model, key):
    """Wrap the model's solver ``options[key]``: the iterations of every
    solve (device tensors) and the first call's (A, b); the step rebuilt."""
    solver = model.options[key]
    inner = solver.solve_fn
    rec = {"its": [], "first": None}

    def solve_fn(A, b, x0):
        x, st = inner(A, b, x0)
        rec["its"].append(st.iterations)
        if rec["first"] is None:
            rec["first"] = (A, b)
        return x, st

    solver.solve_fn = solve_fn
    model._drop_compiled()
    return rec


def count_applies(solver, label, counts):
    """Wrap the preconditioner of ``solver``: each application counted in
    ``counts[label]``."""
    pre = solver.preconditioner
    setup = pre.precond_setup

    def precond_setup(A):
        M = setup(A)

        def counted(r):
            counts[label] = counts.get(label, 0) + 1
            return M(r)
        return counted

    pre.precond_setup = precond_setup


def family_histories(device):
    """Per family, the residual histories of 10 coupled outers of the 64^2
    float64 family cavity with tight inner solves on ``device``."""
    from fvm_tpu_torch.cases import (cavity_family, coupled_step,
                                     tighten_family)

    out = {}
    for family in ("ILU0", "SPIKE"):
        flow, thermal = cavity_family(FAMILY_SLICE_N, family, device=device,
                                      dtype="float64")
        tighten_family(flow, thermal)
        out[family] = [[float(v) for v in coupled_step(flow, thermal)]
                       for _ in range(FAMILY_SLICE_OUTERS)]
    return out


def family_slices(device):
    """cuda against cpu at 64^2 float64, held at FAMILY_TIGHT_RTOL: the
    CPU runs in a child process on one thread while the card's run here
    launches its kernels (both are host-bound)."""
    import os
    from pathlib import Path
    from fvm_tpu_torch.cases import FAMILY_TIGHT_RTOL

    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.family_histories('cpu')))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        cuda = family_histories(device)
        out, _ = child.communicate(timeout=900)
    finally:
        child.kill()
        child.wait()
    if child.returncode != 0:
        raise AssertionError(f"family: the CPU run exited "
                             f"{child.returncode}")
    cpu = json.loads(out.strip().splitlines()[-1])
    for family, hist in cuda.items():
        worst = max_rel(hist, cpu[family])
        log("family", f"{family} {FAMILY_SLICE_N}^2 float64, "
            f"{FAMILY_SLICE_OUTERS} coupled outers with tight inner solves "
            f"(1e-10), cuda vs cpu: max rel diff {worst:.3e} (tol "
            f"{FAMILY_TIGHT_RTOL[family]:g}); last cuda {hist[-1]}")
        if not worst <= FAMILY_TIGHT_RTOL[family]:
            raise AssertionError(f"family: {family}: cuda and cpu differ")
    log("family", f"the {FAMILY_SLICE_N}^2 cuda vs cpu runs in "
        f"{time.perf_counter() - t0:.1f} s")


def hist_rel(h, ref, floor=1e-10):
    """Largest relative difference of two outer histories above the
    round-off floor (``floor`` of the first outer's residual: a converged
    solve's remainder, which each device rounds its own way); inf when
    their lengths differ."""
    if len(h) != len(ref):
        return float("inf")
    lim = floor * abs(ref[0])
    return max((abs(a - c) / abs(c) for a, c in zip(h, ref)
                if abs(c) > lim or abs(a) > lim), default=0.0)


def np_finite_list(values):
    return all(v == v and abs(v) != float("inf") for v in values)


def ilu_kernel_row(A2, b2, errors, launches):
    """The ILU apply on the card against its plain version at full width
    (max abs err 0, (n,) and (n, 2)), then the sweep shape (residual, D 2,
    zero diagonal, the real factors) timed: the kernel, its plain
    version and ``torch.addmv`` on a CSR copy of the triangular part
    beside the bound.  Returns the ``kernels`` row."""
    import torch
    from fvm_tpu_torch.linear.ilu import (PackedFactors, ilu0_apply,
                                          ilu0_apply_plain, ilu0_factor)
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    l, u, ud = ilu0_factor(A2.dia.offsets, A2.dia_coef, A2.diag)
    packed = PackedFactors(l, u, ud)
    worst = 0.0
    for r in (b2, torch.stack([b2, -0.5 * b2], dim=1)):
        got = ilu0_apply(l, u, ud, r, 4, packed)
        want = ilu0_apply_plain(l, u, ud, r, 4)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and err == 0.0):
            raise AssertionError(f"ILU apply: kernel vs plain max abs err "
                                 f"{err:.3e} (need 0)")
        worst = max(worst, err)
    errors["ilu"] = worst
    n, offs = b2.shape[0], packed.neg
    log("family", f"ILU(0) apply on the card, n={n}: the kernel path "
        f"({2 * 4} dia_stencil launches, lower offsets {offs}, upper "
        f"{packed.pos}) against its plain version on (n,) and (n, 2): max "
        f"abs err {worst:g} (need 0) ok")
    sets = []
    for k in range(TIMING_COPIES):
        x, b = kb.random_vectors(n, 1, b2.dtype, b2.device, seed=30 + k)
        sets.append((dk.pack_coef(packed.l), torch.zeros_like(packed.zero),
                     x, b))
    kern = [(lambda c=c: dk.dia_stencil(offs, "residual", c[0], c[1], c[2],
                                        b=c[3])) for c in sets]
    plain = [(lambda c=c: dk.dia_stencil_plain(offs, "residual", c[0], c[1],
                                               c[2], b=c[3])) for c in sets]
    libs = [library_call("residual", csr_copy(offs, c[0], None), c[2], c[3])
            for c in sets]
    got, want = libs[0](), plain[0]()
    lib_err = float((got - want).abs().max()) / float(want.abs().max())
    if not lib_err <= LIBRARY_RTOL["float32"]:
        raise AssertionError(f"torch.addmv disagrees with the sweep: "
                             f"{lib_err:.3e}")
    # the sweep has no diagonal term: its bound counts neither the zero
    # diagonal the launch passes nor its product
    bound_ms, bound_by, nbytes, nops = kb.bound(n, 1, len(offs), "residual",
                                               b2.element_size(), diag=False)
    ms = replay_ms(kern, bound_ms, "ILU sweep")
    eager_ms = time_events(kern, TIMING_REPS)
    plain_ms = replay_ms(plain, bound_ms, "plain ILU sweep")
    lib_ms = replay_ms(libs, bound_ms, "torch.addmv ILU sweep")
    log("timing", f"dia_stencil residual (ILU sweep, D={len(offs)}, zero "
        f"diagonal) ({dk.dispatch(n, b2.dtype)}) n={n} float32: graph "
        f"replay {ms:.5f} ms (eager {eager_ms:.5f}), bound {bound_ms:.5f} "
        f"ms by {bound_by} ({nbytes} B), {100 * bound_ms / ms:.1f}% of bound; "
        f"plain {plain_ms:.5f} ms; torch.addmv CSR (the triangular "
        f"part) {lib_ms:.5f} ms")
    del sets, kern, plain, libs
    return {"name": "dia_stencil.residual (ILU sweep)", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def family_graph(family, flow, thermal, outer_ms):
    """One coupled outer of the family cavity as a CUDA graph replay
    (``cases.coupled_steps``): capture seconds, the residuals against the
    eager outer from the same state under deterministic algorithms (bit
    for bit), and the ms of two timed replays."""
    import torch
    from fvm_tpu_torch.cases import coupled_step, coupled_steps

    snap = snapshot(flow, thermal)
    with deterministic():
        eager = [float(v) for v in coupled_step(flow, thermal)]
        restore(flow, thermal, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = coupled_steps(flow, thermal, 1)[0].tolist()
        capture_s = time.perf_counter() - t0
    runner = flow._runners[("coupled", thermal, 1)]
    times = []
    for _ in range(2):
        restore(flow, thermal, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coupled_steps(flow, thermal, 1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    nodes = sum(runner.captured[0].values())
    log("family", f"{family}: one outer as a CUDA graph ({nodes} "
        f"dia_stencil launches captured): captured and replayed in "
        f"{capture_s:.2f} s; residuals "
        f"{'bit-identical to' if graph == eager else 'DIFFER from'}"
        f" the eager outer's; replays " + ", ".join(f"{t:.3f}" for t in times)
        + f" ms (eager outers {outer_ms:.3f} ms)")
    if graph != eager:
        raise AssertionError(f"family: graph {graph} vs eager {eager}")
    del runner
    flow._runners.clear()
    return min(times)


def apply_timing(label, M, r):
    """The graph-replayed ms of one preconditioner application ``M(r)``
    on the card; logged beside its eager ms and the kernels and device ms
    the profiler recorded (less what its session lost)."""
    import torch
    from fvm_tpu_torch.tools import kernel_bench as kb

    reps = FAMILY_PROFILE_REPS
    events = kb._profile(lambda: [M(r) for _ in range(reps)])
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    kernels = sum(e.count for e in events) / reps
    eager_ms = time_events([lambda: M(r)], reps)
    graph_ms = time_graph([lambda: M(r)], reps)
    log("family", f"{label} apply, n={r.shape[0]}: graph-replayed "
        f"{graph_ms:.4f} ms, eager {eager_ms:.4f} ms; the profiler recorded "
        f"{kernels:g} kernels, {dev_ms:.4f} ms of device time")
    torch.cuda.synchronize()
    return graph_ms


def families_phase(device, errors, smi):
    """18: bench's 1024^2 float32 cavity with the ILU0 and SPIKE families
    (eager), the ILU apply's kernel path against its plain version at full
    width, the apply timings, and cuda against cpu at 64^2.  Returns the
    ILU sweep's ``kernels`` row."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.cases import coupled_step
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.ops import dia_kernel as dk

    t0 = time.perf_counter()
    dmesh = build_device_mesh(quad_2d(MAIN_N, MAIN_N), dtype=MAIN_DTYPE,
                              device=device)
    torch.cuda.synchronize()
    log("family", f"{MAIN_N}^2 {MAIN_DTYPE} device mesh (both families) "
        f"in {time.perf_counter() - t0:.2f} s")
    row = None
    for family in ("ILU0", "SPIKE"):
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        flow, thermal = cases.cavity_models(
            dmesh, solver=functools.partial(cases.family_solver, family))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        outers = FAMILY_OUTERS[family]
        prec = record_solves(flow, "pressureLinearSolver")
        trec = record_solves(thermal, "linearSolver")
        applies = {}
        count_applies(flow.options["pressureLinearSolver"], "pressure",
                      applies)
        count_applies(thermal.options["linearSolver"], "thermal", applies)
        t0 = time.perf_counter()
        coupled_step(flow, thermal)  # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        dk.reset_launches()
        applies.clear()
        n0p, n0t = len(prec["its"]), len(trec["its"])
        t0 = time.perf_counter()
        for _ in range(outers):
            res = coupled_step(flow, thermal)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outer_ms = 1e3 * dt / outers
        per_outer = sum(applies.values()) / outers
        by_shape = dict(dk.dia_stencil.shapes)
        launches = dict(dk.dia_stencil.launches)
        pits = [int(i) for i in prec["its"][n0p:]]
        tits = [int(i) for i in trec["its"][n0t:]]
        resids = [float(v) for v in res]
        if not np_finite_list(resids) or not bool(
                torch.isfinite(flow.state["velocity"]).all()):
            raise AssertionError(f"family: {family}: non-finite {resids}")
        log("family", f"{family} {MAIN_N}^2 {MAIN_DTYPE}: models set up "
            f"{setup_s:.2f} s, warm-up outer {warm_s:.2f} s; "
            f"{outers} eager outer(s) {outer_ms:.3f} ms each "
            f"({MAIN_N * MAIN_N / outer_ms * 1e3:.6e} cells/s) [{smi}]; "
            f"pressure iterations per outer {pits}, thermal {tits}; "
            f"preconditioner applications per outer " + ", ".join(
                f"{k} {v / outers:g}" for k, v in applies.items())
            + f"; final residuals {resids}")
        log("family", f"{family}: dia_stencil launches per outer by mode "
            + ", ".join(f"{m} {v / outers:g}"
                        for m, v in launches.items())
            + "; by (type, variant, mode, rows, D): " + ", ".join(
                f"{k[0]}/{k[1]}/{k[2]}/{k[3]}/D{k[4]} {v / outers:g}"
                for k, v in sorted(by_shape.items())))
        sweeps = sum(v for k, v in by_shape.items()
                     if k[2] == "residual" and k[4] == 2)
        if family == "ILU0" and not sweeps:
            raise AssertionError("family: the ILU sweeps never launched "
                                 "dia_stencil")
        # one outer profiled (ILU0; a profiled SPIKE outer, ~300,000
        # kernels, takes the profiler minutes): where the device time
        # goes, as far as the session recorded it (the idle share is read
        # against the graph replay below)
        if family in FAMILY_PROFILED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                coupled_step(flow, thermal)
                torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in rows) / 1e3
            log("family", f"{family}: one profiled outer ({prof_ms:.3f} "
                f"ms): {sum(e.count for e in rows)} kernels and {busy:.3f} "
                f"ms of device time recorded; the largest:")
            top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                          for e in rows), reverse=True)[:6]
            for ms, n, key in top:
                log("family", f"  {ms:9.3f} ms {n:7d} calls  {key[:90]}")
        # the applications on the first recorded pressure system
        A, b = prec["first"]
        A2, b2, _ = A.condense(b)
        A2 = A2.prepare()
        pre = flow.options["pressureLinearSolver"].preconditioner
        M = type(pre)().precond_setup(A2)
        apply_ms = apply_timing(f"{family} pressure preconditioner", M, b2)
        if family == "ILU0":
            row = ilu_kernel_row(A2, b2, errors, sweeps)
        outer_replay_ms = family_graph(family, flow, thermal, outer_ms)
        # the applications' share of a graph-replayed outer, which holds
        # the device's work with next to no host gaps
        pre_ms = apply_ms * per_outer
        log("family", f"{family}: the applications take {pre_ms:.3f} ms "
            f"per outer ({per_outer:g} applications x {apply_ms:.4f} "
            f"ms replayed), {100 * pre_ms / outer_replay_ms:.1f}% of a "
            f"graph-replayed outer; eager outers "
            f"{100 - 100 * outer_replay_ms / outer_ms:.1f}% idle against "
            f"the replay")
        del flow, thermal, prec, trec, A, b, A2, b2, M
        gc.collect()
        torch.cuda.empty_cache()
        log("family", f"{family}: {time.perf_counter() - t_phase:.1f} s")
    del dmesh
    family_slices(device)
    return row


def plate_phase(device, errors, smi):
    """19: the two-material plate at card size, float64: host set-up by
    stage, outers and seconds to 1e-10, the error against the exact series
    profile, the Mixed variant's energy balance, cuda against cpu at 64 x
    16 and the closure inside an ``outerChunk`` replay.  Returns the
    ``kernels`` rows of the plate's fine level."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell
    from fvm_tpu_torch.tools import kernel_bench as kb

    # cuda against cpu first, small
    nx, ny = PLATE_SLICE
    for walls in ("periodic", "mixed"):
        hs, Ts = [], []
        for dev in (device, "cpu"):
            t, _ = cases.two_material_plate(device=dev, nx=nx, ny=ny,
                                            walls=walls)
            out = cases.plate_run(t)
            hs.append(out["history"])
            Ts.append(t.getTemperature())
        worst = hist_rel(hs[0], hs[1])
        terr = float(np.abs(Ts[0] - Ts[1]).max() / np.abs(Ts[1]).max())
        log("plate", f"{nx} x {ny} {walls}: cuda vs cpu outers {len(hs[0])}"
            f" / {len(hs[1])}, history max rel diff {worst:.3e}, "
            f"temperatures {terr:.3e} (tol {PLATE_SLICE_RTOL:g})")
        if not (worst <= PLATE_SLICE_RTOL and terr <= PLATE_SLICE_RTOL):
            raise AssertionError(f"plate: {walls}: cuda and cpu differ")
    # the closure's derivatives inside a graph replay (deterministic: the
    # fallback entries' index_add adds with atomics)
    runs = []
    for chunk in (0, 3):
        t, _ = cases.two_material_plate(device=device, nx=nx, ny=ny)
        t.options["relativeTolerance"] = 0.0
        t.options["absoluteTolerance"] = 0.0
        t.options["outerChunk"] = chunk
        with deterministic():
            runs.append(([float(h[1]) for h in t.advance(6)],
                         t.getTemperature()))
    same = runs[0][0] == runs[1][0] and np.array_equal(runs[0][1],
                                                       runs[1][1])
    log("plate", f"the contact-resistance closure inside outerChunk(3) "
        f"graph replays: {'bit-identical to' if same else 'DIFFERS from'} "
        f"the eager outers over 6 outers (deterministic algorithms)")
    if not same:
        raise AssertionError(f"plate: replay {runs[1][0]} vs eager "
                             f"{runs[0][0]}")

    rows = []
    for walls in ("periodic", "mixed"):
        t, secs = cases.two_material_plate(device=device, walls=walls)
        dm = t.mesh
        amg = t.options["linearSolver"].preconditioner
        shapes = kb.level_shapes(amg, dm)
        log("plate", f"{walls}: quad_2d({cases.PLATE_NX}, {cases.PLATE_NY})"
            f" float64, {dm.n_interior_cells} cells, {dm.n_cells} rows; "
            f"host seconds " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in secs.items())
            + f"; total {sum(secs.values()):.3f}; hierarchy "
            f"{describe(shapes)}")
        fine = shapes[0]
        if walls == "periodic" and fine.offsets is not None:
            kernel_vs_plain("plate fine level", fine.rows, fine.offsets,
                            device, errors, nrhs=(1,), dia=fine.dia,
                            dtypes=("float64",))
        dk.reset_launches()
        ell.gather_ell_ops.clear()
        out = cases.plate_run(t)
        counts = dk.type_launches(torch.float64)
        gathers = sum(ell.gather_ell_ops.values())
        log("plate", f"{walls}: {out['outers']} outers to rel "
            f"{out['rel']:.3e} (target {cases.PLATE_RTOL:g}) in "
            f"{out['seconds']:.3f} s [{smi}]; history "
            + ", ".join(f"{v:.6e}" for v in out["history"])
            + "; f64 dia_stencil launches " + ", ".join(
                f"{m} {v}" for m, v in counts.items())
            + f"; gather-ELL products {gathers}")
        flows = ", ".join(f"{k} {v:.9e}" for k, v in out["heat_flux"].items())
        log("plate", f"{walls}: heat flows into the domain: {flows}; energy "
            f"balance {out['balance_rel']:.3e} of the largest (tol "
            f"{PLATE_BALANCE:g})")
        if not out["converged"] or out["balance_rel"] > PLATE_BALANCE:
            raise AssertionError(f"plate: {walls}: {out}")
        if walls == "periodic":
            err = float(np.abs(t.getTemperature()
                               - cases.plate_exact(t)).max())
            log("plate", f"periodic: max abs error against the exact series "
                f"profile {err:.3e} K (tol {PLATE_ATOL:g})")
            if not err <= PLATE_ATOL:
                raise AssertionError("plate: the profile is off")
            A, r = t._linearize(dm, t.params, t.state, t._resolve_bcvals())
            solver = t.options["linearSolver"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve_fn(A, r, torch.zeros_like(r))
            torch.cuda.synchronize()
            profile_run("plate", "one solve at the converged state",
                        lambda: solver.solve_fn(A, r, torch.zeros_like(r)),
                        1e3 * (time.perf_counter() - t0))
            if fine.offsets is not None:
                rows = time_modes(
                    " (f64, plate)", fine.rows, fine.offsets,
                    (("mv", 1), ("residual", 1), ("jacobi", 1)), counts,
                    errors, "float64")
            del A, r
        del t, dm, amg
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def small_checks_phase(device):
    """20: the slip-wall Couette flow cuda against cpu, and a restart after
    an ``outerChunk`` replay against the uninterrupted run."""
    import torch
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models import FlowModel, ThermalModel

    hs, Vs = [], []
    for dev in (device, "cpu"):
        m = FlowModel(build_device_mesh(quad_2d(4, 16), dtype="float64",
                                        device=dev))
        m.options["verbose"] = False
        m.vc["viscosity"] = 1.0
        m.options["molecularWeight"] = 8314.472
        m.options["operatingTemperature"] = 2.0 / np.pi
        m.options["operatingPressure"] = 10.0
        for side, u in (("bottom", 0.0), ("top", 1.0)):
            m.bc[side].bc_type = "SlipJump"
            m.bc[side]["specifiedXVelocity"] = u
            m.bc[side]["accomodationCoefficient"] = 1.0
        m.bc["left"].bc_type = "PressureBoundary"
        m.bc["right"].bc_type = "PressureBoundary"
        m.init()
        hs.append([list(map(float, h[1:])) for h in m.advance(SLIP_OUTERS)])
        Vs.append(m.getVelocity())
    worst = max(hist_rel([h[c] for h in hs[0]], [h[c] for h in hs[1]])
                for c in (0, 1))
    verr = float(np.abs(Vs[0] - Vs[1]).max())
    log("small", f"SlipJump Couette 4 x 16, {len(hs[0])} outers: cuda vs "
        f"cpu histories max rel diff {worst:.3e}, velocities max abs diff "
        f"{verr:.3e} (tol {SLIP_RTOL:g})")
    if not (worst <= SLIP_RTOL and verr <= SLIP_RTOL):
        raise AssertionError("small: the slip-wall Couette flow is off")

    def thermal():
        t = ThermalModel(build_device_mesh(quad_2d(32, 32), dtype="float64",
                                           device=device))
        t.options["verbose"] = False
        t.options["outerChunk"] = 3
        t.options["relativeTolerance"] = 0.0
        t.options["urf"] = 0.5
        t.bc["left"].bc_type = "SpecifiedTemperature"
        t.bc["left"]["specifiedTemperature"] = 400.0
        t.bc["right"].bc_type = "Mixed"
        t.bc["right"]["heatTransferCoefficient"] = 4.0
        t.bc["right"]["surfaceEmissivity"] = 0.6
        t.bc["bottom"].bc_type = "Symmetry"
        t.bc["top"].bc_type = "Symmetry"
        t.init()
        return t

    with deterministic():
        ref = thermal()
        ref.advance(3)
        h_ref = [float(h[1]) for h in ref.advance(6)]
        t = thermal()
        t.advance(3)
        data = t.getPersistenceData()
        t.advance(3)
        t.restart(data)
        h = [float(v[1]) for v in t.advance(6)]
    same = h == h_ref and np.array_equal(t.getTemperature(),
                                         ref.getTemperature())
    runner = t._runners[("chunk", 3)]
    log("small", f"persistence: restart after outerChunk(3) replays "
        f"({runner.replays} replays of one graph): "
        f"{'bit-identical to' if same else 'DIFFERS from'} the uninterrupted "
        f"run over the next 6 outers")
    if not (same and runner.graph is not None):
        raise AssertionError(f"small: restart {h} vs {h_ref}")
    torch.cuda.synchronize()


# ---- 21-22: the sensitivities -------------------------------------------
# phase 21: the variable-conductivity slab of tests/test_sensitivity.py:
# 382-411 at quad_2d(1024, 1024), float64 (cases.sensitivity_slab)
SENS_N = 1024
SENS_SEED = 21
SENS_DIRECTIONS = 3
# the tangent against central differences, as tests/test_sensitivity.py:286
SENS_FD_EPS = 1e-6
SENS_FD_RTOL = 5e-5
# the adjoint against the tangent (<grad, v> against d(mean T) . v)
SENS_DUAL_TOL = 1e-6
# <A^T u, v> against <u, A v>, relative to |A^T u| |v|
SENS_TRANSPOSE_TOL = 1e-12
# the duality's second size: the largest power-of-two slab whose
# transposed solve (BiCGStab(Jacobi(3)), 400 iterations at most) reaches
# 1e-10 in fvm_tpu itself (scripts/duality_scale.py, on the CPU: 128^2 in
# 248 iterations; 256^2 stops at 400 with 1.5e-7)
SENS_GATE_N = 128
# phase 22: bench's 1024^2 float32 cavity from phase 5's state, K tangent
# iterations and K - 1 adjoint sweeps; the gates at 32^2 float64 with the
# inner solves tightened to 1e-12 (cases.tighten_cavity)
CAVITY_SENS_NITER = 5
CAVITY_GATE_N = 32
CAVITY_GATE_OUTERS = 20
CAVITY_GATE_NITER = 3
CAVITY_GATE_RTOL = 1e-9


def _launch_summary(shapes, scoped):
    """``dia_stencil`` launches by (type/variant/mode, rows, D), then by
    scope (the tangent's dA x and solves, the transposed solves; the rest
    are the primal solves)."""
    parts = [f"{k[0]}/{k[1]}/{k[2]} n={k[3]} D={k[4]}: {v}"
             for k, v in sorted(shapes.items())]
    total = {}
    for (_, _, mode, _, _), v in shapes.items():
        total[mode] = total.get(mode, 0) + v
    scopes = {}
    for (scope, mode), v in scoped.items():
        scopes.setdefault(scope, {})[mode] = v
        total[mode] -= v
    scopes["primal solves"] = {m: v for m, v in total.items() if v}
    return "; ".join(parts), "; ".join(
        f"{sc}: " + ", ".join(f"{m} {v}" for m, v in sorted(d.items()))
        for sc, d in sorted(scopes.items()))


def slab_duality(t, dirs):
    """The adjoint of mean T against the tangents along ``dirs``: (max
    relative gap, the transposed solve's stats)."""
    g = t.solve_adjoint(lambda T: T.mean(), ["k_cell"])["k_cell"]
    stats = t.options["linearSolver"].transpose_stats
    gaps = []
    for d in dirs:
        want = float(np.mean(t.solve_tangent({"k_cell": d})))
        gaps.append(abs(float(np.dot(g, d)) - want) / abs(want))
    return max(gaps), stats


def _stats_line(stats):
    it = int(stats.iterations)
    rel = float(stats.residual) / float(stats.residual0)
    return it, rel, bool(stats.converged)


def sensitivity_phase(device, smi):
    """Phase 21 (module docstring); returns its ``kernels`` rows."""
    import torch
    from fvm_tpu_torch.cases import sensitivity_slab
    from fvm_tpu_torch.linear.base import LinearSolver, TransposedOperator
    from fvm_tpu_torch.ops import dia_kernel as dk

    t0 = time.perf_counter()
    t = sensitivity_slab(SENS_N, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = t.advance(30)
    torch.cuda.synchronize()
    mesh = t.mesh
    n = mesh.n_interior_cells
    log("sens", f"slab quad_2d({SENS_N}, {SENS_N}) float64: {n} cells, "
        f"{mesh.n_cells} rows, set up in {setup_s:.2f} s; {len(hist)} outers "
        f"to {hist[-1][1] / hist[0][1]:.3e} of the first residual in "
        f"{time.perf_counter() - t0:.2f} s ({smi})")
    rng = np.random.default_rng(SENS_SEED)
    dirs = [rng.standard_normal(n) for _ in range(SENS_DIRECTIONS)]

    # ---- the main path: the tangents and the adjoint, counts reset just
    # before each
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    dk.reset_launches()
    t0 = time.perf_counter()
    dTs = [t.solve_tangent({"k_cell": d}) for d in dirs]
    tan_s = (time.perf_counter() - t0) / len(dirs)
    tan = (dict(dk.dia_stencil.launches), dict(dk.dia_stencil.shapes),
           dict(dk.dia_stencil.scoped))
    dk.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    with stage_clock(secs, [(LinearSolver, "transpose_solve_fn",
                             "transposed solve")]):
        g = t.solve_adjoint(lambda T: T.mean(), ["k_cell"])["k_cell"]
    adj_s = time.perf_counter() - t0
    adj = (dict(dk.dia_stencil.launches), dict(dk.dia_stencil.shapes),
           dict(dk.dia_stencil.scoped))
    peak = torch.cuda.max_memory_allocated() / 2**30
    it, rel, conv = _stats_line(t.options["linearSolver"].transpose_stats)
    log("sens", f"{tan_s:.3f} s per tangent ({len(dirs)} directions), "
        f"{adj_s:.3f} s per adjoint (the transposed solve "
        f"{secs['transposed solve']:.3f} s of it, host); peak memory "
        f"{peak:.3f} GiB, {peak - held:.3f} GiB above the {held:.3f} GiB "
        f"held before ({smi})")
    for label, (_, shapes, scoped) in (("tangents", tan), ("adjoint", adj)):
        by_shape, by_scope = _launch_summary(shapes, scoped)
        log("sens", f"dia_stencil launches, {label}: {by_shape}")
        log("sens", f"  by scope: {by_scope}")
    if not tan[2].get(("tangent dA x", "mv")):
        raise AssertionError("the tangent's dA x never launched the kernel")
    if not any(v for (sc, _), v in adj[2].items()
               if sc == "transposed solve"):
        raise AssertionError("the transposed solve never launched the kernel")
    for d in dTs + [g]:
        if d.shape != (n,) or not np.isfinite(d).all():
            raise AssertionError("a sensitivity is not finite or misshapen")
    gaps = [abs(float(np.dot(g, d)) - float(np.mean(dT)))
            / abs(float(np.mean(dT))) for d, dT in zip(dirs, dTs)]
    log("sens", f"transposed solve at {SENS_N}^2: {it} iterations (cap "
        f"{max(4 * t.options['linearSolver'].nMaxIterations, 400)}), final "
        f"relative residual {rel:.3e}, converged {conv}; duality gap "
        f"|<grad, v> - d(mean T).v| / |d(mean T).v| per direction: "
        + ", ".join(f"{v:.3e}" for v in gaps))
    if conv:
        if not max(gaps) <= SENS_DUAL_TOL:
            raise AssertionError(f"duality gap {max(gaps):.3e} at {SENS_N}^2")
    else:
        log("sens", f"the transposed solve stops at its cap at {SENS_N}^2, "
            f"as fvm_tpu's does from 256^2 on (scripts/duality_scale.py; "
            f"ROADMAP queue 3): the duality is held at {SENS_GATE_N}^2")

    # ---- the transpose: <A^T u, v> = <u, A v>
    A, _ = t._linearize(mesh, t.params, t.state, t._resolve_bcvals())
    gen = torch.Generator(device="cpu").manual_seed(SENS_SEED)
    u, v = (torch.randn(A.n, generator=gen, dtype=torch.float64).to(device)
            for _ in range(2))
    At_u = TransposedOperator(A).mv(u)
    lhs, rhs = float(At_u @ v), float(u @ A.mv(v))
    scale = float(At_u.norm() * v.norm())
    log("sens", f"<A^T u, v> = {lhs:.15e}, <u, A v> = {rhs:.15e}: "
        f"{abs(lhs - rhs) / scale:.3e} of |A^T u||v| (tol "
        f"{SENS_TRANSPOSE_TOL:g})")
    if not abs(lhs - rhs) <= SENS_TRANSPOSE_TOL * scale:
        raise AssertionError("the materialized transpose is not A^T")

    # ---- the first tangent against central differences
    k0 = 1.0 + 0.5 * np.linspace(0, 1, n)
    t0 = time.perf_counter()
    sides = []
    for sgn in (1.0, -1.0):
        ts = sensitivity_slab(SENS_N, dmesh=mesh,
                              conductivity=k0 + sgn * SENS_FD_EPS * dirs[0])
        ts.advance(30)
        sides.append(ts.getTemperature())
        del ts
    fd = (sides[0] - sides[1]) / (2 * SENS_FD_EPS)
    err = np.abs(dTs[0] - fd)
    worst = float(np.max(err / (SENS_FD_RTOL * np.abs(fd)
                                + SENS_FD_RTOL * np.abs(fd).max())))
    log("sens", f"tangent vs central differences (eps {SENS_FD_EPS:g}): max "
        f"abs err {err.max():.3e} (|fd| max {np.abs(fd).max():.3e}), "
        f"{worst:.3f} of the tolerance (rtol {SENS_FD_RTOL:g}, atol "
        f"rtol |fd|max) in {time.perf_counter() - t0:.2f} s")
    if not worst <= 1.0:
        raise AssertionError("the tangent disagrees with central differences")

    # ---- the duality where the transposed solve converges
    ts = sensitivity_slab(SENS_GATE_N, device=device)
    ts.advance(30)
    nn = ts.mesh.n_interior_cells
    gen_dirs = [np.random.default_rng(SENS_SEED + i).standard_normal(nn)
                for i in range(SENS_DIRECTIONS)]
    gap, stats = slab_duality(ts, gen_dirs)
    it2, rel2, conv2 = _stats_line(stats)
    log("sens", f"duality at {SENS_GATE_N}^2: gap {gap:.3e} (tol "
        f"{SENS_DUAL_TOL:g}); transposed solve {it2} iterations, relative "
        f"residual {rel2:.3e}, converged {conv2}")
    if not (conv2 and gap <= SENS_DUAL_TOL):
        raise AssertionError(f"duality at {SENS_GATE_N}^2 fails")
    del t, ts, A
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the kernel at the transpose's shape (the uncondensed matrix's
    # offsets negated: its dA x products and the transposed solve), then
    # the rows with this phase's launches
    launches = {m: tan[0][m] + adj[0][m] for m in dk.MODES}
    return transpose_rows(" (sensitivity, f64)", mesh, 1, launches,
                          "float64", device)


def transpose_rows(tag, mesh, m, launches, dtype_name, device):
    """The kernel against its plain version at the transposed operator's
    shape of ``mesh`` (its uncondensed DIA offsets negated, as the adjoint
    launches it), then the ``kernels`` rows with ``launches``, mv on (n,
    ``m``)."""
    offs = tuple(sorted(-d for d in mesh.dia.offsets))
    errors = {}
    kernel_vs_plain(f"{tag.strip(' ()')}: transposed fine level",
                    mesh.n_cells, offs, device, errors,
                    nrhs=tuple(sorted({1, m})), dtypes=(dtype_name,))
    return time_modes(tag, mesh.n_cells, offs,
                      (("mv", m), ("residual", 1), ("jacobi", 1)), launches,
                      errors, dtype_name)


def cavity_gates(device):
    """Phase 22's gates at 32^2 float64 with tightened inner solves: the
    cavity's sensitivities on the card against the CPU's, and the
    truncated duality on both."""
    from fvm_tpu_torch.cases import (cavity_sensitivities, coupled_cavity,
                                     tighten_cavity)

    import torch

    res = []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        flow, _ = coupled_cavity(CAVITY_GATE_N, device=dev, dtype="float64")
        tighten_cavity(flow)
        flow.advance(CAVITY_GATE_OUTERS)
        out = cavity_sensitivities(flow, niter=CAVITY_GATE_NITER)
        log("cavsens", f"{CAVITY_GATE_N}^2 float64 on {dev.type}: tangent "
            f"force {out['tangent'].tolist()}, <grad mu, 1> {out['dual']:.12e}"
            f", truncated duality gap {out['gap']:.3e} (tol "
            f"{CAVITY_GATE_RTOL:g}) in {time.perf_counter() - t0:.2f} s")
        if not out["gap"] <= CAVITY_GATE_RTOL:
            raise AssertionError(f"truncated duality on {dev.type}")
        res.append(out)
    a, b = res
    worst = float(np.max(np.abs(a["tangent"] - b["tangent"])
                         / np.abs(b["tangent"]).max()))
    for k in b["adjoint"]:
        worst = max(worst, float(np.max(np.abs(a["adjoint"][k]
                                               - b["adjoint"][k]))
                                 / np.abs(b["adjoint"][k]).max()))
    log("cavsens", f"cuda vs cpu: max rel diff {worst:.3e} (tol "
        f"{CAVITY_GATE_RTOL:g})")
    if not worst <= CAVITY_GATE_RTOL:
        raise AssertionError("cavity sensitivities: cuda vs cpu")


def cavity_sensitivity_phase(device, state, smi):
    """Phase 22 (module docstring): ``state`` is the 1024^2 flow state to
    start from (phase 5's; None: the same number of steps from rest);
    returns this phase's rows."""
    import torch
    from fvm_tpu_torch.cases import coupled_cavity
    from fvm_tpu_torch.interop import load_model_state
    from fvm_tpu_torch.linear.base import LinearSolver
    from fvm_tpu_torch.ops import dia_kernel as dk

    cavity_gates(device)
    flow, thermal = coupled_cavity(MAIN_N, device=device, dtype=MAIN_DTYPE)
    del thermal
    if state is None:  # alone (scripts/smoke_phases.py)
        for _ in range(WARMUP_STEPS + 2 * TIMED_STEPS):
            flow.advance(1)
    else:
        load_model_state(flow, {k: v.numpy() for k, v in state.items()})
    K = CAVITY_SENS_NITER
    # the main path: the tangent, then the adjoint, counts reset just
    # before each
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    dk.reset_launches()
    t0 = time.perf_counter()
    dF = flow.solve_tangent_force("top", {"mu": 1.0}, niter=K)
    tan_s = time.perf_counter() - t0
    tan = (dict(dk.dia_stencil.launches), dict(dk.dia_stencil.shapes),
           dict(dk.dia_stencil.scoped))
    dk.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    with stage_clock(secs, [
            (torch.autograd, "grad", "reverse passes"),
            (LinearSolver, "transpose_solve_fn", "transposed solves")]):
        grads = flow.solve_adjoint_force("top", None, ("mu",),
                                         ("top:specifiedXVelocity",),
                                         niter=K - 1)
    adj_s = time.perf_counter() - t0
    adj = (dict(dk.dia_stencil.launches), dict(dk.dia_stencil.shapes),
           dict(dk.dia_stencil.scoped))
    peak = torch.cuda.max_memory_allocated() / 2**30
    mom = flow.options["momentumLinearSolver"].transpose_stats
    pres = flow.options["pressureLinearSolver"].transpose_stats
    dual = float(grads["mu"].sum())
    gap = abs(dual - float(dF[0])) / abs(float(dF[0]))
    log("cavsens", f"{MAIN_N}^2 {MAIN_DTYPE} cavity from phase 5's state: "
        f"tangent force ({K} iterations) {dF.tolist()} in {tan_s:.3f} s, "
        f"{1e3 * tan_s / K:.1f} ms per tangent iteration; adjoint force "
        f"({K - 1} sweeps and the parameter sweep) in {adj_s:.3f} s, "
        f"{1e3 * adj_s / K:.1f} ms per adjoint sweep (host seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"); peak memory {peak:.3f} GiB, {peak - held:.3f} GiB above the "
        f"{held:.3f} GiB held before ({smi})")
    for label, (launch, shapes, scoped) in (("tangent", tan),
                                            ("adjoint", adj)):
        by_shape, by_scope = _launch_summary(shapes, scoped)
        log("cavsens", f"dia_stencil launches per {label} iteration: "
            + ", ".join(f"{m} {launch[m] / K:g}" for m in dk.MODES))
        log("cavsens", f"  {label}, all: {by_shape}")
        log("cavsens", f"  by scope: {by_scope}")
    for name, st in (("momentum", mom), ("pressure", pres)):
        it, rel, conv = _stats_line(st)
        log("cavsens", f"last transposed {name} solve: {it} iterations, "
            f"relative residual {rel:.3e}, converged {conv}")
    log("cavsens", f"kernel ops the differentiated SIMPLE step applies "
        f"outside its solves (their backward: scope 'stencil vjp'): "
        f"{sum(v for (sc, _), v in adj[2].items() if sc == 'stencil vjp')}"
        f" launches; <grad mu, 1> {dual:.6e} against the tangent's "
        f"{float(dF[0]):.6e}: gap {gap:.3e}, not gated: bench's inner "
        f"solves stop at 1e-2 / 1e-3, so the tangent and the adjoint are "
        f"each exact only to those tolerances")
    if not (np.isfinite(dF).all() and dF.shape == (2,)
            and all(np.isfinite(v).all() for v in grads.values())):
        raise AssertionError("cavity sensitivities are not finite")
    if not (tan[2].get(("tangent dA x", "mv"))
            and any(v for (sc, _), v in adj[2].items()
                    if sc == "transposed solve")):
        raise AssertionError("the cavity's tangent or adjoint did not "
                             "launch the kernel")
    mesh = flow.mesh
    del flow, grads
    gc.collect()
    torch.cuda.empty_cache()
    launches = {m: tan[0][m] + adj[0][m] for m in dk.MODES}
    return transpose_rows(" (cavity sensitivities)", mesh, 2, launches,
                          MAIN_DTYPE, device)


def describe(shapes):
    return "; ".join(
        f"L{i} {s.rows} rows " + (
            "gather-ELL" if s.offsets is None else
            f"DIA D={len(s.offsets)} fb={s.fallback}")
        for i, s in enumerate(shapes))


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    t_start = time.time()

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
    smi = smi_line()
    log("device", f"{kind}, {count} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    dk.build(verbose=True)
    log("build", f"dia_stencil wide and narrow (f32, f64) built from "
        f"{KERNEL_SOURCE} and narrow (bf16) from {KERNEL_SOURCE_BF16} in "
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
    launches64, fine64 = slice_phase("slice", coupled_cavity, SLICE_N,
                                     f"{SLICE_N}^2", device)
    kernel_vs_plain(f"{SLICE_N}^2 slice fine level", fine64.rows,
                    fine64.offsets, device, errors, dtypes=("float64",))

    # ---- 5. main path at full size ----------------------------------------
    log("main", f"{MAIN_N}^2 {MAIN_DTYPE} coupled cavity set up and first "
        f"step in {setup_s:.1f} s ({flow.mesh.n_cells} rows)")
    for _ in range(WARMUP_STEPS - 1):
        coupled_step(flow, thermal)
    snap = snapshot(flow, thermal)
    step_ms, launches, by_shape, by_variant, _, hist = timed_steps(
        flow, thermal, "main", MAIN_N * MAIN_N, f"{MAIN_N}^2 {MAIN_DTYPE}")
    missing = [v for v in dk.VARIANTS if by_variant[v] == 0]
    if missing:
        raise AssertionError(f"dia_stencil never launched: {missing}")
    profile_steps(flow, thermal, step_ms)
    restore(flow, thermal, snap)
    graph_steps(flow, thermal, "main", MAIN_N * MAIN_N,
                f"{MAIN_N}^2 {MAIN_DTYPE}", hist, 0.0, step_ms)
    # phase 22 starts from this state
    cavity_state = {k: v.detach().cpu() for k, v in flow.state.items()}
    del flow, thermal, snap
    gc.collect()

    # ---- 6. kernel timing at the main path's shapes ------------------------
    # momentum BiCGStab mv on (n, 2); AMG residual and Jacobi on (n,)
    kernels = time_modes("", n_main, main_offsets,
                         (("mv", 2), ("residual", 1), ("jacobi", 1)),
                         launches, errors, MAIN_DTYPE)
    level_table(shapes, by_shape, {}, MAIN_DTYPE)
    # the float64 rows: timed at the main path's fine level (a random
    # operator of its shape, as phase 3 checks it), with the launches of
    # the float64 slice's run (phase 4); at the slice's own 4,353 rows a
    # launch is launch latency alone
    kernels += time_modes(" (f64)", n_main, main_offsets,
                          (("mv", 2), ("residual", 1), ("jacobi", 1)),
                          launches64, errors, "float64")

    # ---- 7. the 3D slice on the card vs on the CPU -------------------------
    slice_phase("slice3d", coupled_cavity_3d, SLICE3D_N, f"{SLICE3D_N}^3",
                device, exact=deterministic)

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
    for _ in range(WARMUP_STEPS - 1):
        coupled_step(flow, thermal)
    snap = snapshot(flow, thermal)
    step3_ms, launches3, by_shape3, _, gathers3, hist3 = timed_steps(
        flow, thermal, "main3d", cells3, f"{MAIN3D_N}^3 {MAIN_DTYPE}")
    per_level = []
    for lvl, s in enumerate(shapes3):
        kinds = [f"{k[1]}/{k[2]} {v / TIMED_STEPS:g}"
                 for k, v in sorted(by_shape3.items()) if k[3] == s.rows]
        kinds += [f"gather-ELL {k[0]} {v / TIMED_STEPS:g}"
                  for k, v in sorted(gathers3.items()) if k[1] == s.rows]
        per_level.append(f"L{lvl} {s.rows}: " + ", ".join(kinds))
    log("main3d", "launches per step by level (dia_stencil variant/mode; "
        "gather-ELL products): " + "; ".join(per_level))
    if any(s.offsets is None for s in shapes3) and not gathers3:
        raise AssertionError("the gather-ELL products never ran")
    profile_steps(flow, thermal, step3_ms)
    restore(flow, thermal, snap)
    graph_steps(flow, thermal, "main3d", cells3, f"{MAIN3D_N}^3 {MAIN_DTYPE}",
                hist3, GRAPH3D_RTOL, step3_ms)
    del flow, thermal, dmesh, snap
    gc.collect()

    # ---- 11. kernel timing at the 3D shapes -------------------------------
    # momentum BiCGStab mv on (n, 3); AMG residual and Jacobi on (n,)
    kernels += time_modes(" (3d)", shapes3[0].rows, shapes3[0].offsets,
                          (("mv", 3), ("residual", 1), ("jacobi", 1)),
                          launches3, errors3, MAIN_DTYPE)
    level_table(shapes3, by_shape3, gathers3, MAIN_DTYPE)
    # the levels with fallback entries: the kernel alone beside its plain
    # version and the library call (the fallback's index_add follows)
    for lvl, s in enumerate(shapes3):
        if s.offsets is not None and s.fallback:
            time_modes(f" (3d L{lvl}, stencil only)", s.rows, s.offsets,
                       (("residual", 1), ("jacobi", 1)), {}, errors3,
                       MAIN_DTYPE, rows=False)

    # ---- 12. the cavity path's options -------------------------------------
    options_phase(device)
    kernels += bf16_main_phase(device, n_main, main_offsets, errors)

    # ---- 13. the Newton endgame, cuda against cpu ---------------------------
    newton_phase(device)

    # ---- 14. time to a converged residual at 1024^2 -------------------------
    kernels += converge_phase(device, kernels)

    # ---- 15-17. bench.py --suite ------------------------------------------
    suite, errors_suite = {}, {}
    homocase_phase(device, suite, smi)
    _, fine_ch = channel_phase(device, suite, errors_suite, smi)
    _, fine_pr = electrostatics_phase(device, suite, errors_suite, smi)
    log("suite", "dia_stencil launches over phases 15-17: " + ", ".join(
        f"{k[0]}/{k[1]} {v}" for k, v in sorted(suite.items())))
    kernels += time_modes(
        " (suite)", fine_ch.rows, fine_ch.offsets,
        (("mv", 2), ("residual", 1), ("jacobi", 1)),
        {m: suite.get((dk.type_tag(torch.float32), m), 0) for m in dk.MODES},
        errors_suite, "float32")
    kernels += time_modes(
        " (f64, suite)", fine_pr.rows, fine_pr.offsets,
        (("mv", 1), ("residual", 1), ("jacobi", 1)),
        {m: suite.get((dk.type_tag(torch.float64), m), 0) for m in dk.MODES},
        errors_suite, "float64")

    # ---- 18-20. the linear extras and the boundary physics ---------------
    t18 = time.time()
    kernels.extend(extras_phases(device, smi))
    log("done", f"phases 18-20 in {time.time() - t18:.1f} s")

    # ---- 21-22. the sensitivities ---------------------------------------
    t21 = time.time()
    kernels.extend(extras_phases(device, smi, (21, 22), cavity_state))
    log("done", f"phases 21-22 in {time.time() - t21:.1f} s; phases 1-22 in "
        f"{time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def extras_phases(device, smi, phases=(18, 19, 20), cavity_state=None):
    """Phases 18-22 (those in ``phases``), each timed; returns their
    ``kernels`` rows.  Phase 22 starts from ``cavity_state``."""
    errors, rows = {}, []
    for k, phase in ((18, lambda: rows.append(
            families_phase(device, errors, smi))),
            (19, lambda: rows.extend(plate_phase(device, errors, smi))),
            (20, lambda: small_checks_phase(device)),
            (21, lambda: rows.extend(sensitivity_phase(device, smi))),
            (22, lambda: rows.extend(cavity_sensitivity_phase(
                device, cavity_state, smi)))):
        if k in phases:
            t0 = time.time()
            phase()
            log("done", f"phase {k} in {time.time() - t0:.1f} s")
    return rows


if __name__ == "__main__":
    sys.exit(main())
