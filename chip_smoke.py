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
                level, and the device profile of one step; then the same
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
  8. setup3d  - the 80^3 float32 coupled 3D cavity built, host seconds per
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
                80^3 cavity, launches per step by mode, variant and level,
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
 13. newton   - the Newton endgame (``advanceNewton(3)``) from the 32^2
                float64 bench cavity after 60 SIMPLE outers, cuda against
                cpu (the CPU side in two child processes beside the card's
                runs): one program, chunked (25), chunked with the float32
                inner solve, chunked GMRES(30); entry residuals to 1e-8 in
                the float64 modes, the same fixed point in the mixed one;
                the chunk's graph replays bit for bit against the eager
                chunks under deterministic algorithms; ``advanceCoupled(20)``
                and 60 Anderson-accelerated SIMPLE outers;
 14. converge - ``cases.converge_cavity(1024)``, bench's converge mode:
                float32 SIMPLE replays to the stall, promotion to float64,
                the mixed-precision Newton endgame (one step, its inner
                solve graph replays capped at one chunk of 240 iterations),
                thermal; seconds per phase, one line per Newton
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
                float64 over 3 outers with tight inner solves (the CPU
                runs in child processes beside the card's);
 19. plate    - the two-material plate (``cases.two_material_plate``: a
                contact-resistance interface and periodic walls) cuda
                against cpu at 64 x 16, the closure inside ``outerChunk``
                replays against the eager outers; at quad_2d(1024, 256)
                (262,144 cells) in float64: host set-up by stage, the hierarchy, outers and
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
 23. mems     - the structures family's small cases cuda against cpu (the
                CPU side in two child processes; held at 1e-8): the MEMS switch
                at nx 24, ny_gap 12 (lumped stiffness, w at 0.3 and 0.6
                V_PI, 1.4 V_PI pulls in), the cantilever at 40 x 6 with
                inner solves at 1e-12 (deformation, tangent and adjoint in
                E and their duality, Monte Carlo, a creep step and the
                von Mises stress), the FSI beam at n 24 and the small
                models; then the switch at nx 96, ny_gap 32: the lumped
                stiffness, main()'s bias sweep and the 1.1 V_PI snap-down
                within time budgets (cut there), s per coupling iteration,
                ms per electric solve, plate JFNK outer and squeeze-film
                solve, dia_stencil launches by model and level, the idle
                share of a coupling iteration with capped plate solves, the
                pull-in bracket against the parallel-plate V_PI, and the
                gap's fine-level kernel rows;
 24. struct   - the cantilever UQ at 160 x 24 (converge, tangent, adjoint,
                Monte Carlo, seconds each), then the capped card-size run
                (quad_2d(1024, 154), 2 JFNK outers of 12 Krylov trips):
                ms per outer and per trip, each Jacobian-product mode's ms,
                the AD products' and block-ELL products' share of a trip,
                the residual reached, peak memory, a profiled outer;
 25. motion   - ``MovingMeshModel`` on quad_2d(512, 512) (50 sweeps on
                the card, the rebuild, volChange and the GCL), the fracture
                source-steady case and the squeeze-film strip at
                quad_2d(512, 512) float64 against their exact fields,
                with their fine levels' kernel rows;
 26. charging - the charge-transport half of ``ElectricModel`` (injection,
                capture, Poole-Frenkel emission and trap-band tunneling,
                transient) at 64 x 16 cuda against cpu and at
                quad_2d(512, 512) float64, with its charge matrix's kernel
                rows; ``DielectricChargingModel`` on the column stand-in
                for the absent 1x1x1000.cas (``cases.dielectric_column``)
                over 2 of the reference script's 100 steps cuda against
                cpu, then one step of the 8 x 8 membrane of columns
                (``cases.charging_membrane``, 64,000 cells): s per step,
                coefficient evaluation and Newton solve, Krylov trips per
                Newton step, peak memory, the potential solve's residual,
                the averages against the column's, and the internal
                electrostatics' kernel rows;
 27. ke       - ``KeModel`` over the 32^2 float64 cavity's flow cuda
                against cpu, then over bench's 1024^2 float32 cavity after
                its replayed outers (``cases.ke_cavity``): ms per outer
                eager and as ``outerChunk`` graph replays (bit for bit
                against eager), ``dia_stencil`` launches per outer, the LS
                gradients' share, a profiled outer, the fine level's rows;
 28. battery  - ``BatteryModel`` on ``demos/battery_cell.py``'s half cell
                (``cases.battery_cell``) at 32 x 4 cuda against cpu (two
                time steps; the tangent and the adjoint in sigma, timed,
                and their duality), at 128 x 16 (half the largest fvm_tpu
                converges, ``scripts/battery_scale.py``): s per Newton step
                and per time step, the Li balance against -dt I / F,
                kernels and idle share of a profiled Newton step; and one
                capped Newton step at quad_2d(512, 512);
 29. kinetic  - the ES-BGK kinetic model (``fvm_tpu_torch.kinetic``) in
                float64: cuda against cpu (the CPU side in three child
                processes) on the demo Couette (``cases.esbgk_couette``,
                COMET and Picard: the slip profile), the thick DSA case at
                quad_2d(48, 3) (the JAX test's assertion on each device,
                the plain run's relative residual the median over three
                1e-15 changes of the wall temperature) and at quad_2d(32,
                16) (one DSA application on seeded vectors, primal and
                transposed, and one outer with the inner solve at 1e-12),
                the tangent and adjoint in tau and the wall velocity at
                quad_2d(3, 10) with their duality and trips, the immersed
                moving plate at quad_2d(16, 16); ``outerChunk`` replays
                against the eager step bit for bit; then the thick case at
                quad_2d(512, 128): s per outer and per BiCGStab trip, ms per
                exact-Jacobian product, per Woodbury and per DSA
                application, ``dia_stencil`` launches per outer by mode and
                level of the DSA hierarchy, the DSA's fine-level operator
                against the plain version (bit for bit), peak memory, a
                profiled outer and the fine level's kernel rows; and the
                damping stand-in (``cases.esbgk_damping``) at Q(10, 10, 10)
                on quad_2d(192, 64) (a quarter of the largest 3:1 mesh
                within 40 GiB, for time), one time step: s per
                step, the beam force and its change, the conservation
                error, peak memory;
 30. phonon   - the phonon BTE (``PhononModel``) and the mesh I/O
                (``fvm_tpu_torch.io``) in float64: cuda against cpu (the
                CPU side in two child processes) and the JAX tests'
                assertions on each device: the thick DSA slab at
                quad_2d(32, 4) and (64, 4) (and without the DSA at 64),
                the two-band slab (COMET within 3 outers, Picard), a
                two-zone Fluent case written by ``scripts/fluent_case.py``
                and read back (the ballistic closed form, the flux
                balance), Reflecting walls at 0.5, the full scattering
                matrix (energy conserved), the tangent and adjoint with
                their duality; ``outerChunk`` replays against the eager
                step bit for bit; the thick gray slab at quad_2d(1024,
                1024) (PH_CARD_N; 1536^2 is the largest within 40 GiB),
                2 COMET outers, a cost (it stalls from its first): s per
                outer and per trip, ms per exact-Jacobian product,
                Woodbury and DSA application, ``dia_stencil`` launches per
                outer by mode and level, the DSA's fine level against the
                plain version (bit for bit), peak memory, a profiled
                outer, the fine level's kernel rows; the same slab at
                quad_2d(256, 256) (PH_CONV_N) with its inner solve allowed
                400 trips, converged to the JAX test's assertion (s to
                solution); then the I/O leg at quad_2d(512, 512): the binary
                f64 case written and read (s, MB/s, tables against the
                generated mesh's), the device mesh, 2 outers of the
                two-zone slab, ``write_vtk``, ``write_netcdf`` and
                ``read_netcdf`` (s each), a checkpoint round trip (bit for
                bit);
 31. ib       - the immersed boundary's implicit stencil rows, the
                material-point method, the FMG prolongation and the two IB
                demos: the 1024^2 float32 flow cylinder (``cases.
                ib_cylinder``, a generated stand-in): host seconds of
                ``IBManager.update``, ``interpolation_stencil`` and the
                widened set-up (DIA analysis, AMG), its widened momentum
                level against the plain version on its own coefficients
                (bit for bit, the fallback applied), 10 timed outers eager
                and as one graph replay (bit for bit with the eager loop
                under deterministic algorithms: atomics otherwise),
                ms per outer, launches per outer by mode and level, a
                profiled replay; the force balance on the converged 48^2
                float64 cylinder (``cases.ib_force_balance``, 2%); the
                1024^2 float64 hot cylinder (``cases.ib_hot_cylinder``):
                converged in 2 outers, the stencil constraint to 1e-6, its
                widened thermal level bit for bit; the kernel rows of both
                widened levels (kernel plus fallback) beside the bound, the
                plain version and the library call on a CSR copy; the MPM:
                cuda against cpu at 32^2, deterministic replays bit for
                bit, then 1,048,576 particles on a 1024^2 grid (ms per
                substep replayed, momentum held, a profiled replay);
                ``prolong_flow_state`` 256^2 -> 1024^2 (host s, first
                residual warm against cold); the cantilever stand-in and
                the adjoint design for a few steps;
 32. dist     - the distributed runtime (``fvm_tpu_torch.parallel``): one
                world of 4 gloo ranks on the card (fresh processes that
                load the kernels phase 2 built) asserts that gloo takes
                CUDA tensors for each collective, runs the
                sharded golden ``cavity/JACOBI/np4`` (1e-8), the
                64^2 float64 coupled cavity (against the same 4-rank run
                on the CPU, beside it, at 1e-8), ``dryrun_multichip``
                section 1 against the one-device run on the card (the JAX
                package's assertions) and bench's 1024^2 float32 coupled
                cavity over the 4 ranks (host set-up, ms per outer,
                collectives, bytes and their share of the outer, launches
                per outer by level, peak memory, every shard DIA level's
                kernel against the plain version); a one-rank NCCL world
                bit for bit against a one-rank gloo world; the kernel at
                the shard fine level timed in this process alone;
Each phase prints its seconds (``done`` lines).
Kernel rows are timed as graph replays (``replay_ms``).  Then the
``kernels`` JSON line (with the converge path's launches in the
``(converge)`` rows and the suite's in the ``(suite)`` rows, timed at the
channel's and the card-size prisms' fine levels; the ILU sweep and the
plate's fine level in their own rows; the sensitivities' in the
``(sensitivity, f64)`` and ``(cavity sensitivities)`` rows; the
structures family's in the ``(mems gap, f64)``, ``(fracture, f64)`` and
``(squeeze film, f64)`` rows; the remaining models' in the ``(charge
transport, f64)``, ``(charging electrostatics, f64)`` and ``(ke)`` rows;
the kinetic DSA's in the ``(kinetic DSA, f64)`` rows; the phonon DSA's
in the ``(phonon DSA, f64)`` rows; the widened IB-stencil levels' in the
``(IB-stencil level)`` and ``(IB-stencil level, f64)`` rows; the
distributed shard fine level's in the ``(dist shard of 4)`` rows)
and, last, the device JSON line.

It imports nothing of JAX and nothing of the JAX package ``fvm_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
import types
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
# the 3D counterpart: an 80^3 hex cavity (512,000 cells) in float32 (128^3,
# 2,097,152 cells, until the whole script's time limit needed the ~50 s of
# host set-up and timing it cost over 96^3; 96^3 until phase 32 needed the
# time)
MAIN3D_N = 80
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
# before one).  2 Newton steps (4 until phase 31 needed the time, 3 until
# the whole script's time limit did)
NEWTON_N = 32
NEWTON_SIMPLE = 60
NEWTON_STEPS = 2
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
COUPLED_STEPS = 10  # 20 until phase 32 needed the time
ANDERSON_STEPS = 30  # 60 until phase 32 needed the time
# the converge path at 1024^2 in phase 14: the float32 phase and the first
# Newton step (the whole sequence to 1e-6 took 243 s of the card and five
# Newton steps, measured: scripts/converge_run.py runs it; the phase ran
# two steps until the sensitivities' phases 21-22 needed its minute); the
# run must end below the float32 floor it started the endgame from
CONVERGE_NEWTON = 1
CONVERGE_REACH = None
# the Newton step's inner BiCGStab capped at one chunk of 240 iterations
# (986 iterations, 29.8 s, to its forcing 0.1 until the whole script's
# time limit needed the time); None: bench's 4000
CONVERGE_KRYLOV = 240
# the chunk's replays timed (of its 20; the whole chunk, 5.6 s, until the
# whole script's time limit needed the time) and profiled for its idle
# share (profiling all of them cost ~70 s of host time; 2 until the
# kinetic phase needed time)
CONVERGE_TIMED = 4
CONVERGE_PROFILED = 1


_main_mesh = {}


def main_mesh(device):
    """The main path's MAIN_N^2 MAIN_DTYPE quad device mesh, built once and
    shared by the phases that put bench's cavity on it (a build takes ~5 s
    of host time; the models on it do not change it)."""
    key = str(device)
    if key not in _main_mesh:
        from fvm_tpu_torch.mesh import build_device_mesh
        from fvm_tpu_torch.mesh.generate import quad_2d

        _main_mesh[key] = build_device_mesh(quad_2d(MAIN_N, MAIN_N),
                                            dtype=MAIN_DTYPE, device=device)
    return _main_mesh[key]


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


def profile_steps(flow, thermal, step_ms, steps=1, run=None, tag="profile"):
    """Device time of ``steps`` coupled steps by kernel (torch.profiler):
    the device-busy share of the unprofiled step time, the kernel launches
    per step, the ``dia_stencil`` kernels' device ms per step, and the
    kernels that take the most device time.  ``run`` replaces the per-step
    loop (a graph replay of ``steps`` steps).  Returns (busy ms per step,
    kernel launches per step), or None when nothing was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch.cases import coupled_step

    # device activity alone: host-op events (several per kernel) are not
    # read, and recording them cost ~0.5 ms per kernel of host time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if run is not None:
            run()
        else:
            for _ in range(steps):
                coupled_step(flow, thermal)
        torch.cuda.synchronize()
    rows = [(ms / steps, n / steps, key) for ms, n, key in device_rows(prof)
            if ms > 0]
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
    for ms, n, key in rows[:10]:
        log(tag, f"  {ms:8.3f} ms/step {n:7.1f} calls/step  {key[:90]}")
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
    g = torch.Generator(device=device).manual_seed(7)
    K, n = cols.shape
    A = ELLMatrix(
        diag=(torch.rand(n, generator=g, dtype=torch.float64, device=device)
              + 4.0).to(dtype),
        off=torch.randn((K, n), generator=g, dtype=torch.float64,
                        device=device).to(dtype),
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
    from fvm_tpu_torch.cases import cavity_models, coupled_step, coupled_steps
    from fvm_tpu_torch.ops import dia_kernel as dk

    k = TIMED_STEPS
    t0 = time.time()
    flow, thermal = cavity_models(main_mesh(device), amg_precision="bf16")
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


def coupled_runs():
    """Phase 13's advanceCoupled and Anderson runs: (label, configure the
    flow, run it)."""
    def anderson(f):
        f.options["acceleration"] = "anderson"

    return ((f"advanceCoupled({COUPLED_STEPS})", lambda f: None,
             lambda f: f.advanceCoupled(COUPLED_STEPS)),
            (f"Anderson-accelerated SIMPLE, {ANDERSON_STEPS} outers",
             anderson, lambda f: f.advance(ANDERSON_STEPS)))


def coupled_run_history(configure, run, device):
    """One of ``coupled_runs`` on ``device``: the residual history."""
    from fvm_tpu_torch.cases import coupled_cavity

    flow, _ = coupled_cavity(NEWTON_N, device=device, dtype="float64")
    configure(flow)
    return [[float(v) for v in h[1:]] for h in run(flow)]


# phase 13's CPU side in two children: (Newton modes, with the coupled
# runs?) per child
NEWTON_CPU_PARTS = (((0, 1), True), ((2, 3), False))


def newton_cpu_side(part: int):
    """Part ``part`` of phase 13's CPU side (``NEWTON_CPU_PARTS``), for a
    child process: per Newton mode of the part its index, the entry
    history, the residual after one SIMPLE step (relative to the first)
    and the velocity; then, in the part that has them, the
    ``coupled_runs`` histories."""
    indices, with_coupled = NEWTON_CPU_PARTS[part]
    snap, n0 = newton_entry()
    modes = []
    for i in indices:
        opts = dict(NEWTON_MODES[i][1])
        steps = opts.pop("steps", NEWTON_STEPS)
        h, f = newton_run(snap, "cpu", steps=steps, **opts)
        modes.append({"i": i, "h": h,
                      "after": float(f.advance(1)[0][1]) / n0,
                      "V": f.getVelocity().tolist()})
        del f
    return {"modes": modes, "coupled": [
        coupled_run_history(configure, run, "cpu")
        for _, configure, run in coupled_runs()] if with_coupled else []}


def newton_phase(device):
    """advanceNewton(NEWTON_STEPS) in each mode on the card and on the CPU
    from one entry state (the CPU side in two child processes beside the
    card's runs); the chunk's graph replay against the eager chunk;
    advanceCoupled and Anderson-accelerated SIMPLE."""
    t_phase = time.time()
    children = [spawn_cpu(f"newton_cpu_side({part})", 3)
                for part in range(len(NEWTON_CPU_PARTS))]
    try:
        _newton_checks(device, children)
    finally:
        for child in children:
            child.kill()
            child.wait()
    log("newton", f"phase 13 in {time.time() - t_phase:.1f} s")


def _cpu_side(children):
    """The children's results merged: the modes in ``NEWTON_MODES`` order
    and the coupled runs."""
    modes, coupled = {}, []
    for child in children:
        out = child_result(child, "newton")
        modes.update({m["i"]: m for m in out["modes"]})
        coupled += out["coupled"]
    return {"modes": [modes[i] for i in range(len(NEWTON_MODES))],
            "coupled": coupled}


def _newton_checks(device, children):
    """Phase 13's card runs, then its checks against the children's CPU
    side (waited for only once the card's runs are done)."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk

    t0 = time.time()
    snap, n0 = newton_entry()
    log("newton", f"entry: the {NEWTON_N}^2 float64 bench cavity after "
        f"{NEWTON_SIMPLE} SIMPLE outers on the cpu (first residual "
        f"{n0:.6e}) in {time.time() - t0:.1f} s")
    card = []
    for label, opts in NEWTON_MODES:
        t0 = time.time()
        opts = dict(opts)
        steps = opts.pop("steps", NEWTON_STEPS)
        dk.reset_launches()
        h_gpu, f_gpu = newton_run(snap, device, steps=steps, **opts)
        t_gpu = time.time() - t0
        launches = dk.type_launches(torch.float32 if opts.get(
            "newtonInnerPrecision") else torch.float64)
        trace = [(t["inner_its"], f"{t['inner_rel']:.2e}")
                 for t in getattr(f_gpu, "_newton_trace", [])]
        card.append((label, opts, steps, h_gpu, launches, trace, t_gpu,
                     float(f_gpu.advance(1)[0][1]) / n0,
                     f_gpu.getVelocity()))
        if device.type == "cuda" and not sum(launches.values()):
            raise AssertionError(f"newton: {label}: dia_stencil never "
                                 f"launched on the card")
        del f_gpu
        gc.collect()

    # a chunk's graph replay against the same chunks run eagerly (one
    # Newton step; two until the kinetic phase needed the time)
    label, opts = NEWTON_MODES[1]
    with deterministic():
        runs = [newton_run(snap, device, graphed, steps=1, **opts)
                for graphed in (True, False)]
    (h_g, f_g), (h_e, f_e) = runs
    inner = f_g._runners[("newton", opts["newtonChunkIterations"])]
    same = h_g == h_e and all(torch.equal(f_g.state[k], f_e.state[k])
                              for k in f_g.state)
    log("newton", f"{label}, 1 step under deterministic algorithms: graph "
        f"replays ({inner.trips_per_replay} iterations per replay, "
        f"{inner.replays} replays) "
        f"{'bit-identical to' if same else 'DIFFER from'}"
        f" the eager chunks: {h_g} vs {h_e}")
    if not same:
        raise AssertionError("newton: the chunk's replay differs from the "
                             "eager chunk")
    del runs, f_g, f_e, inner
    gc.collect()
    coupled = []
    for label, configure, run in coupled_runs():
        t0 = time.time()
        coupled.append((label, coupled_run_history(configure, run, device),
                        time.time() - t0))

    # the checks against the CPU side
    t0 = time.time()
    cpu_side = _cpu_side(children)
    log("newton", f"waited {time.time() - t0:.1f} s for the CPU side")
    for (label, opts, steps, h_gpu, launches, trace, t_gpu, after_gpu,
         V_gpu), cpu in zip(card, cpu_side["modes"]):
        h_cpu = cpu["h"]
        after = [after_gpu, cpu["after"]]
        V_cpu = np.asarray(cpu["V"])
        dv = float(abs(V_gpu - V_cpu).max() / abs(V_cpu).max())
        mixed = bool(opts.get("newtonInnerPrecision"))
        log("newton", f"{label}: entry residuals cuda "
            + ", ".join(f"{h[0]:.6e}" for h in h_gpu) + " / cpu "
            + ", ".join(f"{h[0]:.6e}" for h in h_cpu)
            + f" (advanceNewton({steps})); card inner its/rel {trace}; one "
            f"SIMPLE step after: "
            f"{after[0]:.3e} / {after[1]:.3e} of the first residual; "
            f"velocities {dv:.3e} apart; card dia_stencil launches "
            + ", ".join(f"{m} {v}" for m, v in launches.items())
            + f"; card {t_gpu:.1f} s")
        if mixed:
            ok = max(after) < 1e-8 and dv < 1e-9
        else:
            ok = close(h_gpu, h_cpu, NEWTON_RTOL, NEWTON_ATOL)
        if not ok:
            raise AssertionError(f"newton: {label}: cuda and cpu disagree")
    for (label, h_gpu, secs), h_cpu in zip(coupled, cpu_side["coupled"]):
        worst = max_rel(h_gpu, h_cpu)
        log("newton", f"{label} at {NEWTON_N}^2 float64: cuda {h_gpu[-1]} vs "
            f"cpu {h_cpu[-1]}; max rel diff {worst:.3e} (tol {SLICE_RTOL:g})"
            f"; card {secs:.1f} s")
        if len(h_gpu) != len(h_cpu) or not worst <= SLICE_RTOL:
            raise AssertionError(f"newton: {label}: cuda and cpu disagree")


# ---- 14. time to a converged residual at 1024^2 ----------------------------

def converge_phase(device, kernels, result=None):
    """``cases.converge_cavity(MAIN_N)`` on the card with at most
    ``CONVERGE_NEWTON`` Newton steps of at most ``CONVERGE_KRYLOV`` inner
    iterations: bench's converge mode (float32 SIMPLE
    to the stall, promotion, the mixed-precision Newton endgame, 20 float64
    thermal steps), counters reset just before it; it must reach
    ``CONVERGE_REACH`` (None: below the float32 floor it promoted at).
    Returns the ``kernels`` rows of the modes it
    launched, the timing numbers taken from ``kernels`` (phase 6's
    measurements at the same shapes); ``result`` (a dict) receives
    converge_cavity's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvm_tpu_torch.cases import NEWTON_CHUNK, NEWTON_KIT, converge_cavity
    from fvm_tpu_torch.ops import dia_kernel as dk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launches()
    models = {}
    t0 = time.time()
    res = converge_cavity(MAIN_N, device=device, newton_steps=CONVERGE_NEWTON,
                          models=models,
                          log=lambda msg: log("converge", msg),
                          krylov_iterations=CONVERGE_KRYLOV or NEWTON_KIT)
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
    # the device idle share of a chunk: CONVERGE_TIMED of its replays
    # timed, and CONVERGE_PROFILED of them profiled (the profiler's own
    # cost grows with the kernels it records, ~25,000 a replay)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(CONVERGE_TIMED):
        inner.trips.replay()
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t1) / CONVERGE_TIMED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CONVERGE_PROFILED):
            inner.trips.replay()
        torch.cuda.synchronize()
    part_ms = replay_ms * CONVERGE_PROFILED
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    top = rows[:8]
    idle = (f"{busy:.3f} ms in {CONVERGE_PROFILED} profiled replays, "
            f"{part_ms:.3f} ms of unprofiled replays' time "
            f"({100 - 100 * busy / part_ms:.1f}% idle; the profiler's own "
            f"cost can make this negative)" if busy else
            "not measured (no device events)")
    log("converge", f"{CONVERGE_TIMED} of a chunk's {inner.n_replays} "
        f"replays ({inner.chunk} iterations a chunk): {replay_ms:.3f} ms a "
        f"replay unprofiled; device busy {idle}")
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


def device_rows(prof):
    """(device ms, records, name) of each name that a finished profiler
    session recorded on the card, the largest first, summed from its raw
    records: ``key_averages`` first builds an event object per record
    (~0.1 ms each, tens of seconds for a replay of 100,000 kernels)."""
    import torch

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((ms, n, key) for key, (ms, n) in agg.items()),
                  reverse=True)


def profile_run(tag, label, fn, wall_ms, top=6):
    """Profile one ``fn()`` (torch.profiler): device busy time against the
    unprofiled ``wall_ms``, the idle share, and the kernels that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
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
# algorithms: the condensation's index_add adds with atomics); ILU0 2
# until phase 31 needed the time
FAMILY_OUTERS = {"ILU0": 1, "SPIKE": 1}
# the card-size runs' pressure and thermal BiCGStab caps (the family's own
# is 200): a SPIKE outer spends all 200 of both (~4.7 s eager, 15 s to
# capture), so its runs stop at 50, for the whole script's time limit
FAMILY_CARD_ITERATIONS = {"ILU0": 200, "SPIKE": 50}
FAMILY_PROFILED = ("ILU0",)
FAMILY_PROFILE_REPS = 20
# cuda against cpu at 64^2 float64 over 3 outers (10 until the remaining
# models' phases needed the time, 5 until the kinetic phase did) with the inner solves tightened to 1e-10
# (cases.tighten_family), held at cases.FAMILY_TIGHT_RTOL
FAMILY_SLICE_N = 64
FAMILY_SLICE_OUTERS = 3
# phase 19: the plate at card size to a 1e-10 relative residual; its max
# abs error against the exact series profile (K, temperatures of 300-400)
# and the Mixed variant's energy balance (the heat flows over all groups
# summed, over the largest)
PLATE_ATOL = 1e-6
PLATE_BALANCE = 1e-8
PLATE_SLICE = (64, 16)
# the card-size plate: quad_2d(1024, 256) (cases.PLATE_NX x PLATE_NY,
# 2048 x 512, until the whole script's time limit needed the ~20 s of
# host set-up it cost)
PLATE_CARD = (1024, 256)
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


def family_histories(device, families=("ILU0", "SPIKE")):
    """Per family, the residual histories of FAMILY_SLICE_OUTERS coupled
    outers of the 64^2 float64 family cavity with tight inner solves on
    ``device``."""
    from fvm_tpu_torch.cases import (cavity_family, coupled_step,
                                     tighten_family)

    out = {}
    for family in families:
        flow, thermal = cavity_family(FAMILY_SLICE_N, family, device=device,
                                      dtype="float64")
        tighten_family(flow, thermal)
        out[family] = [[float(v) for v in coupled_step(flow, thermal)]
                       for _ in range(FAMILY_SLICE_OUTERS)]
    return out


def family_slices(device):
    """cuda against cpu at 64^2 float64, held at FAMILY_TIGHT_RTOL: the
    CPU runs in child processes on one thread each, one per family, while
    the card's run here launches its kernels (both are host-bound)."""
    from fvm_tpu_torch.cases import FAMILY_TIGHT_RTOL

    t0 = time.perf_counter()
    children = [spawn_cpu(f"family_histories('cpu', ({f!r},))")
                for f in ("ILU0", "SPIKE")]
    try:
        cuda = family_histories(device)
        cpu = {}
        for child in children:
            cpu.update(child_result(child, "family"))
    finally:
        for child in children:
            child.kill()
            child.wait()
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
    from fvm_tpu_torch.ops import dia_kernel as dk

    t0 = time.perf_counter()
    dmesh = main_mesh(device)
    torch.cuda.synchronize()
    log("family", f"{MAIN_N}^2 {MAIN_DTYPE} device mesh (both families; "
        f"phase 3's) in {time.perf_counter() - t0:.2f} s")
    row = None
    for family in ("ILU0", "SPIKE"):
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        flow, thermal = cases.cavity_models(
            dmesh, solver=functools.partial(cases.family_solver, family))
        for m, key in ((flow, "pressureLinearSolver"),
                       (thermal, "linearSolver")):
            m.options[key].nMaxIterations = FAMILY_CARD_ITERATIONS[family]
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
            rows = device_rows(prof)
            busy = sum(r[0] for r in rows)
            log("family", f"{family}: one profiled outer ({prof_ms:.3f} "
                f"ms): {sum(r[1] for r in rows)} kernels and {busy:.3f} "
                f"ms of device time recorded; the largest:")
            for ms, n, key in rows[:6]:
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
        t, secs = cases.two_material_plate(device=device, nx=PLATE_CARD[0],
                                           ny=PLATE_CARD[1], walls=walls)
        dm = t.mesh
        amg = t.options["linearSolver"].preconditioner
        shapes = kb.level_shapes(amg, dm)
        log("plate", f"{walls}: quad_2d({PLATE_CARD[0]}, {PLATE_CARD[1]})"
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


def cavity_gate_run(dev):
    """Phase 22's gate on ``dev`` (a device or its name): the 32^2 float64
    cavity's sensitivities with tightened inner solves, as plain
    numbers."""
    import torch
    from fvm_tpu_torch.cases import (cavity_sensitivities, coupled_cavity,
                                     tighten_cavity)

    t0 = time.perf_counter()
    flow, _ = coupled_cavity(CAVITY_GATE_N, device=torch.device(dev),
                             dtype="float64")
    tighten_cavity(flow)
    flow.advance(CAVITY_GATE_OUTERS)
    out = cavity_sensitivities(flow, niter=CAVITY_GATE_NITER)
    return {"tangent": np.asarray(out["tangent"]).tolist(),
            "adjoint": {k: np.asarray(v).tolist()
                        for k, v in out["adjoint"].items()},
            "dual": out["dual"], "gap": out["gap"],
            "s": time.perf_counter() - t0}


def cavity_gates(device):
    """Phase 22's gates at 32^2 float64 with tightened inner solves: the
    cavity's sensitivities on the card against the CPU's (in a child
    process beside the card's run), and the truncated duality on both."""
    child = spawn_cpu("cavity_gate_run('cpu')")
    res = [cavity_gate_run(device), child_result(child, "cavsens")]
    for dev, out in zip(("cuda", "cpu"), res):
        log("cavsens", f"{CAVITY_GATE_N}^2 float64 on {dev}: tangent "
            f"force {out['tangent']}, <grad mu, 1> {out['dual']:.12e}"
            f", truncated duality gap {out['gap']:.3e} (tol "
            f"{CAVITY_GATE_RTOL:g}) in {out['s']:.2f} s")
        if not out["gap"] <= CAVITY_GATE_RTOL:
            raise AssertionError(f"truncated duality on {dev}")
    a, b = ({"tangent": np.asarray(r["tangent"]),
             "adjoint": {k: np.asarray(v) for k, v in r["adjoint"].items()}}
            for r in res)
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
    from fvm_tpu_torch.cases import cavity_models
    from fvm_tpu_torch.interop import load_model_state
    from fvm_tpu_torch.linear.base import LinearSolver
    from fvm_tpu_torch.ops import dia_kernel as dk

    cavity_gates(device)
    flow, thermal = cavity_models(main_mesh(device))
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


# ---- phases 23-25: the structures and MEMS family ------------------------
# cuda-against-cpu gates (the CPU side in a child process, one thread,
# beside the card's work), then the card-size runs
MEMS_GATE = (24, 12)  # tests/test_mems.py's switch
# the largest plate fvm_tpu converges is nx 192, ny_gap 64 (scripts/
# structures_scale.py), at the demo's gap-cell aspect ratio of ~33; the
# run holds half of it (192 x 64 until the whole script's time limit
# needed the time)
MEMS_CARD = (96, 32)
MEMS_SWEEP = tuple(float(f) for f in np.linspace(0.2, 1.6, 8))  # main()
MEMS_SNAP_V = 1.1  # x V_PI, the demo's transient snap-down
MEMS_SNAP_STEPS = 160
MEMS_SWEEP_BUDGET = 4.0  # s of the card-size sweep (cut there)
MEMS_SNAP_BUDGET = 2.0  # s of the card-size snap-down (cut there)
MEMS_PROFILE_TRIPS = 4  # the plate's Krylov trips in the profiled iteration
CANT_GATE = (40, 6)
CANT_GATE_SAMPLES = 1
CANT_CREEP = {"creep": True, "creepConstant": 1e-4, "creepExponent": 1.0,
              "yieldStress": 1e6}
CANT_CREEP_STEPS = 1  # 3, then 2, until phases 29 and 31 needed the time
CANT_UQ = (160, 24)  # the largest cantilever fvm_tpu converges
CANT_UQ_SAMPLES = 1
# 157,696 cells, capped (2048 x 308, 630,784 cells, until the whole
# script's time limit needed the time)
CANT_CAP = (1024, 154)
CANT_CAP_OUTERS = 2
CANT_CAP_TRIPS = 12
FSI_GATE_N = 24
MOTION_N = 512  # 1024 until the whole script's time limit needed the time
MOTION_SWEEPS = 50
GATE_RTOL = 1e-8
GATE_PARTS = ("mems", "rest")  # one CPU child each


class BudgetSpent(Exception):
    """A card-size loop of phase 23 reached its time budget."""


def small_models_run(device):
    """The small models' outputs on ``device`` (phase 25's gate)."""
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models import (FractureModel, IdealGasDensityModel,
                                      OneDConduction, RosselandModel,
                                      ShockTube, SqueezeFilmModel,
                                      ThermalModel)

    out = {}
    st = ShockTube(nx=200, device=device).run(0.2)
    out["sod_rho"] = st.primitives()[0].tolist()
    od = OneDConduction(nx=40, kConst=2.0, device=device)
    od.setBoundaryTemperatures(400.0, 300.0)
    out["oned"] = od.solve().cpu().tolist()
    ks = np.exp(np.random.default_rng(0).normal(0, 0.3, size=(16, 40)))
    out["oned_mc"] = od.solve_mc(ks).cpu().tolist()
    dm = build_device_mesh(quad_2d(8, 8), dtype="float64", device=device)
    fr = FractureModel(dm)
    fr.options["verbose"] = False
    fr.options["transient"] = False
    fr.vc["fractureSource"] = 1.0
    fr.vc["fractureSourceCoef"] = 4.0
    for g in ("left", "right", "bottom", "top"):
        fr.bc[g].bc_type = "Symmetry"
    fr.init()
    fr.advance(10)
    out["fracture"] = fr.getPhaseFieldValue().tolist()
    sq = squeeze_strip(24, 3, device)
    out["film"] = sq.getPressure().tolist()
    dm4 = build_device_mesh(quad_2d(4, 4), dtype="float64", device=device)
    gas = IdealGasDensityModel(dm4)
    gas.vc["temperature"] = np.linspace(280.0, 320.0, dm4.n_cells)
    gas.init()
    gas.advance(1)
    out["gas"] = gas.getDensity().tolist()
    t = ThermalModel(dm4)
    t.options["verbose"] = False
    for g in ("left", "right", "bottom", "top"):
        t.bc[g].bc_type = "Symmetry"
    t.vc["initialTemperature"] = 500.0
    t.init()
    ross = RosselandModel(dm4, t)
    ross.init()
    ross.advance(1)
    out["rosseland"] = ross.getConductivity().tolist()
    return out


def squeeze_strip(nx, ny, device, L=2.0, h0=0.05, mu=0.3, V0=1.0):
    """The squeeze-film strip of ``tests/test_small_models.py:151``,
    closing at V0, advanced 3 outers."""
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models import SqueezeFilmModel

    m = SqueezeFilmModel(build_device_mesh(quad_2d(nx, ny, lx=L, ly=1.0),
                                           dtype="float64", device=device))
    m.options["verbose"] = False
    m.vc["viscosity"] = mu
    m.vc["initialGap"] = h0
    m.bc["left"].bc_type = "Dirichlet"
    m.bc["right"].bc_type = "Dirichlet"
    m.bc["bottom"].bc_type = "Symmetry"
    m.bc["top"].bc_type = "Symmetry"
    m.init()
    m.options["linearSolver"].exit_every = 10
    m.set_gap(h0, -V0)
    m.advance(3)
    return m


def structures_gates(device, parts=GATE_PARTS):
    """Phases 23-25's small cases on ``device``, as plain numbers; "mems":
    the switch at MEMS_GATE (k, w at 0.3 and 0.6 V_PI, whether 1.4 V_PI
    pulls in); "rest": the cantilever at CANT_GATE (deformation, tangent
    and adjoint in E, Monte Carlo, creep steps and von Mises stress), the
    FSI beam and the small models."""
    from fvm_tpu_torch import cases

    out = {}
    if "mems" in parts:
        sw = cases.mems_switch(*MEMS_GATE, device=device)
        k = sw.lumped_stiffness()
        V = sw.pullin_formula(k)
        w6 = sw.static_deflection(0.6 * V)
        w3 = sw.static_deflection(0.3 * V)
        out["mems"] = {"k": k, "w3": w3.tolist(), "w6": w6.tolist(),
                       "pulled": sw.static_deflection(1.4 * V, w0=w6)
                       is None}
    if "rest" not in parts:
        return out
    m = cases.cantilever(*CANT_GATE, device=device)
    tight_jfnk(m)
    uq = cases.cantilever_uq(m, samples=CANT_GATE_SAMPLES)
    out["cant"] = {k: v for k, v in uq.items() if not k.startswith("s_")}
    out["cant"]["w"] = m.getDeformation().tolist()
    mc = cases.cantilever(*CANT_GATE, device=device, options=CANT_CREEP)
    mc.advance(15)
    for _ in range(CANT_CREEP_STEPS):
        mc.advanceCreep(1.0)
        mc.advance(15)
    out["creep"] = {"ep": mc.getPlasticStrain().tolist(),
                    "vm": mc.getVMStress().tolist(),
                    "w": mc.getDeformation().tolist()}
    out["fsi"] = cases.fsi_beam(FSI_GATE_N, device=device)
    out["small"] = small_models_run(device)
    return out


def tight_jfnk(m):
    """The model's JFNK inner solve at 1e-12 (early exit every 10 trips):
    the tangent and the adjoint then agree to round-off (at the default
    1e-6 they differ by ~1e-6, the solves' own tolerance)."""
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver

    solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                      relative_tolerance=1e-12, max_iterations=1000)
    solver.exit_every = 10
    m.options["linearSolver"] = solver
    m._drop_compiled()


# every child process started, killed at exit; and those started ahead
# of their phase (``start_early``), by call
_children = []
_early = {}
# the children's niceness: the process that drives the card is host-bound
# (its launches are the critical path), the children have slack
CHILD_NICE = 10


def spawn_cpu(call: str, threads: int = 1):
    """``chip_smoke.<call>`` in a child process at niceness CHILD_NICE, its
    result printed as JSON (the CPU side of a cuda-against-cpu gate, run
    beside the card's); the child ``start_early`` started for the same
    call, if there is one."""
    import atexit
    import os
    from pathlib import Path

    child = _early.pop(call, None)
    if child is not None:
        return child
    if not _children:
        atexit.register(kill_children)
    child = subprocess.Popen(
        [sys.executable, "-c", f"import os; os.nice({CHILD_NICE}); import "
         f"json, chip_smoke; print(json.dumps(chip_smoke.{call}))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, OMP_NUM_THREADS=str(threads)))
    _children.append(child)
    return child


def start_early(calls):
    """Start the CPU sides ``calls`` ((call, threads) pairs) now, ahead of
    the phases that wait for them (the same checks, less waiting)."""
    for call, threads in calls:
        if call not in _early:
            child = spawn_cpu(call, threads)
            _early[call] = child


def early_cpu_sides(group: str):
    """The CPU sides of phase 13, of phases 18-22, of phases 23-28, of
    phase 29 or of phase 30 (``group`` "13", "18-22", "23-28", "29" or
    "30") as ``start_early`` pairs."""
    if group == "13":
        return [(f"newton_cpu_side({p})", 3)
                for p in range(len(NEWTON_CPU_PARTS))]
    if group == "18-22":
        return [(f"family_histories('cpu', ({f!r},))", 1)
                for f in ("ILU0", "SPIKE")] + [("cavity_gate_run('cpu')", 1)]
    if group == "29":
        return gate_calls("kinetic_gates", KIN_PARTS)
    if group == "30":
        return gate_calls("phonon_gates", PH_PARTS)
    return (gate_calls("structures_gates", GATE_PARTS)
            + gate_calls("models_gates", MODEL_PARTS))


def kill_children():
    """Stop every child process still running (at exit, a failed phase
    included)."""
    for child in _children:
        if child.poll() is None:
            child.kill()
            child.wait()


def child_result(child, what: str):
    """A ``spawn_cpu`` child's result (waits for it; kills it on
    failure)."""
    try:
        out, _ = child.communicate(timeout=1200)
    finally:
        child.kill()
        child.wait()
    if child.returncode != 0:
        raise AssertionError(f"{what}: the CPU side exited "
                             f"{child.returncode}")
    return json.loads(out.strip().splitlines()[-1])


_gates = {}  # by (gate function's name, "cuda" or "cpu")


def gate_calls(fn: str, parts):
    """The CPU side of ``chip_smoke.<fn>``, one child per part, as
    ``start_early`` pairs."""
    return [(f"{fn}('cpu', ({p!r},))", 1) for p in parts]


def gates(fn: str, parts, device):
    """``chip_smoke.<fn>``'s (``structures_gates`` or ``models_gates``)
    results, once each. On the card: run here, its CPU side started first
    in child processes (those ``start_early`` started are taken over). On
    "cpu": those children's results, merged (waits for them)."""
    key = (fn, "cpu" if device == "cpu" else "cuda")
    if key in _gates:
        return _gates[key]
    if device == "cpu":
        out = {}
        for call, _ in gate_calls(fn, parts):
            out.update(child_result(spawn_cpu(call), fn))
    else:
        start_early(gate_calls(fn, parts))
        t0 = time.perf_counter()
        out = globals()[fn](device, parts)
        log("gates", f"{fn} on the card in {time.perf_counter() - t0:.1f} s "
            f"(its CPU side runs in child processes meanwhile)")
    _gates[key] = out
    return out


def gate_diff(a, b):
    """max |a - b| / max |b| over nested lists or numbers."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def column_diffs(a, b):
    """``gate_diff`` of each last-axis column on its own scale (columns of
    very different sizes, as the charging model's trapped and band
    charges)."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return [gate_diff(a[..., j], b[..., j]) for j in range(b.shape[-1])]


def check_gates(phase, cuda, cpu, keys, rtol=GATE_RTOL, columns=()):
    """Log and hold each ``keys`` entry of the two gate dicts; those also
    in ``columns`` column by column (``column_diffs``)."""
    for k in keys:
        ds = (column_diffs(cuda[k], cpu[k]) if k in columns
              else [gate_diff(cuda[k], cpu[k])])
        log(phase, f"cuda vs cpu {k}: max rel diff "
            + ", ".join(f"{d:.3e}" for d in ds)
            + (" (column by column)" if k in columns else "")
            + f" (tol {rtol:g})")
        if not max(ds) <= rtol:
            raise AssertionError(f"{phase}: {k} differs: {max(ds):.3e}")


class SolveClock:
    """Host seconds (synchronized) and counts of the solves a model runs:
    each ``name``'s calls of ``fn`` timed, launches counted in its
    ``dia_stencil`` launch scope."""

    def __init__(self):
        self.secs, self.calls = {}, {}

    def wrap(self, obj, attr, name):
        import torch
        from fvm_tpu_torch.ops import dia_kernel as dk

        inner = getattr(obj, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with dk.launch_scope(name):
                out = inner(*a, **kw)
            torch.cuda.synchronize()
            self.secs[name] = self.secs.get(name, 0.0) + (
                time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        setattr(obj, attr, timed)

    def line(self):
        return ", ".join(
            f"{k} {1e3 * v / max(self.calls[k], 1):.2f} ms x "
            f"{self.calls[k]}" for k, v in self.secs.items())


def scoped_launches():
    """dia_stencil launches since the last reset, by scope and mode."""
    from fvm_tpu_torch.ops import dia_kernel as dk

    return ", ".join(f"{sc}/{m} {v}" for (sc, m), v in
                     sorted(dk.dia_stencil.scoped.items()))


def level_launches(shapes):
    """dia_stencil launches since the last reset by level (rows) of
    ``shapes``, and by mode."""
    from fvm_tpu_torch.ops import dia_kernel as dk

    parts = []
    for i, s in enumerate(shapes):
        got = {k[2]: v for k, v in dk.dia_stencil.shapes.items()
               if k[3] == s.rows}
        if got:
            parts.append(f"L{i} ({s.rows} rows): " + ", ".join(
                f"{m} {v}" for m, v in sorted(got.items())))
    return "; ".join(parts)


def mesh_fine(mesh):
    """The fine level's shape of a device mesh's matrices as the solvers
    see them (the condensed DIA structure where there is one)."""
    from fvm_tpu_torch.tools import kernel_bench as kb

    fine = mesh.dia
    if fine is not None and fine.cond_plan is not None:
        fine = fine.cond_plan.dia2
    return kb._shape(mesh.n_cells, fine)


def shape_rows(tag, label, mesh, launches, device, dtype_name):
    """The kernel against its plain version at ``mesh``'s fine level (bit
    for bit), then the ``kernels`` rows of that shape with ``launches``
    ((n,) vectors)."""
    fine = mesh_fine(mesh)
    errors = {}
    kernel_vs_plain(label, fine.rows, fine.offsets, device, errors,
                    nrhs=(1,), dia=fine.dia, dtypes=(dtype_name,))
    return time_modes(tag, fine.rows, fine.offsets,
                      (("mv", 1), ("residual", 1), ("jacobi", 1)), launches,
                      errors, dtype_name)


def mems_phase(device, smi):
    """23 (module docstring); returns the gap fine level's kernel rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    gpu = gates("structures_gates", GATE_PARTS, device)

    # ---- the published geometry at MEMS_CARD
    nx, ny = MEMS_CARD
    t0 = time.perf_counter()
    sw = cases.mems_switch(nx, ny, device=device)
    torch.cuda.synchronize()
    log("mems", f"switch nx {nx}, ny_gap {ny} float64: plate "
        f"{sw.plate.mesh.n_interior_cells} cells, gap "
        f"{sw.elec.mesh.n_interior_cells} cells, set up in "
        f"{time.perf_counter() - t0:.2f} s; gap hierarchy "
        + describe(kb.level_shapes(
            sw.elec.options["electrostaticsLinearSolver"].preconditioner,
            sw.elec.mesh)))
    clock = SolveClock()
    clock.wrap(sw.elec, "advance", "electric")
    clock.wrap(sw.film, "advance", "film")
    build = sw.plate._build_step

    def timed_build():
        # every step the plate builds (init rebuilds it) timed per outer
        holder = types.SimpleNamespace(step=build())
        clock.wrap(holder, "step", "plate outer")
        return holder.step

    sw.plate._build_step = timed_build
    sw.plate._step = timed_build()
    couplings = {"n": 0, "deadline": None}
    inner = sw.electrostatic_pressure

    def counted(w, V):
        # each coupling iteration starts here: the budget is checked
        if couplings["deadline"] and time.perf_counter() > couplings[
                "deadline"]:
            raise BudgetSpent
        couplings["n"] += 1
        return inner(w, V)

    sw.electrostatic_pressure = counted
    dk.reset_launches()
    t0 = time.perf_counter()
    k = sw.lumped_stiffness()
    V_pi = sw.pullin_formula(k)
    log("mems", f"lumped stiffness k = {k:.6g} MPa um in "
        f"{time.perf_counter() - t0:.2f} s ({clock.line()}); parallel-plate "
        f"V_PI = {V_pi:.4f} V")
    # main()'s bias sweep, within its budget
    t_sweep = time.perf_counter()
    couplings["deadline"] = t_sweep + MEMS_SWEEP_BUDGET
    seen = {"n": couplings["n"], "V_lo": 0.0}

    def report(row):
        nc = couplings["n"] - seen["n"]
        seen["n"] = couplings["n"]
        if row["w_max_g0"] is not None:
            seen["V_lo"] = row["V"]
        log("mems", f"{row['V']:8.3f} V ({row['factor']:.1f} V_PI): "
            + ("PULL-IN" if row["w_max_g0"] is None
               else f"w_max/g0 {row['w_max_g0']:.5f}")
            + f" in {row['s']:.2f} s, {nc} coupling iterations "
            f"({row['s'] / max(nc, 1):.3f} s each)")

    V_hi = None
    try:
        _, (_, V_hi) = sw.sweep(V_pi, MEMS_SWEEP, report)
    except BudgetSpent:
        nc = couplings["n"] - seen["n"]
        log("mems", f"sweep stopped after {nc} coupling iterations of its "
            f"next bias point ({(time.perf_counter() - t_sweep) / max(nc, 1):.3f}"
            f" s each): its budget ({MEMS_SWEEP_BUDGET:g} s) is spent")
    couplings["deadline"] = None
    log("mems", f"per solve: {clock.line()} [{smi}]")
    V_lo = seen["V_lo"]
    log("mems", "simulated pull-in bracket "
        + (f"({V_lo:.3f}, {V_hi:.3f}] V" if V_hi else
           f"above {V_lo:.3f} V (no pull-in within the budget)")
        + f" against the parallel-plate V_PI {V_pi:.3f} V")
    # the idle share from a profiled coupling iteration whose plate Krylov
    # solves are capped (the profiler's cost grows with the kernels it
    # records: ~2.9M in a whole iteration)
    psolver = sw.plate.options["linearSolver"]
    maxit = psolver.nMaxIterations
    psolver.nMaxIterations = MEMS_PROFILE_TRIPS
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.static_deflection(0.2 * V_pi, iters=1)
        torch.cuda.synchronize()
        profile_run("mems", f"one coupling iteration, plate Krylov solves "
                    f"capped at {MEMS_PROFILE_TRIPS} trips",
                    lambda: sw.static_deflection(0.2 * V_pi, iters=1),
                    1e3 * (time.perf_counter() - t0))
    finally:
        psolver.nMaxIterations = maxit
    # the transient snap-down, within its budget
    t0 = time.perf_counter()
    c0 = couplings["n"]
    couplings["deadline"] = t0 + MEMS_SNAP_BUDGET
    try:
        traj = sw.dynamic_pullin(MEMS_SNAP_V * V_pi, nsteps=MEMS_SNAP_STEPS)
        note = f"{len(traj)} steps"
    except BudgetSpent:
        traj, note = [], (f"stopped after {couplings['n'] - c0} steps: its "
                          f"budget ({MEMS_SNAP_BUDGET:g} s) is spent")
    couplings["deadline"] = None
    snap_s = time.perf_counter() - t0
    log("mems", f"snap-down at {MEMS_SNAP_V} V_PI: {note} in {snap_s:.2f} s "
        f"({snap_s / max(couplings['n'] - c0, 1):.3f} s per step)"
        + ("; w_max/g0 " + " ".join(f"{x / sw.g0:.3f}" for x in
                                    traj[::max(1, len(traj) // 10)])
           if traj else ""))
    launches = dk.type_launches(torch.float64)
    log("mems", f"dia_stencil launches by model: {scoped_launches()}")
    log("mems", "by level of the gap hierarchy: " + level_launches(
        kb.level_shapes(
            sw.elec.options["electrostaticsLinearSolver"].preconditioner,
            sw.elec.mesh)))
    log("mems", f"per solve over the phase: {clock.line()}")
    if not launches["residual"]:
        raise AssertionError("mems: the gap solves never launched the kernel")
    t0 = time.perf_counter()
    cpu = gates("structures_gates", GATE_PARTS, "cpu")
    log("mems", f"switch nx {MEMS_GATE[0]}, ny_gap {MEMS_GATE[1]} float64: "
        f"k cuda {gpu['mems']['k']!r} cpu {cpu['mems']['k']!r}; pull-in at "
        f"1.4 V_PI cuda {gpu['mems']['pulled']} cpu {cpu['mems']['pulled']} "
        f"(waited {time.perf_counter() - t0:.1f} s for the CPU side)")
    check_gates("mems", gpu["mems"], cpu["mems"], ("k", "w3", "w6"))
    if not (gpu["mems"]["pulled"] and cpu["mems"]["pulled"]):
        raise AssertionError("mems: 1.4 V_PI does not pull in")
    return shape_rows(" (mems gap, f64)", "MEMS gap fine level",
                      sw.elec.mesh, launches, device, "float64")


def struct_phase(device, smi):
    """24 (module docstring); no kernel rows (block-ELL, no DIA)."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver
    from fvm_tpu_torch.linear.base import product_mode

    gpu = gates("structures_gates", GATE_PARTS, device)
    cpu = gates("structures_gates", GATE_PARTS, "cpu")
    log("struct", f"cantilever {CANT_GATE[0]} x {CANT_GATE[1]} float64: tip "
        f"cuda {gpu['cant']['tip']!r} cpu {cpu['cant']['tip']!r}; duality "
        f"cuda {gpu['cant']['duality']:.3e} cpu {cpu['cant']['duality']:.3e}")
    check_gates("struct", gpu["cant"], cpu["cant"],
                ("w", "tip", "dtip_dE", "adjoint_dtip_dE", "mc_mean"))
    check_gates("struct", gpu["creep"], cpu["creep"], ("w", "ep", "vm"))
    if not gpu["cant"]["duality"] <= GATE_RTOL:
        raise AssertionError("struct: the adjoint and the tangent disagree")

    nx, ny = CANT_UQ
    m = cases.cantilever(nx, ny, device=device)
    uq = cases.cantilever_uq(m, samples=CANT_UQ_SAMPLES)
    h = uq["history"]
    log("struct", f"cantilever UQ {nx} x {ny} ({m.mesh.n_interior_cells} "
        f"cells): {len(h)} outers to {h[-1] / h[0]:.3e}, tip "
        f"{uq['tip']:.6e} in {uq['s_converge']:.2f} s; tangent "
        f"d tip/dE {uq['dtip_dE']:.6e} in {uq['s_tangent']:.2f} s, adjoint "
        f"{uq['adjoint_dtip_dE']:.6e} in {uq['s_adjoint']:.2f} s (duality "
        f"{uq['duality']:.3e}); Monte Carlo {CANT_UQ_SAMPLES} samples, "
        f"{uq['s_per_sample']:.2f} s each [{smi}]")
    del m
    gc.collect()

    # ---- the capped card-size run
    nx, ny = CANT_CAP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = cases.cantilever(nx, ny, device=device)
    solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                      relative_tolerance=1e-6, max_iterations=CANT_CAP_TRIPS)
    m.options["linearSolver"] = solver
    m._drop_compiled()
    torch.cuda.synchronize()
    log("struct", f"capped run quad_2d({nx}, {ny}) float64: "
        f"{m.mesh.n_interior_cells} cells, set up in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    hist = m.advance(CANT_CAP_OUTERS)
    torch.cuda.synchronize()
    outer_s = (time.perf_counter() - t0) / len(hist)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("struct", f"{len(hist)} JFNK outers of {CANT_CAP_TRIPS} Krylov "
        f"trips: {1e3 * outer_s:.1f} ms per outer, "
        f"{1e3 * outer_s / CANT_CAP_TRIPS:.2f} ms per trip; residual "
        + ", ".join(f"{r[1]:.6e}" for r in hist)
        + f" ({hist[-1][1] / hist[0][1]:.3e} of the first); peak memory "
        f"{peak:.3f} GiB [{smi}]")
    # the split of a trip: the AD products against the block-ELL ones
    mesh, params, state = m.mesh, m.params, m.state
    bc = m._resolve_bcvals()
    w = state["deformation"]
    A, r = m._system(mesh, params, state, bc, w)
    v = torch.randn_like(w)
    prod_ms = {}
    for mode in ("graph", "reverse", "forward"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = m._jfnk_operator(mesh, params, state, bc, w, A, mode)
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t0)
        prod_ms[mode] = time_events([lambda: op.mv(v)], 10)
        log("struct", f"Jacobian product ({mode}): {prod_ms[mode]:.3f} ms "
            f"each (its graph built in {build_ms:.1f} ms)")
    bell_ms = time_events([lambda: A.diag_solve(r)], 20)
    mv_ms = time_events([lambda: A.mv(r)], 20)
    trip_ms = 1e3 * outer_s / CANT_CAP_TRIPS
    log("struct", f"block-ELL: diag_solve {bell_ms:.3f} ms, surrogate mv "
        f"{mv_ms:.3f} ms.  A trip makes 6 exact products (2 of the "
        f"operator, 4 in the two Jacobi(3) applications) and 6 "
        f"diag_solves: {6 * prod_ms[product_mode(w)]:.2f} ms of AD "
        f"products ({product_mode(w)}, the mode of this size) and "
        f"{6 * bell_ms:.2f} ms of block-ELL products of the {trip_ms:.2f} "
        f"ms trip")
    profile_run("struct", f"one JFNK outer of the capped run "
                f"({CANT_CAP_TRIPS} trips)", lambda: m.advance(1),
                1e3 * outer_s, top=10)
    del m, A, r, op
    gc.collect()
    torch.cuda.empty_cache()
    return []


def motion_phase(device, smi):
    """25 (module docstring); returns the fracture and squeeze-film fine
    levels' kernel rows."""
    import torch
    from fvm_tpu_torch.mesh import build_device_mesh, compute_geometry
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models import FractureModel, MovingMeshModel
    from fvm_tpu_torch.ops import dia_kernel as dk

    gpu = gates("structures_gates", GATE_PARTS, device)
    cpu = gates("structures_gates", GATE_PARTS, "cpu")
    for i, (a, b) in enumerate(zip(gpu["fsi"], cpu["fsi"])):
        check_gates("motion", a, b, ("p_mean", "w_mean", "vol_change"))
    log("motion", f"FSI beam n {FSI_GATE_N}: " + "; ".join(
        f"iter {i}: p {r['p_mean']:+.5f}, w {r['w_mean']:+.6f}, dV "
        f"{r['vol_change']:+.6f}" for i, r in enumerate(gpu["fsi"])))
    check_gates("motion", gpu["small"], cpu["small"], tuple(cpu["small"]))

    # ---- mesh motion at card size
    n = MOTION_N
    mesh = quad_2d(n, n)
    t0 = time.perf_counter()
    mm = MovingMeshModel(mesh, device=device)
    setup_s = time.perf_counter() - t0
    V0 = mm._geom0.cell_volume[: mesh.n_interior_cells]
    mm.set_boundary_displacement("top", [0.0, 0.1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disp = mm.smooth(MOTION_SWEEPS)
    torch.cuda.synchronize()
    smooth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_mesh, dm = mm.advance(MOTION_SWEEPS, dt=0.5)
    torch.cuda.synchronize()
    adv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    V1 = compute_geometry(new_mesh).cell_volume[: mesh.n_interior_cells]
    fc = mesh.face_cells
    dVdt = np.zeros(mesh.n_cells)
    np.add.at(dVdt, fc[:, 0], mm.sweptVolDot)
    np.add.at(dVdt, fc[:, 1], -mm.sweptVolDot)
    gcl = float(np.abs(dVdt[: mesh.n_interior_cells] - (V1 - V0) / 0.5).max())
    log("motion", f"MovingMeshModel quad_2d({n}, {n}) ({mesh.n_nodes} nodes,"
        f" {len(mm.edges)} edges): set up {setup_s:.2f} s; {MOTION_SWEEPS} "
        f"Jacobi sweeps on the card {1e3 * smooth_s:.1f} ms; advance("
        f"{MOTION_SWEEPS}) with the new geometry and device mesh "
        f"{adv_s:.2f} s; volChange {mm.volChange:.9f} (top wall +0.1); GCL "
        f"max |sum sweptVolDot - dV/dt| {gcl:.3e} (check {time.perf_counter() - t0:.2f} s)")
    if not (gcl <= 1e-9 and abs(mm.volChange - 0.1) <= 1e-9
            and dm.n_interior_cells == n * n):
        raise AssertionError("motion: the moved mesh breaks the GCL")
    del mm, mesh, new_mesh, dm, disp
    gc.collect()

    rows = []
    # ---- the fracture source-steady case at card size
    t0 = time.perf_counter()
    fr = FractureModel(build_device_mesh(quad_2d(n, n), dtype="float64",
                                         device=device))
    fr.options["verbose"] = False
    fr.options["transient"] = False
    fr.vc["fractureSource"] = 1.0
    fr.vc["fractureSourceCoef"] = 4.0
    for g in ("left", "right", "bottom", "top"):
        fr.bc[g].bc_type = "Symmetry"
    fr.init()
    fr.options["linearSolver"].exit_every = 10
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dk.reset_launches()
    t0 = time.perf_counter()
    hist = fr.advance(10)
    torch.cuda.synchronize()
    err = float(np.abs(fr.getPhaseFieldValue() - 0.5).max())
    launches = dk.type_launches(torch.float64)
    log("motion", f"fracture quad_2d({n}, {n}) float64: set up {setup_s:.2f} "
        f"s, {len(hist)} outers in {time.perf_counter() - t0:.2f} s, max "
        f"|d - 0.5| {err:.3e}; dia_stencil launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items()) + f" [{smi}]")
    if not err <= 1e-8:
        raise AssertionError("motion: the fracture field is off")
    rows += shape_rows(" (fracture, f64)", "fracture fine level", fr.mesh,
                       launches, device, "float64")
    del fr
    gc.collect()

    # ---- the squeeze-film strip at card size
    dk.reset_launches()
    t0 = time.perf_counter()
    sq = squeeze_strip(n, n, device)
    torch.cuda.synchronize()
    sq_s = time.perf_counter() - t0
    L, h0, mu, V0_ = 2.0, 0.05, 0.3, 1.0
    x = sq.mesh.cell_centroid[: sq.mesh.n_interior_cells, 0].cpu().numpy()
    p_exact = 6.0 * mu * V0_ / h0**3 * x * (L - x)
    perr = float(np.abs(sq.getPressure() - p_exact).max())
    ptol = 3.0 * mu * V0_ / h0**3 * (L / n) ** 2
    F = sq.getDampingForce()
    F_exact = mu * V0_ * L**3 / h0**3
    launches = dk.type_launches(torch.float64)
    sq.set_gap(h0 / 2, -V0_)
    sq.advance(3)
    ratio = sq.getDampingForce() / F
    log("motion", f"squeeze film quad_2d({n}, {n}) float64: set up and 3 "
        f"outers {sq_s:.2f} s; max |p - p_exact| {perr:.3e} (tol "
        f"{ptol:.3e}); force {F:.9e} against {F_exact:.9e} (rel "
        f"{abs(F - F_exact) / F_exact:.3e}); half gap: force x {ratio:.6f}; "
        f"dia_stencil launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items()) + f" [{smi}]")
    if not (perr <= ptol and abs(F - F_exact) <= 5e-3 * F_exact
            and abs(ratio - 8.0) <= 8e-5):
        raise AssertionError("motion: the squeeze film is off")
    rows += shape_rows(" (squeeze film, f64)", "squeeze-film fine level",
                       sq.mesh, launches, device, "float64")
    del sq
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---- phases 26-28: the remaining models ----------------------------------
# cuda-against-cpu gates (the CPU side in two child processes, one thread,
# beside the card's work), then the card-size runs
CHARGE_GATE_N = 1000  # the column stand-in for the absent 1x1x1000.cas
# of the reference script's 100 steps: cut by time (~2,300 Krylov trips a
# step: 8 s a step on one CPU thread, 5.7 s on the card; 3 until the
# kinetic phase needed the time; the membrane's check compares against the
# column's first CHARGE_MEMBRANE_STEPS, so at least 2)
CHARGE_GATE_STEPS = 2
# columns of the card-size membrane (16 x 16, 256,000 cells, until the
# whole script's time limit needed its ~30 s: 21 s a step on the card)
CHARGE_MEMBRANE = (8, 8)
CHARGE_MEMBRANE_STEPS = 1
# the membrane's averages against the column's, each on its own scale.
# Its internal potential solve (the default BiCGStab(AMG) at 1e-10, 50
# iterations, as in fvm_tpu) stops at its cap at 7.5e-5 of its first
# residual on the 256,000 cells, where the column's converges: the trapped
# average then agrees to 1.3e-7, the band average only to 5.2e-6.  Given
# the iterations to converge (107, early exit every 10), as the column's
# does, they agree to 5.5e-14 and 1.9e-12 (measured on an NVIDIA H100 80GB
# HBM3 at 700 W).
CHARGE_MEMBRANE_RTOL = 1e-10
CHARGE_MEMBRANE_POTENTIAL_ITERS = 400
TRANSPORT_GATE = (64, 16)  # with DIA structure, so the gate launches it
TRANSPORT_CARD = 512
TRANSPORT_STEPS = 2
TRANSPORT_OUTERS = 3
KE_GATE_N = 32
KE_GATE_FLOW = 20  # coupled outers before the k-epsilon steps
KE_CARD_FLOW = 10  # replayed coupled outers of the 1024^2 cavity
KE_STEPS = 2
KE_OUTERS = 3
BATTERY_GATE = (32, 4)  # demos/battery_cell.py's main()
BATTERY_GATE_STEPS = 2
# the largest cell fvm_tpu converges is 256 x 32 (a step 15.5 s on the
# card); the run holds 128 x 16, and caps the 512^2 cell (1024^2,
# 1,048,576 cells, until the whole script's time limit needed the time)
BATTERY_CARD = (128, 16)
BATTERY_CARD_STEPS = 1
BATTERY_CAP = (512, 512)
BATTERY_CAP_TRIPS = 20
BATTERY_PROFILE_TRIPS = 4
MODEL_PARTS = ("charging", "rest")  # one CPU child each


def transport_model(nx, ny, device):
    """ElectricModel with every charge-transport option on (injection,
    capture, Poole-Frenkel emission, trap-band tunneling; transient) over
    quad_2d(nx, ny) on 1 x ny/nx, 10 V across x."""
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models import EPS0, ElectricModel

    m = ElectricModel(build_device_mesh(quad_2d(nx, ny, ly=ny / nx),
                                        dtype="float64", device=device))
    m.options["verbose"] = False
    for k in ("chargetransport_enable", "injection_enable",
              "trapping_enable", "poole_frenkel_enable",
              "trapbandtunneling_enable", "transient"):
        m.options[k] = True
    m.options["timeStep"] = 0.05
    for k, v in {"dielectric_constant": 1.0 / EPS0, "initialCharge": 1e-6,
                 "mobility": 1e-3, "diffusivity": 1e-4, "injectionA": 1e-5,
                 "injectionB": 5.0, "trapDensity": 1.0,
                 "captureCoefficient": 0.5, "emissionCoefficient": 0.01,
                 "emissionFrequency": 1.0, "pfBeta": 0.15,
                 "thermalVoltage": 0.5, "trapDepth": 2.0, "wkbFactor": -3.0,
                 "tunnelingRateScale": 1.0}.items():
        m.vc[k] = v
    for g, V in (("left", 0.0), ("right", 10.0)):
        m.bc[g].bc_type = "SpecifiedPotential"
        m.bc[g]["specifiedPotential"] = V
    m.bc["bottom"].bc_type = m.bc["top"].bc_type = "Symmetry"
    m.init()
    return m


def transport_steps(m, steps, outers):
    """``steps`` time steps of at most ``outers`` outer iterations each;
    the outer iterations taken."""
    taken = 0
    for _ in range(steps):
        taken += len(m.advance(outers))
        m.updateTime()
    return taken


def tight_battery(b):
    """The battery's JFNK inner solve at 1e-12 (early exit every 10)."""
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver

    s = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                 relative_tolerance=1e-12, max_iterations=600)
    s.exit_every = 10
    b.options["linearSolver"] = s
    b._drop_compiled()


def battery_sensitivities(b, electrode):
    """The tangent in sigma and the adjoint (in sigma) of the mean
    electrode potential at the current state, and their duality gap."""
    import torch

    n = b.mesh.n_interior_cells
    w = torch.zeros(n, dtype=b.mesh.dtype, device=b.mesh.device)
    w[torch.as_tensor(np.nonzero(electrode)[0], device=b.mesh.device)] = \
        1.0 / int(electrode.sum())
    t0 = time.perf_counter()
    tan = b.solve_tangent({"sigma": 1.0})
    tan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = b.solve_adjoint(lambda u: torch.sum(u[:, 1] * w), ("sigma",))
    adj_s = time.perf_counter() - t0
    wn = w.cpu().numpy()
    t_val = float(np.sum(tan[:, 1] * wn))
    a_val = float(np.sum(g["sigma"]))
    return {"tangent": tan.tolist(), "adjoint": g["sigma"].tolist(),
            "duality": abs(t_val - a_val) / max(abs(t_val), 1e-300),
            "t_val": t_val, "tan_s": tan_s, "adj_s": adj_s}


def models_gates(device, parts=MODEL_PARTS):
    """Phases 26-28's small cases on ``device``, as plain numbers;
    "charging": the column stand-in over CHARGE_GATE_STEPS time steps;
    "rest": the charge-transport model at TRANSPORT_GATE, k-epsilon over
    the KE_GATE_N^2 cavity, the battery cell at BATTERY_GATE (the demo's
    steps, the tangent and the adjoint)."""
    from fvm_tpu_torch import cases

    out, t0 = {}, time.perf_counter()

    def took(what):
        nonlocal t0
        log("models", f"{what} on {device}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    if "charging" in parts:
        m = cases.dielectric_column(CHARGE_GATE_N, device=device)
        h = cases.charging_run(m, CHARGE_GATE_STEPS)
        out["charging"] = {"history": h[:, 1:].tolist(),
                           "charge": m.state["charge"].cpu().tolist()}
        took(f"the column stand-in, {CHARGE_GATE_STEPS} steps")
    if "rest" not in parts:
        return out
    m = transport_model(*TRANSPORT_GATE, device)
    transport_steps(m, 4, 3)
    out["transport"] = {"charge": m.getCharge().tolist(),
                        "trapped": m.getTrappedCharge().tolist(),
                        "potential": m.getPotential().tolist()}
    took("the charge-transport gate")
    flow, thermal = cases.coupled_cavity(KE_GATE_N, device=device,
                                         dtype="float64")
    for _ in range(KE_GATE_FLOW):
        cases.coupled_step(flow, thermal)
    ke = cases.ke_cavity(flow)
    for _ in range(KE_STEPS):
        ke.advance(KE_OUTERS)
        ke.updateTime()
    out["ke"] = {"k": ke.getK().tolist(), "eps": ke.getEpsilon().tolist(),
                 "mu_w": ke.getWallViscosity("top").tolist()}
    took("the k-epsilon gate")
    b, el = cases.battery_cell(*BATTERY_GATE, device=device)
    rows = cases.battery_steps(b, el, BATTERY_GATE_STEPS)
    tight_battery(b)
    sens = battery_sensitivities(b, el)
    out["battery"] = {"phi": b.getPotential().tolist(),
                      "c": b.getConcentration().tolist(),
                      "dli": [r[3] for r in rows], "tangent": sens["tangent"],
                      "adjoint": sens["adjoint"],
                      "duality": sens["duality"], "tan_s": sens["tan_s"],
                      "adj_s": sens["adj_s"], "t_val": sens["t_val"]}
    took("the battery gate")
    return out


def peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def charging_phase(device, smi):
    """26 (module docstring); returns the charging electrostatics' and the
    charge-transport matrix's kernel rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    gpu = gates("models_gates", MODEL_PARTS, device)
    rows = []
    # ---- the charge-transport half of ElectricModel at card size
    n = TRANSPORT_CARD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = transport_model(n, n, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    clock = SolveClock()
    clock.wrap(m.options["chargeLinearSolver"], "solve_fn", "charge solve")
    clock.wrap(m.options["electrostaticsLinearSolver"], "solve_fn",
               "potential solve")
    m._drop_compiled()
    dk.reset_launches()
    t0 = time.perf_counter()
    outers = transport_steps(m, TRANSPORT_STEPS, TRANSPORT_OUTERS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    charge_launches = {md: v for (sc, md), v in dk.dia_stencil.scoped.items()
                       if sc == "charge solve"}
    q, ct = m.getCharge(), m.getTrappedCharge()
    log("charging", f"charge transport quad_2d({n}, {n}) float64 (injection,"
        f" capture, Poole-Frenkel, trap-band tunneling; "
        f"{m.params['tun_path'].shape[1]}-cell walks): set up {setup_s:.2f} "
        f"s; {TRANSPORT_STEPS} steps of at most {TRANSPORT_OUTERS} outers "
        f"({outers} outers) in {run_s:.2f} s ({1e3 * run_s / outers:.1f} ms "
        f"per outer: "
        f"{clock.line()}); free charge max {q.max():.6e}, trapped max "
        f"{ct.max():.6e}; dia_stencil launches {scoped_launches()}; peak "
        f"{peak_gib():.3f} GiB [{smi}]")
    if not (np.isfinite(q).all() and np.isfinite(ct).all()
            and ct.max() <= 1.0 + 1e-9 and charge_launches.get("residual")):
        raise AssertionError("charging: the transport run is off or never "
                             "launched the kernel")
    rows += shape_rows(" (charge transport, f64)", "charge-transport fine "
                       "level", m.mesh, charge_launches, device, "float64")
    del m
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the column stand-in on the card (the gate's card side)
    col = gpu["charging"]["history"]
    log("charging", f"column stand-in hex_3d(1, 1, {CHARGE_GATE_N}) "
        f"({cases.CHARGING_STANDIN}), {CHARGE_GATE_STEPS} of the reference script's "
        f"{cases.CHARGING_STEPS} steps on the card: (avg trapped, avg band) "
        + " ".join(f"({a:.9e}, {b:.9e})" for a, b in col))

    # ---- the membrane at card size
    nx, ny = CHARGE_MEMBRANE
    nf, nE, lv = nx * ny, 801, 1000
    log("charging", f"membrane hex_3d({nx}, {ny}, {CHARGE_GATE_N}): the "
        f"coefficient program's (energy, face, level) float64 arrays are "
        f"{nE * nf * lv * 8 / 2**30:.3f} GiB each, its (energy, cell, trap) "
        f"ones {nE * nf * CHARGE_GATE_N * 2 * 8 / 2**30:.3f} GiB each")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mem = cases.charging_membrane(nx, ny, CHARGE_GATE_N, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    clock = SolveClock()
    clock.wrap(mem, "_coeffs", "coefficients")
    clock.wrap(mem, "_solve_potential", "potential")
    clock.wrap(mem._solver, "solve_fn", "Newton solve")
    pstats = []
    psolve = mem._electric.options["electrostaticsLinearSolver"]
    psolve.nMaxIterations = CHARGE_MEMBRANE_POTENTIAL_ITERS
    psolve.exit_every = 10
    inner = psolve.solve_fn

    def kept(*a, **kw):
        x, st = inner(*a, **kw)
        pstats.append(st)
        return x, st

    psolve.solve_fn = kept
    dk.reset_launches()
    t0 = time.perf_counter()
    hist = cases.charging_run(mem, CHARGE_MEMBRANE_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trips = [int(s.iterations) for s in mem.solve_stats]
    peak = peak_gib()
    log("charging", f"membrane {mem._n_int} cells float64: set up "
        f"{setup_s:.2f} s; {CHARGE_MEMBRANE_STEPS} steps in {run_s:.2f} s "
        f"({run_s / CHARGE_MEMBRANE_STEPS:.2f} s per step: "
        f"{clock.line()}); Krylov trips per Newton step (the last step) "
        f"{trips}; peak {peak:.3f} GiB [{smi}]")
    phi = mem._electric.getPotential().reshape(nx * ny, CHARGE_GATE_N)
    log("charging", "membrane potential solves (iterations, residual / "
        "first): " + ", ".join(f"{int(st.iterations)}, "
                               f"{float(st.residual / st.residual0):.3e}"
                               for st in pstats)
        + f"; the columns' potentials differ by up to "
        f"{float(np.abs(phi - phi[:1]).max() / np.abs(phi).max()):.3e} of "
        f"the largest")
    x = mem.state["charge"].cpu().numpy().reshape(nx * ny, CHARGE_GATE_N, -1)
    log("charging", "the columns' charges differ by up to (traps, band) "
        + ", ".join(f"{v:.3e}" for v in (
            np.abs(x - x[:1]).max(axis=(0, 1))
            / np.abs(x).max(axis=(0, 1)))[[0, -1]]))
    # the history rows are taken before each step: the totals after the
    # last one close it
    rows_m = np.vstack([hist[:, 1:], [mem.calculateTotalCharges()]])
    diff = column_diffs(rows_m,
                        np.asarray(col)[: CHARGE_MEMBRANE_STEPS + 1])
    log("charging", f"membrane (avg trapped, avg band) " + " ".join(
        f"({a:.9e}, {b:.9e})" for a, b in rows_m)
        + f": against the column's, max rel diff {diff[0]:.3e} (avg "
        f"trapped), {diff[1]:.3e} (avg band) (tol {CHARGE_MEMBRANE_RTOL:g} "
        f"each)")
    if not max(diff) <= CHARGE_MEMBRANE_RTOL:
        raise AssertionError("charging: the membrane's columns disagree "
                             "with the column")
    launches = dk.type_launches(torch.float64)
    em = mem._electric
    log("charging", "electrostatics dia_stencil launches by level: "
        + level_launches(kb.level_shapes(
            em.options["electrostaticsLinearSolver"].preconditioner,
            em.mesh)))
    if not launches["residual"]:
        raise AssertionError("charging: the electrostatics never launched "
                             "the kernel")
    rows += shape_rows(" (charging electrostatics, f64)", "charging "
                       "electrostatics fine level", em.mesh, launches, device,
                       "float64")
    del mem, em
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu = gates("models_gates", MODEL_PARTS, "cpu")
    log("charging", f"waited {time.perf_counter() - t0:.1f} s for the CPU "
        f"side")
    check_gates("charging", gpu["charging"], cpu["charging"],
                ("history", "charge"), columns=("history", "charge"))
    check_gates("charging", gpu["transport"], cpu["transport"],
                ("charge", "trapped", "potential"))
    return rows


def ke_phase(device, smi):
    """27 (module docstring); returns the ke cavity's kernel rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops.gradients import gradient

    gpu = gates("models_gates", MODEL_PARTS, device)
    cpu = gates("models_gates", MODEL_PARTS, "cpu")
    check_gates("ke", gpu["ke"], cpu["ke"], ("k", "eps", "mu_w"))

    t0 = time.perf_counter()
    flow, thermal = cases.cavity_models(main_mesh(device))
    for _ in range(WARMUP_STEPS):
        cases.coupled_step(flow, thermal)
    cases.coupled_steps(flow, thermal, KE_CARD_FLOW)
    torch.cuda.synchronize()
    log("ke", f"bench's {MAIN_N}^2 {MAIN_DTYPE} cavity after "
        f"{WARMUP_STEPS} eager and {KE_CARD_FLOW} replayed coupled outers in "
        f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for label, chunk in (("eager", 0), ("replay", KE_OUTERS)):
        ke = cases.ke_cavity(flow, {"outerChunk": chunk})
        if label == "replay":  # the capture outside the timed steps
            snap = {k: v.clone() for k, v in ke.state.items()}
            ke.advance(KE_OUTERS)
            ke.state = snap
            ke._initial_norm = None
        dk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = []
        for _ in range(KE_STEPS):
            hist += [h[1] for h in ke.advance(KE_OUTERS)]
            ke.updateTime()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[label] = (ke.getK(), ke.getEpsilon(), hist, secs,
                       dk.type_launches(torch.float32), ke)
    outers = KE_STEPS * KE_OUTERS
    ke = runs["eager"][5]
    launches = runs["eager"][4]
    log("ke", f"KeModel on the {MAIN_N}^2 cavity ({ke.mesh.n_cells} rows, "
        f"Wall on the four walls, BiCGStab(Jacobi(3), 1e-8, 100) per "
        f"equation): {KE_STEPS} steps of {KE_OUTERS} outers eager "
        f"{1e3 * runs['eager'][3] / outers:.2f} ms per outer, as outerChunk "
        f"{KE_OUTERS} graph replays {1e3 * runs['replay'][3] / outers:.2f} "
        f"ms per outer; dia_stencil launches per outer " + ", ".join(
            f"{md} {v / outers:g}" for md, v in launches.items())
        + f"; residuals " + ", ".join(f"{r:.6e}" for r in runs["eager"][2])
        + f" [{smi}]")
    same = all(np.array_equal(a, b) for a, b in
               zip(runs["eager"][:3], runs["replay"][:3]))
    log("ke", f"replay against eager: k, eps and the residuals "
        f"{'equal bit for bit' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("ke: the replay differs from the eager loop")
    if not (launches["residual"] and np.isfinite(runs["eager"][0]).all()
            and (runs["eager"][0] > 0).all()):
        raise AssertionError("ke: no kernel launches or a bad k field")
    # the least-squares gradients' share of an outer: one vector gradient
    # (production) and two scalar ones (the k and eps equations)
    coeff = ke.params["grad_coeff"]
    V, k = ke.state["velocity"], ke.state["k"]
    g_vec = time_events([lambda: gradient(ke.mesh, coeff, V)], 20)
    g_sc = time_events([lambda: gradient(ke.mesh, coeff, k)], 20)
    outer_ms = 1e3 * runs["replay"][3] / outers
    log("ke", f"LS gradients: vector {g_vec:.3f} ms, scalar {g_sc:.3f} ms; "
        f"{g_vec + 2 * g_sc:.3f} ms per outer, "
        f"{100 * (g_vec + 2 * g_sc) / outer_ms:.1f}% of a replayed outer")
    profile_run("ke", "one eager ke outer", lambda: ke.advance(1),
                1e3 * runs["eager"][3] / outers, top=8)
    mesh = ke.mesh
    del runs, ke, flow, thermal
    gc.collect()
    rows = shape_rows(" (ke)", "ke fine level", mesh, launches, device,
                      MAIN_DTYPE)
    torch.cuda.empty_cache()
    return rows


def battery_phase(device, smi):
    """28 (module docstring); no kernel rows (matrix-free, no DIA)."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver
    from fvm_tpu_torch.linear.base import product_mode

    gpu = gates("models_gates", MODEL_PARTS, device)
    cpu = gates("models_gates", MODEL_PARTS, "cpu")
    check_gates("battery", gpu["battery"], cpu["battery"],
                ("phi", "c", "dli", "tangent", "adjoint"))
    log("battery", f"the demo's cell {BATTERY_GATE[0]} x {BATTERY_GATE[1]}: "
        f"d(Li_electrode) cuda " + ", ".join(
            f"{v:.9e}" for v in gpu["battery"]["dli"])
        + f"; tangent in sigma {gpu['battery']['tan_s']:.2f} s, adjoint "
        f"{gpu['battery']['adj_s']:.2f} s on the card (inner solves at "
        f"1e-12), d(mean electrode phi) . dsigma "
        f"{gpu['battery']['t_val']:.9e}; duality cuda "
        f"{gpu['battery']['duality']:.3e} cpu {cpu['battery']['duality']:.3e}")
    if not gpu["battery"]["duality"] <= GATE_RTOL:
        raise AssertionError("battery: the adjoint and the tangent disagree")

    # ---- the largest cell fvm_tpu converges, on the card
    nx, ny = BATTERY_CARD
    t0 = time.perf_counter()
    b, el = cases.battery_cell(nx, ny, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = cases.battery_steps(b, el, BATTERY_CARD_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    newton = sum(r[0] for r in steps)
    worst = max(abs(r[3] / r[4] - 1.0) for r in steps)
    log("battery", f"cell quad_2d({nx}, {ny}) float64 "
        f"({b.mesh.n_interior_cells} cells, products "
        f"{product_mode(b._unknowns(b.state))}): set up {setup_s:.2f} s; "
        f"{BATTERY_CARD_STEPS} time steps in {run_s:.2f} s "
        f"({run_s / BATTERY_CARD_STEPS:.2f} s per step, {newton} Newton "
        f"iterations, {run_s / newton:.3f} s each); per step (Newton its, "
        f"last residual, terminal V, d(Li_electrode), -dt I/F): "
        + "; ".join(f"{r[0]}, {r[1]:.3e}, {r[2]:.6f}, {r[3]:.9e}, "
                    f"{r[4]:.9e}" for r in steps)
        + f"; Li balance max rel err {worst:.3e} [{smi}]")
    if not worst <= 1e-8:
        raise AssertionError("battery: the Li balance is off")
    # kernels and idle share of one Newton step with its trips capped
    s = b.options["linearSolver"]
    s.nMaxIterations = BATTERY_PROFILE_TRIPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.advance(1)
    torch.cuda.synchronize()
    profile_run("battery", f"one Newton step, {BATTERY_PROFILE_TRIPS} "
                f"Krylov trips", lambda: b.advance(1),
                1e3 * (time.perf_counter() - t0), top=8)
    del b
    gc.collect()

    # ---- the capped card-size run
    nx, ny = BATTERY_CAP
    solver = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                      relative_tolerance=1e-8,
                      max_iterations=BATTERY_CAP_TRIPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b, el = cases.battery_cell(nx, ny, device=device, solver=solver)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = b.advance(1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    log("battery", f"capped cell quad_2d({nx}, {ny}) float64 "
        f"({b.mesh.n_interior_cells} cells, products "
        f"{product_mode(b._unknowns(b.state))}): set up {setup_s:.2f} s; "
        f"one Newton step of {BATTERY_CAP_TRIPS} Krylov trips in "
        f"{step_s:.2f} s ({1e3 * step_s / BATTERY_CAP_TRIPS:.1f} ms per "
        f"trip), entry residual {hist[0][1]:.6e}; peak {peak_gib():.3f} GiB "
        f"[{smi}]")
    if not np.isfinite(b.getPotential()).all():
        raise AssertionError("battery: the capped run is not finite")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return []


# ---- phase 29: the ES-BGK kinetic solver (kinetic/esbgk.py, kinetic/dsa.py)
# the demo Couette's COMET outers: its residual reaches its plateau (1.1e-9
# from 9.5e-3) at the fourth and its slip profile with it
KIN_COUETTE_OUTERS = 6
KIN_SWEEP_OUTERS = 10
# cuda against cpu on the slip profile: fvm_tpu's own interior distribution
# moves by 4.1e-8 of its largest entry over the demo's first 20 outers
# (1.6e-4 after the first) under a 1e-15 change of the wall velocity
# (scripts/roundoff_sensitivity.py --cases kinetic)
KIN_COUETTE_RTOL = 1e-5
KIN_SWEEP_RTOL = 1e-10  # the Picard path moves by 3.7e-16
KIN_THICK_GATE = (48, 3)  # tests/test_comet.py:158-191
# the plain run's plateau is a round-off sample (fvm_tpu's own moves by 3.3
# relative under a 1e-15 change of the wall temperature): its relative
# residual is the median over these changes of the hot wall's temperature
KIN_THICK_PLAIN_EPS = (0.0, 1e-15, 2e-15)
# the thick case where its DSA hierarchy is DIA at every level: one DSA
# application on seeded vectors, and one outer with the inner solve at
# KIN_APPLY_INNER (tolerance, trips; 291 trips on the CPU)
KIN_APPLY = (32, 16)
KIN_APPLY_SEED = 7
KIN_APPLY_INNER = (1e-12, 400)
KIN_APPLY_RTOL = 1e-12
KIN_OUTER_RTOL = 1e-10
KIN_SENS = (3, 10)  # tests/test_kinetic.py:749-795's duality case
KIN_SENS_OUTERS = 12  # its residual plateaus (~1e-9) by the fifth
KIN_SENS_TRIPS = 400  # solve_adjoint's and solve_tangent's cap
# the tangents, the adjoint and the duality: converged solves move by up to
# 2.1e-9 and read a duality of 1.7e-12 to 3.0e-9 under 1e-16 and 1e-15
# changes to the transposed products (scripts/kinetic_duality.py
# --cpu-samples 4)
KIN_SENS_RTOL = 1e-8
KIN_DUAL_TOL = 1e-8
KIN_IB_N = 16  # tests/test_kinetic.py:690-713's moving plate
# one outer with the inner solves at 1e-12: fvm_tpu's own moments move by
# 1.3e-12-5.5e-12 under a 1e-15 change of tau after one outer, 7.7e-7
# after two (scripts/roundoff_sensitivity.py --cases kinetic)
KIN_IB_OUTERS = 1
KIN_IB_RTOL = 1e-8
# (outerChunk, outers, inner trips) of the replay against eager (the inner
# solve capped at 10 trips: 60 until the kinetic phase needed the time)
KIN_CHUNK = (2, 2, 10)
KIN_PARTS = ("thick", "apply", "rest")  # one CPU child each
# the largest quad_2d(4k, k) within KIN_PEAK_GIB (k a multiple of 8): 41.24
# GiB at quad_2d(1024, 256), 37.71 at (992, 248) (NVIDIA H100 80GB HBM3,
# 700.00 W); the run holds quad_2d(512, 128), about a quarter of those
# cells (its 2 outers took ~13 s at (992, 248), which the whole script's
# time limit no longer had)
KIN_THICK_CARD = (512, 128)
KIN_THICK_OUTERS = 2
# the largest 3:1 quad_2d measured within KIN_PEAK_GIB: 18.13 GiB at
# quad_2d(384, 128); quad_2d(576, 192) ran out of the card's memory in its
# first outer (72.8 GiB allocated, 46.7 of them the graph-replayed
# product's private pool; NVIDIA H100 80GB HBM3, 700.00 W).  The run
# holds quad_2d(192, 64), a quarter of those cells (a step at (384, 128)
# took ~19.5 s, which the whole script's time limit no longer had)
KIN_DAMP_CARD = (192, 64)
KIN_DAMP_STEPS = 1  # of main()'s 40
KIN_PEAK_GIB = 40.0
KIN_REPS = 5  # timed applications of the product and the preconditioners
# the profiled outer's BiCGStab trips (of its 60): the profiler's own cost
# grows with the kernels it records, ~2,000 a trip
KIN_PROFILE_TRIPS = 4


def held_gib():
    """GiB allocated on the card now, after freeing what can be freed, with
    the peak counter reset: a case's own peak is ``peak_gib()`` minus
    this (earlier phases leave ~1.6 GiB held)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def kinetic_gates(device, parts=KIN_PARTS):
    """Phase 29's small cases on ``device``, as plain numbers.  "thick": the
    thick DSA case at KIN_THICK_GATE, 8 outers with the DSA and, for each
    of KIN_THICK_PLAIN_EPS, without; "apply": the thick case at KIN_APPLY,
    one DSA application (``thick_dsa_apply``) and one outer with a tight
    inner solve; "rest": the demo Couette (COMET and Picard), the duality
    case (``kinetic_duality``), the immersed moving plate with tight inner
    solves."""
    from fvm_tpu_torch import cases

    out, t0 = {}, time.perf_counter()

    def took(what):
        nonlocal t0
        log("kinetic", f"{what} on {device}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    if "thick" in parts:
        m = cases.esbgk_thick(*KIN_THICK_GATE, dsa=True, device=device)
        h = [r[1] for r in m.advance(cases.THICK_OUTERS)]
        plain = []
        for eps in KIN_THICK_PLAIN_EPS:
            p = cases.esbgk_thick(*KIN_THICK_GATE, dsa=False, device=device)
            p.bc["left"]["specifiedTemperature"] = 1.1 * (1.0 + eps)
            hp = [r[1] for r in p.advance(cases.THICK_OUTERS)]
            plain.append(hp[-1] / hp[0])
        out["thick"] = {"history": h, "rel_dsa": h[-1] / h[0],
                        "rel_plain": plain}
        took(f"the thick case, {cases.THICK_OUTERS} outers with the DSA and "
             f"{len(plain)} without")
    if "apply" in parts:
        m = cases.esbgk_thick(*KIN_APPLY, dsa=True, device=device)
        out["apply"] = thick_dsa_apply(m)
        m.options["innerTolerance"], m.options["innerIterations"] = \
            KIN_APPLY_INNER
        m._drop_compiled()
        h = m.advance(1)
        n = m.mesh.n_interior_cells
        out["apply"].update(f1=m.state["f"][:n].cpu().tolist(),
                            h0=h[0][1], trips=h.trips[0])
        took(f"the thick case at quad_2d{KIN_APPLY}: one DSA application "
             f"and one outer")
    if "rest" not in parts:
        return out
    m = cases.esbgk_couette(device=device)
    h = [r[1] for r in m.advance(KIN_COUETTE_OUTERS)]
    ux, slip = cases.couette_profile(m)
    out["couette"] = {"history": h, "ux": ux.tolist(), "slip": slip,
                      "conservation": list(m.conservation_error())}
    m = cases.esbgk_couette(device=device, options={"solver": "sweep"})
    h = [r[1] for r in m.advance(KIN_SWEEP_OUTERS)]
    out["sweep"] = {"history": h, "ux": cases.couette_profile(m)[0].tolist()}
    took(f"the demo Couette, {KIN_COUETTE_OUTERS} COMET and "
         f"{KIN_SWEEP_OUTERS} Picard outers")
    out["sens"] = kinetic_duality(device)
    took("the duality case (converge, two tangents, the adjoint)")
    m = cases.esbgk_ib_plate(KIN_IB_N, device=device, pad_faces=80,
                             options={"innerTolerance": 1e-12,
                                      "innerIterations": 200})
    h = [r[1] for r in m.advance(KIN_IB_OUTERS)]
    rho, u, T = m.moments()
    n = m.mesh.n_interior_cells
    out["ib"] = {"history": h, "rho": rho[:n].tolist(),
                 "ux": u[:n, 0].tolist(), "T": T[:n].tolist(),
                 "force": m.getIBForceIntegral().tolist()}
    took(f"the immersed plate, {KIN_IB_OUTERS} outers")
    return out


def thick_dsa_apply(m):
    """One DSA application of the thick model ``m`` on seeded numbers (the
    same on every device): at its state times 1 + 0.01 noise, on a noise
    vector r, the two V-cycles M_T(r wE), the Woodbury + DSA composition
    M_d(r) and its transpose M_d^T(r)."""
    import torch
    from fvm_tpu_torch.kinetic.dsa import DSAPrecond
    from fvm_tpu_torch.kinetic.esbgk import _KineticOperator

    rng = np.random.default_rng(KIN_APPLY_SEED)
    f0 = m.state["f"]
    f = f0 * torch.as_tensor(1.0 + 0.01 * rng.standard_normal(
        tuple(f0.shape))).to(f0.device)
    r = torch.as_tensor(rng.standard_normal(tuple(f0.shape))).to(f0.device)
    mesh, params = m.mesh, m.params
    V = mesh.cell_volume[:, None]
    tau = params["tau"][:, None]
    op = _KineticOperator(mesh, params["dO"], params["dN"], V / tau)
    M_T, wE = m._dsa_tuple()[:2]
    dsa = DSAPrecond(m._woodbury(op, f, V, tau), *m._dsa_tuple())
    return {"M_T": M_T(r @ wE).tolist(),
            "M_d": dsa.precond_setup(op)(r).tolist(),
            "M_d^T": dsa.precond_setup_T(op)(r).tolist()}


def kinetic_duality(device):
    """The duality case (tests/test_kinetic.py:749-795: the Couette layout
    at KIN_SENS, BGK, tau 0.2) after KIN_SENS_OUTERS outers: the tangents
    in tau (seeded) and in the top wall's velocity, the adjoint of J =
    sum((f w c_x)^2) in both, each pair <grad, dp> against dJ(tangent),
    the seconds, the trips and the adjoint's final relative residual."""
    import torch
    from fvm_tpu_torch import cases

    m = cases.esbgk_couette(*KIN_SENS, device=device, collision="BGK",
                            tau=0.2)
    m.advance(KIN_SENS_OUTERS)
    ni = m.mesh.n_interior_cells
    dtau = np.random.default_rng(3).standard_normal(ni)
    bc = "top:specifiedXVelocity"
    t1 = time.perf_counter()
    tan = m.solve_tangent(param_tangents={"tau": dtau},
                          max_iterations=KIN_SENS_TRIPS)
    tan_s = time.perf_counter() - t1
    tanb = m.solve_tangent(bc_tangents={bc: 1.0},
                           max_iterations=KIN_SENS_TRIPS)
    q = m.quadrature
    wcx = torch.as_tensor(q.w * q.c[:, 0]).to(m.mesh.device)

    def J(ff):
        return torch.sum((ff @ wcx) ** 2)

    t1 = time.perf_counter()
    g = m.solve_adjoint(J, param_keys=("tau",), bc_keys=(bc,),
                        max_iterations=KIN_SENS_TRIPS)
    adj_s = time.perf_counter() - t1
    f0 = m.state["f"][:ni]

    def dJ(df):
        return float(torch.func.jvp(J, (f0,), (torch.as_tensor(df).to(
            f0.device),))[1])

    pairs = ((float(np.dot(g["tau"], dtau)), dJ(tan)),
             (float(np.sum(g[bc])), dJ(tanb)))
    st = m.adjoint_stats
    return {"tangent": tan.tolist(), "tangent_bc": tanb.tolist(),
            "adjoint": g["tau"].tolist(), "pairs": pairs,
            "duality": max(abs(a - b) / abs(b) for a, b in pairs),
            "tan_s": tan_s, "adj_s": adj_s,
            "adj_its": int(st.iterations),
            "adj_rel": float(st.residual / st.residual0),
            "tan_its": int(m.tangent_stats.iterations)}


def chunk_check(tag, build, key, chunk, outers, label):
    """``outerChunk`` replays of the COMET step against the same step run
    eagerly (forward-mode products in both), bit for bit: ``build(ch)``
    makes the model with ``outerChunk`` ch (0: eager), ``key`` names its
    state, ``label`` the case in the log line."""
    import torch

    runs = []
    for ch in (0, chunk):
        m = build(ch)
        if ch:
            x_init = m.state[key].clone()
            m.advance(outers)  # the capture
            m.state[key] = x_init
            m._initial_norm = None
        else:
            m._step = m._build_step("forward")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = m.advance(outers)
        torch.cuda.synchronize()
        runs.append(([r[1] for r in h], m.state[key].clone(),
                     (time.perf_counter() - t0) / outers))
    (h0, x0, eager_s), (h1, x1, replay_s) = runs
    same = h0 == h1 and torch.equal(x0, x1)
    log(tag, f"outerChunk {chunk} replays against the eager step, {outers} "
        f"outers of {label}: " + ("bit for bit" if same else "DIFFER")
        + f"; {1e3 * replay_s:.2f} ms per replayed outer, "
        f"{1e3 * eager_s:.2f} eager")
    if not same:
        raise AssertionError(f"{tag}: the chunk replay differs from eager")


def kinetic_chunk_check(device):
    """``chunk_check`` on the duality case's Couette, its inner solves
    capped."""
    from fvm_tpu_torch import cases

    chunk, outers, trips = KIN_CHUNK
    chunk_check("kinetic", lambda ch: cases.esbgk_couette(
        *KIN_SENS, device=device, collision="BGK", tau=0.2, options={
            "outerChunk": ch, "innerIterations": trips,
            "relativeTolerance": 1e-30}), "f", chunk, outers,
        f"the quad_2d{KIN_SENS} Couette (inner solves of {trips} trips)")


def kinetic_checks(gpu, cpu):
    """Phase 29's gates: cuda against cpu, and the JAX tests' assertions on
    each device."""
    th_g, th_c = gpu["thick"], cpu["thick"]
    for dev, th in (("cuda", th_g), ("cpu", th_c)):
        plain = float(np.median(th["rel_plain"]))
        log("kinetic", f"thick quad_2d{KIN_THICK_GATE} on {dev}: rel_dsa "
            f"{th['rel_dsa']:.3e}, rel_plain " + ", ".join(
                f"{v:.3e}" for v in th["rel_plain"]) + f" (median {plain:.3e})"
            f"; history with the DSA " + ", ".join(
                f"{v:.4e}" for v in th["history"]))
        if not (th["rel_dsa"] < 1e-3 and th["rel_dsa"] < plain / 5):
            raise AssertionError(f"kinetic: the thick DSA assertion fails on "
                                 f"{dev}")
    check_gates("kinetic", {"thick h0": th_g["history"][0]},
                {"thick h0": th_c["history"][0]}, ("thick h0",), rtol=1e-10)
    a_g, a_c = gpu["apply"], cpu["apply"]
    log("kinetic", f"thick quad_2d{KIN_APPLY}: one DSA application on seeded "
        f"vectors; one outer with the inner solve at {KIN_APPLY_INNER[0]:g}"
        f": {a_g['trips']} trips cuda, {a_c['trips']} cpu")
    check_gates("kinetic", a_g, a_c, ("M_T", "M_d", "M_d^T"),
                rtol=KIN_APPLY_RTOL)
    check_gates("kinetic", a_g, a_c, ("h0", "f1"), rtol=KIN_OUTER_RTOL)
    if not max(a_g["trips"], a_c["trips"]) < KIN_APPLY_INNER[1]:
        raise AssertionError("kinetic: the thick outer's inner solve did not "
                             "converge")
    c_g, c_c = gpu["couette"], cpu["couette"]
    log("kinetic", f"Couette quad_2d(3, 32) ES-BGK: slip cuda "
        f"{c_g['slip']:.9f} cpu {c_c['slip']:.9f}; histories cuda "
        + ", ".join(f"{v:.3e}" for v in c_g["history"]) + "; cpu "
        + ", ".join(f"{v:.3e}" for v in c_c["history"])
        + f"; conservation error cuda " + ", ".join(
            f"{v:.2e}" for v in c_g["conservation"]))
    check_gates("kinetic", c_g, c_c, ("ux",), rtol=KIN_COUETTE_RTOL)
    check_gates("kinetic", gpu["sweep"], cpu["sweep"], ("history", "ux"),
                rtol=KIN_SWEEP_RTOL)
    if not (c_g["slip"] > 0.05 and c_g["ux"][-1] > 0.05
            and abs(c_g["ux"][-1] + c_g["ux"][0]) < 0.02):
        raise AssertionError("kinetic: no antisymmetric slip profile")
    s_g, s_c = gpu["sens"], cpu["sens"]
    log("kinetic", f"duality case quad_2d{KIN_SENS}: tangent "
        f"{s_g['tan_s']:.2f} s ({s_g['tan_its']} trips), adjoint "
        f"{s_g['adj_s']:.2f} s "
        f"({s_g['adj_its']} trips, relative residual {s_g['adj_rel']:.2e}) "
        f"on the card, {s_c['adj_its']} trips ({s_c['adj_rel']:.2e}) on the "
        f"cpu; duality cuda {s_g['duality']:.3e} cpu {s_c['duality']:.3e}")
    check_gates("kinetic", s_g, s_c, ("tangent", "tangent_bc", "adjoint"),
                rtol=KIN_SENS_RTOL)
    if not max(s_g["adj_its"], s_c["adj_its"], s_g["tan_its"],
               s_c["tan_its"]) < KIN_SENS_TRIPS:
        raise AssertionError("kinetic: a sensitivity solve stopped at its "
                             "cap")
    if not max(s_g["duality"], s_c["duality"]) <= KIN_DUAL_TOL:
        raise AssertionError("kinetic: the adjoint and the tangent disagree")
    i_g, i_c = gpu["ib"], cpu["ib"]
    log("kinetic", f"immersed plate quad_2d({KIN_IB_N}, {KIN_IB_N}): IB force "
        f"cuda {i_g['force']} cpu {i_c['force']}")
    check_gates("kinetic", i_g, i_c, ("rho", "ux", "T", "force"),
                rtol=KIN_IB_RTOL)


def dsa_outer_parts(tag, m, x, R, op_plain, point):
    """ms per exact-Jacobian product of the COMET residual ``R`` at the
    ghost-refreshed state ``x`` (the step's mode), per Woodbury application
    (``point``), per DSA application and per M_T (the two V-cycles) of the
    model ``m``; and the DSA's fine-level operator in every mode against
    the plain version, bit for bit.  Returns (ms by part, the fine level's
    rows, its offsets)."""
    import torch
    from fvm_tpu_torch.kinetic.dsa import DSAPrecond
    from fvm_tpu_torch.kinetic.esbgk import _JVPOperator
    from fvm_tpu_torch.linear.base import product_mode
    from fvm_tpu_torch.ops import dia_kernel as dk

    mode = product_mode(x)
    op = _JVPOperator(op_plain, R, x, mode)
    M_T, wE = m._dsa_tuple()[:2]
    Mw = point.precond_setup(op)
    Md = DSAPrecond(point, *m._dsa_tuple()).precond_setup(op)
    r = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                    generator=torch.Generator(x.device).manual_seed(7))
    rT = r @ wE
    parts = {name: time_events([fn], KIN_REPS) for name, fn in (
        ("product (" + mode + ")", lambda: op.mv(r)),
        ("Woodbury", lambda: Mw(r)),
        ("DSA (Woodbury + 2 V-cycles)", lambda: Md(r)),
        ("2 V-cycles", lambda: M_T(rT)))}
    # the DSA's own fine-level operator on its real coefficients
    A = M_T.matrix.prepare()
    offs = A.dia.offsets
    for mode_ in dk.MODES:
        b = None if mode_ == "mv" else rT.flip(0)
        omega = 0.7 if mode_ == "jacobi" else None
        y = dk._launch(offs, mode_, A.dia_coef, A.diag, rT, b, omega)
        want = dk.dia_stencil_plain(offs, mode_, A.dia_coef, A.diag, rT,
                                    b=b, omega=omega)
        err = float((y - want).abs().max())
        if not err == 0.0:
            raise AssertionError(f"{tag}: the DSA's {mode_} disagrees with "
                                 f"the plain version: {err:.3e}")
    return parts, A.n, tuple(offs)


def dsa_card_run(tag, device, smi, build, key, outers, parts_of, what,
                 rows_as, note=lambda m, hist: ""):
    """A COMET model with the DSA at card size: ``build()`` it, run
    ``outers`` outers with the dia_stencil launches counted and log its
    set-up, seconds per outer and per BiCGStab trip, residuals (and
    ``note(m, hist)``), peak memory above what was held before (at most
    KIN_PEAK_GIB) and launches per outer by mode and level (every mode
    launched); then ``parts_of(m)`` (``dsa_outer_parts``), one outer
    profiled with its BiCGStab capped at KIN_PROFILE_TRIPS trips, and the
    fine level's kernel rows (``rows_as``: their tag and label), which it
    returns.  ``what`` opens the first log line; ``key`` names the
    state."""
    import torch
    from fvm_tpu_torch.linear.base import product_mode
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.tools import kernel_bench as kb

    base = held_gib()
    t0 = time.perf_counter()
    m = build()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dk.reset_launches()
    t0 = time.perf_counter()
    hist = m.advance(outers)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = peak_gib() - base
    x = m.state[key]
    trips = sum(hist.trips)
    launches = dk.type_launches(torch.float64)
    shapes = kb.level_shapes(m._dsa_tuple()[0].amg, m.mesh)
    log(tag, f"{what}: {m.mesh.n_interior_cells} cells x {x.shape[1]} "
        f"ordinates ({key} {x.numel() * 8 / 1e6:.0f} MB, products "
        f"{product_mode(x)}); set up {setup_s:.2f} s (DSA hierarchy: "
        f"{describe(shapes)}); {len(hist)} COMET outers in {run_s:.2f} s "
        f"({run_s / len(hist):.2f} s per outer, {trips} BiCGStab trips, "
        f"{1e3 * run_s / max(trips, 1):.1f} ms per trip); residuals "
        + ", ".join(f"{r[1]:.6e}" for r in hist) + note(m, hist)
        + f"; peak {peak:.3f} GiB above the {base:.3f} held before [{smi}]")
    log(tag, "dia_stencil launches per outer: " + ", ".join(
        f"{k} {v / len(hist):g}" for k, v in sorted(launches.items()))
        + "; by level: " + level_launches(shapes))
    if not all(launches.get(k) for k in dk.MODES):
        raise AssertionError(f"{tag}: the DSA cycles did not launch "
                             f"dia_stencil in every mode")
    if peak > KIN_PEAK_GIB:
        raise AssertionError(f"{tag}: peak {peak:.1f} GiB above "
                             f"{KIN_PEAK_GIB:g}")
    if not (np.isfinite([r[1] for r in hist]).all()
            and bool(torch.isfinite(x).all())):
        raise AssertionError(f"{tag}: the card-size run is not finite")
    parts, n_fine, offs = parts_of(m)
    log(tag, "at the last state, ms per application: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; the DSA's fine level ({n_fine} rows, offsets {offs}) against "
        f"the plain version in every mode: max abs err 0 [{smi}]")
    m.options["innerIterations"] = KIN_PROFILE_TRIPS
    m._step = m._build_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.advance(1)
    torch.cuda.synchronize()
    profile_run(tag, f"one outer of that case, its BiCGStab capped at "
                f"{KIN_PROFILE_TRIPS} trips", lambda: m.advance(1),
                1e3 * (time.perf_counter() - t0), top=8)
    rows = shape_rows(*rows_as, m.mesh, launches, device, "float64")
    del m, x
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def thick_outer_parts(m):
    """``dsa_outer_parts`` of the thick ES-BGK model at its state."""
    from fvm_tpu_torch.kinetic.esbgk import _KineticOperator

    mesh, params = m.mesh, m.params
    bc = m._resolve_bcvals()
    f = m._refresh_ghosts(mesh, params, m.state["f"], bc)
    V = mesh.cell_volume[:, None]
    tau = params["tau"][:, None]
    op = _KineticOperator(mesh, params["dO"], params["dN"], V / tau)
    R_of = m._comet_R_of(mesh, params, bc)
    return dsa_outer_parts("kinetic", m, f, lambda fv: R_of({}, {}, fv), op,
                           m._woodbury(op, f, V, tau))


def kinetic_phase(device, smi):
    """29 (module docstring); returns the DSA fine level's kernel rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.linear.base import product_mode

    gpu = gates("kinetic_gates", KIN_PARTS, device)
    kinetic_chunk_check(device)

    # ---- the thick case at card size
    nx, ny = KIN_THICK_CARD
    rows = dsa_card_run(
        "kinetic", device, smi,
        lambda: cases.esbgk_thick(nx, ny, dsa=True, device=device), "f",
        KIN_THICK_OUTERS, thick_outer_parts,
        f"thick quad_2d({nx}, {ny}) float64, periodic bottom/top, DSA on",
        (" (kinetic DSA, f64)", "kinetic DSA fine level"))

    # ---- the damping stand-in at its published quadrature, card size
    nx, ny = KIN_DAMP_CARD
    base = held_gib()
    t0 = time.perf_counter()
    m = cases.esbgk_damping(nx, ny, device=device)
    F0 = m.getMomentumFluxIntegral("top")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows_d = cases.damping_steps(m, KIN_DAMP_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = peak_gib() - base
    F = m.getMomentumFluxIntegral("top")
    cons = m.conservation_error()
    log("kinetic", f"damping quad_2d({nx}, {ny}) ({cases.DAMPING_STANDIN}), "
        f"Q(10,10,10): {m.mesh.n_interior_cells} cells x {m.quadrature.N} "
        f"ordinates, products {product_mode(m.state['f'])}; set up "
        f"{setup_s:.2f} s; {len(rows_d)} time steps of advance("
        f"{cases.DAMPING_OUTERS}) in {run_s:.2f} s ({run_s / len(rows_d):.2f}"
        f" s per step; cut from main()'s 40; per step outers, last residual,"
        f" F_y: " + "; ".join(
            f"{r[0]}, {r[1]:.3e}, {r[2]:+.9e}" for r in rows_d)
        + f"); beam force static {F0[1]:+.9e}, now {F[1]:+.9e}, "
        f"change {F[1] - F0[1]:+.3e}; conservation error " + ", ".join(
            f"{v:.2e}" for v in cons) + f"; peak {peak:.3f} GiB above "
        f"the {base:.3f} held before [{smi}]")
    if not np.isfinite(F).all():
        raise AssertionError("kinetic: the damping run is not finite")
    if peak > KIN_PEAK_GIB:
        raise AssertionError(f"kinetic: damping peak {peak:.1f} GiB")
    del m
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu = gates("kinetic_gates", KIN_PARTS, "cpu")
    log("kinetic", f"waited {time.perf_counter() - t0:.1f} s for the CPU side")
    kinetic_checks(gpu, cpu)
    return rows


# ---- phase 30: the phonon BTE and the mesh I/O (kinetic/phonon.py, io/*)
# the thick DSA case of tests/test_comet.py:110-156 at quad_2d(nx, 4): with
# the DSA at both sizes (ratio < 5e-7, T within 0.3 of the diffusion
# profile), without it at the larger (ratio > 1e-5); 20 inner trips, so
# each run's later residuals move with round-off (fvm_tpu's own by up to
# 9.1 relative under a 1e-15 change: scripts/roundoff_sensitivity.py
# --cases phonon), and cuda against cpu holds the first residual only.
# At nx 64 the JAX test's assertion is a plateau race in both packages (a
# 20-trip inner solve that finds nothing better than zero repeats its
# residual): over 24 changes of 1e-15 of the hot wall it holds in 23 in
# fvm_tpu and 21 in the port (scripts/phonon_scale.py), so the gate there
# holds the median ratio and T error over these changes
PH_THICK = {32: (0.0,), 64: (0.0, 1e-15, 2e-15, 3e-15, 4e-15)}
PH_THICK_PLAIN_RATIO = 1e-5
PH_NONGRAY = 16  # test_comet.py:73-104, COMET and Picard outers
PH_COMET_OUTERS = 4
PH_SWEEP_OUTERS = 12
PH_TWO_ZONE = 20  # the written two-zone case, split at x = 0.5
PH_TWO_ZONE_OUTERS = 8
PH_REFL = 0.5  # test_phonon_walls.py:34's slab, quad_2d(10, 10)
PH_SENS = (12, 3)  # test_comet.py:193-290's tangent and adjoint slab
PH_SENS_OUTERS = 10  # converged (relative 1e-12) by the third
PH_DUAL_TOL = 1e-8
# converged states cuda against cpu (fvm_tpu's own converged energies
# move by 3.4e-14 to 6.8e-12 under a 1e-15 change); the tangents and the
# adjoint solve to 1e-10
PH_GATE_RTOL = 1e-10
PH_SENS_RTOL = 1e-8
PH_CHUNK = (2, 4)  # (outerChunk, outers) of the replay against eager
PH_PARTS = ("thick", "rest")  # one CPU child each
# the thick gray slab at card size: the largest quad_2d(n, n) within
# KIN_PEAK_GIB, 2 COMET outers with the DSA (3 until phase 31 needed the
# time), a cost: from quad_2d(128,
# 128) its 20-trip inner solve finds nothing better than zero in both
# packages (scripts/phonon_scale.py --square).  Its peak above what was
# held before, one outer each: 0.886 GiB at quad_2d(256, 256), 4.256 at
# (512, 512), 16.856 at (1024, 1024), 33.644 at (1448, 1448), ~n^2: ~37.9
# here (scripts/phonon_peak.py; NVIDIA H100 80GB HBM3, 700.00 W).  The run
# holds quad_2d(1024, 1024) (1536 until the whole script's time limit
# needed its ~15 s of host set-up and outers)
PH_CARD_N = 1024
PH_CARD_OUTERS = 2
# the same slab where it converges: its inner solve allowed PH_CONV_INNER
# trips (70-146 a solve from quad_2d(64, 64) to (256, 256) on the CPU,
# where both packages converge: scripts/phonon_scale.py --square --inner
# 400), held to the JAX test's assertion (ratio < 5e-7, T within 0.3 K):
# 2 outers, 321 + 190 trips, 12.93 s at quad_2d(512, 512); quad_2d(1024,
# 1024) took 3 outers of 400 trips, 62.93 s (scripts/phonon_peak.py
# --inner 400 --outers 6; NVIDIA H100 80GB HBM3, 700.00 W).  The run holds
# quad_2d(256, 256), where the inner solve needs fewer trips (time)
PH_CONV_N = 256
PH_CONV_INNER = 400
# the I/O leg: the two-zone case at quad_2d(n, n) written as a binary f64
# case, read back, 2 COMET outers of its ballistic slab from the linear
# wall-to-wall temperature, the inner solve cut to PH_IO_INNER trips (of
# the case's 200): without the DSA its inner BiCGStab finds nothing better
# than zero at this size within 200 trips either (20.45 s for 2 outers,
# NVIDIA H100 80GB HBM3, 700.00 W), so the outers time its cost;
# quad_2d(1024, 1024) until the whole script's time limit needed the time
PH_IO_N = 512
PH_IO_OUTERS = 2
PH_IO_INNER = 20


def phonon_gates(device, parts=PH_PARTS):
    """Phase 30's small cases on ``device``, as plain numbers.  "thick":
    the thick slab at quad_2d(nx, 4) for nx in PH_THICK with the DSA, and
    the largest without; "rest": the two-band slab (COMET and Picard), a
    written two-zone Fluent case read back and run ballistic, the
    Reflecting walls, the full scattering matrix, and the sensitivities
    (``phonon_duality``)."""
    import tempfile

    from fvm_tpu_torch import cases
    from fvm_tpu_torch.kinetic import phonon as ph
    from fvm_tpu_torch.mesh.generate import quad_2d
    from scripts.fluent_case import two_zone_split, write_fluent_case

    out, t0 = {}, time.perf_counter()

    def took(what):
        nonlocal t0
        log("phonon", f"{what} on {device}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    def interior_T(m):
        return m.getTemperature().tolist()

    if "thick" in parts:
        th = {}
        for nx, changes in PH_THICK.items():
            for k, eps in enumerate(changes):
                m = cases.phonon_thick(nx, 4, dsa=True, device=device)
                m.bc["left"]["specifiedTemperature"] = \
                    cases.PHONON_T[0] * (1.0 + eps)
                h = [r[1] for r in m.advance(cases.PHONON_THICK_OUTERS)]
                th[f"dsa {nx} k {k}"] = {
                    "history": h, "ratio": h[-1] / h[0],
                    "err": cases.phonon_profile_error(m)}
        m = cases.phonon_thick(max(PH_THICK), 4, dsa=False, device=device)
        h = [r[1] for r in m.advance(cases.PHONON_THICK_OUTERS)]
        th["plain"] = {"history": h, "ratio": h[-1] / h[0]}
        out["thick"] = th
        took(f"the thick slab at quad_2d(nx, 4) for nx {list(PH_THICK)}, "
             f"{cases.PHONON_THICK_OUTERS} outers each")
    if "rest" not in parts:
        return out
    m = cases.phonon_nongray(PH_NONGRAY, device=device)
    h = [r[1] for r in m.advance(PH_COMET_OUTERS)]
    out["nongray"] = {"history": h, "T": interior_T(m)}
    m = cases.phonon_nongray(PH_NONGRAY, solver="sweep", device=device)
    h = [r[1] for r in m.advance(PH_SWEEP_OUTERS)]
    out["sweep"] = {"history": h, "T": interior_T(m)}
    took(f"the two-band slab, {PH_COMET_OUTERS} COMET and "
         f"{PH_SWEEP_OUTERS} Picard outers")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/two_zone.cas"
        mesh = quad_2d(PH_TWO_ZONE, PH_TWO_ZONE)
        write_fluent_case(path, mesh, "f64", zones=two_zone_split(mesh))
        m = cases.phonon_two_zone(path, device=device)
    h = [r[1] for r in m.advance(PH_TWO_ZONE_OUTERS)]
    out["two_zone"] = {
        "history": h, "T": interior_T(m),
        "left": m.left_cells.tolist(),
        "exact": cases.phonon_two_zone_exact(m),
        "q": {g: m.getHeatFluxIntegral(g) for g in (
            "left", "right", "top", "bottom", "mid:L", "mid:R")}}
    took("the two-zone Fluent case")
    m = cases.phonon_slab(10, 10, device, tau=0.05, wall="Reflecting",
                          refl=PH_REFL, options={"relativeTolerance": 1e-11})
    h = [r[1] for r in m.advance(6)]
    out["refl"] = {"history": h, "T": interior_T(m)}
    D = len(ph.sn_directions(4, 8)[1])
    M = ph.detailed_balance_correct(
        ph.rta_scattering_matrix(0.1, D=D)
        + 0.3 * np.random.default_rng(5).random((D, D)) / D,
        ph.sn_directions(4, 8)[1])
    m = cases.phonon_slab(10, 6, device, scattering_matrix=M, options={
        "relativeTolerance": 1e-10, "coarseAcceleration": False,
        "innerIterations": 400})
    h = [r[1] for r in m.advance(8)]
    out["scat"] = {"history": h, "T": interior_T(m),
                   "wM": float(np.abs(ph.sn_directions(4, 8)[1] @ M).max()),
                   "q": [m.getHeatFluxIntegral(g) for g in ("left",
                                                            "right")]}
    took("the Reflecting walls and the scattering matrix")
    out["sens"] = phonon_duality(device)
    took("the sensitivities (converge, two tangents, the adjoint)")
    return out


def phonon_duality(device):
    """test_comet.py:193-290's gray slab at PH_SENS (tau 0.15, 310 / 290)
    converged: the tangents in tau (seeded, per direction) and in the hot
    wall's temperature, the adjoint of J = sum(T x) in both, each pair
    <grad, dp> against dJ(tangent), the seconds and the trips."""
    import torch
    from fvm_tpu_torch import cases

    m = cases.phonon_slab(*PH_SENS, device, tau=0.15, T=(310.0, 290.0),
                          options={"relativeTolerance": 1e-12})
    m.advance(PH_SENS_OUTERS)
    ni = m.mesh.n_interior_cells
    dtau = np.random.default_rng(3).standard_normal(m.D * m.B)
    bc = "left:specifiedTemperature"
    t1 = time.perf_counter()
    tan = m.solve_tangent(param_tangents={"tau": dtau})
    tan_s = time.perf_counter() - t1
    tanb = m.solve_tangent(bc_tangents={bc: 1.0})
    xw = m.mesh.cell_centroid[:ni, 0]

    def J(ee):
        return torch.sum(m.temperature(ee) * xw)

    t1 = time.perf_counter()
    g = m.solve_adjoint(J, param_keys=("tau",), bc_keys=(bc,))
    adj_s = time.perf_counter() - t1
    e0 = m.state["e"][:ni]

    def dJ(de):
        return float(torch.func.jvp(J, (e0,), (torch.as_tensor(de).to(
            e0.device),))[1])

    pairs = ((float(np.dot(g["tau"], dtau)), dJ(tan)),
             (float(np.sum(g[bc])), dJ(tanb)))
    return {"tangent": tan.tolist(), "tangent_bc": tanb.tolist(),
            "adjoint": g["tau"].tolist(), "adjoint_bc": g[bc].tolist(),
            "pairs": pairs,
            "duality": max(abs(a - b) / abs(b) for a, b in pairs),
            "tan_s": tan_s, "adj_s": adj_s,
            "adj_its": int(m.adjoint_stats.iterations),
            "tan_its": int(m.tangent_stats.iterations)}


def phonon_checks(gpu, cpu):
    """Phase 30's gates: the JAX tests' assertions on each device, and cuda
    against cpu."""
    for dev, out in (("cuda", gpu), ("cpu", cpu)):
        th = out["thick"]
        log("phonon", f"thick on {dev}: " + "; ".join(
            f"{k} ratio {v['ratio']:.3e}" + (f", T err {v['err']:.4f}"
                                             if "err" in v else "")
            for k, v in th.items()))
        for nx, changes in PH_THICK.items():
            runs = [th[f"dsa {nx} k {k}"] for k in range(len(changes))]
            ratio = float(np.median([r["ratio"] for r in runs]))
            err = float(np.median([r["err"] for r in runs]))
            if not (ratio < 5e-7 and err < 0.3):
                raise AssertionError(f"phonon: the thick DSA assertion fails "
                                     f"at nx {nx} on {dev} (median ratio "
                                     f"{ratio:.3e}, T error {err:.4f})")
        if not th["plain"]["ratio"] > PH_THICK_PLAIN_RATIO:
            raise AssertionError(f"phonon: the plain thick run converged on "
                                 f"{dev}")
        rs = out["nongray"]["history"]
        rel = [r / rs[0] for r in rs]
        T = np.asarray(out["nongray"]["T"])
        if not (min(rel) < 1e-8 and next(
                i for i, r in enumerate(rel) if r < 1e-6) <= 3
                and 300.0 < T.min() < 302.5 and 307.5 < T.max() < 310.0):
            raise AssertionError(f"phonon: the two-band COMET assertion "
                                 f"fails on {dev}")
        hs = out["sweep"]["history"]
        if not all(r / hs[0] > 1e-6 for r in hs):
            raise AssertionError(f"phonon: the Picard run converged on {dev}")
        tz = out["two_zone"]
        T, left = np.asarray(tz["T"]), np.asarray(tz["left"])
        tL, tR = tz["exact"]
        q = tz["q"]
        err = max(np.abs(T[left] / tL - 1).max(),
                  np.abs(T[~left] / tR - 1).max())
        bal = abs(q["mid:L"] + q["mid:R"]) / abs(q["mid:L"])
        walls = abs(q["left"] + q["right"] + q["top"] + q["bottom"]) \
            / abs(q["left"])
        log("phonon", f"two-zone case on {dev}: theta_L, theta_R {tL}, {tR}"
            f" (DMM), max rel error {err:.2e}; interface flux balance "
            f"{bal:.2e}, walls {walls:.2e}; q " + ", ".join(
                f"{k} {v:+.9e}" for k, v in q.items()))
        if not (err < 1e-6 and bal < 1e-10 and walls < 1e-6):
            raise AssertionError(f"phonon: the two-zone closed form or flux "
                                 f"balance fails on {dev}")
        T = np.asarray(out["refl"]["T"])
        if not 300.0 - 1e-6 <= T.min() <= T.max() <= 310.0 + 1e-6:
            raise AssertionError(f"phonon: the Reflecting walls' T leaves "
                                 f"the walls' range on {dev}")
        sc = out["scat"]
        qL, qR = sc["q"]
        T = np.asarray(sc["T"])
        log("phonon", f"scattering matrix on {dev}: |w^T M| {sc['wM']:.2e},"
            f" ratio {sc['history'][-1] / sc['history'][0]:.2e}, energy "
            f"balance {abs(qL + qR) / abs(qL):.2e}")
        if not (sc["wM"] < 1e-14 and sc["history"][-1] < 1e-8
                * sc["history"][0] and abs(qL + qR) < 1e-9 * abs(qL)
                and 300.0 - 1e-6 <= T.min() <= T.max() <= 310.0 + 1e-6):
            raise AssertionError(f"phonon: the scattering matrix's energy "
                                 f"conservation fails on {dev}")
        s = out["sens"]
        log("phonon", f"sensitivities on {dev}: tangent {s['tan_s']:.2f} s "
            f"({s['tan_its']} trips), adjoint {s['adj_s']:.2f} s "
            f"({s['adj_its']} trips), duality {s['duality']:.3e}")
        if not s["duality"] <= PH_DUAL_TOL:
            raise AssertionError(f"phonon: the adjoint and the tangent "
                                 f"disagree on {dev}")
    check_gates("phonon", {"thick h0": [v["history"][0] for v in
                                        gpu["thick"].values()]},
                {"thick h0": [v["history"][0] for v in
                              cpu["thick"].values()]}, ("thick h0",),
                rtol=PH_GATE_RTOL)
    for k in ("nongray", "two_zone", "refl", "scat"):
        check_gates("phonon", {k: gpu[k]["T"]}, {k: cpu[k]["T"]}, (k,),
                    rtol=PH_GATE_RTOL)
    check_gates("phonon", gpu["sweep"], cpu["sweep"], ("history",),
                rtol=PH_GATE_RTOL)
    check_gates("phonon", gpu["sens"], cpu["sens"],
                ("tangent", "tangent_bc", "adjoint", "adjoint_bc"),
                rtol=PH_SENS_RTOL)


def phonon_chunk_check(device):
    """``chunk_check`` on test_chunked.py:143's slab."""
    from fvm_tpu_torch import cases

    chunk, outers = PH_CHUNK
    chunk_check("phonon", lambda ch: cases.phonon_slab(
        12, 3, device, T=(310.0, 290.0), n_polar=2, n_azimuthal=4, options={
            "outerChunk": ch, "relativeTolerance": 0.0,
            "absoluteTolerance": 0.0}), "e", chunk, outers,
        "quad_2d(12, 3) S_N(2, 4)")


def phonon_outer_parts(m):
    """``dsa_outer_parts`` of the gray phonon model at its state."""
    from fvm_tpu_torch.kinetic.esbgk import _KineticOperator

    mesh, params = m.mesh, m.params
    bc = m._resolve_bcvals()
    e = m._refresh_ghosts(mesh, params, m.state["e"], bc)
    V = mesh.cell_volume[:, None]
    rate = m._rate()
    op = _KineticOperator(mesh, params["dO"], params["dN"], V * rate)
    R_of = m._comet_R_of(mesh, params, bc)
    return dsa_outer_parts("phonon", m, e,
                           lambda ev: R_of(m._tau_db, {}, ev), op,
                           m._woodbury(op, V, rate))


def phonon_card(device, smi):
    """The thick gray slab at card size, a cost (returns its kernel rows);
    then at PH_CONV_N with PH_CONV_INNER inner trips, converged."""
    import torch
    from fvm_tpu_torch import cases

    def profile_error(m, hist):
        return (f" (ratio {hist[-1][1] / hist[0][1]:.3e}); T error to the "
                f"diffusion profile {cases.phonon_profile_error(m):.4f} K")

    n = PH_CARD_N
    rows = dsa_card_run(
        "phonon", device, smi,
        lambda: cases.phonon_thick(n, n, dsa=True, device=device), "e",
        PH_CARD_OUTERS, phonon_outer_parts,
        f"thick quad_2d({n}, {n}) float64, S_N(4, 8), DSA on",
        (" (phonon DSA, f64)", "phonon DSA fine level"), profile_error)

    n = PH_CONV_N
    t0 = time.perf_counter()
    m = cases.phonon_thick(n, n, dsa=True, device=device)
    m.options["innerIterations"] = PH_CONV_INNER
    m._drop_compiled()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = m.advance(cases.PHONON_THICK_OUTERS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ratio = hist[-1][1] / hist[0][1]
    err = cases.phonon_profile_error(m)
    log("phonon", f"thick quad_2d({n}, {n}), the inner solve allowed "
        f"{PH_CONV_INNER} trips: set up {setup_s:.2f} s; converged in "
        f"{len(hist)} COMET outers, {run_s:.2f} s ({list(hist.trips)} "
        f"trips); residuals " + ", ".join(f"{r[1]:.6e}" for r in hist)
        + f" (ratio {ratio:.3e}); T error to the diffusion profile "
        f"{err:.4f} K [{smi}]")
    if not (ratio < 5e-7 and err < 0.3):
        raise AssertionError(f"phonon: the thick slab at quad_2d({n}, {n}) "
                             f"did not converge (ratio {ratio:.3e}, T error "
                             f"{err:.4f})")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phonon_io(device, smi):
    """The I/O leg at card size: the two-zone case written as a binary f64
    Fluent case, read back (tables against the generated mesh's), the
    device mesh, PH_IO_OUTERS outers, the VTK and netCDF writers, the
    netCDF round trip and a checkpoint round trip."""
    import os
    import tempfile

    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch import io as fio
    from fvm_tpu_torch.kinetic import PhononModel
    from fvm_tpu_torch.mesh import mesh as mesh_mod
    from fvm_tpu_torch.mesh.generate import quad_2d
    from scripts.fluent_case import two_zone_split, write_fluent_case

    n = PH_IO_N
    secs = {}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/two_zone.cas"
        gen = quad_2d(n, n)
        t0 = time.perf_counter()
        write_fluent_case(path, gen, "f64", zones=two_zone_split(gen))
        secs["write case"] = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        host = fio.read_fluent_mesh(path)
        secs["read case"] = time.perf_counter() - t0
        same = (np.array_equal(host.coords, gen.coords)
                and np.array_equal(host.face_cells, gen.face_cells)
                and np.array_equal(host.face_nodes.row_ptr,
                                   gen.face_nodes.row_ptr)
                and np.array_equal(host.face_nodes.col, gen.face_nodes.col)
                and [(g.ident, g.name, g.group_type, g.offset, g.count)
                     for g in host.face_groups]
                == [(g.ident, g.name, g.group_type, g.offset, g.count)
                    for g in gen.face_groups]
                and [len(z[3]) for z in host.cell_zones] == [n * n // 2] * 2)
        log("phonon", f"two-zone case quad_2d({n}, {n}): binary f64 Fluent "
            f"case of {mb:.1f} MB written in {secs['write case']:.2f} s, "
            f"read in {secs['read case']:.2f} s ({mb / secs['read case']:.1f}"
            f" MB/s, host set-up); tables against the generated mesh's: "
            + ("bit for bit" if same else "DIFFER"))
        if not same:
            raise AssertionError("phonon: the read case's tables differ from "
                                 "the generated mesh's")
        del gen
        with stage_clock(secs, [
                (mesh_mod.Mesh, "make_interface", "make_interface"),
                (cases, "build_device_mesh", "device mesh (cuda)"),
                (PhononModel, "init", "model init")]):
            t0 = time.perf_counter()
            m = cases.phonon_two_zone(host, device=device, inner=PH_IO_INNER)
            torch.cuda.synchronize()
            secs["set up"] = time.perf_counter() - t0
        # from the linear profile between the walls (the case starts at
        # the reference temperature, where the energy density is zero)
        xc = m.mesh.cell_centroid[: host.n_interior_cells, 0].cpu().numpy()
        hot, cold = cases.PHONON_T
        m.vc["initialTemperature"] = hot - (hot - cold) * xc
        m.init()
        t0 = time.perf_counter()
        hist = m.advance(PH_IO_OUTERS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        T = m.getTemperature()
        q = {g: m.getHeatFluxIntegral(g) for g in ("mid:L", "mid:R")}
        log("phonon", f"two-zone slab on the card: set up " + ", ".join(
            f"{k} {secs[k]:.2f} s" for k in (
                "make_interface", "device mesh (cuda)", "model init",
                "set up")) + f"; {len(hist)} COMET outers from the linear "
            f"profile (cut from the case's convergence; the inner solve cut "
            f"to {PH_IO_INNER} of its 200 trips) in {run_s:.2f} s "
            f"({run_s / len(hist):.2f} s per outer, {sum(hist.trips)} "
            f"trips); residuals " + ", ".join(
                f"{r[1]:.6e}" for r in hist)
            + f"; T in [{T.min():.4f}, {T.max():.4f}]; interface flux "
            f"{q['mid:L']:+.6e} / {q['mid:R']:+.6e} [{smi}]")
        if not (np.isfinite(T).all() and 300.0 - 1e-6 <= T.min()
                and T.max() <= 310.0 + 1e-6):
            raise AssertionError("phonon: the card-size two-zone run left "
                                 "the walls' range")
        fields = {"T": m.temperature()[: host.n_interior_cells],
                  "q": m.heat_flux()}
        t0 = time.perf_counter()
        fio.write_vtk(f"{d}/two_zone.vtk", host, fields)
        secs["write_vtk"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fio.write_netcdf(f"{d}/two_zone.nc", host, fields)
        secs["write_netcdf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, got = fio.read_netcdf(f"{d}/two_zone.nc")
        secs["read_netcdf"] = time.perf_counter() - t0
        ok_nc = (np.array_equal(back.face_cells, host.face_cells)
                 and np.array_equal(got["T"], T)
                 and np.array_equal(got["q"], fields["q"]))
        state = {k: v.clone() for k, v in m.state.items()}
        t0 = time.perf_counter()
        ck = fio.Persistence(f"{d}/ckpt.npz", mode="w")
        ck.save_model("phonon", m)
        ck.close()
        secs["checkpoint save"] = time.perf_counter() - t0
        m.state = {k: torch.zeros_like(v) for k, v in m.state.items()}
        t0 = time.perf_counter()
        fio.Persistence(f"{d}/ckpt.npz").restore_model("phonon", m)
        torch.cuda.synchronize()
        secs["checkpoint restore"] = time.perf_counter() - t0
        ok_ck = all(torch.equal(m.state[k], v) for k, v in state.items())
        sizes = {k: os.path.getsize(f"{d}/{f}") / 1e6 for k, f in (
            ("vtk", "two_zone.vtk"), ("nc", "two_zone.nc"),
            ("npz", "ckpt.npz"))}
    log("phonon", "I/O at card size: " + ", ".join(
        f"{k} {secs[k]:.2f} s" for k in (
            "write_vtk", "write_netcdf", "read_netcdf", "checkpoint save",
            "checkpoint restore")) + " (files " + ", ".join(
        f"{k} {v:.1f} MB" for k, v in sizes.items()) + "); netCDF round "
        "trip " + ("bit for bit" if ok_nc else "DIFFERS") + "; checkpoint "
        "state " + ("bit for bit" if ok_ck else "DIFFERS"))
    if not (ok_nc and ok_ck):
        raise AssertionError("phonon: an I/O round trip differs")
    del m
    gc.collect()
    torch.cuda.empty_cache()


def phonon_phase(device, smi):
    """30 (module docstring); returns the DSA fine level's kernel rows."""
    gpu = gates("phonon_gates", PH_PARTS, device)
    phonon_chunk_check(device)
    rows = phonon_card(device, smi)
    phonon_io(device, smi)
    t0 = time.perf_counter()
    cpu = gates("phonon_gates", PH_PARTS, "cpu")
    log("phonon", f"waited {time.perf_counter() - t0:.1f} s for the CPU side")
    phonon_checks(gpu, cpu)
    return rows


# ---- phase 31: the immersed boundary's stencil rows, the material-point
# method, the FMG prolongation and the IB demos (geom/*, models/fmg.py,
# the cases of ROADMAP queue 1 item 9b)
# the flow cylinder (cases.ib_cylinder, a generated stand-in) at card size
# in float32: IB_TIMED outers eager, then the same as one graph replay
IB_N = 1024
IB_TIMED = 10
# the force balance on the fluid region (cases.ib_force_balance) after
# IB_FORCE[1] outers of the float64 cylinder at IB_FORCE[0]^2, replayed in
# chunks of IB_FORCE[2]: within IB_FORCE_RTOL of the boundary flux's scale
# (on the CPU: 8e-3 at 64^2 after 300 outers, 2e-3 after 400; 1e-3 at
# 48^2 after 600; 3e-4 at 24^2 after 250; on the card 2.2e-3 at 64^2
# after 400)
IB_FORCE = (48, 300, 100)
IB_FORCE_RTOL = 2e-2
# the thermal stencil case (cases.ib_hot_cylinder, tests/test_ibm.py:232)
# at card size in float64: converged in 2 outers, the constraint held
IB_HOT_N = 1024
IB_HOT_RATIO = 1e-8
IB_HOT_CONSTRAINT = 1e-6
# the MPM: the two-block collision (cases.mpm_block) on a 1024^2 grid, two
# 256 x 512-cell blocks (512^2 cells) at 4 particles a cell: 1,048,576
# particles, float64, MPM_SUBSTEPS substeps of MPM_DT a replay; its gate
# cuda against cpu at MPM_GATE_N^2 (P2G's index_add adds with atomics on
# the card), and two deterministic card runs bit for bit
MPM_CARD = (1024, (256, 512))
MPM_SUBSTEPS = 20
MPM_DT = 1.0e-4
MPM_GATE_N = 32
MPM_GATE_RTOL = 1e-12
# the prolongation from a 256^2 cavity after FMG_OUTERS replayed outers
# onto bench's 1024^2 cavity
FMG_N = (256, 1024)
FMG_OUTERS = 100
# the cantilever stand-in at the demo's own cell size, (steps, outers)
# (3 steps until phase 32 needed the time)
CANT_RUN = (2, 15)
# demos/adjoint_design.py: (n, iterations) (3 until phase 32 needed the
# time)
DESIGN_RUN = (128, 2)
# the IB kernels rows' tags
IB_ROW = " (IB-stencil level)"
IB_ROW64 = " (IB-stencil level, f64)"


def record_system(model, key):
    """The first (A, b) the model's ``key`` solver gets in one eager
    outer (the step rebuilt around a recording solve), A prepared."""
    solver = model.options[key]
    inner = solver.solve_fn
    got = []

    def solve_fn(A, b, x0):
        if not got:
            got.append((A, b))
        return inner(A, b, x0)

    solver.solve_fn = solve_fn
    model._drop_compiled()
    try:
        model.advance(1)
    finally:
        del solver.solve_fn
        model._drop_compiled()
    A, b = got[0]
    return A.prepare(), b


def widened_check(label, A, b, errors):
    """The widened level's fused op on the card: each variant against the
    plain version on the level's own coefficients, the stencil alone and
    with its fallback entries applied (deterministic: the fallback's
    index_add adds with atomics), (n,) and (n, 2), max abs error 0."""
    import torch
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops.dia import apply_fallback

    d = A.dia
    checks = 0
    for m in (1, 2):
        x = torch.linspace(-1.0, 1.0, A.n * m, dtype=A.diag.dtype,
                           device=A.diag.device).reshape(
                               (A.n,) if m == 1 else (A.n, m))
        bb = (b[:, :m].reshape(x.shape) if b.ndim == 2 else
              b if m == 1 else torch.stack([b, -b], 1)).contiguous()
        for mode in dk.MODES:
            omega = 0.7 if mode == "jacobi" else None
            bm = None if mode == "mv" else bb
            y_ref = dk.dia_stencil_plain(d.offsets, mode, A.dia_coef, A.diag,
                                         x, b=bm, omega=omega)
            for variant in dk.variants(A.diag.dtype):
                y = dk._launch(d.offsets, mode, A.dia_coef, A.diag, x, bm,
                               omega, variant=variant)
                with deterministic():
                    pair = [apply_fallback(t, mode, A.diag, x, omega,
                                           d.fb_rows, d.fb_cols,
                                           A.dia_fb_vals) for t in (y, y_ref)]
                torch.cuda.synchronize()
                for got, want in ((y, y_ref), pair):
                    err = float((got - want).abs().max())
                    if not (bool(torch.isfinite(got).all()) and err == 0.0):
                        raise AssertionError(
                            f"dia_stencil {variant} disagrees at {label}: "
                            f"m={m} {mode}: max abs err {err:.3e}")
                    key = (str(A.diag.dtype).split(".")[-1], variant, mode)
                    errors[key] = max(errors.get(key, 0.0), err)
                    checks += 1
    log("ib", f"{label}: n={A.n} offsets={tuple(d.offsets)} + "
        f"{int(d.fb_rows.shape[0])} fallback entries: {checks} checks on "
        f"its own coefficients (m x modes x variants x {{stencil, with "
        f"fallback}}), max abs err 0 ok")


def csr_with_fallback(A):
    """A widened DIA level (its coefficients and fallback entries) as one
    torch CSR tensor."""
    import torch

    d = A.dia
    base = csr_copy(d.offsets, A.dia_coef, A.diag).to_sparse_coo()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(
            torch.cat([base.indices(), torch.stack([d.fb_rows, d.fb_cols])],
                      1),
            torch.cat([base.values(), A.dia_fb_vals]), base.shape).coalesce()
        return coo.to_sparse_csr()


def widened_rows(tag, A, b, cases_, launches, errors):
    """The widened level's fused op (the kernel, then the fallback's
    scatter-add: what the solves run), its plain version and the library
    call on a CSR copy with the fallback entries, per (mode, m), beside
    the bound (the stencil's bytes and operations, plus the fallback
    entries' value, row and column read once, x gathered and y updated
    once each); the ``kernels`` rows of the modes in ``launches``."""
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops.dia import apply_fallback, fused_apply
    from fvm_tpu_torch.tools import kernel_bench as kb

    d, n = A.dia, A.n
    item = A.diag.element_size()
    nfb = int(d.fb_rows.shape[0])
    fb = dict(fb_rows=d.fb_rows, fb_cols=d.fb_cols, fb_vals=A.dia_fb_vals)
    dtype_name = str(A.diag.dtype).split(".")[-1]
    csr = csr_with_fallback(A)
    out = []
    for mode, m in cases_:
        omega = 0.7 if mode == "jacobi" else None
        sets = []
        for k in range(TIMING_COPIES):
            x, bb = kb.random_vectors(n, m, A.diag.dtype, A.diag.device,
                                      seed=50 + k)
            sets.append((x, None if mode == "mv" else bb))
        kern = [lambda s=s: fused_apply(d.offsets, A.diag, A.dia_coef, s[0],
                                        b=s[1], omega=omega, mode=mode, **fb)
                for s in sets]
        plain = [lambda s=s: apply_fallback(
            dk.dia_stencil_plain(d.offsets, mode, A.dia_coef, A.diag, s[0],
                                 b=s[1], omega=omega), mode, A.diag, s[0],
            omega, d.fb_rows, d.fb_cols, A.dia_fb_vals) for s in sets]
        b_ms, _, nbytes, nops = kb.bound(n, m, len(d.offsets), mode, item)
        nbytes += nfb * (item + 16 + 2 * m * item)
        nops += nfb * m * (2 + (2 if mode == "jacobi" else 0))
        bound_ms, bound_by = kb._limit(nbytes, nops)[:2]
        label = f"dia_stencil {mode}{tag} n={n} m={m} {dtype_name}"
        ms = replay_ms(kern, bound_ms, label)
        plain_ms = replay_ms(plain, bound_ms, f"plain {label}")
        library_ms = None
        if mode in LIBRARY_CALL:
            libs = [library_call(mode, csr, s[0], s[1]) for s in sets]
            got, want = libs[0](), plain[0]()
            err = float((got - want).abs().max()) / float(want.abs().max())
            if not err <= LIBRARY_RTOL[dtype_name]:
                raise AssertionError(f"{library_name(mode, m)} disagrees "
                                     f"with the plain {mode}{tag}: rel err "
                                     f"{err:.3e}")
            library_ms = replay_ms(libs, bound_ms, f"library {label}")
        log("timing", f"dia_stencil {mode}{tag} ({dk.dispatch(n, A.diag.dtype)}"
            f", kernel + fallback) n={n} m={m} D={len(d.offsets)} + {nfb} "
            f"fallback {dtype_name}: graph replay {ms:.5f} ms, bound "
            f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B; {nops} flop), "
            f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.5f} ms; "
            + ("library: none for jacobi (no single call)"
               if library_ms is None else
               f"{library_name(mode, m)} CSR {library_ms:.5f} ms"))
        if not launches.get(mode):
            log("timing", f"dia_stencil {mode}{tag}: not launched at this "
                f"level, so no kernels row")
            continue
        out.append({
            "name": f"dia_stencil.{mode}{tag}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[mode],
            "max_abs_err": max(v for (dt, _, md), v in errors.items()
                               if md == mode and dt == dtype_name),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
    return out


def launches_at(rows, tag):
    """dia_stencil launches since the last reset at ``rows`` rows of type
    ``tag``, by mode."""
    from fvm_tpu_torch.ops import dia_kernel as dk

    out = {m: 0 for m in dk.MODES}
    for (t, _, mode, n, _), v in dk.dia_stencil.shapes.items():
        if t == tag and n == rows:
            out[mode] += v
    return out


def by_level(per=1):
    """dia_stencil launches since the last reset by (type, mode, rows, D),
    divided by ``per``; and the gather-ELL products by (mode, rows)."""
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell

    agg = {}
    for (t, _, mode, n, D), v in dk.dia_stencil.shapes.items():
        agg[(t, mode, n, D)] = agg.get((t, mode, n, D), 0) + v
    parts = [f"{t} {mode} {n} rows D {D}: {v / per:g}"
             for (t, mode, n, D), v in sorted(agg.items(),
                                              key=lambda kv: -kv[0][2])]
    parts += [f"gather-ELL {mode} {n} rows: {v / per:g}"
              for (mode, n), v in sorted(ell.gather_ell_ops.items())]
    return "; ".join(parts)


def widened_levels(amg, ext):
    """The hierarchy ``amg`` holds for a widened pattern (``ext`` a model's
    ``_ib_ext``), as ``describe`` reads it: the condensed fine level, then
    each coarse level but the coarsest."""
    from fvm_tpu_torch.tools import kernel_bench as kb

    cols, mask, d = ext
    levels = amg.setup_structure(cols.cpu().numpy().T, mask.cpu().numpy().T,
                                 cols.device)
    fine = d if d is None or d.cond_plan is None else d.cond_plan.dia2
    out = [kb._shape(cols.shape[1], fine)]
    for lev in levels[:-1]:
        out.append(kb._shape(lev.nC, getattr(lev, "dia_c", None),
                             (lev.cols_c, lev.mask_c))
                   if hasattr(lev, "dia_c") else
                   kb.LevelShape(lev.nC, tuple(lev.coarse_offsets), 0))
    return out


def ib_flow_card(device, smi, errors):
    """31 (a) and (b): the 1024^2 float32 flow cylinder; returns its
    widened momentum level's kernels rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.geom import IBType
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell

    t0 = time.perf_counter()
    f = cases.ib_cylinder(IB_N, device=device, dtype="float32")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    cols, _, d = f._ib_ext
    n_ib = int(f.params["ibs_cells"].shape[0])
    log("ib", f"flow cylinder {IB_N}^2 float32 ({cases.IB_STANDIN}): set up "
        f"in {total:.2f} s host; of it IBManager.update "
        f"{f.ib_setup_s['update']:.3f} s, interpolation_stencil "
        f"{f.ib_setup_s['stencil']:.3f} s, set_immersed_boundary (the "
        f"widened pattern's DIA analysis and the AMG hierarchies) "
        f"{f.ib_setup_s['set_immersed_boundary']:.3f} s; {n_ib} IB cells, "
        f"{int((f.ibm.ib_type == IBType.SOLID).sum())} solid; widened "
        f"pattern "
        f"K {cols.shape[0]}: " + (
            "gather-ELL (too unstructured for DIA)" if d is None else
            f"DIA offsets {tuple(d.offsets)} + {int(d.fb_rows.shape[0])} "
            f"fallback entries (condensed: "
            f"{0 if d.cond_plan is None else int(d.cond_plan.dia2.fb_rows.shape[0])})"))
    pres = f.options["pressureLinearSolver"]
    log("ib", "the pressure AMG's hierarchy of the widened pattern (beside "
        "its structured one; the pressure matrix keeps the mesh's pattern, "
        "so no solve uses it): " + describe(widened_levels(pres, f._ib_ext)))
    # (b) first: the momentum system of one eager outer, against the plain
    # version on its own coefficients
    A, b = record_system(f, "momentumLinearSolver")
    if A.dia is None or A.off.shape[0] != f.mesh.cf_nbr.shape[0] + 4:
        raise AssertionError("the momentum matrix is not the widened one")
    widened_check(f"IB-stencil momentum level ({IB_N}^2 cylinder, f32)", A,
                  b, errors)
    # (a) IB_TIMED eager outers, then the same as one graph replay; the
    # momentum solve's launches (all at the widened level: its BiCGStab
    # has no preconditioner) counted in their own scope, apart from the
    # pressure AMG's at the same rows and offsets
    mom = f.options["momentumLinearSolver"]
    solve = mom.solve_fn

    def scoped(A_, b_, x0):
        with dk.launch_scope("momentum"):
            return solve(A_, b_, x0)

    mom.solve_fn = scoped
    f._drop_compiled()
    f.options["residualSync"] = False
    f.advance(1)
    torch.cuda.synchronize()
    snap = {k: v.clone() for k, v in f.state.items()}
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    t0 = time.perf_counter()
    h = f.advance(IB_TIMED)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / IB_TIMED
    hist = np.array([[float(a), float(c)] for _, a, c in h])
    fine = {m: dk.dia_stencil.scoped.get(("momentum", m), 0)
            for m in dk.MODES}
    levels = by_level(IB_TIMED)
    del mom.solve_fn
    f._drop_compiled()
    if not fine.get("mv"):
        raise AssertionError("dia_stencil was not launched at the widened "
                             "momentum level")
    log("ib", f"{IB_TIMED} eager outers: {eager_ms:.3f} ms per outer "
        f"({IB_N * IB_N / eager_ms * 1e3:.4g} cells/s); the momentum "
        f"solve's launches at the widened level per outer: "
        + ", ".join(f"{m} {v / IB_TIMED:g}" for m, v in fine.items())
        + f"; all dia_stencil launches per outer by (type, mode, level; "
        f"the pressure AMG's fine level has the same rows): {levels}")
    # the replay against the eager loop from the same state, both under
    # deterministic algorithms (the fallback's and the condensation's
    # index_add add with atomics otherwise: two such runs differed by up
    # to 3.7e-6 relative), bit for bit
    f.options.update(momentumTolerance=0.0, continuityTolerance=0.0,
                     absoluteTolerance=0.0)
    with deterministic():
        f.state = {k: v.clone() for k, v in snap.items()}
        h_det = np.array([[float(a), float(c)]
                          for _, a, c in f.advance(IB_TIMED)])
        f.options.update(outerChunk=IB_TIMED, residualSync=True)
        f.state = {k: v.clone() for k, v in snap.items()}
        hr_det = np.array([r[1:] for r in f.advance(IB_TIMED)], float)
    if not np.array_equal(hr_det, h_det):
        raise AssertionError(f"IB cylinder replay differs from the eager "
                             f"loop under deterministic algorithms: "
                             f"{hr_det.tolist()} vs {h_det.tolist()}")
    # the timed replays capture anew, without deterministic algorithms
    f._drop_compiled()
    f.state = {k: v.clone() for k, v in snap.items()}
    t0 = time.perf_counter()
    hr = f.advance(IB_TIMED)
    capture_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(np.array([r[1:] for r in hr]) - hist)
                       / np.abs(hist)))
    runner = f._runners[("chunk", IB_TIMED)]
    f.state = {k: v.clone() for k, v in snap.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f.advance(IB_TIMED)
    torch.cuda.synchronize()
    replay_outer = 1e3 * (time.perf_counter() - t0) / IB_TIMED
    log("ib", f"the same {IB_TIMED} outers as one graph replay: capture and "
        f"first replay {capture_s:.2f} s; {replay_outer:.3f} ms per outer "
        f"({IB_N * IB_N / replay_outer * 1e3:.4g} cells/s); residuals "
        f"equal to the eager loop's bit for bit under deterministic "
        f"algorithms; without them within {rel:.3e} of the eager loop's "
        f"(atomics, ungated); launches per outer from the capture: "
        f"{per_outer(runner.captured, IB_TIMED)}")
    f.state = {k: v.clone() for k, v in snap.items()}
    profile_run("ib", f"one replay of {IB_TIMED} outers",
                lambda: f.advance(IB_TIMED), replay_outer * IB_TIMED)
    F_body, F_bdry = cases.ib_force_balance(f)
    log("ib", f"after {2 + 3 * IB_TIMED} outers (not converged; ungated): "
        f"fluid-region body force {F_body.tolist()}, boundary flux "
        f"{F_bdry.tolist()}, solid-face getIBForceIntegral "
        f"{f.getIBForceIntegral().tolist()}")
    rows = widened_rows(IB_ROW, A, b, (("mv", 2), ("residual", 1),
                                       ("jacobi", 1)), fine, errors)
    # the later parts reuse its host mesh and geometry and its device mesh
    meshes = (f.ibm.mesh, f.ibm.geom, f.mesh)
    del f, A, b, snap, runner
    gc.collect()
    torch.cuda.empty_cache()
    return rows, meshes


def ib_force_gate(device):
    """31 (a): the force balance on the converged float64 cylinder."""
    import torch
    from fvm_tpu_torch import cases

    n, outers, chunk = IB_FORCE
    f = cases.ib_cylinder(n, device=device, dtype="float64")
    f.options["outerChunk"] = chunk
    for k in ("momentumTolerance", "continuityTolerance",
              "absoluteTolerance"):
        f.options[k] = 0.0
    t0 = time.perf_counter()
    h = f.advance(outers)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    F_body, F_bdry = cases.ib_force_balance(f)
    scale = float(np.abs(F_bdry).max())
    err = float(np.abs(F_body + F_bdry).max()) / scale
    log("ib", f"force balance, {n}^2 float64 cylinder after {outers} outers "
        f"({secs:.2f} s, replays of {chunk}; momentum residual "
        f"{h[-1][1] / h[0][1]:.3e} of the first): fluid-region body force "
        f"{F_body.tolist()} against minus the boundary momentum flux "
        f"{(-F_bdry).tolist()}: {err:.3e} of its scale (need < "
        f"{IB_FORCE_RTOL:g}); the solid-face getIBForceIntegral "
        f"{f.getIBForceIntegral().tolist()} (O(h) off: the band's rows are "
        f"constraints, not momentum balances)")
    if not err < IB_FORCE_RTOL:
        raise AssertionError(f"IB force balance off by {err:.3e}")


def ib_hot_card(device, errors, mesh, geom):
    """31 (c): the thermal stencil case at card size in float64 on the
    host ``mesh`` and ``geom`` of (a); returns its widened level's
    kernels rows."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.ops import ell

    t0 = time.perf_counter()
    t = cases.ib_hot_cylinder(IB_HOT_N, device=device, mesh=mesh, geom=geom)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    amg = t.options["linearSolver"].preconditioner
    log("ib", f"hot cylinder {IB_HOT_N}^2 float64 set up in {setup:.2f} s "
        f"host; the BiCGStab's AMG hierarchy of the widened pattern: "
        + describe(widened_levels(amg, t._ib_ext)))
    dk.reset_launches()
    ell.gather_ell_ops.clear()
    t0 = time.perf_counter()
    h = t.advance(2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ratio = h[-1][1] / h[0][1]
    cons = cases.stencil_constraint_error(t)
    n = t.mesh.n_cells
    fine = launches_at(n, dk.type_tag(torch.float64))
    log("ib", f"hot cylinder: 2 outers in {secs:.2f} s, residuals "
        f"{[r[1] for r in h]} (ratio {ratio:.3e}, need < {IB_HOT_RATIO:g}), "
        f"stencil constraint max |T_IB - interp| {cons:.3e} K (need < "
        f"{IB_HOT_CONSTRAINT:g}); dia_stencil launches by (type, mode, "
        f"level), gather-ELL products: {by_level()}")
    if not (ratio < IB_HOT_RATIO and cons < IB_HOT_CONSTRAINT):
        raise AssertionError("the hot cylinder did not converge in 2 outers")
    A, r = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    A = A.prepare()
    widened_check(f"IB-stencil thermal level ({IB_HOT_N}^2 hot cylinder, "
                  f"f64)", A, r, errors)
    rows = widened_rows(IB_ROW64, A, r, (("mv", 1), ("residual", 1),
                                         ("jacobi", 1)), fine, errors)
    del t, A, r
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def mpm_gate(device, n=MPM_GATE_N):
    """The MPM gate's side on ``device``: x, v, F, C after MPM_SUBSTEPS
    substeps of the two-block collision at n^2, float64."""
    from fvm_tpu_torch import cases

    s = cases.mpm_block(n, device=device, dtype="float64")
    s.advance(MPM_DT * MPM_SUBSTEPS * (1024 // n), substeps=MPM_SUBSTEPS)
    return {k: s.state[k].cpu().numpy() for k in ("x", "v", "F", "C")}


def mpm_card(device):
    """31 (d): the MPM gate and the 1,048,576-particle collision."""
    import torch
    from fvm_tpu_torch import cases

    gpu, cpu = mpm_gate(device), mpm_gate("cpu")
    vs = float(np.abs(cpu["v"]).max())
    errs = {k: float(np.abs(gpu[k] - cpu[k]).max()) / sc for k, sc in (
        ("x", 1.0), ("v", vs), ("F", 1.0), ("C", MPM_GATE_N * vs))}
    with deterministic():
        a, b = mpm_gate(device), mpm_gate(device)
    same = all(np.array_equal(a[k], b[k]) for k in a)
    log("mpm", f"gate {MPM_GATE_N}^2, {MPM_SUBSTEPS} substeps, float64: "
        f"cuda (a graph replay) against cpu, max err over scale "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (need <= {MPM_GATE_RTOL:g}); two deterministic card runs bit "
        f"for bit: {same}")
    if not (max(errs.values()) <= MPM_GATE_RTOL and same):
        raise AssertionError("the MPM gate failed")
    n, block = MPM_CARD
    t0 = time.perf_counter()
    s = cases.mpm_block(n, device=device, dtype="float64", block=block)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    p0 = s.momentum()
    scale = float(s.state["m"].sum()) * 0.5
    dt = MPM_DT * MPM_SUBSTEPS
    t0 = time.perf_counter()
    s.advance(dt, substeps=MPM_SUBSTEPS)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.advance(dt, substeps=MPM_SUBSTEPS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / MPM_SUBSTEPS
    p1 = s.momentum()
    err = float(np.abs(p1 - p0).max()) / scale
    npart = int(s.state["x"].shape[0])
    log("mpm", f"{npart} particles on a {n}^2 grid (blocks {block}, 4 a "
        f"cell), float64: seeded in {setup:.2f} s; capture and first "
        f"replay of {MPM_SUBSTEPS} substeps {first:.2f} s; {ms:.3f} ms per "
        f"substep replayed ({npart / ms * 1e3:.4g} particle-substeps/s); "
        f"momentum {p0.tolist()} -> {p1.tolist()}, change {err:.3e} of "
        f"sum(m)/2 (need < 1e-8, tests/test_mpm.py:41); F off I by "
        f"{float((s.state['F'] - torch.eye(2, device=device, dtype=torch.float64)).abs().max()):.3e}")
    if not err < 1e-8:
        raise AssertionError("the MPM momentum moved")
    profile_run("mpm", f"one replay of {MPM_SUBSTEPS} substeps",
                lambda: s.advance(dt, substeps=MPM_SUBSTEPS),
                ms * MPM_SUBSTEPS)
    del s
    gc.collect()
    torch.cuda.empty_cache()


def bench_flow(dmesh):
    """The flow half of bench's cavity (``cases.cavity_models``' flow) on
    a quad device mesh."""
    from fvm_tpu_torch.linear import AMG, BiCGStab
    from fvm_tpu_torch.models import FlowModel

    f = FlowModel(dmesh)
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.options["pressureLinearSolver"] = AMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    f.options["momentumLinearSolver"] = BiCGStab(relative_tolerance=1e-2,
                                                 max_iterations=10)
    f.init()
    return f


def other_paths(device, fine_mesh):
    """31 (e): the prolongation onto ``fine_mesh`` (the 1024^2 float32
    device mesh of (a)), the cantilever and the adjoint design."""
    import torch
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models.fmg import prolong_flow_state

    nc, nf = FMG_N
    if fine_mesh.n_interior_cells != nf * nf:
        raise AssertionError("the fine mesh is not the 1024^2 quad mesh")
    coarse = bench_flow(build_device_mesh(quad_2d(nc, nc), dtype="float32",
                                          device=device))
    coarse.options["outerChunk"] = FMG_OUTERS
    coarse.advance(FMG_OUTERS)
    fine = bench_flow(fine_mesh)
    cold = {k: v.clone() for k, v in fine.state.items()}
    hc = fine.advance(1)  # from the cold start
    fine.state = cold
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prolong_flow_state(coarse, fine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hw = fine.advance(1)
    log("fmg", f"prolong_flow_state {nc}^2 (after {FMG_OUTERS} outers) -> "
        f"{nf}^2 float32: {secs:.2f} s host; the fine model's first "
        f"residuals (momentum, continuity) warm {hw[0][1:]} against cold "
        f"{hc[0][1:]}")
    if not hw[0][1] < hc[0][1]:
        raise AssertionError("the warm start did not lower the residual")
    del coarse, fine
    gc.collect()
    torch.cuda.empty_cache()
    # the unsteady IB cantilever on its stand-in
    steps, outers = CANT_RUN
    t0 = time.perf_counter()
    f, solid, _ = cases.ibm_cantilever(device=device)
    for key in ("momentumLinearSolver", "pressureLinearSolver"):
        f.options[key].exit_every = 10
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = cases.cantilever_unsteady(f, solid, steps, outers)
    secs = time.perf_counter() - t0
    log("demos", f"ibm_cantilever ({cases.CANT_STANDIN}; "
        f"{f.mesh.n_interior_cells} cells, {int(solid.sum())} marked): set up "
        f"{setup:.2f} s, {steps} steps of {outers} outers in {secs:.2f} s "
        f"({secs / steps:.3f} s a step); (t, v, Fx, Fy) {hist.tolist()}")
    if not (hist[0, 1] > 0 and hist[0, 3] < 0):
        raise AssertionError("the cantilever's force does not oppose its "
                             "motion")
    del f
    # the adjoint design loop
    n, iters = DESIGN_RUN
    t0 = time.perf_counter()
    out = cases.adjoint_design(n, iters, device=device)
    secs = time.perf_counter() - t0
    log("demos", f"adjoint_design at {n}^2 float64, {iters} iterations in "
        f"{secs:.2f} s: hot-wall flux J {out['J'].tolist()} (uniform k: "
        f"100), k in [{out['k'].min():.3f}, {out['k'].max():.3f}], mean "
        f"{out['k'].mean():.6f}")
    if not (np.all(np.diff(out["J"]) < 0) and out["J"][-1] < 100.0):
        raise AssertionError("the adjoint design did not lower the flux")


def ib_phase(device, smi):
    """31 (module docstring); returns the widened levels' kernels rows."""
    errors = {}
    t0 = time.perf_counter()
    rows, (mesh, geom, dmesh) = ib_flow_card(device, smi, errors)
    log("ib", f"(a, b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ib_force_gate(device)
    log("ib", f"force gate in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += ib_hot_card(device, errors, mesh, geom)
    del mesh, geom
    log("ib", f"(c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mpm_card(device)
    log("ib", f"(d) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    other_paths(device, dmesh)
    log("ib", f"(e) in {time.perf_counter() - t0:.1f} s; {smi}")
    return rows


# ---- 32. the distributed runtime ------------------------------------------

# 4 gloo ranks on the one card (NCCL refuses two ranks on one GPU) and a
# one-rank NCCL world; each world is fresh rank processes
# (``parallel.run_ranks``) that load the kernels phase 2 built
DIST_RANKS = 4
DIST_TIMEOUT = 400.0  # s, each world: a hang fails the phase
# the sharded golden held at 1e-8 (``python3 -m scripts.roundoff_sensitivity
# --cases goldens_dist``: fvm_tpu's own cavity/JACOBI/np4 moves 5.0e-15
# under a 1e-15 change; cavity/AMG/np4 7.5e-8, so it is not held here;
# cavity/CG/np4, 2.9e-13, is held by the CPU tests)
DIST_GOLDENS = ("JACOBI",)
DIST_GOLDEN_RTOL = 1e-8
DIST_SLICE = (64, 5)  # the 4-rank float64 coupled cavity: card against cpu
DIST_MAIN = (1024, 1, 3)  # the float32 coupled cavity: n, warm-up, timed
GOLDENS = "tests/goldens/histories.json"


def _dist_levels(main):
    """Per-level lines of the timed run: ``dia_stencil`` launches per
    outer summed over the ranks, by (type/variant/mode) at each level's
    rows, and the gather-ELL products."""
    levels = main[0]["main/levels"]
    out = []
    for lvl, n, D, _ in levels:
        per = {}
        for r in main:
            for k, v in zip(r["main/launch_keys"], r["main/launches"]):
                tag, variant, mode, rows_k, _ = str(k).split("/")
                if int(rows_k) == int(n):
                    key = f"{variant}/{mode}"
                    per[key] = per.get(key, 0.0) + float(v)
        out.append(f"L{int(lvl)} {int(n)} rows DIA D={int(D)}: " + ", ".join(
            f"{k} {v:g}" for k, v in sorted(per.items())))
    gathers = {}
    for r in main:
        for k, v in zip(r["main/gather_keys"], r["main/gathers"]):
            gathers[str(k)] = gathers.get(str(k), 0.0) + float(v)
    out.append("gather-ELL (the Krylov products on the halo'd local "
               "matrices): " + ", ".join(f"{k} {v:g}" for k, v in
                                          sorted(gathers.items())))
    return out


def dist_phase(device, smi):
    """Phase 32: the distributed runtime on the card; returns the
    ``kernels`` rows of ``dia_stencil`` at the shard fine level."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk
    from fvm_tpu_torch.parallel import run_ranks

    t_phase = time.time()
    n_s, steps_s = DIST_SLICE
    slice_kw = dict(n=n_s, steps=steps_s, dtype="float64")
    n_m, warm_m, timed_m = DIST_MAIN
    # every world starts at once; the card's 4-rank world waits, before
    # its second probe and the timed 1024^2 cavity, for the sign that the
    # other worlds and the one-device run have ended, so those run alone
    # on the card
    sign = tempfile.mkdtemp(prefix="fvm_dist_")
    go = os.path.join(sign, "alone")
    with ThreadPoolExecutor(4) as ex:
        t0 = time.time()
        card = ex.submit(run_ranks, "dist_suite_rank", DIST_RANKS, {
            "cases": [("probe", "dist_probe_rank", {})]
            + [(f, "dist_cavity_rank", {"solver": f}) for f in DIST_GOLDENS]
            + [("slice", "dist_coupled_rank", slice_kw),
               ("dryrun", "dist_cavity_rank", cases.dryrun_case()),
               ("alone", "dist_wait_rank", {"path": go}),
               ("probe2", "dist_probe_rank", {}),
               ("main", "dist_timed_rank", dict(
                   n=n_m, warm=warm_m, timed=timed_m, dtype="float32"))]},
            device="cuda", backend="gloo", timeout=DIST_TIMEOUT)
        try:
            # the CPU side of the card-against-cpu history
            cpu_slice = ex.submit(run_ranks, "dist_coupled_rank", DIST_RANKS,
                                  slice_kw, device="cpu", backend="gloo",
                                  timeout=DIST_TIMEOUT)
            # one rank: NCCL against gloo, bit for bit under deterministic
            # algorithms (the NCCL wiring; two ranks on one GPU it refuses)
            one = {b: ex.submit(run_ranks, "dist_coupled_rank", 1, dict(
                slice_kw, deterministic=True), device="cuda", backend=b,
                timeout=DIST_TIMEOUT) for b in ("nccl", "gloo")}
            single = cases.dist_dryrun_single(64, device)
            single_s = time.time() - t0
            one = {b: f.result()[0] for b, f in one.items()}
            cpu = cpu_slice.result()
            side_s = time.time() - t0
        finally:
            open(go, "w").close()
        res = card.result()
        card_s = time.time() - t0
    shutil.rmtree(sign)
    r0 = res[0]
    log("dist", f"{DIST_RANKS} gloo ranks on {smi}: the card's world "
        f"{card_s:.1f} s (start, probe, golden, slice, dryrun, the "
        f"{n_m}^2 cavity); beside it, the one-device dryrun {single_s:.1f} "
        f"s, and the cpu world and the one-rank NCCL and gloo worlds done "
        f"at {side_s:.1f} s; the card's world then waited "
        f"{float(r0['alone/waited_s']):.1f} s (rank 0) to run alone")
    log("dist", "every collective (all_to_all, all_gather, all_reduce) took "
        "CUDA tensors on gloo and gave its exact result on the card")
    log("dist", f"ms per call (rank 0, {cases.PROBE_CALLS} calls of a "
        f"{2 * DIST_RANKS}-element float64 tensor) at the world's start, "
        "beside the other worlds: " + "; ".join(
            f"{k[len('probe/'):]} {float(v):.3f}" for k, v in r0.items()
            if k.startswith("probe/") and k != "probe/seconds")
        + " | alone, before the timed outers: " + "; ".join(
            f"{k[len('probe2/'):]} {float(v):.3f}" for k, v in r0.items()
            if k.startswith("probe2/") and k != "probe2/seconds"))
    log("dist", "seconds per case in the card's world (rank 0): " + ", ".join(
        f"{k[:-len('/seconds')]} {float(v):.1f}" for k, v in r0.items()
        if k.endswith("/seconds")))
    with open(GOLDENS) as f:
        goldens = json.load(f)
    for fam in DIST_GOLDENS:
        ref = np.array(goldens[f"cavity/{fam}/np4"])
        got = r0[f"{fam}/hist"]
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        log("dist", f"cavity/{fam}/np4 golden, 30 outers on {DIST_RANKS} "
            f"ranks: max rel diff {rel:.3e} (tol {DIST_GOLDEN_RTOL:g})")
        if not (got.shape == ref.shape and rel <= DIST_GOLDEN_RTOL):
            raise AssertionError(f"dist: cavity/{fam}/np4 disagrees")
    dry = cases.dryrun_compare({k[len("dryrun/"):]: v for k, v in
                                r0.items() if k.startswith("dryrun/")},
                               single)
    log("dist", "dryrun_multichip section 1 (64^2, 40 outers, tight inner "
        f"solves), 4 ranks against one device, both on the card: rel "
        f"residual {dry['rel_dist']:.3e} / {dry['rel_single']:.3e} (< "
        f"1.5e-2), history deviation {dry['hist_dev']:.3e} (< 1e-3), "
        f"velocity deviation {dry['v_dev']:.3e} (< 1e-5) ok")
    h_card, h_cpu = r0["slice/res"].tolist(), cpu[0]["res"].tolist()
    worst = max_rel(h_card, h_cpu)
    log("dist", f"{n_s}^2 float64 coupled cavity, {steps_s} steps on "
        f"{DIST_RANKS} ranks: card {h_card[-1]} vs cpu {h_cpu[-1]}; max rel "
        f"diff {worst:.3e} (tol {SLICE_RTOL:g})")
    if not worst <= SLICE_RTOL:
        raise AssertionError("dist: card and cpu worlds disagree")
    same = one["nccl"]["res"].tolist() == one["gloo"]["res"].tolist()
    log("dist", f"one rank, {n_s}^2 float64, {steps_s} steps, deterministic: "
        f"NCCL {'bit-identical to' if same else 'DIFFERS from'} gloo "
        f"({one['nccl']['res'][-1].tolist()})")
    if not same:
        raise AssertionError("dist: the NCCL world differs from gloo's")

    # the timed float32 cavity: per rank and summed
    main = [{k: v for k, v in r.items() if k.startswith("main/")}
            for r in res]
    stats = np.array([r["main/stats"] for r in main])
    share = [float(r["main/stats"][4]) / (float(r["main/ms"]) / 1e3)
             for r in main]
    levels = main[0]["main/levels"]
    errs = [float(row[3]) for r in main for row in r["main/levels"]]

    def each(key, fmt):
        return ", ".join(format(float(r[key]), fmt) for r in main)

    log("dist", f"{n_m}^2 float32 coupled cavity on {DIST_RANKS} gloo ranks "
        f"({smi}): host set-up per rank {each('main/setup_s', '.2f')} s; "
        f"{timed_m} timed outers after {warm_m}: ms per outer by rank "
        f"{each('main/ms', '.1f')}; per outer and rank {stats[0, 0]:g} "
        f"all_to_all, {stats[0, 1]:g} all_reduce; "
        f"{stats[:, 3].sum() / 1e6:.3f} MB sent per outer over all ranks; "
        f"share of the outer inside collectives (host timers, after a "
        f"device wait) "
        + ", ".join(f"{100 * v:.1f}%" for v in share)
        + f"; peak memory per rank {each('main/peak_gib', '.2f')} GiB; "
        f"residuals {main[0]['main/res'][-1].tolist()}")
    for line in _dist_levels(res):
        log("dist", "launches per outer, all ranks: " + line)
    log("dist", f"every rank's shard hierarchy ({len(levels)} DIA levels, "
        f"rows {[int(v) for v in levels[:, 1]]}): every variant and mode "
        f"against the plain version on the level's own operator, max abs "
        f"err {max(errs):g} (need 0)")
    if max(errs) != 0.0:
        raise AssertionError("dist: dia_stencil disagrees at a shard level")
    launches = {m: 0 for m in dk.MODES}
    for r in main:
        for k, v in zip(r["main/launch_keys"], r["main/launches"]):
            launches[str(k).split("/")[2]] += float(v) * timed_m
    for mode in ("residual", "jacobi"):
        if not launches[mode]:
            raise AssertionError(f"dist: dia_stencil {mode} never launched "
                                 f"on the ranks' shard levels")
    # the kernel at the shard fine level, in this process alone on one
    # rank's operator shape (not under four contending ranks)
    n_f, offs = int(levels[0, 1]), tuple(int(v) for v in
                                         main[0]["main/level_offsets"])
    errors = {}
    kernel_vs_plain(f"{n_m}^2 shard fine level (of {DIST_RANKS})", n_f, offs,
                    device, errors, dtypes=("float32", "float64"))
    rows = time_modes(f" (dist shard of {DIST_RANKS})", n_f, offs,
                      (("residual", 1), ("jacobi", 1)),
                      {m: int(v) for m, v in launches.items()}, errors,
                      "float32")
    log("dist", f"phase 32 in {time.time() - t_phase:.1f} s")
    return rows


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
    clock = {"t": t_start}

    def done(label):
        log("done", f"phase {label} in {time.time() - clock['t']:.1f} s")
        clock["t"] = time.time()

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

    done("1")

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

    done("2")

    # ---- 3. kernel vs plain on the card -----------------------------------
    # phase 13's CPU side starts here, beside phases 3-12 (started with
    # phase 12, phase 13 waited 19-27 s for it)
    start_early(early_cpu_sides("13"))
    # the main path's case, one warm-up step to build its AMG hierarchies
    t0 = time.time()
    flow, thermal = cavity_models(main_mesh(device))
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

    done("3")

    # ---- 4. slice on the card vs slice on the CPU --------------------------
    launches64, fine64 = slice_phase("slice", coupled_cavity, SLICE_N,
                                     f"{SLICE_N}^2", device)
    kernel_vs_plain(f"{SLICE_N}^2 slice fine level", fine64.rows,
                    fine64.offsets, device, errors, dtypes=("float64",))

    done("4")

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

    done("5")

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

    done("6")

    # ---- 7. the 3D slice on the card vs on the CPU -------------------------
    slice_phase("slice3d", coupled_cavity_3d, SLICE3D_N, f"{SLICE3D_N}^3",
                device, exact=deterministic)

    done("7")

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

    done("8")

    # ---- 9. kernel vs plain at the 3D hierarchy's DIA levels --------------
    errors3 = {}
    for lvl, s in enumerate(shapes3):
        if s.offsets is not None:
            kernel_vs_plain(f"3D level {lvl}", s.rows, s.offsets, device,
                            errors3, nrhs=(1, 3), dia=s.dia)

    done("9")

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

    done("10")

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

    done("11")

    # ---- 12. the cavity path's options -------------------------------------
    start_early(early_cpu_sides("18-22"))
    options_phase(device)
    kernels += bf16_main_phase(device, n_main, main_offsets, errors)

    done("12")

    # ---- 13. the Newton endgame, cuda against cpu ---------------------------
    newton_phase(device)

    done("13")

    # ---- 14. time to a converged residual at 1024^2 -------------------------
    start_early(early_cpu_sides("23-28"))
    kernels += converge_phase(device, kernels)

    done("14")

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

    done("15-17")

    # ---- 18-20. the linear extras and the boundary physics ---------------
    t18 = time.time()
    kernels.extend(extras_phases(device, smi))
    log("done", f"phases 18-20 in {time.time() - t18:.1f} s")

    # ---- 21-22. the sensitivities ---------------------------------------
    t21 = time.time()
    kernels.extend(extras_phases(device, smi, (21, 22), cavity_state))
    log("done", f"phases 21-22 in {time.time() - t21:.1f} s")

    # ---- 23-25. the structures and MEMS family ---------------------------
    t23 = time.time()
    kernels.extend(extras_phases(device, smi, (23, 24, 25)))
    log("done", f"phases 23-25 in {time.time() - t23:.1f} s")

    # ---- 26-28. the remaining models -------------------------------------
    start_early(early_cpu_sides("29"))
    t26 = time.time()
    kernels.extend(extras_phases(device, smi, (26, 27, 28)))
    log("done", f"phases 26-28 in {time.time() - t26:.1f} s")

    # ---- 29. the ES-BGK kinetic solver -----------------------------------
    start_early(early_cpu_sides("30"))
    t29 = time.time()
    kernels.extend(extras_phases(device, smi, (29,)))
    log("done", f"phase 29 in {time.time() - t29:.1f} s")

    # ---- 30. the phonon BTE and the mesh I/O -----------------------------
    t30 = time.time()
    kernels.extend(extras_phases(device, smi, (30,)))
    log("done", f"phase 30 in {time.time() - t30:.1f} s")

    # ---- 31. the immersed boundary's stencil rows, MPM, FMG, IB demos -----
    t31 = time.time()
    kernels.extend(extras_phases(device, smi, (31,)))
    log("done", f"phase 31 in {time.time() - t31:.1f} s")

    # ---- 32. the distributed runtime --------------------------------------
    t32 = time.time()
    kernels.extend(extras_phases(device, smi, (32,)))
    log("done", f"phase 32 in {time.time() - t32:.1f} s; phases 1-32 in "
        f"{time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def extras_phases(device, smi, phases=(18, 19, 20), cavity_state=None):
    """Phases 18-32 (those in ``phases``), each timed; returns their
    ``kernels`` rows.  Phase 22 starts from ``cavity_state``."""
    errors, rows = {}, []
    for k, phase in ((18, lambda: rows.append(
            families_phase(device, errors, smi))),
            (19, lambda: rows.extend(plate_phase(device, errors, smi))),
            (20, lambda: small_checks_phase(device)),
            (21, lambda: rows.extend(sensitivity_phase(device, smi))),
            (22, lambda: rows.extend(cavity_sensitivity_phase(
                device, cavity_state, smi))),
            (23, lambda: rows.extend(mems_phase(device, smi))),
            (24, lambda: rows.extend(struct_phase(device, smi))),
            (25, lambda: rows.extend(motion_phase(device, smi))),
            (26, lambda: rows.extend(charging_phase(device, smi))),
            (27, lambda: rows.extend(ke_phase(device, smi))),
            (28, lambda: rows.extend(battery_phase(device, smi))),
            (29, lambda: rows.extend(kinetic_phase(device, smi))),
            (30, lambda: rows.extend(phonon_phase(device, smi))),
            (31, lambda: rows.extend(ib_phase(device, smi))),
            (32, lambda: rows.extend(dist_phase(device, smi)))):
        if k in phases:
            t0 = time.time()
            phase()
            log("done", f"phase {k} in {time.time() - t0:.1f} s")
    return rows


if __name__ == "__main__":
    sys.exit(main())
