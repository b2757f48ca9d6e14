"""Separate the Newton endgame's inner-iteration count between the packages.

    python3 -m scripts.newton_separate [--n 64] [--perturb 1e-15,2e-15]

Run from the repository root on the CPU (it imports both ``fvm_tpu``, the
JAX reference, and the port ``fvm_tpu_torch``).  It runs the sequence of
``cases.converge_cavity`` (``bench.py``'s converge mode) on the n x n
coupled cavity:

1. the float32 phase once, in the port: two warm-up and ten coupled steps
   (norm0 is the first of the ten), then ``coupled_steps(10)`` checked
   every 50 outers until the momentum residual is below 5e-3 of norm0 and
   the last 50 outers took off less than 10%;
2. from that one host snapshot, in each package and for each inner
   precision: a float64 flow model with bench's Newton settings (inner
   tolerance 1e-3, 4000 inner iterations, BiCGStab in chunks of 240,
   Eisenstat-Walker forcing, refreeze, target 1e-6 * norm0), with the
   inner solve in float64 (``newtonInnerPrecision`` None) or on float32
   views, and ``advanceNewton(10)``.

Both packages start each Newton run from the same state, so a difference
in the inner iterations per Newton step comes from the Newton code or from
the inner arithmetic.  With ``--perturb eps1,eps2,...`` both packages run
once more per eps from the snapshot's velocity scaled by 1 + eps: each
package's own spread under round-off, against which their difference is
read.  It prints one line per Newton step (entry residual over norm0,
forcing, inner iterations, the inner solve's relative residual) and, per
precision, the counts of every run and each package's total inner
iterations (least, mean, most over the runs).  If the float64 counts
differ beyond the reference's own spread, the port's Newton path differs
from the reference; if they differ within it, the difference is the
round-off of the inner solve.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# bench.py's converge settings (the port's cases.py constants)
TARGET_REL = 1e-6
POLISH_AT = 5e-3
ITERS, CHECK, MAX_STEPS = 10, 50, 4000
STEPS = 10  # advanceNewton(STEPS): the run stops at the target first
THREADS = 4  # torch intra-op threads of the port's CPU runs
NEWTON = {
    "newtonKrylovTolerance": 1e-3,
    "newtonKrylovIterations": 4000,
    "newtonInnerSolver": "bicgstab",
    "newtonChunkIterations": 240,
    "newtonRefreeze": True,
}


def float32_phase(n: int, log):
    """The port's float32 phase on the CPU; returns (host snapshot of the
    flow state, norm0, outers, rel at the stall)."""
    from fvm_tpu_torch.cases import cavity_models, coupled_step, coupled_steps
    from fvm_tpu_torch.mesh import build_device_mesh
    from fvm_tpu_torch.mesh.generate import quad_2d
    from fvm_tpu_torch.models.fmg import snapshot_state

    flow, thermal = cavity_models(build_device_mesh(
        quad_2d(n, n), dtype="float32", device="cpu"))
    for _ in range(2):
        coupled_step(flow, thermal)
    for _ in range(ITERS):
        hist = coupled_step(flow, thermal)
    norm0 = float(hist[0])
    steps, prev, rel = 0, None, 1.0
    while steps < MAX_STEPS:
        for _ in range(CHECK // ITERS):
            res = coupled_steps(flow, thermal, ITERS)
        rel = float(res[-1][0]) / norm0
        steps += CHECK
        stalled = prev is not None and rel > 0.9 * prev
        prev = rel
        if rel < POLISH_AT and stalled:
            break
    log(f"float32 phase (port): {steps} outers, stall at rel {rel:.4e}, "
        f"norm0 {norm0:.6e}")
    return snapshot_state(flow), norm0, steps, rel


def _configure_flow(f):
    from_torch = f.__class__.__module__.startswith("fvm_tpu_torch")
    if from_torch:
        from fvm_tpu_torch.linear import AMG, BiCGStab
    else:
        from fvm_tpu.linear import AMG, BiCGStab
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.options["pressureLinearSolver"] = AMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    f.options["momentumLinearSolver"] = BiCGStab(
        relative_tolerance=1e-2, max_iterations=10)


def newton_run(pkg: str, n: int, snap: dict, norm0: float, precision,
               steps: int, eps: float = 0.0) -> dict:
    """advanceNewton(steps) from ``snap`` in one package; returns the
    per-step trace and the seconds."""
    opts = dict(NEWTON, newtonInnerPrecision=precision,
                newtonTargetResidual=TARGET_REL * norm0)
    if pkg == "fvm_tpu_torch":
        from fvm_tpu_torch.mesh import build_device_mesh
        from fvm_tpu_torch.mesh.generate import quad_2d
        from fvm_tpu_torch.models import FlowModel
        from fvm_tpu_torch.models.fmg import restore_state

        f = FlowModel(build_device_mesh(quad_2d(n, n), dtype="float64",
                                        device="cpu"))
    else:
        import jax.numpy as jnp
        import fvm_tpu as jfvm
        from fvm_tpu.models import FlowModel
        from fvm_tpu.models.fmg import restore_state

        f = FlowModel(jfvm.mesh.build_device_mesh(
            jfvm.mesh.generate.quad_2d(n, n), dtype=jnp.float64))
    _configure_flow(f)
    f.options.update(opts)
    f.init()
    f.options["residualSync"] = False
    # the snapshot is float32: scale its float64 cast
    restore_state(f, dict(snap, velocity=snap["velocity"].astype(np.float64)
                          * (1.0 + eps)))
    t0 = time.time()
    hn = f.advanceNewton(steps)
    sec = time.time() - t0
    trace = [{"entry_rel": float(t["entry_mom"]) / norm0,
              "eta": float(t["eta"]), "inner_its": int(t["inner_its"]),
              "inner_rel": float(t["inner_rel"])}
             for t in f._newton_trace]
    return {"trace": trace, "s": sec,
            "reached_rel": float(hn[-1][1]) / norm0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--perturb", default="")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    torch.set_num_threads(THREADS)

    def log(msg):
        print(msg, flush=True)

    t0 = time.time()
    snap, norm0, f32_steps, f32_rel = float32_phase(args.n, log)
    log(f"float32 phase: {time.time() - t0:.1f} s")
    out = {"n": args.n, "norm0": norm0, "f32_steps": f32_steps,
           "f32_rel": f32_rel, "runs": {}}
    for prec_name in ("float64", "float32"):
        precision = None if prec_name == "float64" else prec_name
        counts = {}
        epss = [0.0] + [float(e) for e in args.perturb.split(",") if e]
        runs = [(pkg, eps) for eps in epss
                for pkg in ("fvm_tpu", "fvm_tpu_torch")]
        for pkg, eps in runs:
            name = pkg + (f" ({eps:g})" if eps else "")
            r = newton_run(pkg, args.n, snap, norm0, precision, STEPS, eps)
            out["runs"][f"{prec_name}/{name}"] = r
            counts[name] = [t["inner_its"] for t in r["trace"]]
            for k, t in enumerate(r["trace"]):
                log(f"{prec_name} inner, {name}: newton {k}: entry rel "
                    f"{t['entry_rel']:.6e}, eta {t['eta']:.3e}, inner its "
                    f"{t['inner_its']}, inner rel {t['inner_rel']:.3e}")
            log(f"{prec_name} inner, {name}: {sum(counts[name])} inner "
                f"iterations over {len(counts[name])} steps, reached rel "
                f"{r['reached_rel']:.3e} in {r['s']:.1f} s")
        log(f"{prec_name} inner: inner iterations per Newton step: "
            + "; ".join(f"{k} {v}" for k, v in counts.items()))
        for pkg in ("fvm_tpu", "fvm_tpu_torch"):
            tot = [sum(v) for k, v in counts.items()
                   if k.split(" ")[0] == pkg]
            log(f"{prec_name} inner, {pkg}: total inner iterations over "
                f"{len(tot)} runs: least {min(tot)}, mean "
                f"{sum(tot) / len(tot):.1f}, most {max(tot)}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
