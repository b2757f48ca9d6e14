"""The MEMS switch's whole study on one GPU: ``demos/simulator_mems.py``'s
``main()`` through the port.

    python3 -m scripts.mems_run [--nx 192] [--ny-gap 64] [--budget 2000]

Run from the repository root on the GPU machine.  It builds
``cases.mems_switch(nx, ny_gap)`` (float64), measures the lumped stiffness
and the parallel-plate V_PI, runs the bias sweep of ``main()`` (0.2 to
1.6 V_PI in 8 steps, until pull-in) and the transient snap-down at 1.1
V_PI (squeeze-film damped, contact-capped, at most 160 steps), and prints
per bias point the seconds, the coupling iterations and w_max/g0, the
pull-in bracket against V_PI, the snap-down trajectory, and the ms per
electric solve, plate JFNK outer and squeeze-film solve.  ``chip_smoke.py``
phase 23 runs the same at nx 192 within time budgets; this script runs
it whole (stopping cleanly, and saying so, after ``--budget`` seconds).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class Spent(Exception):
    pass


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=192)
    ap.add_argument("--ny-gap", type=int, default=64)
    ap.add_argument("--budget", type=float, default=2000.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mems_run: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import SolveClock
    from fvm_tpu_torch.cases import mems_switch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t_start = time.perf_counter()
    sw = mems_switch(args.nx, args.ny_gap, device="cuda")
    clock = SolveClock()
    clock.wrap(sw.elec, "advance", "electric")
    clock.wrap(sw.film, "advance", "film")
    count = {"n": 0}
    inner = sw.electrostatic_pressure

    def counted(w, V):
        if time.perf_counter() - t_start > args.budget:
            raise Spent
        count["n"] += 1
        return inner(w, V)

    sw.electrostatic_pressure = counted
    t0 = time.perf_counter()
    k = sw.lumped_stiffness()
    V_pi = sw.pullin_formula(k)
    out = {"nx": args.nx, "ny_gap": args.ny_gap, "card": smi, "k": k,
           "V_pi": V_pi, "s_k": time.perf_counter() - t0, "sweep": []}
    print(f"nx {args.nx}, ny_gap {args.ny_gap}: k = {k:.6g} MPa um in "
          f"{out['s_k']:.2f} s; V_PI = {V_pi:.4f} V", flush=True)
    seen = {"n": 0}

    def report(row):
        row["couplings"] = count["n"] - seen["n"]
        seen["n"] = count["n"]
        out["sweep"].append(row)
        print(json.dumps(row), flush=True)

    try:
        _, (V_lo, V_hi) = sw.sweep(V_pi, report=report)
        out["bracket"] = [V_lo, V_hi]
        print(f"pull-in bracket ({V_lo:.3f}, {V_hi}] V against V_PI "
              f"{V_pi:.3f} V; per solve: {clock.line()}", flush=True)
        t0 = time.perf_counter()
        traj = sw.dynamic_pullin(1.1 * V_pi)
        out["snap"] = {"steps": len(traj), "s": time.perf_counter() - t0,
                       "w_max_g0": [x / sw.g0 for x in traj]}
        print(f"snap-down at 1.1 V_PI: {len(traj)} steps in "
              f"{out['snap']['s']:.1f} s; final w_max/g0 "
              f"{traj[-1] / sw.g0:.3f}", flush=True)
    except Spent:
        out["stopped"] = (f"budget of {args.budget:g} s spent after "
                          f"{count['n']} coupling iterations")
        print(out["stopped"], flush=True)
    out["per_solve"] = clock.line()
    out["s_total"] = time.perf_counter() - t_start
    print(f"per solve: {clock.line()}; {out['s_total']:.1f} s in all",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
