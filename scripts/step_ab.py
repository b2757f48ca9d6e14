"""A/B of the coupled step against an earlier checkout, in turns.

    python3 -m scripts.step_ab --parent DIR [--pairs 10]

Run from the repository root. DIR holds an earlier checkout of the
repository (``git archive <commit> | tar -x -C DIR``). Each run is a
fresh process on one CUDA card, in the earlier checkout or in this one,
alternating which side runs first in each pair: the 1024^2 float32
coupled cavity (``cases.coupled_cavity``), 2 warm-up steps, ``--steps``
timed steps closed by a synchronise (ms per step on the host clock),
then two profiled steps (torch.profiler: device busy ms, kernel launches
and ``dia_stencil`` device ms per step). Prints every run, then per side
the median and the quartile spread of each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = r"""
import json, sys, time, torch
from torch.profiler import ProfilerActivity, profile
from fvm_tpu_torch.cases import coupled_cavity, coupled_step
n, steps = int(sys.argv[1]), int(sys.argv[2])
flow, thermal = coupled_cavity(n, device="cuda", dtype="float32")
for _ in range(2):
    coupled_step(flow, thermal)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(steps):
    coupled_step(flow, thermal)
torch.cuda.synchronize()
ms = 1e3 * (time.perf_counter() - t0) / steps
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             acc_events=True) as prof:
    for _ in range(2):
        coupled_step(flow, thermal)
    torch.cuda.synchronize()
ev = [e for e in prof.key_averages()
      if e.device_type == torch.autograd.DeviceType.CUDA
      and e.self_device_time_total > 0]
dia = [e for e in ev if "dia_" in e.key and "_kernel" in e.key]
print(json.dumps({
    "ms_per_step": ms,
    "busy_ms": sum(e.self_device_time_total for e in ev) / 2e3,
    "launches": sum(e.count for e in ev) / 2,
    "dia_ms": sum(e.self_device_time_total for e in dia) / 2e3}))
"""
KEYS = ("ms_per_step", "busy_ms", "launches", "dia_ms")


def run(root, n, steps):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", RUN, str(n), str(steps)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def spread(values):
    q = statistics.quantiles(values, n=4)
    return statistics.median(values), q[2] - q[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[step_ab] {smi}", flush=True)
    runs = {"parent": [], "change": []}
    for pair in range(args.pairs):
        order = ("parent", "change") if pair % 2 == 0 else ("change",
                                                             "parent")
        for side in order:
            r = run(args.parent if side == "parent" else here, args.n,
                    args.steps)
            runs[side].append(r)
            print(f"[step_ab] pair {pair} {side:6s} " + " ".join(
                f"{k} {r[k]:.4f}" for k in KEYS), flush=True)
    wins = sum(c["ms_per_step"] < p["ms_per_step"]
               for p, c in zip(runs["parent"], runs["change"]))
    for side, rs in runs.items():
        print(f"[step_ab] {side:6s} " + "; ".join(
            "{} median {:.4f} IQR {:.4f}".format(k, *spread([r[k] for r in rs]))
            for k in KEYS), flush=True)
    print(f"[step_ab] change faster in {wins} of {args.pairs} pairs",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
