#!/usr/bin/env python3
"""Where one reverse pass of the cavity's adjoint spends the card's time.

    python3 -m scripts.adjoint_profile [--n 1024] [--steps 12]

Run from the repository root on one GPU.  It builds bench's n x n float32
cavity (``cases.coupled_cavity``), takes ``--steps`` coupled steps, then
runs ``solve_adjoint_force("top", niter=0)`` (the step's graph built at
the state and one reverse pass) once untimed, once timed, and once under
torch.profiler: the device time by op, and the advanced-indexing
derivatives (``aten::_index_put_impl_``) by input shape.  It prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fvm_tpu_torch.cases import coupled_cavity, coupled_step
    from fvm_tpu_torch.ops import dia_kernel as dk

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dk.build()
    flow, thermal = coupled_cavity(args.n, device=torch.device("cuda", 0),
                                   dtype="float32")
    for _ in range(args.steps):
        coupled_step(flow, thermal)

    def one_pass():
        flow.solve_adjoint_force("top", None, ("mu",), (), niter=0)
        torch.cuda.synchronize()

    one_pass()
    t0 = time.perf_counter()
    one_pass()
    print(f"graph build and one reverse pass: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        one_pass()
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=15), flush=True)
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::_index_put_impl_"]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        print(f"index_put (advanced-indexing derivative): "
              f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} calls, "
              f"shapes {e.input_shapes}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
