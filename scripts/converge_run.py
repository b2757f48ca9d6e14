"""Time to a converged residual on the coupled cavity, the whole sequence.

    python3 -m scripts.converge_run [--n 1024] [--newton-steps 10]

Run from the repository root on a machine with one NVIDIA GPU.  Runs
``cases.converge_cavity(n)`` (``bench.py``'s converge mode: float32 SIMPLE
replays to the stall, promotion to float64, the mixed-precision Newton
endgame, 20 thermal steps) with the report of ``chip_smoke.py``'s phase
14 (``chip_smoke.converge_phase``): seconds per phase, one line per Newton
step, ms per inner iteration and inner iterations per second,
``dia_stencil`` launches per inner iteration, the idle share of a profiled
chunk replay, peak memory and the time to 1e-6; then the card's name and
power limit, and the result as one JSON line, last.  It fails when the
run does not reach 1e-6.  ``chip_smoke.py`` runs the same phase capped
(the float32 phase and the first two Newton steps).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--newton-steps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("converge_run: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fvm_tpu_torch.ops import dia_kernel as dk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dk.build()
    cs.MAIN_N = args.n
    cs.CONVERGE_NEWTON = args.newton_steps
    cs.CONVERGE_REACH = 1e-6
    result = {}
    cs.converge_phase(torch.device("cuda", 0), [], result)
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
