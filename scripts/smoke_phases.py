#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases 18-32 alone on one GPU, for
development.

Run from the repository root:  python3 scripts/smoke_phases.py 18,19
(phase 22 alone starts from the cavity's first steps and times its rows
itself)

It builds the kernels (``chip_smoke.py``'s phase 2), runs the listed
phases and prints their ``kernels`` rows.  It prints no device line:
``python3 chip_smoke.py`` alone is the smoke test.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    phases = {int(v) for v in (
        sys.argv[1] if len(sys.argv) > 1
        else "18,19,20,21,22,23,24,25,26,27,28,29,30,31,32").split(",")}
    if not torch.cuda.is_available():
        print("smoke_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch import hostlib
    from fvm_tpu_torch.ops import dia_kernel as dk

    smi = cs.smi_line()
    print(smi, flush=True)
    t0 = time.time()
    dk.build(verbose=True)
    hostlib.build()
    cs.log("build", f"kernels built in {time.time() - t0:.1f} s")
    rows = cs.extras_phases(torch.device("cuda", 0), smi, phases)
    cs.log("done", f"phases {sorted(phases)} in {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
