#!/usr/bin/env python3
"""The thick phonon slab on the card by size: its peak memory, seconds,
trips and residuals.

Run from the repository root (needs an NVIDIA GPU):

    python3 -m scripts.phonon_peak [--sizes 256,512,1024,1448]
        [--outers 1] [--inner 20]

For each n it builds ``cases.phonon_thick(n, n)`` (tests/test_comet.py:
110-156's slab: S_N(4, 8), tau 0.01, Isothermal 310 / 300, Symmetry top
and bottom, the DSA on) on the card in float64, its inner BiCGStab
capped at ``--inner`` trips (to 1e-9), runs ``--outers`` COMET outers
(fewer if the residual reaches the model's relative tolerance) and
prints the set-up seconds, the outers' seconds and trips, the peak
memory above what was held before, the residuals and their ratio, and
the temperature's largest distance from the diffusion profile.  With
the defaults it measures the peaks behind ``chip_smoke.py``'s PH_CARD_N
(the largest square slab within KIN_PEAK_GIB); with ``--inner 400
--outers 6`` the solves behind PH_CONV_N (a slab that converges).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="256,512,1024,1448")
    ap.add_argument("--outers", type=int, default=1)
    ap.add_argument("--inner", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("phonon_peak: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.ops import dia_kernel as dk

    smi = cs.smi_line()
    print(smi, flush=True)
    dk.build()
    device = torch.device("cuda", 0)
    for n in (int(v) for v in args.sizes.split(",")):
        base = cs.held_gib()
        t0 = time.perf_counter()
        m = cases.phonon_thick(n, n, dsa=True, device=device)
        if args.inner != m.options["innerIterations"]:
            m.options["innerIterations"] = args.inner
            m._drop_compiled()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist = m.advance(args.outers)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = cs.peak_gib() - base
        cs.log("probe", f"thick quad_2d({n}, {n}), inner cap {args.inner}: "
               f"set up {setup_s:.2f} s; {len(hist)} outers in {run_s:.2f} "
               f"s (trips {[int(t) for t in hist.trips]}); peak {peak:.3f} "
               f"GiB above the {base:.3f} held before; residuals "
               + ", ".join(f"{r[1]:.6e}" for r in hist)
               + f" (ratio {hist[-1][1] / hist[0][1]:.3e}); T error to the "
               f"diffusion profile {cases.phonon_profile_error(m):.4f} K "
               f"[{smi}]")
        del m, hist
    return 0


if __name__ == "__main__":
    sys.exit(main())
