"""The port's counterpart of ``bench.py --suite``: its three metric lines.

    python3 -m scripts.suite_run

Run from the repository root on a machine with one NVIDIA GPU.  It builds
the ``dia_stencil`` kernels and the host aggregation helper, then runs the
three cases of ``bench.py:suite()`` (``bench.py:658-862``) with bench's
settings:

1. ``homocase_thermal_cells_per_sec``: thermal diffusion on
   ``cases.homocase_standin`` (hex_3d(22^3), 10,648 cells, float32, a
   stand-in for the absent homoCase-10000.cas), 20 outers as one chunk
   after a compile run;
2. ``heated_channel_time_to_tol``: ``cases.heated_channel`` (384 x 128,
   float32) to 5e-4 momentum and 1e-5 thermal (``cases.channel_to_tol``);
3. ``electrostatics_tet_bcgstab_cells_x_iters_per_sec``: bench's f64
   BiCGStab on ``cases.electrostatics_standin("reference")`` (7,680
   prisms, the stand-in for the absent cav_tetra.cas), 5 timed solves
   after a warm one (``chip_smoke.py`` phase 17 also runs the 1,048,576-
   prism stand-in).

Each line is bench's JSON (metric, value, unit, ``vs_baseline`` against
bench's estimate of the reference C++ on one CPU core, and bench's extra
fields) with a ``stand_in`` field naming a generated mesh where the
upstream one is absent, and the card's name and power limit
(``device``).  It fails when a case does not converge.
"""

from __future__ import annotations

import json
import subprocess
import sys

# bench.py's estimate of the reference C++ throughput on one CPU core
BASELINE_CPS = 2.5e5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("suite_run: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fvm_tpu_torch import cases, hostlib
    from fvm_tpu_torch.ops import dia_kernel as dk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dk.build()
    hostlib.build()
    lines = []

    def emit(r, baseline, stand_in=None):
        r = {k: v for k, v in r.items() if k not in ("histories", "x")}
        line = {"metric": r.pop("metric"), "value": r.pop("value"),
                "unit": r.pop("unit")}
        line["vs_baseline"] = baseline / line["value"] if (
            line["unit"] == "s") else line["value"] / baseline
        line.update(r)
        if stand_in:
            line["stand_in"] = stand_in
        line["device"] = smi
        print(json.dumps(line), flush=True)
        lines.append(line)

    n = cases.HOMOCASE_N
    t = cases.homocase_standin(device="cuda")
    emit(cases.homocase_run(t), BASELINE_CPS,
         f"hex_3d({n},{n},{n}), {n ** 3} cells, for homoCase-10000.cas")
    del t
    flow, thermal = cases.heated_channel(device="cuda")
    r = cases.channel_to_tol(flow, thermal)
    # bench's reference estimate: the same outer count at the per-core rate
    emit(r, r["outer_steps"] * flow.mesh.n_interior_cells / BASELINE_CPS)
    del flow, thermal
    k, nz, lz = cases.PRISM_STANDINS["reference"]
    em = cases.electrostatics_standin("reference", device="cuda")
    emit(cases.electrostatics_run(em), BASELINE_CPS * 10,
         f"extrude(tri_2d({k},{k}), nz={nz}, lz={lz:g}), "
         f"{em.mesh.n_interior_cells} prisms, for cav_tetra.cas")
    print(smi, flush=True)
    return 0 if all(line["converged"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
