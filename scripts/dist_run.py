"""Run a distributed case of the port at any rank count.

    python -m scripts.dist_run --ranks 4 --device cpu
    python -m scripts.dist_run --case cavity --ranks 8 --device cpu --n 32 \\
        --solver JACOBI
    python3 scripts/dist_run.py --case timed --device cuda --backend gloo \\
        --n 1024 --dtype float32

Run from the repository root.  Each case starts ``--ranks`` fresh rank
processes (``fvm_tpu_torch.parallel.run_ranks``; gloo by default on the
CPU, NCCL on the GPU, which runs one rank per GPU: pass ``--backend gloo``
for several ranks on one card) and prints rank 0's results:

* ``thermal``: ``demos/testThermalParallel.py`` on quad_2d(n, n), 20
  outers (``cases.dist_thermal_rank``);
* ``cavity``: ``demos/testFlowParallel.py``'s cavity, by default the
  goldens' cav32 configuration with the pressure solver of a golden
  family (``--solver``; ``cases.dist_cavity_rank``), ``--steps`` outers;
* ``coupled``: bench's coupled cavity (``cases.dist_coupled_rank``);
* ``dryrun``: ``__graft_entry__.dryrun_multichip`` section 1 with its
  assertions (``cases.dist_dryrun``: the 64^2 cavity over 40 outers, dist
  against one device);
* ``timed``: bench's coupled cavity timed (``cases.dist_timed_rank``: ms
  per outer, collectives, launches by shape, peak memory, the kernel
  against its plain version at every DIA level of the shard hierarchy).

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _short(v):
    a = np.asarray(v)
    if a.dtype.kind in "US":
        return a.tolist()
    if a.size > 12:
        return {"shape": list(a.shape), "first": a.reshape(-1)[:6].tolist(),
                "last": a.reshape(-1)[-6:].tolist()}
    return a.tolist()


def main() -> int:
    from fvm_tpu_torch import cases
    from fvm_tpu_torch.parallel import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="thermal",
                    choices=("thermal", "cavity", "coupled", "dryrun",
                             "timed"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--solver", default="AMG")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--timeout", type=float, default=1800.0)
    a = ap.parse_args()
    t0 = time.time()
    kw = dict(device=a.device, backend=a.backend, timeout=a.timeout)
    if a.case == "thermal":
        out = cases.dist_thermal(a.n or 64, a.ranks, dtype=a.dtype,
                                 niter=a.steps or 20, **kw)
    elif a.case == "cavity":
        out = cases.dist_cavity(a.n or 32, a.ranks, a.solver, dtype=a.dtype,
                                niter=a.steps or 30, **kw)
    elif a.case == "coupled":
        out = cases.dist_coupled_cavity(a.n or 64, a.ranks, dtype=a.dtype,
                                        steps=a.steps or 5, **kw)
    elif a.case == "dryrun":
        out = cases.dist_dryrun(a.n or 64, a.ranks, dtype=a.dtype,
                                niter=a.steps or 40, **kw)
    else:
        out = run_ranks("dist_timed_rank", a.ranks, dict(
            n=a.n or 1024, timed=a.steps or 3, dtype=a.dtype), **kw)[0]
    print(json.dumps({"case": a.case, "ranks": a.ranks, "device": a.device,
                      "seconds": round(time.time() - t0, 2),
                      "rank0": {k: _short(v) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
