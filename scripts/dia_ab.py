"""A/B timing of the ``dia_stencil`` kernels against an earlier checkout's.

    python3 -m scripts.dia_ab --parent DIR [--json PATH]

Run from the repository root. DIR holds an earlier checkout of the
repository (``git archive <commit> | tar -x -C DIR``). Its
``fvm_tpu_torch/ops/dia_kernel.py`` is loaded under another name and
builds its own kernel into DIR/build/kernels. On one CUDA card the
script then measures, for the AMG levels that the 1024^2 cavity's
pressure solver builds (``kernel_bench.level_shapes``) in float32:

- device ms per launch (torch.profiler) of the earlier kernel and of both
  variants of this one, Jacobi and residual on (n,) at every level and mv
  on (n, 2) at the fine level, in one profiler session per shape, in
  turns (earlier, narrow, wide, wide, narrow, earlier), with the bound;
- host us per wrapper call: an eager loop of residual calls at n = 512,
  where the device time is negligible, earlier and this wrapper in turns.

Operands cycle through 4 copies per shape (beyond the 50 MB L2 at the
fine level).  The earlier wrapper takes a contiguous coef, this one the
padded layout; the values are the same.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from fvm_tpu_torch.linear import AMG
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.ops import dia_kernel as dk
from fvm_tpu_torch.tools import kernel_bench as kb

REPS = 100
COPIES = 4
HOST_CALLS = 4000
HOST_N = 512
KERNEL_KEYS = {"parent": "dia_stencil_kernel", "narrow": "dia_narrow_kernel",
               "wide": "dia_wide_kernel"}


def load_parent(root):
    path = os.path.join(root, "fvm_tpu_torch", "ops", "dia_kernel.py")
    spec = importlib.util.spec_from_file_location("parent_dia_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operands(n, offsets, m, device, seed):
    dtype = torch.float32
    out = []
    for k in range(COPIES):
        coef, diag = kb.random_operator(n, offsets, dtype, device, seed + k)
        x, b = kb.random_vectors(n, m, dtype, device, seed + 10 + k)
        out.append((coef, coef.contiguous(), diag, x, b))
    return out


def calls(mod, ops, offsets, mode, variant=None):
    kw = {"omega": 0.7} if mode == "jacobi" else {}
    fns = []
    for coef, coef_c, diag, x, b in ops:
        bb = None if mode == "mv" else b
        if mod is dk:
            fns.append(lambda c=coef, d=diag, x=x, bb=bb: dk._launch(
                offsets, mode, c, d, x, bb, kw.get("omega"), variant=variant))
        else:
            fns.append(lambda c=coef_c, d=diag, x=x, bb=bb: mod.dia_stencil(
                offsets, mode, c, d, x, b=bb, **kw))
    return fns


def host_us(fn, calls_):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls_):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls_


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dia_ab: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[ab] {smi}", flush=True)
    parent = load_parent(args.parent)
    parent.build()
    dk.build()

    rows = []
    mesh = build_device_mesh(quad_2d(1024, 1024), dtype="float32",
                             device=device)
    shapes = [(s.rows, s.offsets)
              for s in kb.level_shapes(AMG(coarse_size=256), mesh)]
    del mesh
    cases = [(0, "mv", 2)] + [(lvl, mode, 1) for lvl in range(len(shapes))
                              for mode in ("jacobi", "residual")]
    for lvl, mode, m in cases:
        n, offsets = shapes[lvl]
        ops = operands(n, offsets, m, device, seed=100 * lvl)
        t = kb.time_device_by_kernel(
            [(v, KERNEL_KEYS[v],
              calls(parent if v == "parent" else dk, ops, offsets, mode,
                    None if v == "parent" else v))
             for v in ("parent", *dk.VARIANTS)], REPS)
        bound_ms = kb.bound(n, m, len(offsets), mode, 4)[0]
        chosen = "wide" if n >= dk.WIDE_MIN_ROWS else "narrow"
        row = {"level": lvl, "n": n, "m": m, "mode": mode, "bound_ms": bound_ms,
               "parent_ms": t["parent"], "narrow_ms": t["narrow"],
               "wide_ms": t["wide"], "chosen": chosen}
        rows.append(row)
        print(f"[ab] L{lvl:<2d} n={n:<8d} m={m} {mode:8s} bound {bound_ms:.5f} "
              f"parent {t['parent']:.5f} narrow {t['narrow']:.5f} wide "
              f"{t['wide']:.5f} ms ({chosen}: "
              f"{100 * bound_ms / t[chosen]:.1f}% of bound, "
              f"{t['parent'] / t[chosen]:.2f}x parent)", flush=True)
        del ops

    # the public wrappers, as the solvers call them
    offsets = (-16, -1, 1, 16)
    coef, coef_c, diag, x, b = operands(HOST_N, offsets, 1, device, seed=7)[0]
    old = lambda: parent.dia_stencil(offsets, "residual", coef_c, diag, x, b=b)
    new = lambda: dk.dia_stencil(offsets, "residual", coef, diag, x, b=b)
    readings = {"parent": [], "new": []}
    for label, fn in (("parent", old), ("new", new), ("new", new),
                      ("parent", old)):
        readings[label].append(host_us(fn, HOST_CALLS))
    host = {k: sum(v) / len(v) for k, v in readings.items()}
    print(f"[ab] host us per wrapper call (residual, n={HOST_N}, eager "
          f"loop of {HOST_CALLS}): parent {readings['parent']} -> "
          f"{host['parent']:.3f}; new {readings['new']} -> "
          f"{host['new']:.3f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "levels": rows, "host_us": host,
                       "host_readings": readings}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
