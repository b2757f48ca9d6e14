"""Where the thick phonon slab's COMET solve ends, under round-off.

    python3 -m scripts.phonon_scale [--samples K] [--package port|jax]
        [--sizes 32,64] [--square] [--outers 6] [--inner 20]

Run from the repository root on the CPU.  For each size nx it builds the
acoustically thick slab of ``tests/test_comet.py:110-156`` (the port's
``cases.phonon_thick``: quad_2d(nx, 4), S_N(4, 8), tau 0.01, Isothermal
310 / 300, Symmetry top and bottom, the inner BiCGStab 20 trips to 1e-9,
the DSA on) for K hot-wall temperatures 310 (1 + k 1e-15), k = 0 .. K - 1,
in the package that ``--package`` names (``port``: on the CPU; ``jax``:
the JAX reference, ``fvm_tpu``), runs its 6 outers and prints each run's
residual ratio, its temperature's distance from the diffusion profile
and whether the JAX test's assertion (ratio < 5e-7, error < 0.3 K)
holds.  ``--square`` takes quad_2d(nx, nx) instead (``chip_smoke.py``
phase 30's card-size slab), ``--outers`` another number of outers,
``--inner`` another cap on the inner BiCGStab's trips.  A history that
repeats an entry is a plateau: the inner solve found no iterate better
than zero within its trips, so that Newton step did nothing; where it
starts is a matter of round-off.  The port's lines end with the trips
of each inner solve (the JAX package does not report them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def jax_thick(nx, ny, eps, inner):
    import fvm_tpu as fvm
    from fvm_tpu.kinetic.phonon import PhononModel

    dm = fvm.mesh.build_device_mesh(fvm.mesh.generate.quad_2d(nx, ny))
    m = PhononModel(dm, n_polar=4, n_azimuthal=8)
    m.options["verbose"] = False
    m.options["innerIterations"] = inner
    m.options["innerTolerance"] = 1e-9
    m.options["coarseAcceleration"] = True
    m.vc["relaxationTime"] = 0.01
    m.bc["left"].bc_type = "Isothermal"
    m.bc["left"]["specifiedTemperature"] = 310.0 * (1 + eps)
    m.bc["right"].bc_type = "Isothermal"
    m.bc["right"]["specifiedTemperature"] = 300.0
    m.bc["top"].bc_type = "Symmetry"
    m.bc["bottom"].bc_type = "Symmetry"
    m.init()
    return m


def port_thick(nx, ny, eps, inner):
    from fvm_tpu_torch import cases

    m = cases.phonon_thick(nx, ny, dsa=True, device="cpu")
    m.bc["left"]["specifiedTemperature"] = 310.0 * (1 + eps)
    if inner != m.options["innerIterations"]:
        m.options["innerIterations"] = inner
        m._drop_compiled()
    return m


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--package", default="port", choices=("port", "jax"))
    ap.add_argument("--sizes", default="32,64")
    ap.add_argument("--square", action="store_true")
    ap.add_argument("--outers", type=int, default=6)
    ap.add_argument("--inner", type=int, default=20)
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        make = jax_thick
    else:
        import torch

        torch.set_num_threads(1)
        make = port_thick
    for nx in (int(v) for v in args.sizes.split(",")):
        held = 0
        for k in range(args.samples):
            t0 = time.perf_counter()
            m = make(nx, nx if args.square else 4, k * 1e-15, args.inner)
            hist = m.advance(args.outers)
            h = [r[1] for r in hist]
            ni = m.mesh.n_interior_cells
            x = np.asarray(m.mesh.cell_centroid[:ni, 0])
            err = float(np.abs(np.asarray(m.getTemperature())
                               - (310.0 - 10.0 * x)).max())
            ratio = h[-1] / h[0]
            ok = ratio < 5e-7 and err < 0.3
            held += ok
            print(f"{args.package} quad_2d({nx}, "
                  f"{nx if args.square else 4}) k {k}: ratio {ratio:.3e}, T err "
                  f"{err:.4f}, {'holds' if ok else 'FAILS'}; history "
                  + ", ".join(f"{v:.3e}" for v in h)
                  + (f"; trips {[int(t) for t in hist.trips]}"
                     if hasattr(hist, "trips") else "")
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"{args.package} nx {nx}{' square' if args.square else ''}:"
              f" the assertion holds in {held} of "
              f"{args.samples}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
