"""How far the battery half cell's own solver reaches, in the JAX package.

    python3 -m scripts.battery_scale [--sizes 32x4,64x8,128x16,256x32]
        [--package jax|port|both] [--steps 1]

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference, and with ``--package port`` or ``both`` the port).  For each
size it builds ``demos/battery_cell.py``'s half cell (quad_2d(nx, ny) over
2 x 1, electrolyte | cathode split by a double-shell interface, I = 5,
dt = 20, the default JFNK inner solve BiCGStab(Jacobi(3), 1e-8, 300)),
takes ``--steps`` time steps of ``advance(20)`` and prints the Newton
iterations, the outer residuals reached against the first one, the Li
balance d(Li in the electrode) against the exact -dt I / F and the
seconds.  The largest size at which the JAX package's own solve converges
(outer residual below 1e-8 of the first, the balance to 1e-8) is the card
size of ``chip_smoke.py`` phase 28 (``BATTERY_CARD``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

FARADAY = 96485.33


def cell(pkg, nx, ny):
    """(model, electrode mask) of the demo's cell in ``pkg``."""
    if pkg == "port":
        from fvm_tpu_torch import cases

        return cases.battery_cell(nx, ny, device="cpu")
    import fvm_tpu as fvm
    from fvm_tpu.mesh.metrics import compute_geometry
    from fvm_tpu.models.battery import BatteryModel

    m = fvm.mesh.generate.quad_2d(nx, ny, lx=2.0, ly=1.0)
    elyte = compute_geometry(m).cell_centroid[: m.n_interior_cells, 0] < 1.0
    m2 = m.make_interface("sep", m.interface_faces_between(elyte, ~elyte),
                          left_cells=elyte)
    b = BatteryModel(fvm.mesh.build_device_mesh(m2))
    b.options["verbose"] = False
    b.options["transient"] = True
    b.options["timeStep"] = 20.0
    xc = compute_geometry(m2).cell_centroid[: m2.n_interior_cells, 0]
    b.set_material_regions(np.where(xc < 1.0, 1, 2))
    b.vc["conductivity"] = (100.0, 1.0, 10.0)
    b.vc["diffusivity"] = (1e-2, 1e-2, 1e-2)
    b.bc["left"].bc_type = "SpecifiedPotential"
    b.bc["left"]["specifiedPotential"] = 0.0
    b.bc["right"].bc_type = "SpecifiedCurrent"
    b.bc["right"]["specifiedCurrent"] = 5.0
    b.bc["top"].bc_type = "Symmetry"
    b.bc["bottom"].bc_type = "Symmetry"
    b.init()
    return b, ~(xc < 1.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="32x4,64x8,128x16,256x32")
    ap.add_argument("--package", default="jax")
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    if args.package in ("jax", "both"):
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    pkgs = ("jax", "port") if args.package == "both" else (args.package,)
    for size in args.sizes.split(","):
        nx, ny = (int(v) for v in size.split("x"))
        for pkg in pkgs:
            t0 = time.perf_counter()
            b, el = cell(pkg, nx, ny)
            vol = 2.0 / b.mesh.n_interior_cells
            for step in range(args.steps):
                c0 = np.asarray(b.getConcentration())
                h = [float(r[1]) for r in b.advance(20)]
                c1 = np.asarray(b.getConcentration())
                dli = float((c1[el] - c0[el]).sum() * vol)
                exact = -20.0 * 5.0 / FARADAY
                ok = h[-1] <= 1e-8 * h[0] and abs(dli / exact - 1) <= 1e-8
                print(f"{pkg} {nx}x{ny} ({b.mesh.n_interior_cells} cells) "
                      f"step {step}: {len(h)} Newton iterations, residual "
                      f"{h[-1]:.3e} ({h[-1] / h[0]:.3e} of the first); "
                      f"d(Li_electrode) {dli:.9e} against {exact:.9e} (rel "
                      f"{abs(dli / exact - 1):.3e}); "
                      f"{'converged' if ok else 'NOT converged'}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                b.updateTime()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
