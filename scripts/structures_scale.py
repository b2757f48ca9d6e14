"""How far the structures models' own solvers reach, in both packages.

    python3 -m scripts.structures_scale [--package both|jax|port]
        [--plate 64,96,128,192,256,512,1024]
        [--cantilever 40,80,160,320,640]

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference, beside the port).  For each size it prints the outer residual
history, the relative residual reached and the deflection:

* the MEMS strip ``PlateModel`` of ``demos/simulator_mems.py`` (quad_2d(nx,
  3) over 200 x 20 um, clamped ends, symmetry sides, E 160e3, nu 0.22, h
  0.5) under a uniform 1 kPa load, 6 outers with the default
  BiCGStab(Jacobi(3), 1e-8, 400) (``lumped_stiffness``): w_max;
* the cantilever of ``demos/cantilever_uq.py`` on quad_2d(nx, 0.15 nx)
  over 1 x 0.15 (square cells), 15 outers with the default
  BiCGStab(Jacobi(3), 1e-6, 200): the tip deflection.

The largest sizes at which both packages converge pin the card sizes of
``chip_smoke.py`` phases 23 and 24 (``MEMS_CARD``, ``CANT_UQ``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def plate(pkg, nx):
    """(history, w_max) of the MEMS strip under 1 kPa."""
    if pkg == "jax":
        import fvm_tpu as fvm

        dm = fvm.mesh.build_device_mesh(fvm.mesh.generate.quad_2d(
            nx, 3, lx=200.0, ly=20.0))
        from fvm_tpu.models import PlateModel
    else:
        import fvm_tpu_torch as fvm
        from fvm_tpu_torch.models import PlateModel

        dm = fvm.mesh.build_device_mesh(fvm.mesh.generate.quad_2d(
            nx, 3, lx=200.0, ly=20.0), device="cpu")
    p = PlateModel(dm)
    p.options["verbose"] = False
    p.vc["ym"] = 160e3
    p.vc["nu"] = 0.22
    p.vc["thickness"] = 0.5
    p.vc["density"] = 2.33e-15
    for g in ("left", "right"):
        p.bc[g].bc_type = "Clamped"
    for g in ("bottom", "top"):
        p.bc[g].bc_type = "Symmetry"
    p.init()
    p.set_pressure(np.full(dm.n_cells, -1e-3))
    hist = [float(h[1]) for h in p.advance(6)]
    return hist, float(np.abs(p.getDeflection()).max())


def cantilever(pkg, nx):
    """(history, tip deflection) of the square-cell cantilever."""
    ny = int(round(0.15 * nx))
    if pkg == "jax":
        import fvm_tpu as fvm
        from fvm_tpu.models import StructureModel

        dm = fvm.mesh.build_device_mesh(fvm.mesh.generate.quad_2d(
            nx, ny, lx=1.0, ly=0.15))
        m = StructureModel(dm)
        m.options["verbose"] = False
        m.vc["youngsModulus"] = 1e9
        m.vc["poissonsRatio"] = 0.0
        m.bc["left"].bc_type = "SpecifiedDeformation"
        m.bc["right"].bc_type = "SpecifiedTraction"
        m.bc["right"]["specifiedYTraction"] = -1e4
        m.bc["top"].bc_type = "ZeroTraction"
        m.bc["bottom"].bc_type = "ZeroTraction"
        m.init()
        hist = [float(h[1]) for h in m.advance(15)]
        x = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
        tip = float(m.getDeformation()[x > x.max() - 1e-6, 1].mean())
        return hist, tip
    from fvm_tpu_torch.cases import cantilever as build, tip_deflection

    m = build(nx, ny, device="cpu")
    hist = [float(h[1]) for h in m.advance(15)]
    return hist, tip_deflection(m)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="both")
    ap.add_argument("--plate", default="64,96,128,192,256,512,1024")
    ap.add_argument("--cantilever", default="40,80,160,320,640")
    args = ap.parse_args()
    pkgs = ("jax", "port") if args.package == "both" else (args.package,)
    if "jax" in pkgs:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    for name, fn, sizes, what in (
            ("plate", plate, args.plate, "w_max"),
            ("cantilever", cantilever, args.cantilever, "tip")):
        for nx in (int(v) for v in sizes.split(",") if v):
            for pkg in pkgs:
                t0 = time.perf_counter()
                hist, val = fn(pkg, nx)
                print(f"{pkg:4s} {name} nx {nx}: {len(hist)} outers, "
                      f"residuals " + ", ".join(f"{h:.4g}" for h in hist)
                      + f"; reached {hist[-1] / hist[0]:.3e} of the first; "
                      f"{what} {val:.6e} ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
