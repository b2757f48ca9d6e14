"""How far the thick ES-BGK heat-transfer case's own COMET solve reaches, in
the JAX package.

    python3 -m scripts.kinetic_scale [--sizes 48x3,128x32,256x64]
        [--outers 3] [--dsa on|off] [--samples K --package port|jax]

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference; with ``--samples K --package port`` the port instead).  For
each size it builds the thick case of ``tests/test_comet.py:158-191`` (the
port's
``cases.esbgk_thick``: quad_2d(nx, ny) over the unit square, periodic
bottom/top, Quadrature(8, 8, 4), tau 0.01, diffuse walls at 1.1 and 0.9,
the inner BiCGStab 60 trips to 1e-9, the DSA on by default), runs
``--outers`` COMET outers and prints the residual history and the
seconds.  A history that repeats its first entry is a stall: the inner
solve found no iterate better than zero, so the Newton step did nothing.
``chip_smoke.py`` phase 29 runs this case at card size as a cost
measurement (s per outer and per trip); this script shows where the
reference itself stops making progress.

With ``--samples K`` it runs instead the thick case at quad_2d(48, 3), 8
outers, with and without the DSA for K hot-wall temperatures
1.1 (1 + k 1e-15), k = 0 .. K - 1, in the package that ``--package``
names (``port``: ``cases.esbgk_thick`` on the CPU; ``jax``: the JAX
reference), and prints each pair's relative residuals and whether the JAX
test's assertion (rel_dsa < 1e-3 and rel_dsa < rel_plain / 5) holds:
where each run ends is a plateau reached by round-off.
"""

from __future__ import annotations

import argparse
import time


def thick(nx, ny, dsa):
    import fvm_tpu as fvm
    from fvm_tpu.kinetic import KineticModel, Quadrature

    mesh = fvm.mesh.generate.quad_2d(nx, ny)
    mesh.make_periodic("bottom", "top")
    m = KineticModel(fvm.mesh.build_device_mesh(mesh), Quadrature(8, 8, 4))
    m.options["verbose"] = False
    m.options["innerIterations"] = 60
    m.options["innerTolerance"] = 1e-9
    m.options["coarseAcceleration"] = dsa
    m.vc["relaxationTime"] = 0.01
    m.bc["left"].bc_type = "DiffuseWall"
    m.bc["left"]["specifiedTemperature"] = 1.1
    m.bc["right"].bc_type = "DiffuseWall"
    m.bc["right"]["specifiedTemperature"] = 0.9
    m.bc["bottom"].bc_type = "Periodic"
    m.bc["top"].bc_type = "Periodic"
    m.init()
    return m


def samples(k_max, package):
    """The thick case under k 1e-15 changes (module docstring)."""
    if package == "port":
        import torch
        from fvm_tpu_torch import cases

        torch.set_num_threads(1)

        def build(dsa):
            return cases.esbgk_thick(48, 3, dsa=dsa, device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")

        def build(dsa):
            return thick(48, 3, dsa)
    held = 0
    for k in range(k_max):
        rel = {}
        for dsa in (True, False):
            m = build(dsa)
            m.bc["left"]["specifiedTemperature"] = 1.1 * (1 + k * 1e-15)
            h = [r[1] for r in m.advance(8)]
            rel[dsa] = h[-1] / h[0]
        ok = rel[True] < 1e-3 and rel[True] < rel[False] / 5
        held += ok
        print(f"{package} thick quad_2d(48, 3), k = {k}: rel_dsa "
              f"{rel[True]:.3e}, rel_plain {rel[False]:.3e}, ratio "
              f"{rel[False] / rel[True]:.2f}: the assertion "
              f"{'holds' if ok else 'fails'}", flush=True)
    print(f"{package}: the assertion holds in {held} of {k_max}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="48x3,128x32,256x64")
    ap.add_argument("--outers", type=int, default=3)
    ap.add_argument("--dsa", default="on", choices=("on", "off"))
    ap.add_argument("--samples", type=int, default=0)
    ap.add_argument("--package", default="port", choices=("port", "jax"))
    args = ap.parse_args()
    if args.samples:
        return samples(args.samples, args.package)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for size in args.sizes.split(","):
        nx, ny = (int(v) for v in size.split("x"))
        m = thick(nx, ny, args.dsa == "on")
        t0 = time.perf_counter()
        h = [r[1] for r in m.advance(args.outers)]
        secs = time.perf_counter() - t0
        stalled = len(h) > 1 and all(v == h[0] for v in h)
        print(f"thick quad_2d({nx}, {ny}), DSA {args.dsa}: residuals "
              + ", ".join(f"{v:.6e}" for v in h)
              + (" (stalled from the first outer)" if stalled else "")
              + f"; {secs:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
