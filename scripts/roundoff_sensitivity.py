"""How far the JAX package's own residual histories move under round-off.

    python3 -m scripts.roundoff_sensitivity

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference, and nothing of the port).  Each case runs twice from inputs
that differ by 1e-15 relative and prints the largest relative difference
of the two residual histories, entry by entry:

* the Newton endgame (``advanceNewton(3)``, one program, inner tolerance
  1e-5) from the 32^2 cavity after 60 SIMPLE outers, the velocity state
  scaled by 1 + 1e-15;
* the same in chunks of 25 with the Eisenstat-Walker forcing and inner
  tolerance 1e-10;
* ``advanceCoupled(10)`` on the plane Poiseuille case of
  ``tests/test_flow.py:145`` (coupled solves to 1e-3), the viscosity
  scaled by 1 + 1e-15.

A port held against these histories cannot be held tighter than this
spread; the port's parity tests run the Newton and Poiseuille
comparisons with tight inner solves for that reason.
"""

from __future__ import annotations

import numpy as np


def _cavity(jfvm, JFlow, n, **opts):
    import jax.numpy as jnp

    f = JFlow(jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(n, n),
                                          dtype=jnp.float64))
    f.options["verbose"] = False
    f.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        f.bc[side].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    for k, v in opts.items():
        f.options[k] = v
    f.init()
    return f


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import fvm_tpu as jfvm
    from fvm_tpu.models import FlowModel as JFlow

    def spread(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.max(np.abs(a - b) / np.abs(a)))

    for label, opts in (("Newton, one program, inner tol 1e-5", {}),
                        ("Newton, chunks of 25, Eisenstat-Walker", {
                            "newtonChunkIterations": 25,
                            "newtonKrylovTolerance": 1e-10})):
        hs = []
        for eps in (0.0, 1e-15):
            f = _cavity(jfvm, JFlow, 32, **opts)
            f.advance(60)
            f.state = dict(f.state, velocity=f.state["velocity"] * (1 + eps))
            hs.append([[r[1], r[2]] for r in f.advanceNewton(3)])
        print(f"{label}: entry residuals {hs[0]} / {hs[1]}; max rel "
              f"difference {spread(*hs):.3e}", flush=True)
    hs = []
    for eps in (0.0, 1e-15):
        m = JFlow(jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(
            16, 16, lx=4.0, ly=1.0)))
        m.options["verbose"] = False
        m.vc["viscosity"] = 0.1 * (1 + eps)
        m.bc["left"].bc_type = "PressureBoundary"
        m.bc["left"]["specifiedPressure"] = 1.0
        m.bc["right"].bc_type = "PressureBoundary"
        m.bc["right"]["specifiedPressure"] = 0.0
        m.bc["bottom"].bc_type = "NoSlipWall"
        m.bc["top"].bc_type = "NoSlipWall"
        m.init()
        hs.append([[r[1], r[2]] for r in m.advanceCoupled(10)])
    print(f"advanceCoupled(10), Poiseuille: max rel difference "
          f"{spread(*hs):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
