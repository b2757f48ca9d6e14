"""How far the JAX package's own residual histories move under round-off.

    python3 -m scripts.roundoff_sensitivity [--cases newton,poiseuille,
        ib,channel,homocase,electric,goldens]

Run from the repository root on the CPU (it imports ``fvm_tpu``, the JAX
reference, and nothing of the port).  Each case runs twice from inputs
that differ by 1e-15 relative and prints the largest relative difference
of the two residual histories, entry by entry (``--cases`` picks them;
all by default):

* the Newton endgame (``advanceNewton(3)``, one program, inner tolerance
  1e-5) from the 32^2 cavity after 60 SIMPLE outers, the velocity state
  scaled by 1 + 1e-15;
* the same in chunks of 25 with the Eisenstat-Walker forcing and inner
  tolerance 1e-10;
* ``advanceCoupled(10)`` on the plane Poiseuille case of
  ``tests/test_flow.py:145`` (coupled solves to 1e-3), the viscosity
  scaled by 1 + 1e-15;
* ``ib``: 40 SIMPLE outers of the immersed-block cavity of
  ``tests/test_ibm.py:337`` (20^2, default solvers), the viscosity scaled;
* ``channel``: bench's heated channel at ``quad_2d(48, 16)`` in float64
  (``bench.py:729-813``, the port's ``cases.heated_channel``), the
  viscosity scaled: the flow's first ``CHANNEL_OUTERS`` outers, then the
  mass-flux handoff and ``CHANNEL_TOUTERS`` thermal outers, once with
  bench's solvers (momentum ``BiCGStab(1e-2, 10)``, AMG to 1e-3 in 6
  cycles) and once with tight ones (momentum ``BiCGStab(1e-12, 60)``,
  AMG to 1e-12 in 60 cycles);
* ``homocase``: 3 thermal outers of the homoCase stand-in at 8^3
  (``cases.homocase_standin``'s settings), the zmax temperature scaled;
* ``electric``: 5 outers of ``tests/test_torch_electric.py``'s prism
  model (per-cell permittivity, space charge and a random potential from
  seed 1, default solver), the zmax potential scaled;
* ``goldens``: the golden configurations of
  ``tests/test_golden_histories.py:44-143`` for the families ILU0, SPIKE
  and JACOBI: ``cavity/<family>/np1`` (30 SIMPLE outers, the viscosity
  scaled) and ``thermal/<family>/np1`` (10 outers, the left wall
  temperature scaled; not for JACOBI, which has no thermal golden), each
  also against its pinned history in ``tests/goldens/histories.json``.

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


CHANNEL_OUTERS, CHANNEL_TOUTERS = 60, 8
TIGHT = {"mom": (1e-12, 60), "amg": (1e-12, 60)}
BENCH = {"mom": (1e-2, 10), "amg": (1e-3, 6)}


def channel_models(jfvm, nx, ny, solvers=BENCH, mu_scale=1.0):
    """(flow, thermal) of bench's heated channel (``bench.py:729-784``) in
    the JAX package, float64, with the given solver tolerances."""
    import jax.numpy as jnp
    from fvm_tpu.linear import AMG, BiCGStab
    from fvm_tpu.mesh.metrics import compute_geometry
    from fvm_tpu.models import FlowModel, ThermalModel

    mesh = jfvm.mesh.generate.quad_2d(nx, ny, lx=3.0, ly=1.0)
    yc = compute_geometry(mesh).cell_centroid[: mesh.n_interior_cells, 1]
    solid = yc < 0.25
    dm = jfvm.mesh.build_device_mesh(mesh, dtype=jnp.float64)
    amg_tol, amg_it = solvers["amg"]
    flow = FlowModel(dm)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01 * mu_scale
    flow.options["pressureLinearSolver"] = AMG(
        coarse_size=128, relative_tolerance=amg_tol, max_iterations=amg_it)
    flow.options["momentumLinearSolver"] = BiCGStab(
        relative_tolerance=solvers["mom"][0],
        max_iterations=solvers["mom"][1])
    flow.bc["left"].bc_type = "VelocityBoundary"
    flow.bc["left"]["specifiedXVelocity"] = np.where(yc[:ny] >= 0.25, 1.0,
                                                     0.0)
    flow.bc["right"].bc_type = "PressureBoundary"
    flow.bc["top"].bc_type = "NoSlipWall"
    flow.bc["bottom"].bc_type = "NoSlipWall"
    flow.init()
    flow.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    thermal = ThermalModel(dm)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = AMG(
        coarse_size=128, relative_tolerance=amg_tol, max_iterations=amg_it)
    thermal.vc["thermalConductivity"] = np.where(solid, 20.0, 1.0)
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "SpecifiedTemperature"
    thermal.bc["bottom"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "ZeroGradient"
    thermal.bc["top"].bc_type = "Symmetry"
    thermal.init()
    return flow, thermal


def ib_cavity(JFlow, jfvm, n=20, mu=0.1):
    """The immersed-block cavity of ``tests/test_ibm.py:337``."""
    m = JFlow(jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(n, n)))
    m.options["verbose"] = False
    m.vc["viscosity"] = mu
    for s_ in ("left", "right", "bottom", "top"):
        m.bc[s_].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.init()
    cc = np.asarray(m.mesh.cell_centroid)[: m.mesh.n_interior_cells]
    solid = ((cc[:, 0] > 0.3) & (cc[:, 0] < 0.7)
             & (cc[:, 1] > 0.4) & (cc[:, 1] < 0.6))
    m.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    return m


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="newton,poiseuille,ib,channel")
    cases = ap.parse_args().cases.split(",")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import fvm_tpu as jfvm
    from fvm_tpu.models import FlowModel as JFlow

    def spread(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.max(np.abs(a - b) / np.abs(a)))

    if "ib" in cases:
        hs = []
        for eps in (0.0, 1e-15):
            m = ib_cavity(JFlow, jfvm, mu=0.1 * (1 + eps))
            hs.append([[r[1], r[2]] for r in m.advance(40)])
        print(f"immersed-block cavity, 40 SIMPLE outers: max rel "
              f"difference {spread(*hs):.3e}", flush=True)
    if "channel" in cases:
        for label, solvers in (("bench's solvers", BENCH),
                               ("tight solvers", TIGHT)):
            hf, ht = [], []
            for eps in (0.0, 1e-15):
                f, t = channel_models(jfvm, 48, 16, solvers, 1 + eps)
                hf.append([[r[1], r[2]] for r in f.advance(CHANNEL_OUTERS)])
                t.state["massFlux"] = f.state["massFlux"]
                ht.append([r[1] for r in t.advance(CHANNEL_TOUTERS)])
            print(f"heated channel 48x16, {label}: flow {CHANNEL_OUTERS} "
                  f"outers max rel difference {spread(*hf):.3e}, first 10 "
                  f"{spread(hf[0][:10], hf[1][:10]):.3e}; thermal "
                  f"{CHANNEL_TOUTERS} outers {spread(*ht):.3e}", flush=True)
    if "homocase" in cases:
        from fvm_tpu.linear import AMG
        from fvm_tpu.models import ThermalModel

        hs = []
        for eps in (0.0, 1e-15):
            t = ThermalModel(jfvm.mesh.build_device_mesh(
                jfvm.mesh.generate.hex_3d(8, 8, 8)))
            t.options["verbose"] = False
            t.options["linearSolver"] = AMG(
                coarse_size=64, relative_tolerance=1e-3, max_iterations=20)
            t.bc["zmax"].bc_type = "SpecifiedTemperature"
            t.bc["zmax"]["specifiedTemperature"] = 400.0 * (1 + eps)
            t.bc["zmin"].bc_type = "SpecifiedTemperature"
            t.bc["zmin"]["specifiedTemperature"] = 300.0
            for g in ("xmin", "xmax", "ymin", "ymax"):
                t.bc[g].bc_type = "Symmetry"
            t.init()
            hs.append([r[1] for r in t.advance(3)])
        print(f"homoCase stand-in 8^3, 3 outers: max rel difference "
              f"{spread(*hs):.3e}", flush=True)
    if "electric" in cases:
        import jax.numpy as jnp
        from fvm_tpu.models.electric import ElectricModel

        hs = []
        for eps in (0.0, 1e-15):
            rng = np.random.default_rng(1)
            dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.extrude(
                jfvm.mesh.generate.tri_2d(6, 5), 4, lz=0.5))
            nc = dm.n_interior_cells
            m = ElectricModel(dm)
            m.options["verbose"] = False
            m.vc["dielectric_constant"] = rng.uniform(1.0, 10.0, nc)
            m.vc["initialCharge"] = 1e-9 * rng.normal(size=nc)
            phi0 = rng.normal(size=dm.n_cells)
            m.bc["zmax"].bc_type = "SpecifiedPotential"
            m.bc["zmax"]["specifiedPotential"] = 1.0 + eps
            m.bc["zmin"].bc_type = "SpecifiedCharge"
            m.bc["zmin"]["specifiedCharge"] = 1e-10
            for g in ("left", "right", "bottom", "top"):
                m.bc[g].bc_type = "Symmetry"
            m.init()
            m.state["potential"] = jnp.asarray(phi0)
            hs.append([r[1] for r in m.advance(5)])
        print(f"electric prisms, 5 outers: max rel difference "
              f"{spread(*hs):.3e}", flush=True)
    if "goldens" in cases:
        _goldens(jfvm, JFlow, spread)
    if "newton" not in cases:
        if "poiseuille" in cases:
            _poiseuille(JFlow, jfvm, spread)
        return 0
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
    if "poiseuille" in cases:
        _poiseuille(JFlow, jfvm, spread)
    return 0


def _golden_solver(family):
    """A family's solver as ``tests/test_golden_histories.py:44-86``."""
    from fvm_tpu.linear import BiCGStab, JacobiSolver
    from fvm_tpu.linear.ilu import ILU0Solver
    from fvm_tpu.linear.spike import SpikeSolver

    if family == "JACOBI":
        return JacobiSolver(sweeps=60)
    pre = {"ILU0": ILU0Solver, "SPIKE": SpikeSolver}[family]()
    return BiCGStab(preconditioner=pre, relative_tolerance=1e-3,
                    max_iterations=200)


def _goldens(jfvm, JFlow, spread):
    import json
    import os
    from fvm_tpu.models import ThermalModel

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens", "histories.json")
    with open(path) as f:
        pinned = json.load(f)
    for family in ("ILU0", "SPIKE", "JACOBI"):
        hs = []
        for eps in (0.0, 1e-15):
            m = JFlow(jfvm.mesh.build_device_mesh(
                jfvm.mesh.generate.quad_2d(32, 32)))
            m.options["verbose"] = False
            m.vc["density"] = 1.0
            m.vc["viscosity"] = 0.1 * (1 + eps)
            for s_ in ("left", "right", "bottom", "top"):
                m.bc[s_].bc_type = "NoSlipWall"
            m.bc["top"]["specifiedXVelocity"] = 1.0
            m.options["pressureLinearSolver"] = _golden_solver(family)
            m.init()
            hs.append([[r[1], r[2]] for r in m.advance(30)])
        key = f"cavity/{family}/np1"
        print(f"{key}: max rel difference {spread(*hs):.3e}; unperturbed "
              f"run vs the pinned golden {spread(pinned[key], hs[0]):.3e}",
              flush=True)
        if family == "JACOBI":
            continue
        hs = []
        for eps in (0.0, 1e-15):
            t = ThermalModel(jfvm.mesh.build_device_mesh(
                jfvm.mesh.generate.quad_2d(32, 32)))
            t.options["verbose"] = False
            s_ = _golden_solver(family)
            s_.relativeTolerance = 5e-2
            s_.nMaxIterations = min(s_.nMaxIterations, 8)
            t.options["linearSolver"] = s_
            t.bc["left"].bc_type = "SpecifiedTemperature"
            t.bc["left"]["specifiedTemperature"] = 400.0 * (1 + eps)
            t.bc["right"].bc_type = "SpecifiedTemperature"
            t.bc["right"]["specifiedTemperature"] = 300.0
            t.bc["bottom"].bc_type = "Symmetry"
            t.bc["top"].bc_type = "Symmetry"
            t.init()
            hs.append([[r[1]] for r in t.advance(10)])
        key = f"thermal/{family}/np1"
        print(f"{key}: max rel difference {spread(*hs):.3e}; unperturbed "
              f"run vs the pinned golden {spread(pinned[key], hs[0]):.3e}",
              flush=True)


def _poiseuille(JFlow, jfvm, spread):
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


if __name__ == "__main__":
    raise SystemExit(main())
