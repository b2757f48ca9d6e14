"""How far the JAX package's own residual histories move under round-off.

    python3 -m scripts.roundoff_sensitivity [--cases newton,poiseuille,
        ib,ib_stencil,channel,homocase,electric,goldens,goldens_dist,
        structures,transport,ke,battery,charging,kinetic,phonon]

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
* ``ib_stencil``: the flow cylinder of the port's ``cases.ib_cylinder``
  (a 1024-gon of radius 0.1 at (0.4, 0.5) in quad_2d(24, 24), the solid
  pinned, the IB band's momentum rows the implicit interpolation
  stencil; inlet, outlet, walls; float64), the viscosity scaled: the
  first ``IBS_OUTERS`` SIMPLE outers with bench's cavity solvers and with
  tight ones (momentum ``BiCGStab(1e-12, 60)``, AMG to 1e-12 in 60
  cycles);
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
  also against its pinned history in ``tests/goldens/histories.json``;
* ``goldens_dist``: the sharded golden configurations of
  ``tests/test_golden_histories.py:43-143`` on 8 virtual CPU devices (the
  script sets ``--xla_force_host_platform_device_count=8`` before it
  imports jax): ``cavity/<family>/np4`` for the six families (30 SIMPLE
  outers, the viscosity scaled) and ``thermal/<family>/np8`` for AMG, ILU0
  and SPIKE (10 outers, the left wall temperature scaled), each also
  against its pinned history;
* ``structures``: the JFNK models with their default inner solves and
  with inner solves at 1e-12: the cantilever of ``demos/cantilever_uq.py``
  (40 x 6, 15 outers, the end traction scaled), the plate strip of
  ``tests/test_plate.py:42`` (30 x 4, 8 outers, the load scaled): the
  residual histories and the largest relative change of the deformation;
  and the MEMS switch of ``tests/test_mems.py`` (nx 24, ny_gap 12, the
  Young's modulus scaled): the lumped stiffness and w_max at 0.3 and 0.6
  V_PI.
* ``transport``: the charge-transport cases of
  ``tests/test_electric_species.py:60-295`` (drift, injection with traps,
  trap-band tunneling, Poole-Frenkel at 100 V), the right (or left) wall
  potential scaled: the charge and the traps after their time steps;
* ``ke``: the three cases of ``tests/test_ke.py``, the initial k scaled:
  k and eps after their time steps;
* ``battery``: the cells of ``tests/test_battery.py`` (the sandwich at 3.75
  V, steady and transient; the double-shell cell, steady and transient),
  the applied potential or current scaled, with the default inner solve
  and with one at 1e-12: the histories' length, their entries and the
  final unknowns;
* ``charging``: the dielectric column stand-in of ``DielectricCharging
  Model`` (``hex_3d(1, 1, 150)``, 200 nm, 5 steps of the reference script's loop),
  the membrane voltage scaled: the (time, trapped, band) history.
* ``kinetic``: the ES-BGK cases: the Couette of
  ``tests/test_torch_kinetic_solve.py`` (quad_2d(3, 6), Q(6, 6, 4), tau
  scaled; COMET with the inner solve at 1e-12 in BGK and ES-BGK, and
  Picard; 2 outers); ``demos/esbgk_couette.py``'s (quad_2d(3, 32), Q(8, 8,
  4), ES-BGK, 20 of its 80 outers) and the small COMET Couette of
  ``tests/test_comet.py:16`` (quad_2d(3, 10), Q(6, 6, 4), BGK, 12
  outers), the top wall velocity scaled; the thick heat transfer of
  ``tests/test_comet.py:158-191`` (quad_2d(48, 3), 8 outers, with and
  without the DSA), the hot wall temperature scaled; the damping driver's
  fallback (``demos/esbgk_damping.py``, quad_2d(24, 8), Q(10, 10, 10), 2
  time steps of ``advance(5)``), the relaxation time scaled (a 1e-15
  change of the beam's 0.00594 is lost in c - u); the immersed moving
  plate of ``tests/test_kinetic.py:690`` (quad_2d(16, 16), Q(8, 8, 4),
  inner solves at 1e-12, 2 outers), the relaxation time scaled: the
  residual histories, the interior distribution after the first outer and
  at the end, and the beam force.
* ``phonon``: the phonon BTE (``fvm_tpu/kinetic/phonon.py``), the hot
  wall temperature scaled: the gray slab of
  ``tests/test_torch_phonon_solve.py`` (quad_2d(8, 4), S_N(2, 4), tau
  0.1, COMET at the default inner solve and at 1e-12, and Picard), the
  two-band and the scattering-matrix slabs of
  ``tests/test_phonon_walls.py`` (quad_2d(10, 6)), the ballistic
  two-material slab (quad_2d(12, 4) over 2 x 1, DMM) and the thick slab of
  ``tests/test_comet.py:110-156`` (quad_2d(32, 4) and (64, 4), 6 outers,
  with and without the DSA): the residual histories, the interior energy
  after the first outer and at the end.

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


IBS_N, IBS_OUTERS = 24, 40
IBS_SEGMENTS, IBS_CENTER, IBS_RADIUS = 1024, (0.4, 0.5), 0.1


def ib_cylinder_jax(jfvm, n=IBS_N, solvers=BENCH, mu_scale=1.0):
    """The JAX package's twin of the port's ``cases.ib_cylinder(n,
    dtype="float64")`` (float64), with the given solver tolerances:
    (flow, IBManager, stencil)."""
    import jax.numpy as jnp
    from fvm_tpu.geom import IBManager, IBType
    from fvm_tpu.linear import AMG, BiCGStab
    from fvm_tpu.models import FlowModel

    mesh = jfvm.mesh.generate.quad_2d(n, n)
    ibm = IBManager(mesh)
    th = np.linspace(0, 2 * np.pi, IBS_SEGMENTS + 1)[:-1]
    verts = np.stack([IBS_CENTER[0] + IBS_RADIUS * np.cos(th),
                      IBS_CENTER[1] + IBS_RADIUS * np.sin(th)], 1)
    elems = np.stack([np.arange(IBS_SEGMENTS),
                      (np.arange(IBS_SEGMENTS) + 1) % IBS_SEGMENTS], 1)
    t = ibm.update(verts, elems)
    solid = t[: mesh.n_interior_cells] == IBType.SOLID
    f = FlowModel(jfvm.mesh.build_device_mesh(mesh, dtype=jnp.float64))
    f.options["verbose"] = False
    f.vc["viscosity"] = 1.0 * mu_scale
    amg_tol, amg_it = solvers["amg"]
    f.options["pressureLinearSolver"] = AMG(
        coarse_size=256, relative_tolerance=amg_tol, max_iterations=amg_it)
    f.options["momentumLinearSolver"] = BiCGStab(
        relative_tolerance=solvers["mom"][0],
        max_iterations=solvers["mom"][1])
    f.bc["left"].bc_type = "VelocityBoundary"
    f.bc["left"]["specifiedXVelocity"] = 1.0
    f.bc["right"].bc_type = "PressureBoundary"
    f.bc["top"].bc_type = "NoSlipWall"
    f.bc["bottom"].bc_type = "NoSlipWall"
    f.init()
    st = ibm.interpolation_stencil()
    f.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid, stencil=st)
    return f, ibm, st


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
    if "goldens_dist" in cases:
        # the sharded goldens need 8 devices: virtual CPU devices, set
        # before jax is first imported
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
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
    if "ib_stencil" in cases:
        for label, solvers in (("bench's solvers", BENCH),
                               ("tight solvers", TIGHT)):
            hs = []
            for eps in (0.0, 1e-15):
                f, _, _ = ib_cylinder_jax(jfvm, IBS_N, solvers, 1 + eps)
                hs.append([[r[1], r[2]] for r in f.advance(IBS_OUTERS)])
            print(f"IB-stencil cylinder {IBS_N}^2, {label}: {IBS_OUTERS} "
                  f"SIMPLE outers max rel difference {spread(*hs):.3e}, "
                  f"first 10 {spread(hs[0][:10], hs[1][:10]):.3e}",
                  flush=True)
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
    if "goldens_dist" in cases:
        _goldens_dist(jfvm, JFlow, spread)
    if "structures" in cases:
        _structures(jfvm, spread)
    if "battery" in cases:
        _battery(jfvm, spread)
    if "transport" in cases:
        _transport(jfvm)
    if "ke" in cases:
        _ke(jfvm)
    if "charging" in cases:
        _charging()
    if "kinetic" in cases:
        _kinetic(jfvm)
    if "phonon" in cases:
        _phonon(jfvm)
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


def _dist_golden_solver(family, part):
    """A family's sharded solver as ``tests/test_golden_histories.py:
    44-86`` builds it for ``dist``."""
    from fvm_tpu.linear import AMG, BiCGStab, CG, JacobiSolver
    from fvm_tpu.linear.ilu import ILU0Solver
    from fvm_tpu.linear.spike import SpikeSolver

    if family == "AMG":
        s = AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=30)
        sm = part.sharded_mesh
        assert s.setup_structure_dist(
            np.asarray(sm.cf_nbr).transpose(0, 2, 1),
            np.asarray(sm.cf_mask).transpose(0, 2, 1), sm.n_owned_cells)
        return s
    if family == "JACOBI":
        return JacobiSolver(sweeps=60)
    if family == "SPIKE":
        pre = SpikeSolver()
        pre.setup_structure_dist(part)
    else:
        pre = {"BCGStab": lambda: JacobiSolver(sweeps=3),
               "CG": lambda: JacobiSolver(sweeps=3),
               "ILU0": ILU0Solver}[family]()
    cls = CG if family == "CG" else BiCGStab
    return cls(preconditioner=pre, relative_tolerance=1e-3,
               max_iterations=200)


def _goldens_dist(jfvm, JFlow, spread):
    import json
    import os
    from fvm_tpu.models import ThermalModel
    from fvm_tpu.parallel import Partition

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens", "histories.json")
    with open(path) as f:
        pinned = json.load(f)
    quad = jfvm.mesh.generate.quad_2d
    for family in ("AMG", "BCGStab", "CG", "ILU0", "JACOBI", "SPIKE"):
        hs = []
        for eps in (0.0, 1e-15):
            part = Partition(quad(32, 32), 4)
            m = JFlow(part.sharded_mesh, partition=part)
            m.options["verbose"] = False
            m.vc["density"] = 1.0
            m.vc["viscosity"] = 0.1 * (1 + eps)
            for s_ in ("left", "right", "bottom", "top"):
                m.bc[s_].bc_type = "NoSlipWall"
            m.bc["top"]["specifiedXVelocity"] = 1.0
            m.options["pressureLinearSolver"] = _dist_golden_solver(
                family, part)
            m.init()
            hs.append([[float(r[1]), float(r[2])] for r in m.advance(30)])
        key = f"cavity/{family}/np4"
        print(f"{key}: max rel difference {spread(*hs):.3e}; unperturbed "
              f"run vs the pinned golden {spread(pinned[key], hs[0]):.3e}",
              flush=True)
    for family in ("AMG", "ILU0", "SPIKE"):
        hs = []
        for eps in (0.0, 1e-15):
            part = Partition(quad(32, 32), 8)
            t = ThermalModel(part.sharded_mesh, partition=part)
            t.options["verbose"] = False
            s_ = _dist_golden_solver(family, part)
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
            hs.append([[float(r[1])] for r in t.advance(10)])
        key = f"thermal/{family}/np8"
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


def _structures(jfvm, spread):
    """The ``structures`` case: each configuration from inputs 1e-15
    apart, with the default inner solve and with one at 1e-12."""
    import runpy
    from pathlib import Path

    from fvm_tpu.linear import BiCGStab, JacobiSolver
    from fvm_tpu.models import PlateModel, StructureModel

    def cantilever(eps, tight):
        dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(
            40, 6, lx=1.0, ly=0.1))
        m = StructureModel(dm)
        m.options["verbose"] = False
        m.vc["youngsModulus"] = 1e9
        m.vc["poissonsRatio"] = 0.0
        m.bc["left"].bc_type = "SpecifiedDeformation"
        m.bc["right"].bc_type = "SpecifiedTraction"
        m.bc["right"]["specifiedYTraction"] = -1e4 * (1 + eps)
        m.bc["top"].bc_type = "ZeroTraction"
        m.bc["bottom"].bc_type = "ZeroTraction"
        if tight:
            m.options["linearSolver"] = BiCGStab(
                preconditioner=JacobiSolver(sweeps=3),
                relative_tolerance=1e-12, max_iterations=1000)
        m.init()
        return [r[1] for r in m.advance(15)], m.getDeformation()

    def plate(eps, tight):
        dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(
            30, 4, lx=1.0, ly=0.2))
        m = PlateModel(dm)
        m.options["verbose"] = False
        m.vc["ym"] = 1e9
        m.vc["nu"] = 0.0
        m.vc["thickness"] = 0.02
        m.vc["pressure"] = 100.0 * (1 + eps)
        m.bc["left"].bc_type = "Clamped"
        m.bc["right"].bc_type = "Free"
        m.bc["bottom"].bc_type = "Symmetry"
        m.bc["top"].bc_type = "Symmetry"
        if tight:
            m.options["linearSolver"] = BiCGStab(
                preconditioner=JacobiSolver(sweeps=3),
                relative_tolerance=1e-12, max_iterations=1000)
        m.init()
        return [r[1] for r in m.advance(8)], m.getDeflection()

    for name, fn in (("cantilever 40x6", cantilever),
                     ("plate strip 30x4", plate)):
        for tight in (False, True):
            (h0, w0), (h1, w1) = fn(0.0, tight), fn(1e-15, tight)
            n = min(len(h0), len(h1))
            print(f"{name}, {'inner 1e-12' if tight else 'default inner'}:"
                  f" outers {len(h0)}/{len(h1)}, history max rel "
                  f"difference {spread(h0[:n], h1[:n]):.3e}; deformation "
                  f"{float(np.abs(w0 - w1).max() / np.abs(w0).max()):.3e}",
                  flush=True)

    demo = Path(__file__).resolve().parent.parent / "demos" / \
        "simulator_mems.py"
    mod = runpy.run_path(str(demo))
    rows = []
    for eps in (0.0, 1e-15):
        sw = mod["MemsSwitch"](nx=24, ny_gap=12, E=160e3 * (1 + eps))
        k = sw.lumped_stiffness()
        V = np.sqrt(8.0 * k * sw.g0**3 / (27.0 * mod["EPS0"] * sw.L * sw.W))
        rows.append([k] + [float(sw.static_deflection(f * V).max())
                           for f in (0.3, 0.6)])
    print(f"MEMS switch nx 24: k, w_max(0.3 V_PI), w_max(0.6 V_PI) "
          f"{rows[0]} / {rows[1]}; max rel difference "
          f"{spread(rows[0], rows[1]):.3e}", flush=True)


def _rel(a, b):
    """max |a - b| over max |a| (0 where both are 0)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _transport(jfvm):
    """The ``transport`` case (module docstring)."""
    import jax.numpy as jnp
    from fvm_tpu.models.electric import EPS0, ElectricModel

    cases = {
        "drift": ((16, 4), 1.0, {"timeStep": 1e-2},
                  {"initialCharge": 1e-12, "mobility": 1.0,
                   "diffusivity": 1e-3}, (10.0, 0.0), 3, 3),
        "injection": ((12, 4), 1.0, {"timeStep": 0.1,
                                     "injection_enable": True,
                                     "trapping_enable": True},
                      {"dielectric_constant": 1.0 / EPS0,
                       "initialCharge": 1e-15, "mobility": 1e-3,
                       "diffusivity": 1e-4, "injectionA": 1e-5,
                       "injectionB": 5.0, "trapDensity": 1.0,
                       "captureCoefficient": 0.5,
                       "emissionCoefficient": 0.01}, (50.0, 0.0), 5, 3),
        "trap-band tunneling": (
            (40, 2), 0.05, {"timeStep": 0.01, "trapping_enable": True,
                            "trapbandtunneling_enable": True},
            {"dielectric_constant": 1.0 / EPS0, "mobility": 0.0,
             "diffusivity": 1e-6, "trapDensity": 1.0, "trapDepth": 2.0,
             "wkbFactor": -3.0, "tunnelingRateScale": 1.0}, (0.0, 10.0), 5,
            2),
        "Poole-Frenkel 100 V": (
            (12, 4), 1.0, {"timeStep": 0.02, "trapping_enable": True,
                           "poole_frenkel_enable": True},
            {"dielectric_constant": 1.0 / EPS0, "initialTrappedCharge": 1.0,
             "mobility": 1e-6, "diffusivity": 1e-6, "trapDensity": 1.0,
             "emissionCoefficient": 0.01, "emissionFrequency": 1.0,
             "trapDepth": 1.5, "pfBeta": 0.15, "thermalVoltage": 0.5},
            (100.0, 0.0), 10, 3),
    }
    for name, (shape, ly, opts, vc, bias, steps, inner) in cases.items():
        out = []
        for eps in (0.0, 1e-15):
            dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(
                *shape, ly=ly))
            m = ElectricModel(dm)
            m.options["verbose"] = False
            m.options["chargetransport_enable"] = True
            m.options["transient"] = True
            for k, v in opts.items():
                m.options[k] = v
            for k, v in vc.items():
                m.vc[k] = v
            for g, V in zip(("left", "right"), bias):
                m.bc[g].bc_type = "SpecifiedPotential"
                m.bc[g]["specifiedPotential"] = V * (1 + eps)
            m.bc["bottom"].bc_type = "Symmetry"
            m.bc["top"].bc_type = "Symmetry"
            m.init()
            if name == "trap-band tunneling":
                x = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
                full = np.zeros(dm.n_cells)
                full[: len(x)] = np.where(x < 0.3, 0.5, 0.0)
                m.state["trapped"] = m.state["trapped_N1"] = jnp.asarray(full)
            for _ in range(steps):
                m.advance(inner)
                m.updateTime()
            out.append((m.getCharge(), m.getTrappedCharge()))
        (c0, t0), (c1, t1) = out
        print(f"charge transport, {name}: charge max rel difference "
              f"{_rel(c0, c1):.3e}, traps {_rel(t0, t1):.3e}", flush=True)


def _ke(jfvm):
    """The ``ke`` case (module docstring)."""
    import jax.numpy as jnp
    from fvm_tpu.models.ke import KeModel

    sym = {g: ("Symmetry", {}) for g in ("left", "right", "bottom", "top")}
    wall = {"bottom": ("Wall", {}),
            "top": ("SpecifiedKE", {"specifiedK": 0.1, "specifiedE": 0.3}),
            "left": ("Symmetry", {}), "right": ("Symmetry", {})}
    cases = {"decay": ((4, 4), 0.002, 1.0, 2.0, sym, {}, 0.0, 50, 4),
             "shear": ((4, 4), 0.002, 1.0, 2.0, sym, {}, 1.0, 20, 3),
             "wall functions": ((4, 16), 0.01, 0.1, 0.3, wall,
                                {"viscosity": 1e-4}, 2.0, 10, 3)}
    for name, (shape, dt, k0, e0, bcs, vc, shear, steps, inner) in \
            cases.items():
        out = []
        for eps in (0.0, 1e-15):
            dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(
                *shape))
            m = KeModel(dm)
            m.options["verbose"] = False
            m.options["transient"] = True
            m.options["timeStep"] = dt
            m.vc["initialK"] = k0 * (1 + eps)
            m.vc["initialE"] = e0
            for k, v in vc.items():
                m.vc[k] = v
            for g, (t, vals) in bcs.items():
                m.bc[g].bc_type = t
                for k, v in vals.items():
                    m.bc[g][k] = v
            m.init()
            if shear:
                cc = dm.cell_centroid
                m.set_flow_state(velocity=jnp.stack(
                    [shear * cc[:, 1], jnp.zeros(dm.n_cells)], axis=1))
            for _ in range(steps):
                m.advance(inner)
                m.updateTime()
            out.append((m.getK(), m.getEpsilon()))
        (k_0, e_0), (k_1, e_1) = out
        print(f"k-epsilon, {name}: k max rel difference {_rel(k_0, k_1):.3e},"
              f" eps {_rel(e_0, e_1):.3e}", flush=True)


def _charging():
    """The ``charging`` case (module docstring)."""
    from fvm_tpu.mesh.generate import hex_3d
    from fvm_tpu.models.charging import (DielectricChargingConstants,
                                         DielectricChargingModel)

    n, steps = 150, 5
    hs = []
    for eps in (0.0, 1e-15):
        h = 200e-9 / n
        m = DielectricChargingModel(
            hex_3d(1, 1, n, lx=h, ly=h, lz=200e-9), "zmin", "zmax",
            constants=DielectricChargingConstants(
                membrane_voltage=100.0 * (1 + eps)))
        m.init()
        hs.append(m.advance_transient(steps, 1e-9, 1.1))
    print(f"dielectric column hex_3d(1, 1, {n}), {steps} time steps: "
          f"(avg trapped, avg band) max rel difference "
          f"{_rel(hs[0][:, 1], hs[1][:, 1]):.3e}, "
          f"{_rel(hs[0][:, 2], hs[1][:, 2]):.3e}", flush=True)


def _battery(jfvm, spread):
    """The ``battery`` case (module docstring)."""
    from fvm_tpu.linear import BiCGStab, JacobiSolver
    from fvm_tpu.mesh.metrics import compute_geometry
    from fvm_tpu.models.battery import BatteryModel

    def sandwich(eps, transient):
        dm = jfvm.mesh.build_device_mesh(jfvm.mesh.generate.quad_2d(30, 2))
        m = BatteryModel(dm)
        m.options["verbose"] = False
        if transient:
            m.options["transient"] = True
            m.options["timeStep"] = 5.0
        x = np.asarray(dm.cell_centroid)[: dm.n_interior_cells, 0]
        m.set_material_regions(np.where(x < 1 / 3, 0,
                                        np.where(x < 2 / 3, 1, 2)))
        m.bc["left"].bc_type = "SpecifiedPotential"
        m.bc["left"]["specifiedPotential"] = 0.0
        m.bc["right"].bc_type = "SpecifiedPotential"
        m.bc["right"]["specifiedPotential"] = 3.75 * (1 + eps)
        m.bc["bottom"].bc_type = "Symmetry"
        m.bc["top"].bc_type = "Symmetry"
        return m

    def shell(eps, transient):
        m = jfvm.mesh.generate.quad_2d(16, 4, lx=2.0, ly=1.0)
        left = compute_geometry(m).cell_centroid[: m.n_interior_cells, 0] \
            < 1.0
        m2 = m.make_interface("sep", m.interface_faces_between(left, ~left),
                              left_cells=left)
        b = BatteryModel(jfvm.mesh.build_device_mesh(m2))
        b.options["verbose"] = False
        if transient:
            b.options["transient"] = True
            b.options["timeStep"] = 20.0
        xc = compute_geometry(m2).cell_centroid[: m2.n_interior_cells, 0]
        b.set_material_regions(np.where(xc < 1.0, 1, 2))
        b.vc["conductivity"] = (100.0, 1.0, 10.0)
        b.vc["diffusivity"] = (1e-2, 1e-2, 1e-2)
        b.bc["left"].bc_type = "SpecifiedPotential"
        b.bc["left"]["specifiedPotential"] = 0.0
        b.bc["right"].bc_type = "SpecifiedCurrent"
        b.bc["right"]["specifiedCurrent"] = 5.0 * (1 + eps)
        b.bc["top"].bc_type = "Symmetry"
        b.bc["bottom"].bc_type = "Symmetry"
        return b

    for name, make, niter in (("sandwich", sandwich, 25),
                              ("double shell", shell, 25)):
        for transient in (False, True):
            for tight in (False, True):
                runs = []
                for eps in (0.0, 1e-15):
                    m = make(eps, transient)
                    if tight:
                        m.options["linearSolver"] = BiCGStab(
                            preconditioner=JacobiSolver(sweeps=3),
                            relative_tolerance=1e-12, max_iterations=600)
                    m.init()
                    h = [r[1] for r in m.advance(niter)]
                    u = np.concatenate([m.getPotential(),
                                        m.getConcentration()])
                    runs.append((h, u))
                (h0, u0), (h1, u1) = runs
                n = min(len(h0), len(h1))
                print(f"battery {name}, "
                      f"{'transient' if transient else 'steady'}, "
                      f"{'inner 1e-12' if tight else 'default inner'}: "
                      f"outers {len(h0)}/{len(h1)}, history max rel "
                      f"difference {spread(h0[:n], h1[:n]):.3e}; unknowns "
                      f"{float(np.abs(u0 - u1).max() / np.abs(u0).max()):.3e}",
                      flush=True)


def _kinetic(jfvm):
    """The ``kinetic`` case (module docstring)."""
    from fvm_tpu.kinetic import KineticModel, Quadrature

    def couette(eps, nx, ny, quad, coll):
        m = KineticModel(jfvm.mesh.build_device_mesh(
            jfvm.mesh.generate.quad_2d(nx, ny)), Quadrature(*quad))
        m.options["verbose"] = False
        m.options["collisionModel"] = coll
        m.vc["relaxationTime"] = 0.1 if coll == "ESBGK" else 0.2
        m.bc["top"].bc_type = "DiffuseWall"
        m.bc["top"]["specifiedXVelocity"] = 0.3 * (1 + eps)
        m.bc["bottom"].bc_type = "DiffuseWall"
        m.bc["bottom"]["specifiedXVelocity"] = -0.3
        m.bc["left"].bc_type = "Symmetry"
        m.bc["right"].bc_type = "Symmetry"
        m.init()
        return m

    def thick(eps, dsa):
        mesh = jfvm.mesh.generate.quad_2d(48, 3)
        mesh.make_periodic("bottom", "top")
        m = KineticModel(jfvm.mesh.build_device_mesh(mesh),
                         Quadrature(8, 8, 4))
        m.options["verbose"] = False
        m.options["innerIterations"] = 60
        m.options["innerTolerance"] = 1e-9
        m.options["coarseAcceleration"] = dsa
        m.vc["relaxationTime"] = 0.01
        m.bc["left"].bc_type = "DiffuseWall"
        m.bc["left"]["specifiedTemperature"] = 1.1 * (1 + eps)
        m.bc["right"].bc_type = "DiffuseWall"
        m.bc["right"]["specifiedTemperature"] = 0.9
        m.bc["bottom"].bc_type = "Periodic"
        m.bc["top"].bc_type = "Periodic"
        m.init()
        return m

    def run(label, make, outers):
        hs, f1, fe = [], [], []
        for eps in (0.0, 1e-15):
            m = make(eps)
            n = m.mesh.n_interior_cells
            h = [r[1] for r in m.advance(1)]
            f1.append(np.asarray(m.state["f"])[:n])
            h += [r[1] for r in m.advance(outers - 1)]
            hs.append(h)
            fe.append(np.asarray(m.state["f"])[:n])
        n = min(len(hs[0]), len(hs[1]))
        per = ", ".join(f"{_rel(a, b):.1e}" for a, b in zip(hs[0][:n],
                                                             hs[1][:n]))
        print(f"{label}: outers {len(hs[0])}/{len(hs[1])}, history rel "
              f"difference by outer [{per}]; f after one outer "
              f"{_rel(*f1):.3e}, at the end {_rel(*fe):.3e}", flush=True)

    def small(eps, coll, solver):
        m = couette(0.0, 3, 6, (6, 6, 4), coll)
        m.vc["relaxationTime"] = 0.2 * (1 + eps)
        m.options["solver"] = solver
        if solver == "COMET":
            m.options["innerTolerance"] = 1e-12
            m.options["innerIterations"] = 200
        m.init()
        return m

    for coll, solver in (("BGK", "COMET"), ("ESBGK", "COMET"),
                         ("ESBGK", "sweep")):
        run(f"Couette quad_2d(3, 6) Q(6,6,4) {coll} {solver}"
            + (", inner 1e-12" if solver == "COMET" else "") + ", 2 outers",
            lambda e, c=coll, s=solver: small(e, c, s), 2)
    run("Couette quad_2d(3, 10) Q(6,6,4) BGK COMET, 12 outers",
        lambda e: couette(e, 3, 10, (6, 6, 4), "BGK"), 12)
    run("Couette demo quad_2d(3, 32) Q(8,8,4) ES-BGK, 20 outers",
        lambda e: couette(e, 3, 32, (8, 8, 4), "ESBGK"), 20)
    for dsa in (True, False):
        run(f"thick quad_2d(48, 3), DSA {'on' if dsa else 'off'}, 8 outers",
            lambda e, dsa=dsa: thick(e, dsa), 8)
    def plate(eps):
        m = KineticModel(jfvm.mesh.build_device_mesh(
            jfvm.mesh.generate.quad_2d(16, 16)), Quadrature(8, 8, 4))
        m.options["verbose"] = False
        m.options["innerTolerance"] = 1e-12
        m.options["innerIterations"] = 200
        m.vc["relaxationTime"] = 0.2 * (1 + eps)
        for s in ("left", "right", "bottom", "top"):
            m.bc[s].bc_type = "DiffuseWall"
        m.init()
        cc = np.asarray(m.mesh.cell_centroid)[: m.mesh.n_interior_cells]
        m.set_immersed_boundary(
            (np.abs(cc[:, 0] - 0.5) < 0.25) & (np.abs(cc[:, 1] - 0.5) < 0.1),
            wall_velocity=(0.2, 0.0, 0.0))
        return m

    run("immersed plate quad_2d(16, 16) Q(8,8,4) COMET, inner 1e-12, 2 "
        "outers", plate, 2)
    rows = []
    for eps in (0.0, 1e-15):
        m = KineticModel(jfvm.mesh.build_device_mesh(
            jfvm.mesh.generate.quad_2d(24, 8, lx=3.0, ly=1.0)),
            Quadrature(10, 10, 10))
        m.options["verbose"] = False
        m.options["collisionModel"] = "ESBGK"
        m.options["transient"] = True
        m.options["timeStep"] = 0.5e-2
        m.vc["relaxationTime"] = 0.2 * (1 + eps)
        m.bc["top"].bc_type = "DiffuseWall"
        m.bc["top"]["specifiedYVelocity"] = -0.0297 * 0.2
        m.bc["bottom"].bc_type = "DiffuseWall"
        m.bc["left"].bc_type = "Symmetry"
        m.bc["right"].bc_type = "PressureInlet"
        m.bc["right"]["specifiedPressure"] = 1.0
        m.init()
        h = []
        for _ in range(2):
            h += [r[1] for r in m.advance(5)]
            m.updateTime()
        rows.append((h, np.asarray(m.state["f"]),
                     m.getMomentumFluxIntegral("top")))
    (h0, f0, F0), (h1, f1, F1) = rows
    n = min(len(h0), len(h1))
    print(f"damping fallback quad_2d(24, 8) Q(10,10,10), 2 steps: history "
          f"rel difference by outer [" + ", ".join(
              f"{_rel(a, b):.1e}" for a, b in zip(h0[:n], h1[:n]))
          + f"]; f {_rel(f0, f1):.3e}; beam force {_rel(F0, F1):.3e}",
          flush=True)


def _phonon(jfvm):
    """The ``phonon`` case (module docstring)."""
    import fvm_tpu.mesh.metrics as metrics
    from fvm_tpu.kinetic.phonon import (PhononModel, detailed_balance_correct,
                                        rta_scattering_matrix, sn_directions)

    def slab(eps, mesh, dirs=(4, 8), opts=None, tau=None, **kw):
        m = PhononModel(jfvm.mesh.build_device_mesh(mesh), *dirs, **kw)
        m.options["verbose"] = False
        for k, v in (opts or {}).items():
            m.options[k] = v
        if tau is not None:
            m.vc["relaxationTime"] = tau
        m.bc["left"].bc_type = "Isothermal"
        m.bc["left"]["specifiedTemperature"] = 310.0 * (1 + eps)
        m.bc["right"].bc_type = "Isothermal"
        m.bc["right"]["specifiedTemperature"] = 300.0
        m.bc["top"].bc_type = "Symmetry"
        m.bc["bottom"].bc_type = "Symmetry"
        m.init()
        return m

    def run(label, make, outers):
        hs, e1, ee = [], [], []
        for eps in (0.0, 1e-15):
            m = make(eps)
            n = m.mesh.n_interior_cells
            h = [r[1] for r in m.advance(1)]
            e1.append(np.asarray(m.state["e"])[:n])
            h += [r[1] for r in m.advance(outers - 1)]
            hs.append(h)
            ee.append(np.asarray(m.state["e"])[:n])
        n = min(len(hs[0]), len(hs[1]))
        per = ", ".join(f"{_rel(a, b):.1e}" for a, b in zip(hs[0][:n],
                                                             hs[1][:n]))
        print(f"{label}: outers {len(hs[0])}/{len(hs[1])}, history rel "
              f"difference by outer [{per}]; e after one outer "
              f"{_rel(*e1):.3e}, at the end {_rel(*ee):.3e}", flush=True)

    q = jfvm.mesh.generate.quad_2d
    for label, opts in (("COMET", {}),
                        ("COMET inner 1e-12", {"innerTolerance": 1e-12,
                                               "innerIterations": 300}),
                        ("Picard", {"solver": "sweep"})):
        run(f"gray slab quad_2d(8, 4) S_N(2, 4) {label}, 4 outers",
            lambda e, o=opts: slab(e, q(8, 4), (2, 4), o, 0.1), 4)
    bands = [(0.6, 3.0, 0.02), (0.4, 1.0, 0.2)]
    run("two-band slab quad_2d(10, 6), 4 outers",
        lambda e: slab(e, q(10, 6), bands=bands), 4)
    M = detailed_balance_correct(
        rta_scattering_matrix(0.1, D=32)
        + 0.3 * np.random.default_rng(5).random((32, 32)) / 32,
        sn_directions(4, 8)[1])
    run("scattering-matrix slab quad_2d(10, 6), 4 outers",
        lambda e: slab(e, q(10, 6), opts={"coarseAcceleration": False,
                                          "innerIterations": 400},
                       scattering_matrix=M), 4)

    def two(eps):
        mesh = q(12, 4, lx=2.0, ly=1.0)
        xc = metrics.compute_geometry(mesh).cell_centroid[
            : mesh.n_interior_cells, 0]
        left = xc < 1.0
        m2 = mesh.make_interface(
            "mid", mesh.interface_faces_between(left, ~left),
            left_cells=left)
        return slab(eps, m2, opts={"coarseAcceleration": False,
                                   "innerIterations": 200},
                    bands=[(np.where(left, 1.0, 3.0), 1.0, 1e8)])

    run("two-material slab quad_2d(12, 4), ballistic, 4 outers", two, 4)
    for nx in (32, 64):
        for dsa in (True, False):
            run(f"thick slab quad_2d({nx}, 4), DSA {'on' if dsa else 'off'}"
                f", 6 outers", lambda e, nx=nx, dsa=dsa: slab(
                    e, q(nx, 4), opts={"innerIterations": 20,
                                       "innerTolerance": 1e-9,
                                       "coarseAcceleration": dsa},
                    tau=0.01), 6)


if __name__ == "__main__":
    raise SystemExit(main())

