"""The flagship workload: the coupled lid-driven cavity, in 2D and 3D.

The configuration of the JAX package's ``bench.py:main()``: a lid-driven
cavity ``FlowModel`` on ``quad_2d(n, n)`` (viscosity 0.01, lid u = 1,
SIMPLE with pressure ``AMG(coarse_size=256, rtol=1e-3, max 6 cycles)`` and
momentum ``BiCGStab(rtol=1e-2, max 10)``) coupled one way to a convective
``ThermalModel`` (walls 400 / 300, symmetry top and bottom, the same AMG
settings) that convects with the flow's face mass flux.  One outer step
is one flow SIMPLE step, the mass-flux handoff and one thermal step.

``coupled_cavity_3d`` is its 3D counterpart on ``hex_3d(n, n, n)`` with the
same solver settings: the lid is ``zmax`` moving in +x (as in
``tests/test_flow.py:266-286``), the thermal walls are 400 on ``xmin`` and
300 on ``xmax`` with symmetry elsewhere.  Its row graph is no tensor-product
grid, so both AMG solvers build greedy-aggregation hierarchies.
"""

from __future__ import annotations

from .linear import AMG, BiCGStab
from .mesh import build_device_mesh
from .mesh.generate import hex_3d, quad_2d
from .models import FlowModel, ThermalModel


# boundary groups of the cavity meshes: (walls, lid, hot wall, cold wall)
_WALLS = {
    2: (("left", "right", "bottom", "top"), "top", "left", "right"),
    3: (("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"), "zmax", "xmin",
        "xmax"),
}


def cavity_models(dmesh):
    """(flow, thermal) of the bench configuration on a quad or hex cavity
    device mesh, initialised, residual norms kept on the device
    (``residualSync`` False)."""
    walls, lid, hot, cold = _WALLS[dmesh.dim]
    flow = FlowModel(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in walls:
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc[lid]["specifiedXVelocity"] = 1.0
    flow.options["pressureLinearSolver"] = AMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    flow.options["momentumLinearSolver"] = BiCGStab(
        relative_tolerance=1e-2, max_iterations=10)
    flow.init()

    thermal = ThermalModel(dmesh)
    thermal.options["verbose"] = False
    thermal.options["convective"] = True
    thermal.options["linearSolver"] = AMG(
        coarse_size=256, relative_tolerance=1e-3, max_iterations=6)
    for side in walls:
        thermal.bc[side].bc_type = "Symmetry"
    thermal.bc[hot].bc_type = "SpecifiedTemperature"
    thermal.bc[hot]["specifiedTemperature"] = 400.0
    thermal.bc[cold].bc_type = "SpecifiedTemperature"
    thermal.bc[cold]["specifiedTemperature"] = 300.0
    thermal.init()

    flow.options["residualSync"] = False
    thermal.options["residualSync"] = False
    return flow, thermal


def coupled_cavity(n: int, device=None, dtype="float32"):
    """(flow, thermal) on an n x n cavity (``cavity_models``)."""
    return cavity_models(build_device_mesh(quad_2d(n, n), dtype=dtype,
                                           device=device))


def coupled_cavity_3d(n: int, device=None, dtype="float32"):
    """(flow, thermal) on an n^3 hex cavity (``cavity_models``)."""
    return cavity_models(build_device_mesh(hex_3d(n, n, n), dtype=dtype,
                                           device=device))


def coupled_step(flow, thermal):
    """One coupled outer step; returns the (momentum, continuity, thermal)
    residual norms as device tensors."""
    hf = flow.advance(1)
    thermal.state["massFlux"] = flow.state["massFlux"]
    ht = thermal.advance(1)
    return hf[-1][1], hf[-1][2], ht[-1][1]
