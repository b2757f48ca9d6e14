"""The flagship workload: the coupled lid-driven cavity.

The configuration of the JAX package's ``bench.py:main()``: a lid-driven
cavity ``FlowModel`` on ``quad_2d(n, n)`` (viscosity 0.01, lid u = 1,
SIMPLE with pressure ``AMG(coarse_size=256, rtol=1e-3, max 6 cycles)`` and
momentum ``BiCGStab(rtol=1e-2, max 10)``) coupled one way to a convective
``ThermalModel`` (walls 400 / 300, symmetry top and bottom, the same AMG
settings) that convects with the flow's face mass flux.  One outer step
is one flow SIMPLE step, the mass-flux handoff and one thermal step.
"""

from __future__ import annotations

from .linear import AMG, BiCGStab
from .mesh import build_device_mesh
from .mesh.generate import quad_2d
from .models import FlowModel, ThermalModel


def coupled_cavity(n: int, device=None, dtype="float32"):
    """(flow, thermal) on an n x n cavity, initialised, residual norms kept
    on the device (``residualSync`` False)."""
    dmesh = build_device_mesh(quad_2d(n, n), dtype=dtype, device=device)

    flow = FlowModel(dmesh)
    flow.options["verbose"] = False
    flow.vc["viscosity"] = 0.01
    for side in ("left", "right", "bottom", "top"):
        flow.bc[side].bc_type = "NoSlipWall"
    flow.bc["top"]["specifiedXVelocity"] = 1.0
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
    thermal.bc["left"].bc_type = "SpecifiedTemperature"
    thermal.bc["left"]["specifiedTemperature"] = 400.0
    thermal.bc["right"].bc_type = "SpecifiedTemperature"
    thermal.bc["right"]["specifiedTemperature"] = 300.0
    thermal.bc["bottom"].bc_type = "Symmetry"
    thermal.bc["top"].bc_type = "Symmetry"
    thermal.init()

    flow.options["residualSync"] = False
    thermal.options["residualSync"] = False
    return flow, thermal


def coupled_step(flow, thermal):
    """One coupled outer step; returns the (momentum, continuity, thermal)
    residual norms as device tensors."""
    hf = flow.advance(1)
    thermal.state["massFlux"] = flow.state["massFlux"]
    ht = thermal.advance(1)
    return hf[-1][1], hf[-1][2], ht[-1][1]
