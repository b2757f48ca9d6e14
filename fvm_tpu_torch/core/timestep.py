"""Adaptive time-step controller (``fvm_tpu/core/timestep.py``).

Counterpart of the reference's TimeStep helper (src/fvm/scripts/
TimeStep.py:5-60): grows or shrinks dt from the number of outer
iterations the last step needed.  Host code.
"""

from __future__ import annotations


class TimeStepController:
    def __init__(
        self,
        dt0: float,
        dt_min: float = 1e-12,
        dt_max: float = 1e3,
        grow: float = 1.25,
        shrink: float = 0.5,
        target_iterations: int = 8,
    ):
        self.dt = float(dt0)
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.grow = grow
        self.shrink = shrink
        self.target = target_iterations

    def update(self, iterations_used: int, converged: bool = True) -> float:
        """Adapt dt from the last step's outer-iteration count."""
        if not converged:
            self.dt = max(self.dt * self.shrink, self.dt_min)
        elif iterations_used <= self.target // 2:
            self.dt = min(self.dt * self.grow, self.dt_max)
        elif iterations_used > self.target:
            self.dt = max(self.dt * self.shrink, self.dt_min)
        return self.dt

    def step_model(self, model, max_outer: int = 50):
        """Advance one transient step with the current dt; adapt after."""
        model.options["timeStep"] = self.dt
        hist = model.advance(max_outer)
        opts = model.options
        converged = (hist[-1][1] / max(hist[0][1], 1e-300)
                     < opts["relativeTolerance"]
                     or hist[-1][1] < opts["absoluteTolerance"])
        model.updateTime()
        self.update(len(hist), converged)
        return hist
