"""The chunked inner Krylov solve of the Newton endgame
(``FlowModel.advanceNewton``; the JAX package's "chunk" program,
``fvm_tpu/models/flow.py:1497-1839``).

Per Newton step the inner system is fixed: the Jacobian operator
linearised at the step's state, its assembled Picard surrogate and the
CoupledSIMPLE preconditioner built from it (two AMG hierarchies).  The
JAX package rebuilds the surrogate and both hierarchies inside every
chunk program; they depend only on the step's (mesh, params, state)
views, so building them once per Newton step, as here, gives the same
numbers.  The solve then runs in chunks of ``chunk`` iterations that
continue one Krylov iteration exactly (the solver's carry), with one
read-back of (iterations, relative residual, converged) per chunk.

On the CPU everything runs eagerly.  On a CUDA device two graphs are
captured once and replayed:

* the set-up graph: the system on static copies of the step's state,
  boundary values and rhs, the preconditioner and the initial carry;
* the trips graph: ``trips`` BiCGStab iterations (a divisor of the
  chunk, so a chunk of 240 is 20 replays of 12 trips, with no read-back
  between them; the graph of a whole chunk would hold hundreds of
  thousands of nodes) or one whole GMRES chunk (its restart cycles span
  the chunk).  It takes the forcing ``eta`` and a ``fresh`` flag as
  static scalar buffers: on the first replay of a Newton step the carry
  starts from the set-up graph's initial carry, later replays continue
  their own carry.

The graphs hold the tensors they read by address and nothing that leads
back to the model (the system is built by a function that holds its model
weakly), so a dropped model frees them at once.
"""

from __future__ import annotations

import torch

from .chunk import Graph, _map, copy_into


# BiCGStab iterations per trips graph at most (at 1024^2 its 8,664
# dia_stencil launches are a fraction of its kernels)
GRAPH_TRIPS = 12


def graph_trips(chunk: int) -> int:
    """The largest divisor of ``chunk`` that is at most GRAPH_TRIPS: the
    BiCGStab iterations per trips-graph replay."""
    return max(d for d in range(1, min(chunk, GRAPH_TRIPS) + 1)
               if chunk % d == 0)


class NewtonInner:
    """The chunked inner solve on one (mesh, params) view.

    ``build(state, bcvals)`` returns (op, solver): the matrix-free operator
    and a Krylov solver (preconditioner bound, ``max_iterations`` = the
    chunk) on the system of that state."""

    def __init__(self, build, chunk: int, device, graph: bool = True):
        self.build = build
        self.chunk = int(chunk)
        self.device = torch.device(device)
        self.graphed = graph and self.device.type == "cuda"
        self.setup = None  # Graph of the set-up (CUDA)
        self.trips = None  # Graph of the trips (CUDA)
        self.replays = 0

    # --- the eager form ----------------------------------------------------

    def _begin_eager(self, state, bcvals, r0):
        self._op, self._solver = self.build(state, bcvals)
        self._carry = self._solver.init_carry(self._op, r0,
                                              torch.zeros_like(r0))

    def _chunk_eager(self, eta):
        rn_b = torch.clamp(self._carry[-1], min=1e-300)
        target = torch.full((), float(eta), dtype=rn_b.dtype,
                            device=rn_b.device) * rn_b
        x, st, self._carry = self._solver.solve_chunk(self._op, self._carry,
                                                      target)
        return x, _stats(st, rn_b)

    # --- the graphed form -------------------------------------------------

    def _capture(self, state, bcvals, r0):
        self._in = _map(torch.clone, {"state": state, "bcvals": bcvals,
                                      "r0": r0})
        inp = self._in

        def setup():
            op, solver = self.build(inp["state"], inp["bcvals"])
            init = solver.init_carry(op, inp["r0"], torch.zeros_like(r0))
            return op, solver, init

        self.setup = Graph(setup, setup, self.device)
        self.setup.replay()
        op, solver, init = self.setup.outputs
        bicg = not hasattr(solver, "restart")
        trips = graph_trips(self.chunk) if bicg else self.chunk
        self.n_replays = self.chunk // trips
        x0 = init[1]
        self._carry = [t.clone() for t in solver.carry_template(
            tuple(x0.shape), x0.dtype, x0.device)]
        self._eta = torch.zeros((), dtype=torch.float64, device=self.device)
        self._fresh = torch.ones((), dtype=torch.bool, device=self.device)

        def run(k):
            c = tuple(torch.where(self._fresh, a, b)
                      for a, b in zip(init, self._carry))
            rn_b = torch.clamp(c[-1], min=1e-300)
            target = self._eta.to(rn_b.dtype) * rn_b
            if bicg:
                x, st, out = solver.solve_chunk(op, c, target, trips=k)
            else:
                x, st, out = solver.solve_chunk(op, c, target)
            for buf, t in zip(self._carry, out):
                buf.copy_(t)
            return x, _stats(st, rn_b)

        self.trips = Graph(lambda: run(trips), lambda: run(1), self.device)
        self.trips_per_replay = trips

    def begin(self, state, bcvals, r0):
        """Set up the inner system of one Newton step (state, boundary
        values and rhs in the inner dtype)."""
        if not self.graphed:
            self._begin_eager(state, bcvals, r0)
            return
        if self.setup is None:
            self._capture(state, bcvals, r0)
        else:
            copy_into(self._in, {"state": state, "bcvals": bcvals, "r0": r0})
            self.setup.replay()
        self._fresh.fill_(True)

    def run_chunk(self, eta: float):
        """One chunk of inner iterations at forcing ``eta``; returns (dq,
        (iterations, relative residual, converged)) with the three numbers
        read back in one copy.  Iterations count over the Newton step."""
        if not self.graphed:
            x, stats = self._chunk_eager(eta)
        else:
            self._eta.fill_(float(eta))
            for r in range(self.n_replays):
                self.trips.replay()
                if r == 0:
                    self._fresh.fill_(False)
            self.replays += self.n_replays
            x, stats = self.trips.outputs
            x = x.clone()
        it, rel, conv = stats.tolist()
        return x, (int(it), rel, bool(conv))


def _stats(st, rn_b):
    """(iterations, residual / rn_b, converged) as one float64 tensor."""
    return torch.stack([st.iterations.double(),
                        (st.residual / rn_b).double(),
                        st.converged.double()])
