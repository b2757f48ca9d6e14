"""Several outer steps per dispatch: the port's device-resident outer loop.

The JAX package runs ``outerChunk`` outer iterations in one jitted
``lax.while_loop`` (``fvm_tpu/models/base.py:604-747``) and ``bench.py``
its timed coupled loop as one ``lax.scan``.  PyTorch runs eagerly, so the
counterpart of such a program is a CUDA graph: the chunk is written as a
fixed number of trips (the port's frozen form, ``linear/base.py``: a trip
past the stopping test computes, and ``torch.where`` keeps the old state),
captured once, and replayed.

``Runner`` wraps one such function ``fn(inputs, scal) -> outputs``, where
``inputs`` is a dict of tensors or of dicts of tensors (model states,
boundary values), ``scal`` a dict of Python numbers handed to ``fn`` as
0-d tensors (trip bound, tolerances, initial norms), and ``outputs`` any
nest of tuples, lists and dicts of tensors.

* On the CPU it calls ``fn`` eagerly.
* On a CUDA device the first call copies the inputs into static buffers,
  runs ``build(1)`` (one trip: lazy library loads, solver handles and
  host-side caches are set up before capture) on a side stream, captures
  ``build(trips)`` in one ``torch.cuda.CUDAGraph`` and replays it; every
  later call copies its inputs into the same buffers and replays.  The
  outputs are cloned out of the graph's memory, so a caller may hold them
  across replays.  A capture that fails raises; nothing falls back to
  the per-step loop.

What a graph freezes: the tensors it reads (model ``params`` and the mesh,
by address) and every Python-side choice made while it was captured
(options, boundary types, solver settings).  Boundary *values* and the
scalars are inputs and may change between calls.  Models drop their
runners in ``init()``.  ``build`` must not hold the object that holds the
runner: the models build it from their step (which holds its model only
weakly), mesh and params, so that a dropped model frees its graphs at
once (a graph that the cycle collector freed in the middle of another
capture would invalidate that capture).

A check that needs the host (the ``info`` of a factorisation,
``linear.base.check_info``) cannot run inside a capture: it is made after
each replay instead, and a failure raises ``SolverError`` there.

A distributed mesh (``parallel.Partition.local_mesh``) is refused: gloo's
collectives cannot be captured, so distributed models run eagerly.

Launch counters (``dia_kernel.dia_stencil.launches`` and ``.shapes``,
``ell.gather_ell_ops``) count executions: the launches issued while a
graph is captured are taken back out of the counters and kept as the
graph's per-replay ``captured`` counts, which each replay adds back.
"""

from __future__ import annotations

import torch

from ..exceptions import SolverError
from ..linear import base as lbase
from ..ops import dia_kernel, ell


def _counters():
    return (dia_kernel.dia_stencil.launches, dia_kernel.dia_stencil.shapes,
            ell.gather_ell_ops)


def _snapshot():
    return tuple(dict(c) for c in _counters())


def _delta(before):
    return tuple({k: v - b.get(k, 0) for k, v in c.items()
                  if v != b.get(k, 0)}
                 for c, b in zip(_counters(), before))


def _add(delta, sign=1):
    for c, d in zip(_counters(), delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + sign * v


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def copy_into(dst, src):
    """Copy the tensors of ``src`` into the same-keyed buffers of ``dst``."""
    if set(dst) != set(src):
        raise KeyError(f"graph inputs changed: {sorted(src)} vs "
                       f"{sorted(dst)}")
    for k, v in src.items():
        if isinstance(v, dict):
            copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def _scalars(scal: dict, device) -> dict:
    """The scalars as 0-d tensors: float64 for floats, int64 for ints."""
    return {k: torch.tensor(v, dtype=torch.int64 if isinstance(v, int)
                            else torch.float64, device=device)
            for k, v in scal.items()}


class Graph:
    """``fn()`` captured in one CUDA graph on ``device``: ``warm()`` runs
    once eagerly on a side stream first (lazy library loads, solver handles
    and host-side caches are set up before capture), then ``fn()`` is
    captured and its return value kept as ``outputs`` (tensors in the
    graph's memory, rewritten by each replay).  ``replay()`` runs the graph,
    moves the captured launch counts to the counters and makes the checks
    deferred at capture.  A capture that fails raises."""

    def __init__(self, fn, warm, device):
        device = torch.device(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        lbase._deferred_checks = []
        try:
            with torch.cuda.graph(graph):
                self.outputs = fn()
        finally:
            self._checks = lbase._deferred_checks
            lbase._deferred_checks = None
            self.captured = _delta(before)
            _add(self.captured, -1)
        self.graph = graph

    def replay(self):
        self.graph.replay()
        _add(self.captured)
        self._check()

    def _check(self):
        """The checks deferred at capture (``linear.base.check_info``),
        made on this replay's results: one read-back."""
        if not self._checks:
            return
        bad = torch.stack([(info != 0).any() for info, _ in self._checks])
        for ok, (info, what) in zip((~bad).tolist(), self._checks):
            if not ok:
                raise SolverError(f"{what} failed in a graph replay: info "
                                  f"{info.tolist()}")


class Runner:
    """``build(trips)`` run eagerly on the CPU, as one CUDA graph replay
    on a CUDA device (module docstring)."""

    def __init__(self, build, trips: int, device, mesh=None):
        if getattr(mesh, "group", None) is not None:
            from ..exceptions import ConfigError

            raise ConfigError(
                "chunk.Runner: a distributed mesh runs eager (its "
                "collectives cannot be captured in a CUDA graph)")
        self.build = build
        self.trips = int(trips)
        self.device = torch.device(device)
        self.graph = None  # Graph, once captured (CUDA only)
        self.replays = 0
        self._fn = build(self.trips)

    @property
    def captured(self):
        """Per-replay launch counts (launches, shapes, gather-ELL) of the
        captured graph, or None."""
        return None if self.graph is None else self.graph.captured

    def __call__(self, inputs: dict, scal: dict | None = None):
        scal = scal or {}
        if self.device.type != "cuda":
            return self._fn(inputs, _scalars(scal, self.device))
        if self.graph is None:
            self._inputs = _map(torch.clone, inputs)
            self._scal = _scalars(scal, self.device)
            warm = self.build(1)
            self.graph = Graph(
                lambda: self._fn(self._inputs, self._scal),
                lambda: warm(self._inputs, self._scal), self.device)
        else:
            copy_into(self._inputs, inputs)
            for k, v in scal.items():
                self._scal[k].fill_(v)
        self.graph.replay()
        self.replays += 1
        return _map(torch.clone, self.graph.outputs)
