"""Inputs, level shapes, bounds and device timing for the ``dia_stencil``
kernels.

Shared by ``chip_smoke.py``, the card tests and ``scripts/dia_ab.py``.
The timing functions need a CUDA card; the rest runs anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..linear.amg import _StructuredLevel
from ..ops import dia_kernel as dk

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# extra operations per element on top of the D + 1 products and D sums
MODE_OPS = {"mv": 0, "residual": 1, "jacobi": 4}


def _generator(device, seed):
    """A generator on ``device`` itself, made from a seed: on a card the
    numbers are drawn there (a million-row operator drawn on the host
    takes ~0.3 s of one core; the values differ from the host's)."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def random_operator(n, offsets, dtype, device, seed):
    """Random DIA operator in the kernel's layout, with the out-of-range
    coefficients zeroed (as ``analyze_offsets`` guarantees for real
    matrices) and a dominant diagonal, made from a seed."""
    g = _generator(device, seed)
    coef = torch.randn((len(offsets), n), generator=g, dtype=torch.float64,
                       device=device)
    idx = torch.arange(n, device=device)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = torch.rand(n, generator=g, dtype=torch.float64,
                      device=device) + 4.0
    return dk.pack_coef(coef.to(dtype)), diag.to(dtype)


def random_vectors(n, m, dtype, device, seed):
    g = _generator(device, seed)
    shape = (n,) if m == 1 else (n, m)
    x = torch.randn(shape, generator=g, dtype=torch.float64, device=device)
    b = torch.randn(shape, generator=g, dtype=torch.float64, device=device)
    return x.to(dtype), b.to(dtype)


@dataclass(frozen=True)
class LevelShape:
    """One smoothed level of an AMG hierarchy, as its products see it."""

    rows: int
    offsets: tuple | None  # DIA offsets; None: the gather-ELL products
    fallback: int  # entries outside the DIA offsets (a scatter-add)
    dia: object = None  # the level's DIAInfo (fallback tables), if any
    graph: tuple | None = None  # (cols, mask) of a greedy coarse level


def _shape(rows, dia, graph=None):
    if dia is None:
        return LevelShape(rows, None, 0, None, graph)
    return LevelShape(rows, tuple(dia.offsets), int(dia.fb_rows.shape[0]),
                      dia, graph)


def level_shapes(amg, mesh):
    """Every smoothed level of the hierarchy ``amg`` holds for the
    matrices of ``mesh`` (structured or greedy): the condensed fine level
    first, then each coarse level but the coarsest (solved densely).
    ``setup_structure`` returns the solver's own cached hierarchy once the
    model's ``init`` has built it."""
    levels = amg.setup_structure(*mesh.host_cf(), mesh.device)
    if not levels:
        return []
    fine = mesh.dia
    if fine is not None and fine.cond_plan is not None:
        fine = fine.cond_plan.dia2
    out = [_shape(mesh.n_cells, fine)]
    for lev in levels[:-1]:
        if isinstance(lev, _StructuredLevel):
            out.append(LevelShape(lev.nC, tuple(lev.coarse_offsets), 0))
        else:
            out.append(_shape(lev.nC, lev.dia_c, (lev.cols_c, lev.mask_c)))
    return out


def bound(n, m, D, mode, item, diag=True):
    """Least time of one call on an H100 (ms), what bounds it, and the
    bytes and operations counted: each input read once (diag, D coef rows,
    x, and b but in mv), y written once; per element the diag product, D
    multiply-adds and the mode's extra operations.  ``diag`` False: a
    function with no diagonal term (an ILU triangular sweep, whose launch
    passes a zero diagonal), so neither its row nor its product counts."""
    vec = n * m
    rows = D + 1 if diag else D
    nbytes = item * (n * rows + vec * (2 if mode == "mv" else 3))
    nops = vec * (2 * D + (1 if diag else 0) + MODE_OPS[mode])
    return _limit(nbytes, nops)


def gather_ell_bound(n, K, mode, item):
    """``bound`` for one gather-ELL product on (n,): the K slots' values,
    int64 columns and bool mask read once, diag, x and (but in mv) b read
    once, y written once; per row K + 1 products, K sums and the mode's
    extra operations."""
    nbytes = K * n * (item + 8 + 1) + item * n * (3 if mode == "mv" else 4)
    return _limit(nbytes, n * (2 * K + 1 + MODE_OPS[mode]))


def _limit(nbytes, nops):
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / FP32_OPS_PER_S
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, nops
    return ops_ms, "operations", nbytes, nops


def _profile(run, sessions=3):
    """The device events of ``run()`` under torch.profiler.  A short
    session now and then comes back without the card's activity records
    (once on an H100, at a 1,024-row level): ``run`` is profiled again,
    up to ``sessions`` times, before the empty list is returned."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events
    return []


def time_device_by_kernel(labelled, reps, turns=2):
    """Device ms per launch of several kernels in one profiler session,
    in turns (a b c, then c b a, ...): ``labelled`` is a list of (label,
    kernel-name substring, fns).  Each label's time is the device time of
    the kernels whose name holds its substring over their launch count."""
    for _, _, fns in labelled:
        for fn in fns:
            fn()

    def run():
        for turn in range(turns):
            order = labelled if turn % 2 == 0 else labelled[::-1]
            for _, _, fns in order:
                for i in range(reps):
                    fns[i % len(fns)]()

    events = _profile(run)
    out = {}
    for label, key, _ in labelled:
        hits = [e for e in events if key in e.key]
        count = sum(e.count for e in hits)
        if not count:
            raise AssertionError(f"no device time recorded for {label}")
        out[label] = sum(e.self_device_time_total for e in hits) / 1e3 / count
    return out
