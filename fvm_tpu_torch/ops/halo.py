"""Halo exchange and global sums over ``torch.distributed`` ranks.

Counterpart of ``fvm_tpu/ops/halo.py`` (the reference's
Field::syncLocal, which packs ghost arrays through ScatterMap indices into
Isend/Irecv transfers, Field.cpp:234-383).  The JAX package runs one
``jax.lax.all_to_all`` inside ``shard_map``; here each shard is one
process and the exchange is one ``all_to_all_single`` of its rank's group
(``parallel.ShardGroup``):

* ``HaloSpec`` holds this rank's ``(P, M)`` tables from the partitioner:
  ``send_idx[p]`` the local cells peer ``p`` needs (padded with cell 0,
  sent and dropped), ``recv_idx[p]`` the local halo slots its copies land
  in (padded with ``n_cells``, out of range).  The JAX exchange drops the
  padded receives with ``mode="drop"``; torch raises on an out-of-range
  index, so the valid receive positions are found once, at set-up.
* ``halo_exchange`` gathers the send rows, exchanges them (every rank
  sends ``M`` rows to every peer: equal splits) and writes the valid
  receives.  It is linear, and its reverse-mode derivative is the
  reversed exchange that adds the halo slots' cotangents onto their
  owner cells and zeroes them in place (``fvm_tpu/ops/halo.py:48-53``:
  the adjoint solves rely on it).
* ``gsum`` is ``all_reduce(SUM)`` (the JAX ``psum``); ``maybe_sync``
  refreshes the halo of a cell array on a distributed mesh and is the
  identity on one device.  On gloo, an all-reduce of a few values (the
  Krylov solvers' dot products; ``SMALL_REDUCE`` or fewer) is one
  ``all_to_all_single`` of host tensors: every rank sends its values to
  every rank and folds the copies in rank order on the host, so every
  rank holds the same result.  gloo's own ``all_reduce`` of a scalar is a
  ring of 2 (P - 1) latency-bound steps, 1.44 ms for 4 ranks on a CPU
  against 0.35 ms for an ``all_to_all_single``.

Every collective takes the tensors where they are: gloo takes CUDA
tensors for all three (``cases.dist_probe_rank`` asserts it on the card),
and NCCL takes no host tensor.

Every collective adds to ``stats``: its count by kind, the bytes this rank
sends, and the host seconds spent inside the call (``time.perf_counter``
around it; the call returns when the collective has completed).  On gloo
a CUDA tensor's collective first waits for the device (gloo's own copy to
the host would wait for the same work), so those seconds hold the
collective alone, not the kernels queued before it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# collectives since the last ``reset_stats()``, this process
stats: dict = {}


def reset_stats() -> None:
    stats.clear()
    stats.update({"all_to_all": 0, "all_reduce": 0, "all_gather": 0,
                  "bytes": 0, "seconds": 0.0})


reset_stats()


class HaloSpec:
    """This rank's exchange tables from its host ``(P, M)`` ``send_idx``
    and ``recv_idx`` (the JAX package's per-device slices), on the device:
    the flat send rows, and the receive buffer positions that hold a real
    halo copy with their local slots."""

    def __init__(self, send_idx, recv_idx, n_cells: int, device):
        self.P, self.M = np.shape(send_idx)
        flat = np.asarray(recv_idx, dtype=np.int64).reshape(-1)
        valid = flat < n_cells
        dev = torch.device(device)

        def idx(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

        self.send = idx(np.asarray(send_idx).reshape(-1))
        self.recv_pos = idx(np.nonzero(valid)[0])
        self.recv_dst = idx(flat[valid])


def _timed(kind: str, t, group, call):
    """``call()``, counted in ``stats`` for a collective of ``t``."""
    if t.is_cuda and group.backend == "gloo":
        # gloo copies a CUDA tensor to the host once the work queued
        # before it has run; waiting here keeps that work off the timer
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    call()
    stats["seconds"] += time.perf_counter() - t0
    stats[kind] += 1
    stats["bytes"] += t.numel() * t.element_size()


def all_to_all(send, group):
    """``all_to_all_single`` of a ``(P * M, ...)`` tensor in equal splits;
    returns the received ``(P * M, ...)`` tensor on ``send``'s device."""
    import torch.distributed as dist

    send = send.contiguous()
    r = torch.empty_like(send)
    _timed("all_to_all", send, group,
           lambda: dist.all_to_all_single(r, send, group=group.pg))
    return r


# all-reduces of at most this many values: one host all_to_all_single
SMALL_REDUCE = 64

_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _small_reduce(v, group, op):
    """``all_reduce`` of a few values through one ``all_to_all_single`` on
    the host, folded in rank order (the same result on every rank)."""
    import torch.distributed as dist

    flat = v.detach().reshape(1, -1)
    if flat.is_cuda:
        flat = group.host_buffer(flat).copy_(flat)
    send = flat.expand(group.world, -1).contiguous()
    recv = torch.empty_like(send)
    _timed("all_reduce", send, group,
           lambda: dist.all_to_all_single(recv, send, group=group.pg))
    acc = recv[0]
    for p in range(1, group.world):
        acc = _FOLD[op](acc, recv[p])
    return acc.to(v.device).reshape(v.shape)


def all_reduce(v, group, op: str = "sum"):
    """SUM (or ``op`` "max", "min") over the ranks of ``group``, a new
    tensor (``v`` is kept)."""
    import torch.distributed as dist

    if v.numel() <= SMALL_REDUCE and group.backend == "gloo":
        return _small_reduce(v, group, op)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    shape = v.shape
    buf = v.detach().reshape(-1).clone()
    _timed("all_reduce", buf, group,
           lambda: dist.all_reduce(buf, op=rop, group=group.pg))
    return buf.reshape(shape)


def all_gather(v, group):
    """Every rank's ``v`` (equal shapes), stacked ``(world, ...)``."""
    import torch.distributed as dist

    v = v.detach().contiguous()
    out = [torch.empty_like(v) for _ in range(group.world)]
    _timed("all_gather", v, group,
           lambda: dist.all_gather(out, v, group=group.pg))
    return torch.stack(out)


def _exchange(x, spec: HaloSpec, group):
    recv = all_to_all(x.index_select(0, spec.send), group)
    return x.index_copy(0, spec.recv_dst, recv.index_select(0, spec.recv_pos))


def _exchange_transpose(g, spec: HaloSpec, group):
    """The reversed exchange: each halo slot's value goes back to the rank
    that owns the cell and is added there; the slot itself becomes 0."""
    buf = g.new_zeros((spec.P * spec.M,) + tuple(g.shape[1:]))
    buf.index_copy_(0, spec.recv_pos, g.index_select(0, spec.recv_dst))
    back = all_to_all(buf, group)
    return g.index_fill(0, spec.recv_dst, 0.0).index_add(0, spec.send, back)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, group):
        ctx.spec, ctx.group = spec, group
        return _exchange(x, spec, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange_transpose(g, ctx.spec, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, group):
        ctx.group = group
        return all_reduce(v, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def halo_exchange(x, spec: HaloSpec, group):
    """Refresh the halo slots of a local cell array (any trailing dims)."""
    if x.requires_grad:
        return _Exchange.apply(x, spec, group)
    return _exchange(x, spec, group)


def halo_exchange_transpose(g, spec: HaloSpec, group):
    """The transpose of ``halo_exchange`` applied to ``g``."""
    return _exchange_transpose(g, spec, group)


def gsum(mesh, v):
    """Global (cross-rank) sum of a local reduction result."""
    group = getattr(mesh, "group", None)
    if group is None:
        return v
    if v.requires_grad:
        return _AllReduce.apply(v, group)
    return all_reduce(v, group)


def maybe_sync(mesh, x):
    """Halo-refresh a cell array on a distributed mesh; else identity."""
    if getattr(mesh, "group", None) is None:
        return x
    return halo_exchange(x, mesh.halo, mesh.group)
