"""Ranks, process groups and the launcher of a distributed run.

The counterpart of the JAX package's device-mesh axis
(``fvm_tpu/parallel/partition.py:594-603``, ``shard_map``): one process
per shard, joined by a ``torch.distributed`` process group.

* ``ShardGroup``: this process's rank, the world size, the backend, the
  process group and the rank's device.
* ``init_group``: joins a world through a ``FileStore`` in a directory
  the ranks share (no TCP port is chosen).  The backend is explicit:
  ``"nccl"`` by default on CUDA and ``"gloo"`` on the CPU.  NCCL needs
  one GPU per rank; asking it for more ranks than visible GPUs raises
  ``ConfigError`` (no quiet switch to gloo).  gloo runs several ranks on
  one GPU.
* ``run_ranks(fn_name, world, args, device, backend, timeout)``: starts
  each rank as a fresh ``python -m fvm_tpu_torch.parallel.launch``
  process (never a fork: a fork of a process that has initialised CUDA
  breaks), each calling ``fn(group, **args)``; with CUDA ranks the parent
  builds the ``dia_stencil`` kernels first and the ranks only load them
  (``dia_kernel.load_built``); a rank function returns a
  dict of arrays, which comes back through an ``.npz`` file.  When a rank
  fails, or the time limit passes, every rank is killed and ``RankError``
  raised with the failed rank's error output.  Rank functions live in the
  port (``fvm_tpu_torch.cases`` by default), so a rank imports neither a
  test module nor ``jax``.

A distributed model runs eagerly: gloo's collectives cannot be captured
in a CUDA graph, so ``models/chunk.Runner`` refuses a distributed mesh.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..exceptions import ConfigError, RankError

BACKENDS = ("gloo", "nccl")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass(eq=False)
class ShardGroup:
    rank: int
    world: int
    backend: str
    pg: object  # torch.distributed.ProcessGroup
    device: torch.device
    _buffers: dict = field(default_factory=dict, repr=False)

    def host_buffer(self, like):
        """A pinned host buffer of ``like``'s shape and dtype (the small
        all-reduce's, ``ops/halo.py``), kept for the next call of the same
        shape."""
        key = (tuple(like.shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: ``"cuda"`` spreads the ranks over the
    visible GPUs (all on ``cuda:0`` with one GPU); an indexed device is
    taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise ConfigError("a CUDA rank was asked for and no GPU is "
                              "visible")
        return torch.device("cuda", rank % n)
    return dev


def check_backend(backend: str, device, world: int) -> None:
    """Raise ``ConfigError`` for a backend that cannot run ``world``
    ranks on ``device``."""
    if backend not in BACKENDS:
        raise ConfigError(f"unknown backend {backend!r} (one of {BACKENDS})")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ConfigError("the nccl backend needs CUDA ranks")
        n = torch.cuda.device_count()
        if world > n:
            raise ConfigError(
                f"the nccl backend needs one GPU per rank: {world} ranks, "
                f"{n} visible GPU(s); use backend='gloo' for several ranks "
                "on one GPU")


def init_group(rank: int, world: int, store_dir: str, device="cpu",
               backend: str | None = None,
               timeout: float = 120.0) -> ShardGroup:
    """Join the world of ``world`` ranks that share ``store_dir``."""
    import torch.distributed as dist

    backend = backend or default_backend(device)
    check_backend(backend, device, world)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return ShardGroup(rank, world, backend, dist.group.WORLD, dev)


def close_group(group: ShardGroup) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def resolve(fn_name: str):
    """``"module:function"``, or a function name of
    ``fvm_tpu_torch.cases``."""
    mod, _, name = fn_name.rpartition(":")
    return getattr(importlib.import_module(mod or "fvm_tpu_torch.cases"),
                   name)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_ranks(fn_name: str, world: int, args: dict | None = None,
              device="cuda", backend: str | None = None,
              timeout: float = 120.0) -> list:
    """Run ``fn(group, **args)`` on ``world`` fresh rank processes, one
    torch thread each; returns each rank's result dict (arrays), in rank
    order.  Raises ``RankError`` when a rank fails or ``timeout`` seconds
    pass (every rank is killed first)."""
    backend = backend or default_backend(device)
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise ConfigError("run_ranks: CUDA ranks asked for and no GPU is "
                          "available")
    check_backend(backend, device, world)
    if cuda:
        # the kernels are built here, once; the ranks only load them
        from ..ops import dia_kernel

        dia_kernel.build()
    tmp = tempfile.mkdtemp(prefix="fvm_ranks_")
    try:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args or {}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        env["OMP_NUM_THREADS"] = "1"
        procs = []
        for r in range(world):
            cmd = [sys.executable, "-m", "fvm_tpu_torch.parallel.launch",
                   "--fn", fn_name, "--rank", str(r), "--world", str(world),
                   "--dir", tmp, "--device", str(device),
                   "--backend", backend, "--timeout", str(timeout)]
            out = open(os.path.join(tmp, f"log{r}.txt"), "w")
            procs.append((subprocess.Popen(cmd, env=env, cwd=_ROOT,
                                           stdout=out, stderr=out), out))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {codes[bad[0]]}")
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = (next(r for r, c in enumerate(codes) if c is None),
                          f"timed out after {timeout:.0f} s")
                break
            time.sleep(0.02)
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
        if failed is not None:
            r, why = failed
            raise RankError(
                f"{fn_name}: rank {r} of {world} failed ({why}); its output:"
                f"\n{_tail(os.path.join(tmp, f'log{r}.txt'))}")
        results = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"out{r}.npz"),
                         allow_pickle=False) as z:
                results.append({k: z[k] for k in z.files})
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of run_ranks")
    ap.add_argument("--fn", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=120.0)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    if torch.device(a.device).type == "cuda":
        from fvm_tpu_torch.ops import dia_kernel

        dia_kernel.load_built()
    # the parent wrote these arguments (run_ranks)
    with open(os.path.join(a.dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    fn = resolve(a.fn)
    group = init_group(a.rank, a.world, a.dir, a.device, a.backend,
                       a.timeout)
    try:
        out = fn(group, **args) or {}
    finally:
        close_group(group)
    np.savez(os.path.join(a.dir, f"out{a.rank}.npz"),
             **{k: _as_numpy(v) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(_main())
