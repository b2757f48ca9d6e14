"""Channel logging and per-phase tracing (``fvm_tpu/core/rlog.py``).

The reference's rlog integration (RLogInterface.h:15: channels cdtor/ctor,
cdtor/dtor, info, info/warning, info/error) and its timing dumps.
Channels form a '/'-separated hierarchy; enabling a prefix enables the
subtree.  The ``FVM_TPU_LOG`` environment variable (comma-separated
prefixes, or 'all') selects channels at import time; ``enable`` and
``disable`` adjust them at run time.

The tracer sums named phase wall times (``with phase("assemble")``).
PyTorch returns before the card finishes, so a ``Tracer(sync=True)``
closes each phase with ``torch.cuda.synchronize()`` when CUDA is in use,
and its numbers then mean what they say; ``report()`` returns (and
prints) the totals.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

import torch

_enabled: set[str] = set()
_sink = sys.stderr


def _init_from_env() -> None:
    spec = os.environ.get("FVM_TPU_LOG", "info/warning,info/error")
    for tok in spec.split(","):
        tok = tok.strip()
        if tok:
            _enabled.add(tok)


_init_from_env()


def enable(*channels: str) -> None:
    _enabled.update(channels)


def disable(*channels: str) -> None:
    for c in channels:
        _enabled.discard(c)


def set_sink(fileobj) -> None:
    global _sink
    _sink = fileobj


def is_enabled(channel: str) -> bool:
    if "all" in _enabled:
        return True
    parts = channel.split("/")
    return any("/".join(parts[: i + 1]) in _enabled for i in range(len(parts)))


def log(channel: str, msg: str, *args) -> None:
    if is_enabled(channel):
        print(f"[{channel}] " + (msg % args if args else msg), file=_sink)


class Channel:
    """Bound channel (reference: rlog::RLogChannel)."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, msg: str, *args) -> None:
        log(self.name, msg, *args)

    @property
    def on(self) -> bool:
        return is_enabled(self.name)


# reference channel inventory (RLogInterface.cpp:7-11)
ctor = Channel("cdtor/ctor")
dtor = Channel("cdtor/dtor")
info = Channel("info")
warning = Channel("info/warning")
error = Channel("info/error")
solver = Channel("solver")
model = Channel("model")


# ---------------------------------------------------------------------------
# phase tracer


class Tracer:
    """Accumulates per-phase wall time and call counts."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _sync(self) -> None:
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=None) -> dict:
        rows = {
            k: {"seconds": v, "calls": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
        if out is not None:
            for k, v in rows.items():
                print(
                    f"{k:>24s}: {v['seconds']:.4f} s over {v['calls']} calls",
                    file=out,
                )
        return rows

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


tracer = Tracer()
phase = tracer.phase
