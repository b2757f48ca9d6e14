"""Halo synchronisation hooks (counterpart of ``fvm_tpu/ops/halo.py``).

The port runs on one device so far: both hooks are identities.  They stay
at their call sites so the distributed slice (``torch.distributed``
all_to_all and all_reduce) slots in without touching the models.
"""

from __future__ import annotations


def gsum(mesh, v):
    """Global (cross-device) sum of a local reduction result."""
    return v


def maybe_sync(mesh, x):
    """Halo-sync a cell array on a distributed mesh; identity here."""
    return x
