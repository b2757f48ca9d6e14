"""The distributed runtime (counterpart of ``fvm_tpu/parallel``): the
partitioner, ranks and process groups, and the rank launcher.  The JAX
package's ``parallel/coupling.py`` (two-program FSI over sockets) is not
ported yet (ROADMAP queue 1 item 8b)."""

from .partition import Partition, greedy_partition, rcb_partition

_LAUNCH = ("ShardGroup", "init_group", "run_ranks")


def __getattr__(name):
    # the launcher is imported on first use: ``python -m
    # fvm_tpu_torch.parallel.launch`` (a rank) imports this package first,
    # and must not find its own module imported already
    if name in _LAUNCH:
        from . import launch

        return getattr(launch, name)
    raise AttributeError(name)
