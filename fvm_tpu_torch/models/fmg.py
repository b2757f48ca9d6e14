"""Moving a model's state between models of one mesh
(the state half of ``fvm_tpu/models/fmg.py:90-130``).

``snapshot_state`` pulls a model's state to host numpy, ``restore_state``
writes such a snapshot into another model, cast to that model's dtypes,
and ``promote_state`` is the two together: the float32 -> float64
promotion of the converge path (an f32 SIMPLE fixed point floors at a
round-off-limited relative residual; the last decades need f64 state).
Snapshot, drop the source models, build the destination, restore: then the
two generations' device buffers (and CUDA graphs) never coexist.
"""

from __future__ import annotations

import numpy as np
import torch


def snapshot_state(src) -> dict:
    """A model's state as host numpy arrays, keyed as ``src.state``."""
    return {k: v.detach().cpu().numpy() for k, v in src.state.items()
            if isinstance(v, torch.Tensor)}


def restore_state(dst, snap: dict) -> None:
    """Write a host snapshot into ``dst.state``, cast on the host to each
    entry's dtype and reshaped to its shape.  Keys that ``dst`` lacks are
    ignored (as the JAX package's ``restore_state``)."""
    for key, host in snap.items():
        tgt = dst.state.get(key)
        if not isinstance(tgt, torch.Tensor):
            continue
        a = np.asarray(host).astype(
            torch.empty((), dtype=tgt.dtype).numpy().dtype
        ).reshape(tuple(tgt.shape))
        dst.state[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
            tgt.device)


def promote_state(src, dst) -> None:
    """Copy ``src``'s state into ``dst`` (same mesh shape), cast to
    ``dst``'s dtypes."""
    if (src.mesh.n_cells != dst.mesh.n_cells
            or src.mesh.n_faces != dst.mesh.n_faces):
        raise ValueError("promote_state: meshes differ in shape")
    restore_state(dst, snapshot_state(src))
