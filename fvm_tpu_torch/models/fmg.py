"""Mesh-sequencing (full-multigrid style) warm start and moving a model's
state between models (counterpart of ``fvm_tpu/models/fmg.py``).

The SIMPLE outer iteration carries long-wavelength information one
stencil a step, so a cold start's spin-up costs O(N) outers on an N^2
mesh.  ``prolong_flow_state`` starts a fine model from a coarser model's
converged state instead: inverse-distance interpolation (gradient
corrected) from the k nearest coarse interior centroids to every fine
centroid, on the host (numpy and the kd-tree; a one-shot operation), and
the interior mass flux rebuilt from the prolonged velocity on the fine
model's device.  The reference always cold-starts (testFlowParallel.py).

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

from ..exceptions import ConfigError
from ..geom.search import KSearchTree


def interp_to_points(coarse_mesh, points, values, k: int = 4,
                     grad: bool = False) -> np.ndarray:
    """IDW-interpolate per-interior-cell ``values`` ((n_coarse_interior,
    m) or (n,)) of a device mesh onto arbitrary points (host); returns
    (len(points), m).  ``grad``: each neighbour's value gradient-corrected,
    u_i + G_i . (x - x_i), with the coarse mesh's least-squares gradients
    (exact for linear fields)."""
    cc = np.asarray(coarse_mesh.host.cell_centroid, dtype=np.float64)
    cc = cc[: coarse_mesh.n_interior_cells]
    fc = np.asarray(points, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    if v.ndim == 1:
        v = v[:, None]
    kk = min(int(k), len(cc))
    d, idx = KSearchTree(cc).query_batch(fc, kk)
    d = np.asarray(d).reshape(len(fc), kk)
    idx = np.asarray(idx).reshape(len(fc), kk)
    w = 1.0 / np.maximum(d, 1e-12)
    w = w / w.sum(axis=1, keepdims=True)
    vals = v[idx]  # (nf, k, m)
    if grad:
        from ..geom.particles import ParticleTracker

        G = ParticleTracker(coarse_mesh, k=kk)._velocity_gradient(v)
        dx = fc[:, None, :] - cc[idx]
        vals = vals + np.einsum("pkmd,pkd->pkm", G[idx], dx)
    return np.einsum("pk,pkm->pm", w, vals)


def interp_cell_field(coarse_mesh, fine_mesh, values, k: int = 4,
                      grad: bool = False) -> np.ndarray:
    """``interp_to_points`` at every cell of ``fine_mesh`` (ghost and
    padding cells too: their BCs refresh them inside the step), (n_fine
    cells, m)."""
    return interp_to_points(
        coarse_mesh, np.asarray(fine_mesh.host.cell_centroid,
                                dtype=np.float64), values, k=k, grad=grad)


def prolong_flow_state(coarse, fine, k: int = 4, grad: bool = True) -> None:
    """Warm-start ``fine`` (an initialised FlowModel) from ``coarse``'s
    state: velocity and pressure interpolated from the coarse interior
    cells onto every fine cell (``interp_to_points``), and the interior
    face mass flux rebuilt from the prolonged velocity on the fine mesh.
    A distributed model (the JAX package gathers or scatters through its
    Partition) raises ``ConfigError``."""
    from ..core import bcs as bck
    from ..ops import assembly

    for m in (coarse, fine):
        if getattr(m, "partition", None) is not None:
            raise ConfigError(
                "prolong_flow_state: a distributed model is not ported yet "
                "(ROADMAP queue 1 item 8b)")
    both_src = np.concatenate([coarse.getVelocity(),
                               coarse.getPressure()[:, None]], axis=1)
    mesh = fine.mesh
    both = interp_to_points(coarse.mesh, mesh.host.cell_centroid, both_src,
                            k=k, grad=grad)
    dtype = fine.state["pressure"].dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    V = torch.from_numpy(np.ascontiguousarray(
        both[:, : mesh.dim].astype(np_dtype))).to(mesh.device)
    pr = torch.from_numpy(np.ascontiguousarray(
        both[:, mesh.dim].astype(np_dtype))).to(mesh.device)
    # ghost velocities are refreshed from the BCs inside the step; the
    # owner copy only feeds the near-boundary interior faces' averages
    Vf = assembly.cells_to_faces_distance_weighted(
        mesh, bck.extend_to_ghosts(mesh, V))
    rho_f = assembly.cells_to_faces_distance_weighted(mesh,
                                                      fine.params["rho"])
    fine.state["velocity"] = V
    fine.state["pressure"] = pr
    fine.state["massFlux"] = rho_f * torch.einsum("fd,fd->f", Vf,
                                                  mesh.face_area)
    for key in ("velocity_N1", "velocity_N2"):
        if key in fine.state:
            fine.state[key] = V


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
