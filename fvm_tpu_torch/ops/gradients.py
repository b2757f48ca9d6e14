"""Least-squares cell gradients (counterpart of ``fvm_tpu/ops/gradients.py``).

The reference's per-cell least-squares "gradient matrix" over the
cellCells stencil (GradientMatrix.h:31) becomes a static SLOT-LEADING
(K, n_cells, dim) coefficient tensor aligned with the ELL cell->neighbor
table, so a gradient evaluation is one gather and one einsum:

    grad_c = sum_k  coeff[k, c, :] * (phi_nbr(c,k) - phi_c)
"""

from __future__ import annotations

import numpy as np
import torch


def ls_gradient_coefficients(mesh):
    """Least-squares gradient coefficients, (K, nc, dim), on the mesh's
    device and dtype.  Built on the host from the build's numpy copies
    (static per-mesh geometry), exactly as the JAX package's single-device
    path does, so the coefficients match it bit for bit."""
    cc = mesh.host.cell_centroid
    cf_nbr = mesh.host.cf_nbr
    mask = mesh.host.cf_mask
    d = cc[cf_nbr] - cc[:, None, :]
    d = np.where(mask[:, :, None], d, 0.0)
    d2 = np.sum(d * d, axis=2)
    w = np.where(mask, 1.0 / np.maximum(d2, 1e-300), 0.0)
    M = np.einsum("nk,nki,nkj->nij", w, d, d, optimize=True)
    # regularize directions with no information (rank-deficient ghost
    # stencils): eps*I leaves well-posed directions untouched
    scale = np.trace(M, axis1=1, axis2=2)[:, None, None]
    eye = np.eye(mesh.dim)
    Mreg = M + 1e-10 * np.maximum(scale, 1e-300) * eye
    Minv = np.linalg.inv(Mreg)
    coeff = np.einsum("nij,nkj,nk->nki", Minv, d, w, optimize=True)
    # no coefficient can physically exceed O(1/|d|): clamp the near-null
    # directions the regularized inverse amplifies
    cmag = np.linalg.norm(coeff, axis=2)
    cap = 4.0 / np.sqrt(np.maximum(d2, 1e-300))
    with np.errstate(over="ignore"):
        scale_c = np.minimum(1.0, cap / np.maximum(cmag, 1e-30))
    coeff = coeff * scale_c[:, :, None]
    coeff = np.where(mask[:, :, None], coeff, 0.0)
    np_dtype = np.float32 if mesh.dtype == torch.float32 else np.float64
    return torch.from_numpy(
        np.ascontiguousarray(coeff.transpose(1, 0, 2), dtype=np_dtype)
    ).to(mesh.device)


def gradient(mesh, coeff, x):
    """Cell gradients: x is (nc,) -> (nc, dim); (nc, m) -> (nc, m, dim).

    ``coeff`` is slot-leading (K, nc, dim)."""
    xn = mesh.take_cells(x)
    if x.ndim == 1:
        dphi = xn - x[None, :]
        return torch.einsum("kn,kni->ni", dphi, coeff)
    dphi = xn - x[None, :, :]  # (K, nc, m)
    return torch.einsum("knm,kni->nmi", dphi, coeff)
