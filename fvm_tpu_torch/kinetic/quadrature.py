"""Velocity-space quadrature for the discrete-velocity kinetic models
(counterpart of ``fvm_tpu/kinetic/quadrature.py``).

The reference's ``Quadrature<T>`` (esbgkbase/Quadrature.h:23: cartesian
and spherical ordinate sets with weights).  The ordinate set is a flat
(N, 3) numpy array of velocities and (N,) weights, computed on the host
exactly as the JAX package computes them, so the tables are bit-identical;
the distribution function is one (n_cells, N) tensor.  ``maxwellian`` and
``moments`` act on tensors on any device; ``reflection_tables`` is host
numpy on ``geom.search.KSearchTree``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geom.search import KSearchTree


def sn_directions(n_polar: int = 4, n_azimuthal: int = 8):
    """Discrete-ordinate direction set: Gauss-Legendre in cos(theta) x
    uniform azimuth (``fvm_tpu/kinetic/phonon.py:39``).  Returns (s (D, 3),
    w (D,)) with sum w = 4 pi."""
    mu, wmu = np.polynomial.legendre.leggauss(n_polar)
    phi = (np.arange(n_azimuthal) + 0.5) * 2 * np.pi / n_azimuthal
    wphi = 2 * np.pi / n_azimuthal
    M, P = np.meshgrid(mu, phi, indexing="ij")
    WM, _ = np.meshgrid(wmu, phi, indexing="ij")
    st = np.sqrt(1 - M**2)
    s = np.stack([st * np.cos(P), st * np.sin(P), M], axis=-1).reshape(-1, 3)
    w = (WM * wphi).reshape(-1)
    return s, w


class Quadrature:
    """Cartesian tensor-product Gauss-Hermite ordinates.

    c: (N, 3) ordinate velocities (scaled by the T0^(1/2) reference
    thermal speed), w: (N,) weights such that sum(w * f_maxwellian) = rho.
    """

    def __init__(self, n1: int = 8, n2: int = 8, n3: int = 8, T0: float = 1.0):
        x1, w1 = np.polynomial.hermite.hermgauss(n1)
        x2, w2 = np.polynomial.hermite.hermgauss(n2)
        x3, w3 = np.polynomial.hermite.hermgauss(n3)
        s = np.sqrt(T0)
        CX, CY, CZ = np.meshgrid(x1 * s * np.sqrt(2), x2 * s * np.sqrt(2),
                                 x3 * s * np.sqrt(2), indexing="ij")
        WX, WY, WZ = np.meshgrid(w1, w2, w3, indexing="ij")
        self.c = np.stack([CX.ravel(), CY.ravel(), CZ.ravel()], axis=1)
        # with c = sqrt(2 T0) x the velocity integral is
        #   int F(c) dc = (2 T0)^{3/2} sum w1w2w3 e^{|c|^2/(2T0)} F(c),
        # the exponential folded into the weight
        c2 = (self.c**2).sum(axis=1)
        self.w = (WX * WY * WZ).ravel() * np.exp(c2 / (2.0 * T0)) * (
            (2.0 * T0) ** 1.5
        )
        self.N = self.c.shape[0]
        self.T0 = T0
        self._dev = {}

    @staticmethod
    def spherical(n_r: int = 8, n_polar: int = 6, n_azimuthal: int = 8,
                  T0: float = 1.0, r_max: float = 6.0):
        """Spherical-coordinate ordinates (reference Quadrature.h spherical
        mode): Gauss-Legendre radial shells x S_N angular directions (no
        specular-mirror permutation: use cartesian for symmetry planes)."""
        q = Quadrature.__new__(Quadrature)
        xr, wr = np.polynomial.legendre.leggauss(n_r)
        rmax = r_max * np.sqrt(T0)
        r = 0.5 * rmax * (xr + 1.0)
        wr = 0.5 * rmax * wr
        s, ws = sn_directions(n_polar, n_azimuthal)
        q.c = (r[:, None, None] * s[None, :, :]).reshape(-1, 3)
        q.w = (wr[:, None] * r[:, None] ** 2 * ws[None, :]).reshape(-1)
        q.N = q.c.shape[0]
        q.T0 = T0
        q._dev = {}
        return q

    def tensors(self, like: torch.Tensor):
        """(c (N, 3), w (N,)) as tensors of ``like``'s dtype on its device,
        made once per (dtype, device)."""
        key = (like.dtype, like.device)
        hit = self._dev.get(key)
        if hit is None:
            hit = (torch.as_tensor(self.c).to(like.device, like.dtype),
                   torch.as_tensor(self.w).to(like.device, like.dtype))
            self._dev[key] = hit
        return hit

    def rest_moments(self, like: torch.Tensor):
        """The moments (rho, momentum, sum w f |c|^2) = (1, 0, 0, 0, 3) of a
        unit gas at rest, T = 1 (the collision Jacobian's stand-in state of
        a cell without mass), made once per (dtype, device): a CUDA graph
        capture copies nothing from the host."""
        key = ("rest", like.dtype, like.device)
        hit = self._dev.get(key)
        if hit is None:
            hit = torch.tensor([1.0, 0.0, 0.0, 0.0, 3.0], dtype=like.dtype,
                               device=like.device)
            self._dev[key] = hit
        return hit

    def maxwellian(self, rho, u, T):
        """Discrete Maxwellian at the ordinates.

        rho: (...,), u: (..., 3), T: (...,) -> f: (..., N)
        """
        c, _ = self.tensors(rho)
        du = c - u[..., None, :]
        c2 = torch.sum(du * du, dim=-1)
        rho = rho[..., None]
        T = T[..., None]
        return rho / (2.0 * math.pi * T) ** 1.5 * torch.exp(-c2 / (2.0 * T))

    def moments(self, f):
        """Conserved moments: rho (...,), momentum (..., 3), energy (...,)."""
        c, w = self.tensors(f)
        rho = torch.sum(f * w, dim=-1)
        mom = torch.einsum("...n,n,nd->...d", f, w, c)
        e = 0.5 * torch.einsum("...n,n,n->...", f, w, torch.sum(c * c, dim=1))
        return rho, mom, e


def reflection_tables(points, normals, k: int | None = None,
                      tol: float = 1e-9, weights=None):
    """Specular-reflection redistribution tables for arbitrary wall
    orientations (reference: esbgkbase/KineticBoundaryConditions.h +
    KineticModel.h:275-310).  The reflected ordinate c_r = c - 2 (c.n) n
    is interpolated over the ``k`` nearest ordinates (inverse distance),
    exact whenever c_r lands on an ordinate, so axis-aligned tensor grids
    get the mirror permutation.

    With ``weights`` (the quadrature weights) the operator is made
    flux-exact by a short Sinkhorn balance: each outgoing ordinate's wall
    flux w_j (c_j.n) is redistributed to incoming ordinates with the total
    preserved, so the wall passes zero net mass flux for any distribution,
    and the rows of the table sum to about 1 (no amplification of the
    ghost-update fixed point).  The stencil widens until the rows balance.

    Returns (idx (L, N, k) int32, w (L, N, k) float64); faces share tables
    through their (rounded) unique normals.  Host numpy, the JAX package's
    arithmetic step by step: the tables are bit-identical to its."""
    if k is None:
        k = 12 if weights is not None else 4
    pts = np.asarray(points, dtype=np.float64)
    nrm = np.asarray(normals, dtype=np.float64)
    N = len(pts)
    mag = np.linalg.norm(nrm, axis=1)
    safe = np.where(mag[:, None] > 1e-300,
                    nrm / np.maximum(mag, 1e-300)[:, None],
                    np.eye(1, pts.shape[1], 0))
    key = np.round(safe, 9)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    tree = KSearchTree(pts)
    qw = None if weights is None else np.asarray(weights, dtype=np.float64)

    def knn_rows(nh, k_try):
        cn = pts @ nh
        cr = pts - 2.0 * cn[:, None] * nh[None, :]
        d, j = tree.query_batch(cr, min(k_try, N))
        d = np.asarray(d).reshape(N, -1)
        j = np.asarray(j).reshape(N, -1)
        w = 1.0 / np.maximum(d, 1e-12)
        w = w / w.sum(axis=1, keepdims=True)
        exact = d[:, 0] < tol
        w[exact] = 0.0
        w[exact, 0] = 1.0
        return cn, j, w

    def balanced(nh, k_try):
        """The flux-weighted operator M_ij = w_i |c_i.n| R_ij balanced to
        column sums w_j (c_j.n)_+ and row sums w_i |c_i.n| (Sinkhorn, ending
        on the column step: conservation exact).  Returns (idx, weights,
        largest row-sum excess)."""
        cn, j, w = knn_rows(nh, k_try)
        kw = j.shape[1]
        incoming = cn < 0
        recv_wt = np.where(incoming, qw * (-cn), 0.0)
        src_flux = qw * np.maximum(cn, 0.0)
        colsum = np.zeros(N)
        np.add.at(colsum, j[incoming].ravel(),
                  (recv_wt[:, None] * w)[incoming].ravel())
        # sources that no incoming stencil references: couple each to the
        # incoming ordinate nearest its reflection
        patches = [[] for _ in range(N)]
        uncovered = (src_flux > 1e-300) & (colsum <= 1e-300)
        if uncovered.any():
            inc_idx = np.nonzero(incoming & (recv_wt > 1e-300))[0]
            tree_in = KSearchTree(pts[inc_idx])
            for jj in np.nonzero(uncovered)[0]:
                crj = pts[jj] - 2.0 * (pts[jj] @ nh) * nh
                _, ii = tree_in.query_batch(crj[None, :], 1)
                istar = inc_idx[int(np.asarray(ii).reshape(-1)[0])]
                patches[istar].append((jj, 1.0))
        kp = max((len(p) for p in patches), default=0)
        jj_full = np.concatenate([j, np.zeros((N, kp), dtype=j.dtype)],
                                 axis=1)
        M = np.concatenate([w, np.zeros((N, kp))], axis=1)
        for i, plist in enumerate(patches):
            for pn, (pj, pw) in enumerate(plist):
                jj_full[i, kw + pn] = pj
                M[i, kw + pn] = pw
        M = recv_wt[:, None] * M
        M[~incoming] = 0.0
        live_row = recv_wt > 1e-300
        for _ in range(60):
            rowsum = M.sum(axis=1)
            M[live_row] *= (
                recv_wt[live_row] / np.maximum(rowsum[live_row], 1e-300)
            )[:, None]
            colsum = np.zeros(N)
            np.add.at(colsum, jj_full.ravel(), M.ravel())
            beta = np.where(colsum > 1e-300,
                            src_flux / np.maximum(colsum, 1e-300), 0.0)
            M = M * beta[jj_full]
        w2 = np.where(live_row[:, None],
                      M / np.maximum(recv_wt, 1e-300)[:, None],
                      np.concatenate([w, np.zeros((N, kp))], axis=1))
        excess = float(np.abs(w2[live_row].sum(axis=1) - 1.0).max()) if \
            live_row.any() else 0.0
        return jj_full, w2, excess

    per_normal = []
    for nh in uniq:
        nh = nh / max(np.linalg.norm(nh), 1e-300)
        if qw is None:
            _, j, w = knn_rows(nh, k)
            per_normal.append((j, w))
            continue
        # the plan can be infeasible on a too-sparse support (not monotone
        # in k): widen the stencil until the rows balance
        best = None
        k_try = k
        while True:
            jj_full, w2, excess = balanced(nh, k_try)
            if best is None or excess < best[2]:
                best = (jj_full, w2, excess)
            if excess < 0.3 or k_try >= min(4 * max(k, 16), N):
                break
            k_try *= 2
        per_normal.append(best[:2])
    kmax = max(jj.shape[1] for (jj, _) in per_normal)
    idx_u = np.zeros((len(uniq), N, kmax), dtype=np.int32)
    w_u = np.zeros((len(uniq), N, kmax), dtype=np.float64)
    for ui, (j, w) in enumerate(per_normal):
        kw = j.shape[1]
        idx_u[ui, :, :kw] = j
        w_u[ui, :, :kw] = w
    return idx_u[inv], w_u[inv]
