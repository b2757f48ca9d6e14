"""ILU(0) solver / preconditioner (counterpart of ``fvm_tpu/linear/ilu.py``).

The reference's ILU0Solver (ILU0Solver.h:20), as the JAX package computes
it: the fine-grained fixed-point factorization of Chow & Patel (SIAM J.
Sci. Comput. 2015) on the DIA coefficients, every L/U entry updated from
the ILU equations at once in each sweep (rolls and elementwise products),
and the triangular solves approximated by truncated Jacobi sweeps on the
strictly triangular parts:

    lower sweep  z = r - sum_{d<0} l_d z[i+d]
    upper sweep  x = (z - sum_{d>0} u_d x[i+d]) / u_diag

Each sweep is one DIA product, so on a CUDA tensor it is one launch of the
port's ``dia_stencil`` kernel (``ops/dia_kernel.py``, the port of the JAX
package's only TPU kernel) in residual mode with a zero diagonal: the
kernel computes ``b - (0 * x + sum_d coef_d x[i+d])``, diagonal term first
and then the offsets in order, which is the sweep's own sum in the same
order.  The plain version beside it (:func:`ilu0_apply_plain`) is the JAX
package's roll formula, run for a CPU tensor only.

The roll wraps around and the kernel reads x as 0 outside [0, n); the two
agree because every coefficient whose column i+d falls outside [0, n) is
0: the DIA bucketing (``ops/dia.analyze_offsets``) places only real
couplings, and the factorization keeps those entries at 0 (0 / u_diag of
the wrapped row).  ``tests/test_torch_ilu_spike.py`` asserts this on the
condensed cavity and thermal matrices.

Not a device fallback: a matrix with fallback entries (offsets outside the
DIA set) or no DIA structure is preconditioned by diagonal scaling, the
JAX package's own semantics (``ilu.py:107-125``).  That is a choice of the
algorithm, the same on every device; a CUDA tensor never runs the plain
version or the CPU in place of the kernel.
"""

from __future__ import annotations

import torch

from ..ops import dia_kernel
from .base import LinearSolver, SolveStats, condensed, prepared


def ilu0_factor(offsets, coef, diag, sweeps: int = 3):
    """Fixed-point ILU(0) factorization on DIA arrays: ``coef`` is the
    logical (D, n) view of the offsets' coefficients (any row stride).

    Returns (l (dict d<0 -> (n,)), u (dict d>0 -> (n,)), u_diag (n,)),
    A = L U on the sparsity pattern, L unit lower triangular; the JAX
    formula term by term, in the same order of offsets and terms."""
    offsets = [int(d) for d in offsets]
    neg = [d for d in offsets if d < 0]
    pos = [d for d in offsets if d > 0]
    a = {d: coef[i] for i, d in enumerate(offsets)}
    u_diag = diag
    l = {d: a[d] / torch.roll(diag, -d) for d in neg}
    u = {d: a[d] for d in pos}

    def corrections(l, u, t):
        """sum over k < min(i, j) of l_ik u_kj restricted to the pattern."""
        acc = None
        for d1 in neg:
            d2 = t - d1
            if d2 == 0:
                continue  # k == j (t < 0) is the division; k == i never
            if d2 not in u:
                continue
            if t < 0 and not (d1 < t):
                continue  # need k < j for L entries
            term = l[d1] * torch.roll(u[d2], -d1)
            acc = term if acc is None else acc + term
        return acc

    for _ in range(sweeps):
        new_l = {}
        for d in neg:
            c = corrections(l, u, d)
            num = a[d] if c is None else a[d] - c
            new_l[d] = num / torch.roll(u_diag, -d)
        new_u = {}
        for d in pos:
            c = corrections(l, u, d)
            new_u[d] = a[d] if c is None else a[d] - c
        c0 = corrections(l, u, 0)
        new_ud = diag if c0 is None else diag - c0
        l, u, u_diag = new_l, new_u, new_ud
    return l, u, u_diag


def _expand(v, x):
    """The strictly triangular part ``v`` applied to x: sum_d c_d x[i+d]
    with the roll (the JAX formula)."""
    acc = None
    for d, c in v.items():
        cc = c if x.ndim == 1 else c[:, None]
        term = cc * torch.roll(x, -d, dims=0)
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros_like(x)
    return acc


def ilu0_apply_plain(l, u, u_diag, r, tri_sweeps: int = 4):
    """Plain PyTorch version: approximate (LU)^-1 r by truncated Jacobi
    triangular solves, the JAX package's roll formula."""
    z = r
    for _ in range(tri_sweeps):
        z = r - _expand(l, z)
    ud = u_diag if r.ndim == 1 else u_diag[:, None]
    x = z / ud
    for _ in range(tri_sweeps):
        x = (z - _expand(u, x)) / ud
    return x


class PackedFactors:
    """The factors as ``dia_stencil`` operands: the lower and upper
    coefficients each packed in the kernel's layout
    (``dia_kernel.pack_coef``), u_diag, and one zero diagonal (contiguous,
    16-byte aligned), made once per factorization."""

    def __init__(self, l, u, u_diag):
        self.neg = tuple(l)
        self.pos = tuple(u)
        n = u_diag.shape[0]
        kw = dict(dtype=u_diag.dtype, device=u_diag.device)
        self.l = dia_kernel.pack_coef(torch.stack(list(l.values()))) \
            if l else dia_kernel.empty_coef(0, n, **kw)
        self.u = dia_kernel.pack_coef(torch.stack(list(u.values()))) \
            if u else dia_kernel.empty_coef(0, n, **kw)
        self.u_diag = u_diag.contiguous()
        self.zero = torch.zeros(n, **kw)


def _sweep(offsets, coef, zero, x, b):
    """b - sum_d coef_d x[i+d]: one ``dia_stencil`` launch in residual mode
    with the zero diagonal (b itself when there is no offset, as the roll
    formula's b - 0)."""
    if not offsets:
        return b - torch.zeros_like(x)
    return dia_kernel.dia_stencil(offsets, "residual", coef, zero,
                                  x.contiguous(), b=b.contiguous())


def ilu0_apply_dia(packed, r, tri_sweeps: int = 4):
    """The sweeps as ``dia_stencil`` calls on the factors ``packed`` (a
    :class:`PackedFactors`): one launch per sweep on a CUDA tensor (its
    plain version on a CPU tensor, which the tests hold against
    :func:`ilu0_apply_plain` bit for bit)."""
    p = packed
    z = r
    for _ in range(tri_sweeps):
        z = _sweep(p.neg, p.l, p.zero, z, r)
    ud = p.u_diag if r.ndim == 1 else p.u_diag[:, None]
    x = z / ud
    for _ in range(tri_sweeps):
        x = _sweep(p.pos, p.u, p.zero, x, z) / ud
    return x


def ilu0_apply(l, u, u_diag, r, tri_sweeps: int = 4, packed=None):
    """Approximate (LU)^-1 r for r of shape (n,) or (n, m), m <= 3.

    A CPU tensor runs :func:`ilu0_apply_plain`.  A CUDA tensor runs each
    triangular sweep as one ``dia_stencil`` launch (module docstring), 2
    ``tri_sweeps`` launches per apply, on ``packed`` (the
    :class:`PackedFactors` of the same factors, made once by the caller;
    made here when None)."""
    if r.device.type == "cpu":
        return ilu0_apply_plain(l, u, u_diag, r, tri_sweeps)
    if packed is None:
        packed = PackedFactors(l, u, u_diag)
    return ilu0_apply_dia(packed, r, tri_sweeps)


def stationary_solve(solver, A, b, x0):
    """The stationary loop x += omega M(b - A x) of ``ILU0Solver`` and
    ``SpikeSolver`` (their JAX ``solve_fn``, one ``lax.while_loop``) in the
    port's frozen form (``linear/base.py``): ``max_iterations`` trips, the
    iterate frozen once the residual norm meets the target."""
    A, b, recover = condensed(A, b)
    A = prepared(A)
    M = solver.precond_setup(A)
    rnorm0 = A.norm(A.residual(x0, b))
    target = torch.clamp(solver.relativeTolerance * rnorm0,
                         min=solver.absoluteTolerance)
    i = torch.zeros((), dtype=torch.int64, device=b.device)
    x, rn = x0, rnorm0
    for _ in range(solver.nMaxIterations):
        active = rn > target
        x_n = x + solver.omega * M(A.residual(x, b))
        rn_n = A.norm(A.residual(x_n, b))
        i = i + active.to(i.dtype)
        x, rn = torch.where(active, x_n, x), torch.where(active, rn_n, rn)
    return recover(x), SolveStats(i, rnorm0, rn, rn <= target)


def diag_scaling(A):
    """The diagonal-scaling preconditioner both solvers take on a matrix
    without the structure they need (the JAX package's semantics)."""
    return A.diag_solve


class ILU0Solver(LinearSolver):
    """ILU(0) smoother / preconditioner / stationary solver."""

    def __init__(self, factor_sweeps: int = 3, tri_sweeps: int = 4,
                 omega: float = 1.0, **kw):
        kw.setdefault("max_iterations", 50)
        super().__init__(**kw)
        self.factor_sweeps = factor_sweeps
        self.tri_sweeps = tri_sweeps
        self.omega = omega

    def _factor(self, A):
        if getattr(A, "dia", None) is None or A.dia_coef is None:
            return None
        if A.dia.fb_rows.shape[0]:
            return None  # pattern not purely DIA: diagonal scaling
        return ilu0_factor(A.dia.offsets, A.dia_coef, A.diag,
                           self.factor_sweeps)

    def precond_setup(self, A):
        A = prepared(A)
        fac = self._factor(A)
        if fac is None:
            return diag_scaling(A)
        l, u, ud = fac
        tri = self.tri_sweeps
        packed = None if ud.device.type == "cpu" else PackedFactors(l, u, ud)

        def M(r):
            return ilu0_apply(l, u, ud, r, tri, packed)

        return M

    def solve_fn(self, A, b, x0):
        return stationary_solve(self, A, b, x0)
