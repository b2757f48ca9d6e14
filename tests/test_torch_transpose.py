"""The transposed DIA operator and the derivative rules of ``dia_stencil``
(float64, CPU).

* ``ELLMatrix.transposed`` (``transpose_dia`` for a DIA matrix; the
  mirror-slot gather-ELL with its scatter list otherwise) against the
  dense transpose to 1e-14, on the assembled thermal matrices of
  ``quad_2d``, ``tri_2d``, a periodic strip and the two-material plate
  (interface shell ghosts, periodic pairs) at 16^2, with the slot values
  replaced by random ones (a symmetric matrix would hide a wrong
  transpose); each also through the gather-ELL route (its DIA structure
  dropped).
* The kernel op's plain version under ``torch.autograd.gradcheck`` and
  ``torch.func.jvp`` (finite differences / autograd), and its rules
  (``dia_kernel.stencil_function`` over the plain version, the code the
  kernel's rules run on the card) against torch's autograd of the plain
  version to 1e-14, for mv and residual on (n,) and (n, 2); ``build_coef``
  differentiable through an ``ELLMatrix`` product with fallback entries.
* ``solve_fn_implicit``: the jvp against a dense solve's derivative and
  the reverse mode against the dense adjoint, to 1e-10.
"""

import numpy as np
import pytest
import torch

from fvm_tpu_torch import cases
from fvm_tpu_torch.linear import AMG, BiCGStab
from fvm_tpu_torch.linear.base import TransposedOperator
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh import generate as tgen
from fvm_tpu_torch.models import ThermalModel
from fvm_tpu_torch.ops import dia_kernel as dk
from fvm_tpu_torch.ops.dia import DIAMatrix, transpose_dia
from test_torch_newton import one_thread  # noqa: F401

N = 16


def _thermal(dm, periodic=False):
    t = ThermalModel(dm)
    t.options["verbose"] = False
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["right"].bc_type = ("Periodic" if periodic else "SpecifiedHeatFlux")
    if periodic:
        t.bc["left"].bc_type = "Periodic"
    t.bc["top"].bc_type = "SpecifiedTemperature"
    t.bc["bottom"].bc_type = "Symmetry"
    t.init()
    return t


def _matrix(kind):
    """An assembled thermal matrix with random slot values (seeded)."""
    if kind == "plate":
        t, _ = cases.two_material_plate(device="cpu", nx=N, ny=N)
    elif kind == "periodic":
        m = tgen.quad_2d(N, N)
        m.make_periodic("left", "right")
        t = _thermal(build_device_mesh(m, dtype="float64", device="cpu"),
                     periodic=True)
    else:
        gen = getattr(tgen, kind)
        t = _thermal(build_device_mesh(gen(N, N), dtype="float64",
                                       device="cpu"))
    A, _ = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    rng = np.random.default_rng(7)
    off = torch.as_tensor(rng.standard_normal(A.off.shape))
    diag = torch.as_tensor(4.0 + rng.random(A.n))
    return A.replace(off=torch.where(A.mask, off, 0.0), diag=diag)


def _dense(op, n):
    eye = torch.eye(n, dtype=torch.float64)
    return torch.stack([op.mv(eye[i]) for i in range(n)], dim=1)


@pytest.mark.parametrize("kind", ["quad_2d", "tri_2d", "periodic", "plate"])
@pytest.mark.parametrize("route", ["as built", "gather-ELL"])
def test_transposed_equals_dense_transpose(kind, route):
    A = _matrix(kind)
    assert A.dia is not None  # all four have DIA structure at 16^2
    if route == "gather-ELL":
        A = A.replace(dia=None)
    Ad = _dense(A, A.n)
    At = A.transposed()
    assert isinstance(At, DIAMatrix if route == "as built" else type(A))
    np.testing.assert_allclose(_dense(At, A.n).numpy(), Ad.T.numpy(),
                               rtol=0, atol=1e-14 * Ad.abs().max().item())
    if kind == "plate" and route == "gather-ELL":
        # the shell ghosts' extra slots have no mirror
        assert At.scatter is not None and At.scatter[0].numel()
    op = TransposedOperator(A)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.n))
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(A.n))
    ref = Ad.T @ x
    tol = 1e-13 * ref.abs().max().item()
    np.testing.assert_allclose(op.residual(x, b).numpy(), (b - ref).numpy(),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(
        op.jacobi_step(x, b, 0.7).numpy(),
        (x + 0.7 * (b - ref) / A.diag).numpy(), rtol=0, atol=tol)


def test_transpose_dia_shifts_and_swaps():
    """``transpose_dia`` on a random DIA operator with fallback entries:
    offsets negated and sorted, rows and columns of the fallback swapped,
    the kernel's layout kept, and (A^T)^T = A exactly."""
    rng = np.random.default_rng(3)
    n, offs = 57, (-9, -1, 1, 4, 9)
    coef = dk.pack_coef(torch.as_tensor(rng.standard_normal((5, n))))
    diag = torch.as_tensor(rng.standard_normal(n))
    fb = (torch.tensor([3, 10, 10]), torch.tensor([40, 0, 2]),
          torch.as_tensor(rng.standard_normal(3)))
    A = DIAMatrix(diag, coef, offs, fb)
    t = transpose_dia(offs, diag, coef, *fb)
    assert t[0] == (-9, -4, -1, 1, 9)
    assert dk.coef_packed(t[2])
    assert t[3] is fb[1] and t[4] is fb[0]
    At = DIAMatrix(t[1], t[2], t[0], t[3:])
    assert torch.equal(At.to_dense(), A.to_dense().T)
    tt = transpose_dia(*t)
    assert tt[0] == offs and torch.equal(
        DIAMatrix(tt[1], tt[2], tt[0], tt[3:]).to_dense(), A.to_dense())


def _operands(mode, m, n=40, offs=(-7, -1, 1, 7), seed=5):
    rng = np.random.default_rng(seed)
    shape = (n,) if m == 1 else (n, m)
    coef = dk.pack_coef(torch.as_tensor(rng.standard_normal((len(offs), n))))
    diag = torch.as_tensor(2.0 + rng.random(n))
    x = torch.as_tensor(rng.standard_normal(shape))
    b = torch.as_tensor(rng.standard_normal(shape)) if mode != "mv" else None
    return offs, coef, diag, x, b


@pytest.mark.parametrize("mode", ["mv", "residual", "jacobi"])
def test_plain_version_gradcheck_and_jvp(mode):
    """torch differentiates the plain version on a CPU tensor: its
    gradients against finite differences, its jvp against autograd."""
    offs, coef, diag, x, b = _operands(mode, 2, n=12)
    b = torch.zeros_like(x) if b is None else b

    def f(c, d, xx, bb):
        return dk.dia_stencil(offs, mode, c, d, xx,
                              b=None if mode == "mv" else bb,
                              omega=0.7 if mode == "jacobi" else None)

    ins = tuple(t.clone().requires_grad_(True) for t in (coef, diag, x, b))
    assert torch.autograd.gradcheck(f, ins)
    tans = tuple(torch.ones_like(t) for t in ins)
    _, jv = torch.func.jvp(f, (coef, diag, x, b), tans)
    y = f(*ins)
    ref = torch.autograd.grad(y, ins, torch.ones_like(y), allow_unused=True)
    # <g, J t> = <J^T g, t> with g = t = ones
    lhs = jv.sum()
    rhs = sum((r * t).sum() for r, t in zip(ref, tans) if r is not None)
    assert abs(float(lhs - rhs)) <= 1e-12 * float(abs(rhs))


def _plain(offsets, mode, coef, diag, x, b, omega):
    return dk.dia_stencil_plain(offsets, mode, coef, diag, x, b=b,
                                omega=omega)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("mode", ["mv", "residual"])
def test_rules_match_autograd_of_the_plain_version(mode, m):
    """The kernel op's jvp and backward rules, run over the plain version,
    equal torch's own derivatives of the plain version (the rules' code
    is the card's; only the product differs)."""
    offs, coef, diag, x, b = _operands(mode, m)
    fn = dk.stencil_function(_plain)
    rng = np.random.default_rng(9)

    def rules(c, d, xx, bb):
        return fn.apply(c, d, xx, bb, offs, mode)

    def plain(c, d, xx, bb):
        return dk.dia_stencil_plain(offs, mode, c, d, xx, b=bb)

    ins = [t for t in (coef, diag, x, b) if t is not None]
    tans = [torch.as_tensor(rng.standard_normal(t.shape)) for t in ins]
    args = ins + ([None] if b is None else [])
    targs = tans + ([None] if b is None else [])
    if b is None:
        f1 = lambda c, d, xx: rules(c, d, xx, None)  # noqa: E731
        f2 = lambda c, d, xx: plain(c, d, xx, None)  # noqa: E731
        args, targs = args[:3], targs[:3]
    else:
        f1, f2 = rules, plain
    _, j1 = torch.func.jvp(f1, tuple(args), tuple(targs))
    _, j2 = torch.func.jvp(f2, tuple(args), tuple(targs))
    np.testing.assert_allclose(j1.numpy(), j2.numpy(), rtol=0, atol=1e-14)
    gy = torch.as_tensor(rng.standard_normal(x.shape))
    leaves = [t.clone().requires_grad_(True) for t in args]
    g1 = torch.autograd.grad(f1(*leaves), leaves, gy)
    leaves = [t.clone().requires_grad_(True) for t in args]
    g2 = torch.autograd.grad(f2(*leaves), leaves, gy)
    for a, c in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-14)


def test_ell_product_differentiable_through_build_coef():
    """An ``ELLMatrix`` product differentiated with respect to its slot
    values and diagonal (``build_coef``'s differentiable route, the
    fallback entries' scatter included) against finite differences."""
    A = _matrix("plate")
    assert A.dia is not None and A.dia.fb_rows.numel()
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(A.n))

    def f(off, diag):
        return A.replace(off=off, diag=diag).mv(x)

    ins = (A.off.clone().requires_grad_(True),
           A.diag.clone().requires_grad_(True))
    assert torch.autograd.gradcheck(f, ins)


@pytest.fixture(scope="module")
def slab():
    t = cases.sensitivity_slab(N, device="cpu", ny=8)
    t.advance(5)
    A, r = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    return t, A, r


def test_implicit_solve_jvp_and_adjoint_match_dense(slab):
    """dx = A^-1 (db - dA x) and (b-bar, A-bar) = (A^-T x-bar, -lambda x^T)
    of ``solve_fn_implicit`` against a dense solve, to 1e-10."""
    t, A, _ = slab
    solver = BiCGStab(preconditioner=AMG(), relative_tolerance=1e-13,
                      max_iterations=60)
    AMG.setup_structure(solver.preconditioner, *t.mesh.host_cf(), "cpu")
    rng = np.random.default_rng(11)
    b = torch.as_tensor(rng.standard_normal(A.n))
    db = torch.as_tensor(rng.standard_normal(A.n))
    doff = torch.where(A.mask, torch.as_tensor(
        rng.standard_normal(A.off.shape)), 0.0)
    ddiag = torch.as_tensor(rng.standard_normal(A.n))
    Ad = _dense(A, A.n)
    dAd = _dense(A.replace(off=doff, diag=ddiag), A.n)
    x = torch.linalg.solve(Ad, b)
    ref = torch.linalg.solve(Ad, db - dAd @ x)

    def f(diag, off, bb):
        return solver.solve_fn_implicit(A.replace(diag=diag, off=off), bb,
                                        None, transposable=True)[0]

    _, dx = torch.func.jvp(f, (A.diag, A.off, b), (ddiag, doff, db))
    np.testing.assert_allclose(dx.numpy(), ref.numpy(), rtol=0,
                               atol=1e-10 * ref.abs().max().item())
    g = torch.as_tensor(rng.standard_normal(A.n))
    leaves = [A.diag.clone().requires_grad_(True),
              A.off.clone().requires_grad_(True),
              b.clone().requires_grad_(True)]
    gd, goff, gb = torch.autograd.grad(f(*leaves), leaves, g)
    lam = torch.linalg.solve(Ad.T, g)
    np.testing.assert_allclose(gb.numpy(), lam.numpy(), rtol=0,
                               atol=1e-10 * lam.abs().max().item())
    # <A-bar, dA> = -lambda^T dA x
    lhs = float((gd * ddiag).sum() + (goff * doff).sum())
    rhs = float(-(lam @ (dAd @ x)))
    assert abs(lhs - rhs) <= 1e-10 * abs(rhs)
    with pytest.raises(RuntimeError, match="transposable"):
        leaves = [t.clone().requires_grad_(True) for t in (A.diag, A.off, b)]
        y = solver.solve_fn_implicit(A.replace(diag=leaves[0],
                                               off=leaves[1]), leaves[2],
                                     None)[0]
        torch.autograd.grad(y.sum(), leaves)
