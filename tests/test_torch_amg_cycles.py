"""The port's AMG W and F cycles and its bfloat16 cycle against fvm_tpu
(CPU).

* W and F cycles (and V beside them) in the setup of
  ``tests/test_linear.py:406-440``: the 48^2 two-wall thermal system,
  standalone AMG, coarse size 16, rtol 1e-10, 40 cycles at most, float64.
  Equal cycle counts and converged flags; solutions to 1e-10 relative.

bfloat16 has an 8-bit significand: its unit round-off is u = 2^-8 (a
rounding moves a value by at most u/2 of its magnitude).  Every bfloat16
tolerance below is a multiple of u fixed from that, not from a run:

* ``dia_stencil``'s plain version in bfloat16 against fvm_tpu's bfloat16
  ``fused_apply`` (the roll formula in bfloat16) at every mode: the port
  rounds once (float32 arithmetic inside), the JAX package after each of
  its D + 1 products and sums and each of the mode's up to four further
  operations, each rounding at most u/2 of a partial result bounded by
  the row's sum of magnitudes S.  So per row
  |y_port - y_jax| <= (D + 6) u/2 S, with S = |diag x| + sum |c x_d|
  (mv), plus |b| (residual), and |x| + omega (|b| + S) / |diag| (Jacobi).
* One bfloat16 cycle (the preconditioner ``M(r)``) against the same cycle
  in float64, for each package: every operand and intermediate is the
  float64 one rounded to 8 bits, and the smoother and the coarse
  correction damp the earlier roundings, so the result stays within 2u
  (2-norm, relative) of the float64 cycle; the two packages within 4u of
  each other.
* bfloat16 AMG as a standalone solver (rtol 1e-4): the solve is the
  cycle iterated on the float64 residual, x_k = x_{k-1} + M(r_{k-1}).
  Over the first ``FIRST_CYCLES`` cycles each package's iterate and its
  residual norm are held against the other's at the same 4u: the
  iterates' difference obeys d_k = (I - M A) d_{k-1} + e_k, with e_k the
  two cycles' difference on one input (at most 4u of the correction
  M(r_{k-1}), above); the error propagation I - M A of a convergent cycle
  damps what is carried and the corrections shrink, so the iterates stay
  within 4u of each other.  The residual is the float64 image b - A x_k,
  and the cycles' difference comes from their coarse-grid corrections
  (interpolated, so smooth) and is damped by the post-smoother, so A
  does not magnify it: the residual norms too stay within 4u.  The full
  solve takes the same number of cycles in both packages, and both
  converge.
* bfloat16 AMG as the BiCGStab preconditioner (rtol 1e-8): the first
  iteration's residual norm is held at 4u as above (each of its two
  preconditioner applications differs by at most 4u).  From the second
  iteration on, BiCGStab's scalars (inner products with the shadow
  residual, and their ratios) carry those differences into every later
  direction, and the two packages' iterations part: their residual
  norms are not compared there.  Both converge, and their iteration
  counts may differ by one: the preconditioner is a slightly different
  nonlinear map in each package, both contract at the same average rate,
  and the noise only moves the iteration at which each crosses the
  target.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu.linear as jlin
import fvm_tpu_torch as tfvm
import fvm_tpu_torch.linear as tlin
from fvm_tpu.models import ThermalModel as JThermal
from fvm_tpu.ops import dia as jdia
from fvm_tpu_torch.models import ThermalModel as TThermal
from fvm_tpu_torch.ops import dia_kernel as dk

SOL_RTOL = 1e-10
U_BF16 = 2.0 ** -8
FIRST_CYCLES = 6


def _thermal_system(pkg, Thermal, n=48):
    kw = {"device": "cpu", "dtype": "float64"} if pkg is tfvm else {
        "dtype": jnp.float64}
    t = Thermal(pkg.mesh.build_device_mesh(pkg.mesh.generate.quad_2d(n, n),
                                           **kw))
    t.options["verbose"] = False
    t.options["linearSolver"] = pkg.linear.AMG(coarse_size=16)
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    return t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())


@pytest.fixture(scope="module")
def systems():
    return (_thermal_system(jfvm, JThermal), _thermal_system(tfvm, TThermal))


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_cycle_matches(systems, cycle):
    (jA, jb), (tA, tb) = systems
    mk = lambda L: L.AMG(coarse_size=16, cycle=cycle,
                         relative_tolerance=1e-10, max_iterations=40)
    xj, sj = mk(jlin).solve_fn(jA, jb, jnp.zeros_like(jb))
    xt, st = mk(tlin).solve_fn(tA, tb, torch.zeros_like(tb))
    assert int(st.iterations) == int(sj.iterations)
    assert bool(st.converged) == bool(sj.converged)
    # V stalls here; W and F converge (fewer cycles for W)
    assert bool(st.converged) == (cycle != "V")
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=SOL_RTOL,
                               atol=SOL_RTOL * float(np.abs(xj).max()))


@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("m", [1, 2])
def test_bf16_stencil_matches_jax(mode, m):
    n, offsets, omega = 3000, (-60, -1, 1, 60), 0.7
    rng = np.random.default_rng(4 + m)
    coef = rng.standard_normal((len(offsets), n))
    idx = np.arange(n)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = 4.0 + rng.random(n)
    shape = (n,) if m == 1 else (n, m)
    x, b = rng.standard_normal(shape), rng.standard_normal(shape)
    # the operands as bfloat16 values, held exactly in float64 for S
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tc, td, tx, tb = bf(coef), bf(diag), bf(x), bf(b)
    c64, d64, x64, b64 = (t.double().numpy() for t in (tc, td, tx, tb))
    kw = {} if mode == "mv" else {"b": tb}
    if mode == "jacobi":
        kw["omega"] = omega
    y = dk.dia_stencil(offsets, mode, dk.pack_coef(tc), td, tx, **kw)
    assert y.dtype == torch.bfloat16
    j = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
    yj = jdia.fused_apply(offsets, j(d64), j(c64), j(x64),
                          b=None if mode == "mv" else j(b64),
                          omega=omega if mode == "jacobi" else None,
                          mode=mode)
    assert yj.dtype == jnp.bfloat16
    # S: the row's sum of magnitudes of the terms the mode adds up
    dg = d64 if m == 1 else d64[:, None]
    S = np.abs(dg * x64)
    for k, d in enumerate(offsets):
        xs = np.zeros_like(x64)
        lo, hi = max(0, -d), min(n, n - d)
        xs[lo:hi] = x64[lo + d:hi + d]
        S = S + np.abs((c64[k] if m == 1 else c64[k][:, None]) * xs)
    if mode == "residual":
        S = S + np.abs(b64)
    elif mode == "jacobi":
        S = np.abs(x64) + omega * (np.abs(b64) + S) / np.abs(dg)
    err = np.abs(y.double().numpy() - np.asarray(yj, dtype=np.float64))
    bound = (len(offsets) + 6) * U_BF16 / 2 * S
    assert np.all(err <= bound), float((err / bound).max())


def _condensed(A, b):
    A2, b2, _ = A.condense(b)
    return A2.prepare(), b2


def test_bf16_cycle_matches(systems):
    (jA, jb), (tA, tb) = systems
    jA2, jb2 = _condensed(jA, jb)
    tA2, tb2 = _condensed(tA, tb)
    zj = np.asarray(jlin.AMG(coarse_size=16, precision="bf16")
                    .precond_setup(jA2)(jb2))
    tamg = tlin.AMG(coarse_size=16, precision="bf16")
    zt = tamg.precond_setup(tA2)(tb2)
    assert zt.dtype == torch.float64  # cast back at the cycle's edge
    _, mats, inv = tamg._build_hierarchy(tA2)
    assert inv.dtype == torch.bfloat16
    assert all(M.diag.dtype == torch.bfloat16 for M in mats)
    zt = zt.numpy()
    zf = tlin.AMG(coarse_size=16).precond_setup(tA2)(tb2).numpy()
    rel = lambda a, ref: np.linalg.norm(a - ref) / np.linalg.norm(ref)
    assert rel(zt, zf) <= 2 * U_BF16
    assert rel(zj, zf) <= 2 * U_BF16
    assert rel(zt, zj) <= 4 * U_BF16
    assert rel(zt, zf) > 0  # it did run in bfloat16


def _bf16_solver(L, solver, maxit):
    if solver == "amg":
        return L.AMG(coarse_size=16, precision="bf16",
                     relative_tolerance=1e-4, max_iterations=maxit)
    return L.BiCGStab(preconditioner=L.AMG(coarse_size=16, precision="bf16"),
                      relative_tolerance=1e-8, max_iterations=maxit)


@pytest.mark.parametrize("solver,first,maxit,count_spread", [
    ("amg", FIRST_CYCLES, 60, 0),
    ("bicgstab+amg", 1, 40, 1),
])
def test_bf16_solves_match(systems, solver, first, maxit, count_spread):
    (jA, jb), (tA, tb) = systems
    # the first iterations, each package run to k iterations
    for k in range(1, first + 1):
        xj, sj = _bf16_solver(jlin, solver, k).solve_fn(
            jA, jb, jnp.zeros_like(jb))
        xt, st = _bf16_solver(tlin, solver, k).solve_fn(
            tA, tb, torch.zeros_like(tb))
        assert int(st.iterations) == int(sj.iterations) == k
        rj, rt = float(sj.residual), float(st.residual)
        assert abs(rt - rj) <= 4 * U_BF16 * rj, (k, abs(rt - rj) / rj)
        xj = np.asarray(xj)
        dx = np.linalg.norm(xt.numpy() - xj)
        assert dx <= 4 * U_BF16 * np.linalg.norm(xj), (k, dx)
    # the whole solve
    xj, sj = _bf16_solver(jlin, solver, maxit).solve_fn(
        jA, jb, jnp.zeros_like(jb))
    xt, st = _bf16_solver(tlin, solver, maxit).solve_fn(
        tA, tb, torch.zeros_like(tb))
    assert bool(st.converged) and bool(sj.converged)
    assert abs(int(st.iterations) - int(sj.iterations)) <= count_spread


def test_bf16_plain_rounds_once():
    """The bfloat16 rounding is defined in one place: the plain version
    widens the operands to float32, computes in the float32 order and
    rounds once; the dispatch sends every bfloat16 call to ``narrow``, the
    one variant built for it, and the operand check takes bfloat16 in the
    kernel's layout (``cast_coef``)."""
    n, offsets = 1027, (-33, -1, 1, 33)
    rng = np.random.default_rng(9)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    coef = dk.cast_coef(bf(rng.standard_normal((4, n))), torch.bfloat16)
    diag, x, b = bf(4 + rng.random(n)), bf(rng.standard_normal(n)), bf(
        rng.standard_normal(n))
    assert dk.coef_packed(coef) and coef.dtype == torch.bfloat16
    for mode in dk.MODES:
        kw = {} if mode == "mv" else {"b": b}
        if mode == "jacobi":
            kw["omega"] = 0.7
        y = dk.dia_stencil(offsets, mode, coef, diag, x, **kw)
        f = {k: v.float() for k, v in kw.items() if torch.is_tensor(v)}
        want = dk.dia_stencil_plain(offsets, mode, coef.float(),
                                    diag.float(), x.float(),
                                    **dict(kw, **f)).to(torch.bfloat16)
        assert torch.equal(y, want)
        assert dk.check_operands(offsets, mode, coef, diag, x, **kw) == 1
    assert dk.variants(torch.bfloat16) == ("narrow",)
    assert dk.variants(torch.float32) == dk.VARIANTS
    for rows in (1, dk.WIDE_MIN_ROWS, 4 * dk.WIDE_MIN_ROWS):
        assert dk.dispatch(rows, torch.bfloat16) == "narrow"
    assert dk.dispatch(dk.WIDE_MIN_ROWS, torch.float32) == "wide"
