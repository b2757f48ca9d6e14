"""ILU(0), truncated SPIKE and the solver-family goldens against fvm_tpu
(float64, CPU).

* ``ilu0_factor`` and ``ilu0_apply`` to 1e-12 against the JAX package's on
  the condensed matrices of the cavity's pressure correction and of the
  two-wall thermal case (32^2, the golden configurations), on (n,) and
  (n, 2) right-hand sides made from a numpy seed; ``spike_apply`` to 1e-12
  on random tridiagonals (single and multi right-hand side, n not a
  multiple of the chunk) and the exact solve of
  ``tests/test_linear.py:253``.
* The zero-wrap property the CUDA path rests on: every DIA coefficient of
  those condensed matrices, and of their ILU factors, whose column i+d
  falls outside [0, n) is 0; then the kernel path's sweeps
  (``ilu0_apply_dia``: ``dia_stencil`` in residual mode with a zero
  diagonal, its plain version on the CPU) equal the roll formula bit for
  bit.
* ``tests/test_linear.py:210-318`` in the port: ILU(0) beats Jacobi on an
  anisotropic Poisson problem, BiCGStab(ILU0) converges, SPIKE line
  relaxation beats Jacobi by 10x on a stretched mesh, the stationary SPIKE
  solve converges; each solve also against fvm_tpu's iterates.
* The goldens.  ``cavity/JACOBI/np1`` is held at 1e-8 (fvm_tpu's own
  history moves by 1.1e-14 under a 1e-15 change of the viscosity).  The
  ILU0 and SPIKE goldens move by more under round-off in fvm_tpu itself
  (``scripts/roundoff_sensitivity.py --cases goldens``, CPU: cavity ILU0
  1.3e-2, SPIKE 6.9e-2; thermal ILU0 2.1e-8, SPIKE 5.6e-6), so the
  solver's own iterates are held instead: BiCGStab(ILU0) and
  BiCGStab(SPIKE) in the golden settings on the first outer's fixed
  pressure and thermal systems, solution and iteration count against
  fvm_tpu's at 1e-10 (the pressure solve up to 12 iterations: its
  recurrence amplifies round-off ~10x per two iterations in both
  packages, ``CAVITY_TRIPS``).
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fvm_tpu.linear import BiCGStab as JBiCGStab, JacobiSolver as JJacobi
from fvm_tpu.linear.ilu import (ILU0Solver as JILU0, ilu0_apply as j_apply,
                                ilu0_factor as j_factor)
from fvm_tpu.linear.spike import SpikeSolver as JSpike
from fvm_tpu.linear.spike import spike_apply as j_spike
from fvm_tpu.ops.dia import DIAInfo as JDIAInfo
from fvm_tpu.ops.ell import ELLMatrix as JELL
from fvm_tpu_torch import cases
from fvm_tpu_torch.exceptions import ConfigError
from fvm_tpu_torch.linear import (BiCGStab, ILU0Solver, JacobiSolver,
                                  LinearSolver, SpikeSolver)
from fvm_tpu_torch.linear.ilu import (PackedFactors, ilu0_apply,
                                      ilu0_apply_dia, ilu0_apply_plain,
                                      ilu0_factor)
from fvm_tpu_torch.linear.spike import spike_apply
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import quad_2d
from fvm_tpu_torch.models import FlowModel, ThermalModel
from fvm_tpu_torch.ops.ell import ELLMatrix
from test_torch_newton import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "histories.json")
RTOL = 1e-12
ITER_RTOL = 1e-10
HIST_RTOL = 1e-8  # BASELINE.md parity tolerance, test_golden_histories RTOL


class _Recording(LinearSolver):
    """A solver that keeps the (A, b) of each call and hands it on."""

    def __init__(self, inner):
        super().__init__()
        self.inner, self.calls = inner, []

    def solve_fn(self, A, b, x0):
        self.calls.append((A, b))
        return self.inner.solve_fn(A, b, x0)


def _mesh(nx, ny=None, **kw):
    return build_device_mesh(quad_2d(nx, ny or nx, **kw), dtype="float64",
                             device="cpu")


def _thermal(dm, solver):
    t = ThermalModel(dm)
    t.options["verbose"] = False
    t.options["linearSolver"] = solver
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedTemperature"
    t.bc["right"]["specifiedTemperature"] = 300.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    return t


def _cavity(dm, solver):
    m = FlowModel(dm)
    m.options["verbose"] = False
    m.vc["density"] = 1.0
    m.vc["viscosity"] = 0.1
    for s in ("left", "right", "bottom", "top"):
        m.bc[s].bc_type = "NoSlipWall"
    m.bc["top"]["specifiedXVelocity"] = 1.0
    m.options["pressureLinearSolver"] = solver
    m.init()
    return m


@pytest.fixture(scope="module")
def systems():
    """The first outer's (A, b) of the golden cavity's pressure correction
    and of the golden thermal case, 32^2 float64, from the port."""
    rec_p = _Recording(cases.family_solver("JACOBI"))
    _cavity(_mesh(32), rec_p).advance(1)
    rec_t = _Recording(cases.family_solver("JACOBI"))
    t = _thermal(_mesh(32), rec_t)
    t.advance(1)
    return {"cavity": rec_p.calls[0], "thermal": rec_t.calls[0]}


def _jax_ell(A):
    """The same ELL matrix in the JAX package (host (n, K) DIA analysis)."""
    cols = A.cols.numpy().T.copy()
    mask = A.mask.numpy().T.copy()
    return JELL(diag=jnp.asarray(A.diag.numpy()),
                off=jnp.asarray(A.off.numpy()),
                cols=jnp.asarray(A.cols.numpy(), jnp.int32),
                mask=jnp.asarray(A.mask.numpy()),
                dia=JDIAInfo.build(cols, mask))


def _condensed(A, b):
    A2, b2, _ = A.condense(b)
    return A2.prepare(), b2


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("which", ["cavity", "thermal"])
def test_ilu0_factor_and_apply_equal_fvm_tpu(systems, which):
    A, b = _condensed(*systems[which])
    assert A.dia is not None and A.dia.fb_rows.shape[0] == 0
    offs, coef, diag = A.dia.offsets, A.dia_coef, A.diag
    l, u, ud = ilu0_factor(offs, coef, diag)
    jl, ju, jud = j_factor(offs, jnp.asarray(coef.numpy()),
                           jnp.asarray(diag.numpy()))
    assert list(l) == list(jl) and list(u) == list(ju)
    for d in l:
        _close(l[d].numpy(), jl[d])
    for d in u:
        _close(u[d].numpy(), ju[d])
    _close(ud.numpy(), jud)
    rng = np.random.default_rng(4)
    for shape in ((A.n,), (A.n, 2)):
        r = rng.standard_normal(shape)
        got = ilu0_apply(l, u, ud, torch.from_numpy(r))
        _close(got.numpy(), j_apply(jl, ju, jud, jnp.asarray(r)))


@pytest.mark.parametrize("which", ["cavity", "thermal"])
def test_zero_wrap_and_kernel_path_bit_for_bit(systems, which):
    """The roll and the kernel's zero fill agree: every coefficient whose
    column leaves [0, n) is 0, in the matrix and in its factors; the
    ``dia_stencil`` sweeps equal the roll formula bit for bit."""
    A, _ = _condensed(*systems[which])
    offs, n = A.dia.offsets, A.n
    idx = torch.arange(n)
    l, u, ud = ilu0_factor(offs, A.dia_coef, A.diag)
    rows = {d: A.dia_coef[j] for j, d in enumerate(offs)}
    for name, table in (("matrix", rows), ("l", l), ("u", u)):
        for d, c in table.items():
            out = (idx + d < 0) | (idx + d >= n)
            assert out.any()
            assert bool((c[out] == 0).all()), (name, d)
    packed = PackedFactors(l, u, ud)
    assert packed.neg == tuple(d for d in offs if d < 0)
    assert packed.pos == tuple(d for d in offs if d > 0)
    rng = np.random.default_rng(5)
    for shape in ((n,), (n, 3)):
        r = torch.from_numpy(rng.standard_normal(shape))
        want = ilu0_apply_plain(l, u, ud, r)
        got = ilu0_apply_dia(packed, r)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,k", [(500, 1), (501, 2), (300, 3), (64, 1),
                                 (63, 2)])
def test_spike_apply_equals_fvm_tpu(n, k):
    rng = np.random.default_rng(n + k)
    a = rng.uniform(-1, 0, n)
    c = rng.uniform(-1, 0, n)
    a[0] = 0.0
    c[-1] = 0.0
    d = 3.0 + rng.uniform(0, 1, n)
    x_true = rng.standard_normal((n, k) if k > 1 else n)
    T = np.diag(d) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    r = T @ x_true
    got = spike_apply(*(torch.from_numpy(v) for v in (a, d, c, r)), 64)
    want = j_spike(*(jnp.asarray(v) for v in (a, d, c, r)), 64)
    _close(got.numpy(), want)
    # the truncated reduced system is exact here (test_linear.py:253)
    np.testing.assert_allclose(got.numpy(), x_true, atol=1e-10)


def test_spike_cross_shard_raises():
    z = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ConfigError, match="item 8"):
        spike_apply(z, z + 1, z, z, 4, axis="shards")
    with pytest.raises(ConfigError, match="item 8"):
        SpikeSolver().setup_structure_dist(None)


def _anisotropic():
    """The anisotropic Poisson matrix of test_linear.py:210 (x couplings
    50x stronger), in both packages, and a right-hand side from a seed."""
    dm = _mesh(32)
    cols = dm.cf_nbr.numpy().T
    mask = dm.cf_mask.numpy().T
    n = cols.shape[0]
    delta = np.where(mask, cols - np.arange(n)[:, None], 0)
    off = np.where(np.abs(delta) == 1, -50.0, -1.0) * mask
    diag = -off.sum(1) + 0.5
    diag = np.where(mask.any(1), diag, 1.0)
    A = ELLMatrix(diag=torch.from_numpy(diag),
                  off=torch.from_numpy(off.T.copy()),
                  cols=dm.cf_nbr, mask=dm.cf_mask, dia=dm.dia)
    b = np.random.default_rng(0).standard_normal(n) * mask.any(1)
    return A, _jax_ell(A), b


def _same_solve(got, want, rtol=ITER_RTOL):
    (x, st), (jx, jst) = got, want
    assert int(st.iterations) == int(jst.iterations)
    assert bool(st.converged) == bool(jst.converged)
    _close(x.numpy(), jx, rtol)
    _close(float(st.residual), float(jst.residual), 1e-8)


def test_ilu0_beats_jacobi_on_anisotropic():
    A, JA, b = _anisotropic()
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    kw = dict(max_iterations=40, relative_tolerance=1e-8)
    x_i, st_i = ILU0Solver(**kw).solve(A, tb)
    _same_solve((x_i, st_i), JILU0(**kw).solve(JA, jb))
    x_j, st_j = JacobiSolver(omega=0.7, **kw).solve(A, tb)
    assert float(st_i.residual) < 0.1 * float(st_j.residual)
    kw = dict(relative_tolerance=1e-10, max_iterations=60)
    got = BiCGStab(preconditioner=ILU0Solver(), **kw).solve(A, tb)
    assert bool(got[1].converged)
    _same_solve(got, JBiCGStab(preconditioner=JILU0(), **kw).solve(JA, jb))


def test_spike_line_preconditioner_anisotropic():
    import fvm_tpu as jfvm
    from fvm_tpu.models import ThermalModel as JThermal

    def setup(m):
        m.options["verbose"] = False
        m.bc["bottom"].bc_type = "SpecifiedTemperature"
        m.bc["bottom"]["specifiedTemperature"] = 400.0
        m.bc["top"].bc_type = "SpecifiedTemperature"
        m.bc["top"]["specifiedTemperature"] = 300.0
        m.bc["left"].bc_type = "Symmetry"
        m.bc["right"].bc_type = "Symmetry"
        m.init()
        return m._linearize(m.mesh, m.params, m.state, m._resolve_bcvals())

    A, r = setup(ThermalModel(_mesh(8, 64, lx=8.0, ly=1.0)))
    JA, jr = setup(JThermal(jfvm.mesh.build_device_mesh(
        jfvm.mesh.generate.quad_2d(8, 64, lx=8.0, ly=1.0),
        dtype=jnp.float64)))
    kw = dict(relative_tolerance=1e-8, max_iterations=200)
    xs, st_s = BiCGStab(preconditioner=SpikeSolver(), **kw).solve_fn(
        A, r, torch.zeros_like(r))
    xj, st_j = BiCGStab(preconditioner=JacobiSolver(sweeps=1),
                        **kw).solve_fn(A, r, torch.zeros_like(r))
    assert bool(st_s.converged)
    assert int(st_s.iterations) * 10 <= int(st_j.iterations)
    np.testing.assert_allclose(xs.numpy(), xj.numpy(), atol=1e-3)
    _same_solve((xs, st_s), JBiCGStab(preconditioner=JSpike(), **kw)
                .solve_fn(JA, jr, jnp.zeros_like(jr)))
    kw = dict(relative_tolerance=1e-8, max_iterations=100)
    x, st = SpikeSolver(**kw).solve_fn(A, r, torch.zeros_like(r))
    assert bool(st.converged) and int(st.iterations) <= 20
    _same_solve((x, st), JSpike(**kw).solve_fn(JA, jr, jnp.zeros_like(jr)))


# BiCGStab's recurrence on the cavity's pressure correction amplifies
# round-off ~10x per two iterations in both packages (ILU0 at 32^2: the
# iterates of the two differ by 1.7e-16 after 1 iteration, 7.7e-14 after
# 12, 1.7e-11 after 20 and 2e-4 at the solve's end, 35): the iterates are
# held up to CAVITY_TRIPS iterations; the thermal systems to the end of
# their golden solve
CAVITY_TRIPS = (4, 12)


@pytest.mark.parametrize("family", ["ILU0", "SPIKE"])
@pytest.mark.parametrize("which", ["cavity", "thermal"])
def test_golden_family_iterates_equal_fvm_tpu(systems, family, which):
    """The golden settings' solver on the first outer's fixed system (the
    thermal goldens loosen it to rtol 5e-2 and 8 iterations), against
    fvm_tpu's iterates (module docstring: the goldens themselves move by
    more than 1e-8 under round-off)."""
    A, b = systems[which]
    jb = jnp.asarray(b.numpy())
    JA = _jax_ell(A)
    trips = CAVITY_TRIPS if which == "cavity" else (None,)
    for cap in trips:
        solver = cases.family_solver(family)
        jsolver = JBiCGStab(
            preconditioner={"ILU0": JILU0, "SPIKE": JSpike}[family](),
            relative_tolerance=1e-3, max_iterations=200)
        for s in (solver, jsolver):
            if which == "thermal":
                s.relativeTolerance = 5e-2
                s.nMaxIterations = min(s.nMaxIterations, 8)
            else:
                s.nMaxIterations = cap
        got = solver.solve_fn(A, b, torch.zeros_like(b))
        _same_solve(got, jsolver.solve_fn(JA, jb, jnp.zeros_like(jb)))


def test_cavity_jacobi_golden_history():
    m = _cavity(_mesh(32), cases.family_solver("JACOBI"))
    hist = [[h[1], h[2]] for h in m.advance(30)]
    with open(GOLDEN_PATH) as f:
        ref = json.load(f)["cavity/JACOBI/np1"]
    assert len(hist) == len(ref) == 30
    np.testing.assert_allclose(hist, ref, rtol=HIST_RTOL, atol=1e-12)


@pytest.mark.parametrize("family", cases.FAMILIES)
def test_cavity_family_solvers(family):
    """``cases.cavity_family``: bench's cavity with the family's pressure
    and thermal solvers and bench's momentum solver; one coupled step on
    the CPU stays finite."""
    flow, thermal = cases.cavity_family(8, family, device="cpu",
                                        dtype="float64")
    for s in (flow.options["pressureLinearSolver"],
              thermal.options["linearSolver"]):
        assert type(s) is type(cases.family_solver(family))
    assert flow.options["momentumLinearSolver"].nMaxIterations == 10
    res = cases.coupled_step(flow, thermal)
    assert all(bool(torch.isfinite(v)) for v in res)
    with pytest.raises(ValueError):
        cases.family_solver("AMG")
