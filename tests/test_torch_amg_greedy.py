"""The port's greedy-aggregation AMG, gather-ELL products and DirectSolver
against fvm_tpu.

* Aggregation: the compiled host helper and the numpy loop give the same
  aggregates, and both the JAX package's (``aggregate``/``_lump_isolated``)
  on hex, triangle and quad meshes.
* ``_Level`` tables (aggregates, fine->coarse maps, coarse graphs and the
  coarse levels' DIA offsets and fallback) identical to the JAX package's;
  Galerkin coarse matrices to 1e-13 on a seeded system.
* Greedy DIA levels: every coefficient whose neighbour lies outside
  [0, n) is zero, so the port's zero-padded stencil and the JAX roll agree;
  the fused op with its fallback entries against the JAX ``fused_apply``.
* Gather-ELL ``mv``/``residual``/``jacobi_step`` (matrices without DIA
  structure) against the JAX ``ELLMatrix`` with ``dia=None``, to 1e-14.
* ``DirectSolver``, and ``AMG(structured=False)`` standalone and as a
  BiCGStab preconditioner on the 32^2 thermal and pressure systems:
  iteration counts equal, solutions and final residuals to 1e-10.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import fvm_tpu as jfvm
import fvm_tpu_torch as tfvm
from fvm_tpu.linear import (AMG as JAMG, BiCGStab as JBiCGStab,
                            DirectSolver as JDirect)
from fvm_tpu.linear import amg as jamg
from fvm_tpu.models import FlowModel as JFlow, ThermalModel as JThermal
from fvm_tpu.ops import dia as jdia
from fvm_tpu.ops.ell import ELLMatrix as JELL
from fvm_tpu_torch import hostlib
from fvm_tpu_torch.linear import (AMG as TAMG, BiCGStab as TBiCGStab,
                                  DirectSolver as TDirect)
from fvm_tpu_torch.linear import amg as tamg
from fvm_tpu_torch.models import FlowModel as TFlow, ThermalModel as TThermal
from fvm_tpu_torch.ops import dia as tdia
from fvm_tpu_torch.ops.ell import ELLMatrix as TELL
from fvm_tpu_torch.tools.kernel_bench import level_shapes

COEF_RTOL = 1e-13
ELL_RTOL = 1e-14
SOL_RTOL = 1e-10
MESHES = [("hex_3d", (8, 8, 8)), ("tri_2d", (16, 16)), ("quad_2d", (32, 32))]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _close(t, j, rtol):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    if j.size == 0:
        return
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def _meshes(gen, args):
    jd = jfvm.mesh.build_device_mesh(getattr(jfvm.mesh.generate, gen)(*args),
                                     dtype=jnp.float64)
    td = tfvm.mesh.build_device_mesh(getattr(tfvm.mesh.generate, gen)(*args),
                                     dtype="float64", device="cpu")
    return jd, td


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{g}{'x'.join(map(str, a))}" for g, a in MESHES])
def meshes(request):
    return _meshes(*request.param)


def _graphs(td):
    """The mesh's row graph and its condensed form (what the AMG
    coarsens)."""
    cols, mask = td.host_cf()
    cols = np.asarray(cols, dtype=np.int64)
    plan = td.dia.cond_plan if td.dia is not None else None
    return [(cols, mask)] + ([(cols, plan.mask2)] if plan else [])


def test_aggregation_matches(meshes, monkeypatch):
    from fvm_tpu import native

    _, td = meshes
    for cols, mask in _graphs(td):
        helper = hostlib.aggregate(cols, mask)
        _eq(helper, tamg.aggregate_plain(cols, mask))
        port = tamg.aggregate(cols, mask)
        _eq(port, tamg._lump_isolated(helper, mask))
        _eq(port, jamg.aggregate(cols, mask))
        # the JAX package's numpy loop, its native library bypassed
        with monkeypatch.context() as mp:
            mp.setattr(native, "aggregate", lambda c, m: None)
            _eq(port, jamg.aggregate(cols, mask))


@pytest.mark.parametrize("structured", [True, False])
def test_level_tables_identical(meshes, structured):
    jd, td = meshes
    jlev = JAMG(coarse_size=64, structured=structured).setup_structure(
        *jd.host_cf())
    tlev = TAMG(coarse_size=64, structured=structured).setup_structure(
        *td.host_cf(), "cpu")
    assert len(tlev) == len(jlev) >= 1
    greedy = 0
    for jl, tl in zip(jlev, tlev):
        assert type(tl).__name__ == type(jl).__name__
        if not isinstance(tl, tamg._Level):
            continue
        greedy += 1
        assert (tl.n, tl.K, tl.nC, tl.Kc) == (jl.n, jl.K, jl.nC, jl.Kc)
        for f in ("agg", "to_diag", "to_off", "cols_c", "mask_c"):
            _eq(getattr(jl, f), getattr(tl, f))
        assert (tl.dia_c is None) == (jl.dia_c is None)
        if tl.dia_c is not None:
            assert tl.dia_c.offsets == jl.dia_c.offsets
            for f in ("bucket", "fb_rows", "fb_slots", "fb_cols"):
                _eq(getattr(jl.dia_c, f), getattr(tl.dia_c, f))
    # quad meshes take the structured levels unless told otherwise
    assert (greedy == 0) == (structured and td.dim == 2
                             and td.max_faces_per_cell == 4)


@pytest.mark.parametrize("gen,args", [("quad_2d", (64, 64)),
                                      ("hex_3d", (12, 12, 12))])
def test_level_shapes_read_the_live_hierarchy(gen, args):
    """``kernel_bench.level_shapes`` reports the hierarchy the solver
    holds (structured or greedy): the condensed fine level, then every
    coarse level but the coarsest, with its DIA offsets and fallback
    count, or None and its graph for a gather-ELL level."""
    td = tfvm.mesh.build_device_mesh(getattr(tfvm.mesh.generate, gen)(*args),
                                     dtype="float64", device="cpu")
    amg = TAMG(coarse_size=64)
    levels = amg.setup_structure(*td.host_cf(), "cpu")
    shapes = level_shapes(amg, td)
    assert len(shapes) == len(levels)
    assert shapes[0].rows == td.n_cells
    assert shapes[0].offsets == td.dia.cond_plan.dia2.offsets
    for s, lev in zip(shapes[1:], levels[:-1]):
        assert s.rows == lev.nC
        if isinstance(lev, tamg._Level):
            assert (s.offsets is None) == (lev.dia_c is None)
            if s.offsets is None:
                assert s.graph[0] is lev.cols_c and s.graph[1] is lev.mask_c
            else:
                assert s.offsets == lev.dia_c.offsets
                assert s.fallback == lev.dia_c.fb_rows.shape[0]
        else:
            assert s.offsets == tuple(lev.coarse_offsets) and s.fallback == 0
    kinds = {type(lev) for lev in levels}
    assert kinds == ({tamg._StructuredLevel} if gen == "quad_2d"
                     else {tamg._Level})
    if gen == "hex_3d":
        assert any(s.offsets is None for s in shapes)


def _seeded_system(jd, td, seed=4):
    """One random diagonally dominant system on the mesh's structure, in
    both packages' ELL form, condensed at solve entry as the AMG does."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(jd.cf_mask)
    off = np.where(mask, -rng.random(mask.shape), 0.0)
    diag = np.abs(off).sum(axis=0) + 0.5 + rng.random(mask.shape[1])
    b = rng.standard_normal(mask.shape[1])
    jA = JELL(diag=jnp.asarray(diag), off=jnp.asarray(off), cols=jd.cf_nbr,
              mask=jd.cf_mask, dia=jd.dia)
    tA = TELL(diag=torch.from_numpy(diag), off=torch.from_numpy(off),
              cols=td.cf_nbr, mask=td.cf_mask, dia=td.dia)
    jA, jb, _ = jA.condense(jnp.asarray(b))
    tA, tb, _ = tA.condense(torch.from_numpy(b))
    return jA.prepare(), jb, tA.prepare(), tb


def test_galerkin_coarse_matrices_match(meshes):
    jd, td = meshes
    jA, _, tA, _ = _seeded_system(jd, td)
    jlev = JAMG(coarse_size=64, structured=False).setup_structure(
        *jd.host_cf())
    tlev = TAMG(coarse_size=64, structured=False).setup_structure(
        *td.host_cf(), "cpu")
    for jl, tl in zip(jlev, tlev):
        jA = jl.galerkin(jA).prepare()
        tA = tl.galerkin(tA).prepare()
        _close(tA.diag, jA.diag, COEF_RTOL)
        _close(tA.off, jA.off, COEF_RTOL)
        if tA.dia is not None:
            _close(tA.dia_coef, jA.dia_coef, COEF_RTOL)
            _close(tA.dia_fb_vals, jA.dia_fb_vals, COEF_RTOL)


@pytest.mark.parametrize("gen,args", [("hex_3d", (12, 12, 12)),
                                      ("tri_2d", (64, 64))])
def test_greedy_dia_levels_pad_with_zeros(gen, args):
    """On every greedy level with DIA structure, coefficients whose
    neighbour i + d lies outside [0, n) are zero (so reading x as 0 there,
    as ``dia_stencil`` does, equals the JAX roll), and the fused op with
    the level's fallback entries matches the JAX ``fused_apply``."""
    jd, td = _meshes(gen, args)
    jA, _, tA, _ = _seeded_system(jd, td, seed=5)
    jlev = JAMG(coarse_size=64).setup_structure(*jd.host_cf())
    tlev = TAMG(coarse_size=64).setup_structure(*td.host_cf(), "cpu")
    rng = np.random.default_rng(6)
    fallback_levels = 0
    for jl, tl in zip(jlev, tlev):
        jA = jl.galerkin(jA).prepare()
        tA = tl.galerkin(tA).prepare()
        if tA.dia is None:
            continue
        n = tA.n
        idx = np.arange(n)
        coef = _np(tA.dia_coef)
        for k, d in enumerate(tA.dia.offsets):
            outside = (idx + d < 0) | (idx + d >= n)
            assert not coef[k, outside].any(), (n, d)
        fallback_levels += tA.dia.fb_rows.shape[0] > 0
        for m in (1, 3):
            shape = (n,) if m == 1 else (n, m)
            x = rng.standard_normal(shape)
            b = rng.standard_normal(shape)
            for mode in ("mv", "residual", "jacobi"):
                kw = {} if mode == "mv" else {"b": b}
                omega = 0.7 if mode == "jacobi" else None
                jy = jdia.dia_apply_coef(
                    jA.dia, jA.diag, jA.dia_coef, jA.dia_fb_vals,
                    jnp.asarray(x), b=None if mode == "mv" else jnp.asarray(b),
                    omega=omega, mode=mode)
                ty = tdia.dia_apply_coef(
                    tA.dia, tA.diag, tA.dia_coef, tA.dia_fb_vals,
                    torch.from_numpy(x),
                    b=None if mode == "mv" else torch.from_numpy(b),
                    omega=omega, mode=mode)
                _close(ty, jy, ELL_RTOL)
    assert fallback_levels >= 1


@pytest.fixture(scope="module")
def gather_level():
    """A coarse level without DIA structure (hex_3d(12^3), level 2) and a
    seeded matrix on it, in both packages."""
    jd, td = _meshes("hex_3d", (12, 12, 12))
    jlev = JAMG(coarse_size=64).setup_structure(*jd.host_cf())
    tlev = TAMG(coarse_size=64).setup_structure(*td.host_cf(), "cpu")
    lev = next(i for i, t in enumerate(tlev) if t.dia_c is None)
    jl, tl = jlev[lev], tlev[lev]
    rng = np.random.default_rng(7)
    mask = _np(tl.mask_c)
    off = np.where(mask, -rng.random(mask.shape), 0.0)
    diag = np.abs(off).sum(axis=0) + 1.0
    jA = JELL(diag=jnp.asarray(diag), off=jnp.asarray(off), cols=jl.cols_c,
              mask=jl.mask_c)
    tA = TELL(diag=torch.from_numpy(diag), off=torch.from_numpy(off),
              cols=tl.cols_c, mask=tl.mask_c)
    return jA, tA


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("mode", ["mv", "residual", "jacobi"])
def test_gather_ell_products_match(gather_level, mode, m):
    jA, tA = gather_level
    assert tA.dia is None and tA.prepare() is tA
    n = tA.n
    rng = np.random.default_rng(8 + m)
    shape = (n,) if m == 1 else (n, m)
    x, b = rng.standard_normal(shape), rng.standard_normal(shape)
    jx, jb, tx, tb = (jnp.asarray(x), jnp.asarray(b), torch.from_numpy(x),
                      torch.from_numpy(b))
    if mode == "mv":
        jy, ty = jA.mv(jx), tA.mv(tx)
    elif mode == "residual":
        jy, ty = jA.residual(jx, jb), tA.residual(tx, tb)
    else:
        jy, ty = jA.jacobi_step(jx, jb, 0.7), tA.jacobi_step(tx, tb, 0.7)
    _close(ty, jy, ELL_RTOL)


def test_direct_solver_matches(gather_level):
    jA, tA = gather_level
    rng = np.random.default_rng(9)
    for shape in ((tA.n,), (tA.n, 2)):
        b = rng.standard_normal(shape)
        jx, jst = JDirect().solve_fn(jA, jnp.asarray(b),
                                     jnp.zeros(shape, jnp.float64))
        tx, tst = TDirect().solve_fn(tA, torch.from_numpy(b),
                                     torch.zeros(shape, dtype=torch.float64))
        _close(tx, jx, SOL_RTOL)
        assert bool(tst.converged) and bool(jst.converged)
        _close(tst.residual0, jst.residual0, COEF_RTOL)
        assert float(tst.residual) <= 1e-10 * float(tst.residual0)


def _recording(solver):
    solver.systems = []
    inner = solver.solve_fn

    def solve_fn(A, b, x0):
        solver.systems.append((A, b))
        return inner(A, b, x0)

    solver.solve_fn = solve_fn
    return solver


@pytest.fixture(scope="module")
def systems():
    """The pressure and thermal systems of the first outer step of the
    32^2 coupled cavity, recorded in both packages."""
    n = 32
    out = {}
    for Flow, Thermal, AMG, BiCGStab, mesh, key in (
            (JFlow, JThermal, JAMG, JBiCGStab, jfvm.mesh.build_device_mesh(
                jfvm.mesh.generate.quad_2d(n, n), dtype=jnp.float64), "j"),
            (TFlow, TThermal, TAMG, TBiCGStab, tfvm.mesh.build_device_mesh(
                tfvm.mesh.generate.quad_2d(n, n), dtype="float64",
                device="cpu"), "t")):
        flow = Flow(mesh)
        flow.options["verbose"] = False
        flow.vc["viscosity"] = 0.01
        for side in ("left", "right", "bottom", "top"):
            flow.bc[side].bc_type = "NoSlipWall"
        flow.bc["top"]["specifiedXVelocity"] = 1.0
        flow.options["momentumLinearSolver"] = BiCGStab(
            relative_tolerance=1e-2, max_iterations=10)
        flow.options["pressureLinearSolver"] = _recording(
            AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
        thermal = Thermal(mesh)
        thermal.options["verbose"] = False
        thermal.options["linearSolver"] = _recording(
            AMG(coarse_size=16, relative_tolerance=1e-3, max_iterations=6))
        thermal.bc["left"].bc_type = "SpecifiedTemperature"
        thermal.bc["left"]["specifiedTemperature"] = 400.0
        thermal.bc["right"].bc_type = "SpecifiedTemperature"
        thermal.bc["right"]["specifiedTemperature"] = 300.0
        thermal.bc["bottom"].bc_type = "Symmetry"
        thermal.bc["top"].bc_type = "Symmetry"
        for m in (flow, thermal):
            m.init()
            step = m._step_raw if key == "j" else m._step
            step(m.mesh, m.params, m.state, m._resolve_bcvals())
        out[key, "pressure"] = flow.options["pressureLinearSolver"].systems[0]
        out[key, "thermal"] = thermal.options["linearSolver"].systems[0]
    return out


SOLVERS = {
    # greedy pairs contract the pinned pressure system slowly (~0.95 per
    # cycle): 1e-4 is reached in ~150 cycles
    "amg": lambda L: L["AMG"](coarse_size=16, structured=False,
                              relative_tolerance=1e-4, max_iterations=300),
    "bicgstab+amg": lambda L: L["BiCGStab"](
        preconditioner=L["AMG"](coarse_size=16, structured=False),
        relative_tolerance=1e-9, max_iterations=100),
}
CASES = [(s, v) for s in ("pressure", "thermal") for v in SOLVERS]


@pytest.mark.parametrize("system,solver", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_unstructured_amg_solves_match(systems, system, solver):
    (jA, jb), (tA, tb) = systems["j", system], systems["t", system]
    js = SOLVERS[solver]({"AMG": JAMG, "BiCGStab": JBiCGStab})
    ts = SOLVERS[solver]({"AMG": TAMG, "BiCGStab": TBiCGStab})
    jx, jst = js.solve_fn(jA, jb, jnp.zeros_like(jb))
    tx, tst = ts.solve_fn(tA, tb, torch.zeros_like(tb))
    assert bool(tst.converged) and bool(jst.converged)
    assert int(tst.iterations) == int(jst.iterations)
    _close(tx, jx, SOL_RTOL)
    # the final residual norm to 1e-10 of the initial one (a converged
    # Krylov residual carries the round-off of the recurrence)
    np.testing.assert_allclose(float(tst.residual0), float(jst.residual0),
                               rtol=COEF_RTOL)
    np.testing.assert_allclose(float(tst.residual), float(jst.residual),
                               rtol=0, atol=SOL_RTOL * float(jst.residual0))
    # greedy levels really ran: the hierarchy holds no structured level
    amg = ts if solver == "amg" else ts.preconditioner
    levels = next(iter(amg._levels_by_cols.values()))[1]
    assert levels and all(isinstance(lev, tamg._Level) for lev in levels)
