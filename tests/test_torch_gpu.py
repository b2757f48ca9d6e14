"""The CUDA ``dia_stencil`` kernels against their plain version, on the card.

These tests need an NVIDIA GPU (marker ``gpu``) and skip elsewhere; whether
a card exists is decided inside the fixture, never at import, so every
test-runner worker collects the same tests.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest``: ``tests/conftest.py`` imports jax, which a GPU machine
need not have.)

Both variants (``narrow`` and ``wide``) are built without FMA contraction
and sum in the plain version's order, so each must equal the plain
version exactly: max abs error 0.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from fvm_tpu_torch import hostlib
from fvm_tpu_torch.cases import (coupled_cavity, coupled_cavity_3d,
                                 coupled_step, coupled_steps,
                                 electrostatics_run, electrostatics_standin,
                                 heated_channel)
from fvm_tpu_torch.linear import AMG
from fvm_tpu_torch.linear.amg import aggregate_plain
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import hex_3d, quad_2d, tri_2d
from fvm_tpu_torch.models import FlowModel
from fvm_tpu_torch.ops import dia_kernel as dk
from fvm_tpu_torch.ops.dia import fused_apply
from fvm_tpu_torch.ops.ell import ELLMatrix
from fvm_tpu_torch.tools.kernel_bench import level_shapes

pytestmark = pytest.mark.gpu

EDGE = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _operator(n, offsets, dtype, device, m, seed=3):
    rng = np.random.default_rng(seed)
    coef = -rng.random((len(offsets), n))
    idx = np.arange(n)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = 4.0 + rng.random(n)
    shape = (n,) if m == 1 else (n, m)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    coef, diag, x, b = (torch.from_numpy(a).to(device, dtype)
                        for a in (coef, diag, x, b))
    return dk.pack_coef(coef), diag, x, b


def _kw(mode, b):
    kw = {} if mode == "mv" else {"b": b}
    if mode == "jacobi":
        kw["omega"] = 0.8
    return kw


def _exact(offsets, mode, coef, diag, x, b, variant):
    """Run one variant and require bit-equal agreement with the plain
    version; returns the kernel's y."""
    kw = _kw(mode, b)
    y = dk._launch(offsets, mode, coef, diag, x, kw.get("b"),
                   kw.get("omega"), variant=variant)
    y_ref = dk.dia_stencil_plain(offsets, mode, coef, diag, x, **kw)
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape and bool(torch.isfinite(y).all())
    assert float((y - y_ref).abs().max()) == 0.0, (variant, mode)
    return y


@pytest.mark.parametrize("variant", dk.VARIANTS)
@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_matches_plain_512(cuda, variant, mode, dtype, m):
    n = EDGE * EDGE
    offsets = (-EDGE, -1, 1, EDGE)
    coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
    _exact(offsets, mode, coef, diag, x, b, variant)


@pytest.mark.parametrize("variant", dk.VARIANTS)
def test_kernel_every_amg_level(cuda, variant):
    """Every smoothed level of the 1024^2 cavity's hierarchy, every mode,
    float32 and float64, (n,) and (n, 2)."""
    mesh = build_device_mesh(quad_2d(1024, 1024), dtype="float32",
                             device=cuda)
    levels = [(s.rows, s.offsets)
              for s in level_shapes(AMG(coarse_size=256), mesh)]
    assert len(levels) == 12
    assert [n for n, _ in levels[1:]] == [2 ** (20 - k) for k in range(1, 12)]
    for n, offsets in levels:
        for dtype in (torch.float32, torch.float64):
            for m in (1, 2):
                coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
                for mode in dk.MODES:
                    _exact(offsets, mode, coef, diag, x, b, variant)


@pytest.mark.parametrize("variant", dk.VARIANTS)
@pytest.mark.parametrize("n", [1, 3, 300, 1027, 4099, 131075])
def test_kernel_small_and_ragged_n(cuda, variant, n):
    offsets = (-64, -1, 1, 64)
    for dtype in (torch.float32, torch.float64):
        for m in (1, 2):
            coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
            for mode in dk.MODES:
                _exact(offsets, mode, coef, diag, x, b, variant)


@pytest.mark.parametrize("variant", dk.VARIANTS)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_unaligned_views(cuda, variant, m):
    """x and b at bases that are not 16-byte aligned (and not aligned the
    same way), n not a multiple of 4."""
    n = 200_003
    offsets = (-448, -1, 1, 448)
    for dtype in (torch.float32, torch.float64):
        coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
        shape = x.shape
        xs = torch.zeros(n * m + 5, dtype=dtype, device=cuda)
        bs = torch.zeros(n * m + 5, dtype=dtype, device=cuda)
        xv = xs[1:1 + n * m].view(shape)
        bv = bs[3:3 + n * m].view(shape)
        xv.copy_(x)
        bv.copy_(b)
        assert xv.data_ptr() % 16 != 0 and bv.data_ptr() % 16 != 0
        for mode in dk.MODES:
            y = _exact(offsets, mode, coef, diag, xv, bv, variant)
            torch.testing.assert_close(
                y, _exact(offsets, mode, coef, diag, x, b, variant),
                rtol=0, atol=0)


@pytest.mark.parametrize("variant", dk.VARIANTS)
@pytest.mark.parametrize("offsets", [
    (-300, -17, -1, 1, 17, 300),
    tuple(range(-8, 0)) + tuple(range(1, 8)) + (2500,),
    tuple(d * 311 for d in range(-8, 0)) + tuple(d * 311 for d in range(1, 9)),
], ids=["D6", "D16", "D16-wide"])
def test_kernel_many_offsets(cuda, variant, offsets):
    """D = 6 and D = 16 (the 16-offset instantiation), offsets up to
    +-2500 rows."""
    n = 150_001
    for dtype in (torch.float32, torch.float64):
        for m in (1, 3):
            coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
            for mode in dk.MODES:
                _exact(offsets, mode, coef, diag, x, b, variant)


def test_variant_counters(cuda):
    """The dispatch takes the wide variant from ``WIDE_MIN_ROWS`` rows on,
    and counts each launch by variant, mode and rows."""
    offsets = (-128, -1, 1, 128)
    small, large = dk.WIDE_MIN_ROWS - 1, dk.WIDE_MIN_ROWS
    dk.reset_launches()
    for n in (small, large):
        coef, diag, x, b = _operator(n, offsets, torch.float32, cuda, 1)
        dk.dia_stencil(offsets, "residual", coef, diag, x, b=b)
        dk.dia_stencil(offsets, "mv", coef, diag, x)
    torch.cuda.synchronize()
    assert dk.dia_stencil.shapes == {
        ("f32", "narrow", "residual", small, 4): 1,
        ("f32", "narrow", "mv", small, 4): 1,
        ("f32", "wide", "residual", large, 4): 1,
        ("f32", "wide", "mv", large, 4): 1,
    }
    assert dk.variant_launches() == {"narrow": 2, "wide": 2}
    assert dk.dia_stencil.launches == {"mv": 2, "residual": 2, "jacobi": 0}


def test_kernel_rejects_what_it_does_not_take(cuda):
    offsets = (-1, 1)
    coef, diag, x, b = _operator(100, offsets, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="contiguous"):
        dk.dia_stencil(offsets, "mv", coef, diag,
                       torch.stack([x, x], dim=1)[:, 0])
    with pytest.raises(ValueError, match="float64"):
        dk.dia_stencil(offsets, "mv", coef, diag, x.double())
    with pytest.raises(ValueError, match="needs b"):
        dk.dia_stencil(offsets, "residual", coef, diag, x)
    with pytest.raises(ValueError, match="layout"):
        dk.dia_stencil(offsets, "mv", coef.contiguous(), diag, x)


@pytest.mark.parametrize("make,n", [(coupled_cavity, 32),
                                    (coupled_cavity_3d, 8)],
                         ids=["2d", "3d"])
def test_coupled_slice_cuda_matches_cpu(cuda, make, n):
    """The coupled step on the card against the CPU (float64).  The 3D
    cavity's greedy levels sum with float atomics on the card
    (``index_add``), so the histories agree to 1e-8, not bit for bit."""
    def history(device):
        flow, thermal = make(n, device=device, dtype="float64")
        return [[float(v) for v in coupled_step(flow, thermal)]
                for _ in range(3)]

    before = sum(dk.dia_stencil.launches.values())
    h_gpu = history(cuda)
    assert sum(dk.dia_stencil.launches.values()) > before
    np.testing.assert_allclose(h_gpu, history("cpu"), rtol=1e-8)


@pytest.fixture(scope="module")
def hex24_levels():
    """The live greedy hierarchy of the hex_3d(24^3) pressure solver: the
    condensed fine level (D = 6) and the coarse levels, among them one
    with 16 offsets and fallback entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    mesh = build_device_mesh(hex_3d(24, 24, 24), dtype="float32",
                             device=torch.device("cuda", 0))
    return level_shapes(AMG(coarse_size=256), mesh)


@pytest.mark.parametrize("variant", dk.VARIANTS)
def test_kernel_3d_hierarchy_levels(cuda, hex24_levels, variant):
    """Bit-exact at every DIA level of a 3D greedy hierarchy: the fine
    level (D = 6) with (n,) and (n, 3), and the coarse DIA levels (up to
    D = 16)."""
    dia_levels = [s for s in hex24_levels if s.offsets is not None]
    assert len(hex24_levels[0].offsets) == 6
    assert max(len(s.offsets) for s in dia_levels) == 16
    for s in dia_levels:
        for dtype in (torch.float32, torch.float64):
            for m in (1, 3):
                coef, diag, x, b = _operator(s.rows, s.offsets, dtype, cuda,
                                             m)
                for mode in dk.MODES:
                    _exact(s.offsets, mode, coef, diag, x, b, variant)


def test_fused_apply_with_fallback_cuda_matches_cpu(cuda, hex24_levels):
    """The D = 16 level's fused op with its fallback entries (kernel, then
    a scatter-add on the card) against the same op on the CPU, float64,
    (n,) and (n, 3)."""
    s = next(s for s in hex24_levels if s.fallback > 0)
    assert len(s.offsets) == 16
    rng = np.random.default_rng(11)
    fb = [t.cpu() for t in (s.dia.fb_rows, s.dia.fb_cols)]
    fb_vals = torch.from_numpy(rng.standard_normal(s.fallback))
    for m in (1, 3):
        coef, diag, x, b = _operator(s.rows, s.offsets, torch.float64, "cpu",
                                     m)
        for mode in dk.MODES:
            kw = dict(_kw(mode, b), mode=mode)
            want = fused_apply(s.offsets, diag, coef, x, fb_rows=fb[0],
                               fb_cols=fb[1], fb_vals=fb_vals, **kw)
            kw = {k: v.to(cuda) if torch.is_tensor(v) else v
                  for k, v in kw.items()}
            got = fused_apply(s.offsets, diag.to(cuda), dk.pack_coef(
                coef.to(cuda)), x.to(cuda), fb_rows=s.dia.fb_rows,
                fb_cols=s.dia.fb_cols, fb_vals=fb_vals.to(cuda), **kw)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-12,
                                       atol=1e-12)


def test_gather_ell_cuda_matches_cpu(cuda, hex24_levels):
    """The gather-ELL products (a coarse level without DIA structure) on
    the card against the CPU, float64, to 1e-12."""
    s = next(s for s in hex24_levels if s.offsets is None)
    cols, mask = s.graph
    rng = np.random.default_rng(12)
    K, n = cols.shape
    off = torch.from_numpy(np.where(mask.cpu().numpy(),
                                    -rng.random((K, n)), 0.0))
    diag = off.abs().sum(dim=0) + 1.0
    A = {"cpu": ELLMatrix(diag=diag, off=off, cols=cols.cpu(),
                          mask=mask.cpu()),
         "cuda": ELLMatrix(diag=diag.to(cuda), off=off.to(cuda), cols=cols,
                           mask=mask)}
    for m in (1, 3):
        shape = (n,) if m == 1 else (n, m)
        x = torch.from_numpy(rng.standard_normal(shape))
        b = torch.from_numpy(rng.standard_normal(shape))
        for op in ("mv", "residual", "jacobi"):
            y = {}
            for dev, M in A.items():
                xd, bd = x.to(M.diag.device), b.to(M.diag.device)
                y[dev] = (M.mv(xd) if op == "mv" else
                          M.residual(xd, bd) if op == "residual" else
                          M.jacobi_step(xd, bd, 0.7))
            torch.testing.assert_close(y["cuda"].cpu(), y["cpu"], rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("mesh", ["hex_3d", "tri_2d"])
def test_host_aggregation_helper_matches_numpy_loop(cuda, mesh):
    """The compiled host helper, built on this machine, gives the numpy
    loop's aggregates id for id."""
    m = hex_3d(10, 10, 10) if mesh == "hex_3d" else tri_2d(24, 24)
    cols, mask = build_device_mesh(m, dtype="float64",
                                   device="cpu").host_cf()
    cols = np.asarray(cols, dtype=np.int64)
    np.testing.assert_array_equal(hostlib.aggregate(cols, mask),
                                  aggregate_plain(cols, mask))


# --- bfloat16, graph replays and the options of the cavity path ----------


@contextlib.contextmanager
def _deterministic():
    """Deterministic PyTorch algorithms (``index_add`` without atomics)."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


@pytest.mark.parametrize("mesh", ["quad_2d", "hex_3d"])
def test_bf16_kernel_every_amg_level(cuda, mesh):
    """The bfloat16 kernel (one variant, narrow) bit-exact against the
    plain version (float32 arithmetic, one rounding) at every DIA level of
    the 1024^2 structured and the 24^3 greedy hierarchy, every mode,
    (n,) and (n, 2) / (n, 3)."""
    if mesh == "quad_2d":
        dmesh = build_device_mesh(quad_2d(1024, 1024), dtype="float32",
                                  device=cuda)
        ms = (1, 2)
    else:
        dmesh = build_device_mesh(hex_3d(24, 24, 24), dtype="float32",
                                  device=cuda)
        ms = (1, 3)
    assert dk.variants(torch.bfloat16) == ("narrow",)
    levels = [s for s in level_shapes(AMG(coarse_size=256), dmesh)
              if s.offsets is not None]
    assert levels
    for s in levels:
        for m in ms:
            coef, diag, x, b = _operator(s.rows, s.offsets, torch.bfloat16,
                                         cuda, m)
            for mode in dk.MODES:
                y = _exact(s.offsets, mode, coef, diag, x, b, "narrow")
                assert y.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no wide variant"):
        dk._launch(s.offsets, "mv", coef, diag, x, None, None,
                   variant="wide")


def test_bf16_amg_launches_the_kernel(cuda):
    """AMG(precision="bf16") on a CUDA tensor runs its DIA levels through
    the bfloat16 kernel; the solve agrees with the CPU's to a few bf16
    units (the coarse matmul and the sums round in another order)."""
    def solve(device):
        flow, thermal = coupled_cavity(64, device=device, dtype="float32")
        amg = AMG(coarse_size=256, precision="bf16",
                  relative_tolerance=1e-3, max_iterations=6)
        thermal.options["linearSolver"] = amg
        thermal.init()
        A, r = thermal._linearize(thermal.mesh, thermal.params,
                                  thermal.state, thermal._resolve_bcvals())
        return amg.solve_fn(A, r, torch.zeros_like(r))[0]

    dk.reset_launches()
    x = solve(cuda)
    torch.cuda.synchronize()
    assert sum(dk.type_launches(torch.bfloat16).values()) > 0
    x_cpu = solve("cpu")
    err = float((x.cpu() - x_cpu).norm() / x_cpu.norm())
    assert err <= 4 * 2.0 ** -8, err


def _thermal_chunked(device, chunk, n=32):
    from fvm_tpu_torch.models import ThermalModel
    t = ThermalModel(build_device_mesh(quad_2d(n, n), dtype="float64",
                                       device=device))
    t.options["verbose"] = False
    t.options["relativeTolerance"] = 1e-30
    t.options["absoluteTolerance"] = 0.0
    # under-relaxed, so the residual halves each outer and never reaches 0
    t.options["urf"] = 0.5
    t.options["outerChunk"] = chunk
    t.bc["left"].bc_type = "SpecifiedTemperature"
    t.bc["left"]["specifiedTemperature"] = 400.0
    t.bc["right"].bc_type = "SpecifiedHeatFlux"
    t.bc["right"]["specifiedHeatFlux"] = 10.0
    t.bc["bottom"].bc_type = "Symmetry"
    t.bc["top"].bc_type = "Symmetry"
    t.init()
    return t


def _flow_chunked(device, chunk, n=32):
    from fvm_tpu_torch.models import FlowModel
    f = FlowModel(build_device_mesh(quad_2d(n, n), dtype="float64",
                                    device=device))
    f.options["verbose"] = False
    f.options["outerChunk"] = chunk
    for g in ("left", "right", "bottom", "top"):
        f.bc[g].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.init()
    return f


@pytest.mark.parametrize("model", ["thermal", "flow"])
def test_chunked_advance_replays_the_graph(cuda, model):
    """advance(n) with outerChunk > 1 on the card is a CUDA graph replay
    per chunk and equals the eager per-step loop on the card bit for bit,
    and the CPU to 1e-10."""
    make = _thermal_chunked if model == "thermal" else _flow_chunked
    eager, chunked, cpu = make(cuda, 0), make(cuda, 4), make("cpu", 4)
    h0 = eager.advance(9)
    h1 = chunked.advance(9)
    h2 = cpu.advance(9)
    runner = chunked._runners[("chunk", 4)]
    assert runner.graph is not None and runner.replays == 3
    assert [tuple(map(float, h)) for h in h0] == [
        tuple(map(float, h)) for h in h1]
    np.testing.assert_allclose([h[1:] for h in h1], [h[1:] for h in h2],
                               rtol=1e-10)
    key = "T" if model == "thermal" else "velocity"
    assert torch.equal(eager.state[key], chunked.state[key])
    assert sum(runner.captured[0].values()) > 0  # dia_stencil in the graph


@pytest.mark.parametrize("make,n", [(coupled_cavity, 32),
                                    (coupled_cavity_3d, 8)],
                         ids=["2d", "3d"])
def test_coupled_steps_replay_equals_eager(cuda, make, n):
    """cases.coupled_steps on the card (one graph replay) against the eager
    per-step loop on the card: bit for bit in 2D, and in 3D with
    deterministic algorithms (the greedy levels' index_add adds with
    atomics otherwise); against the CPU to 1e-8."""
    ctx = _deterministic() if make is coupled_cavity_3d else \
        contextlib.nullcontext()
    with ctx:
        fe, te = make(n, device=cuda, dtype="float64")
        eager = torch.tensor([[float(v) for v in coupled_step(fe, te)]
                              for _ in range(5)], dtype=torch.float64)
        fg, tg = make(n, device=cuda, dtype="float64")
        dk.reset_launches()
        graph = torch.cat([coupled_steps(fg, tg, 5)]).cpu()
        torch.cuda.synchronize()
    assert torch.equal(graph, eager)
    assert torch.equal(fe.state["velocity"], fg.state["velocity"])
    assert torch.equal(te.state["T"], tg.state["T"])
    runner = fg._runners[("coupled", tg, 5)]
    assert sum(runner.captured[0].values()) > 0
    fc, tc = make(n, device="cpu", dtype="float64")
    np.testing.assert_allclose(graph.numpy(),
                               coupled_steps(fc, tc, 5).numpy(), rtol=1e-8)


def test_graph_replay_takes_new_boundary_values(cuda):
    """Boundary values are graph inputs: a changed lid speed reaches the
    next replay (compared with the eager loop from the same state)."""
    fe, te = coupled_cavity(16, device=cuda, dtype="float64")
    fg, tg = coupled_cavity(16, device=cuda, dtype="float64")
    coupled_step(fe, te)
    coupled_steps(fg, tg, 1)
    for f in (fe, fg):
        f.bc["top"]["specifiedXVelocity"] = 2.0
    a = torch.stack(coupled_step(fe, te)).cpu()
    b = coupled_steps(fg, tg, 1)[0].cpu()
    assert torch.equal(a, b)


@pytest.mark.parametrize("option", [
    "amg-W", "amg-F", "cg+jacobi", "gmres", "sou", "vanLeer", "L1"])
def test_options_cuda_match_cpu(cuda, option):
    """Each option of the cavity path on the card against the CPU,
    float64, 32^2: histories to 1e-8."""
    from fvm_tpu_torch.linear import CG, GMRES, JacobiSolver

    def run(device):
        flow, thermal = coupled_cavity(32, device=device, dtype="float64")
        if option.startswith("amg-"):
            flow.options["pressureLinearSolver"] = AMG(
                coarse_size=256, cycle=option[-1], relative_tolerance=1e-3,
                max_iterations=6)
        elif option == "cg+jacobi":
            flow.options["pressureLinearSolver"] = CG(
                preconditioner=JacobiSolver(sweeps=3),
                relative_tolerance=1e-3, max_iterations=100)
        elif option == "gmres":
            flow.options["momentumLinearSolver"] = GMRES(
                restart=10, relative_tolerance=1e-2, max_iterations=10)
        elif option == "sou":
            flow.options["convectionScheme"] = "sou"
        elif option == "vanLeer":
            thermal.options["convectionScheme"] = "vanLeer"
        else:
            flow.options["residualNorm"] = "L1"
        flow.init()
        thermal.init()
        return [[float(v) for v in coupled_step(flow, thermal)]
                for _ in range(3)]

    np.testing.assert_allclose(run(cuda), run("cpu"), rtol=1e-8)


def test_bf16_coupled_steps_replay_equals_eager(cuda):
    """Both AMG solvers in bfloat16 (bench's FVM_BENCH_AMG_PREC=bf16): the
    graph replay launches the bfloat16 kernel and equals the eager loop on
    the card bit for bit."""
    fe, te = coupled_cavity(32, device=cuda, dtype="float32",
                            amg_precision="bf16")
    eager = torch.stack([torch.stack(coupled_step(fe, te))
                         for _ in range(3)]).cpu()
    fg, tg = coupled_cavity(32, device=cuda, dtype="float32",
                            amg_precision="bf16")
    graph = coupled_steps(fg, tg, 3).cpu()
    assert torch.equal(graph, eager)
    captured = fg._runners[("coupled", tg, 3)].captured[1]
    assert dk.type_launches(torch.bfloat16, captured)["jacobi"] > 0


def test_capture_survives_dead_graphs(cuda):
    """Models dropped with their captured graphs free them at once (no
    reference cycle holds them), so a collector that runs often cannot
    free one of those graphs while another capture runs."""
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(3):
            f, t = coupled_cavity(16, device=cuda, dtype="float64")
            coupled_steps(f, t, 2)
            del f, t
        f, t = coupled_cavity(16, device=cuda, dtype="float64")
        assert bool(torch.isfinite(coupled_steps(f, t, 2)).all())
    finally:
        gc.set_threshold(*threshold)


def test_failed_capture_raises(cuda):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing falls back to the per-step loop."""
    t = _thermal_chunked(cuda, 4, n=16)
    step = t._step

    def syncing_step(*args):
        st, aux = step(*args)
        float(aux["rnorm"])  # a host read-back
        return st, aux

    t._step = syncing_step
    with pytest.raises(RuntimeError):
        t.advance(8)
    assert t._runners[("chunk", 4)].graph is None
    torch.cuda.synchronize()


# --- the Newton endgame's inner-solve graphs ---------------------------------

def _newton_flow(device, n=16, **opts):
    """The bench cavity at n^2 float64 after 40 SIMPLE outers on the CPU,
    moved to ``device`` with the Newton options ``opts``."""
    from fvm_tpu_torch.models.fmg import restore_state, snapshot_state

    f, _ = coupled_cavity(n, device="cpu", dtype="float64")
    f.advance(40)
    g, _ = coupled_cavity(n, device=device, dtype="float64")
    restore_state(g, snapshot_state(f))
    g.options.update(dict(dict(
        newtonKrylovTolerance=1e-10, newtonKrylovIterations=200,
        newtonChunkIterations=10, newtonForcing="fixed"), **opts))
    return g


@pytest.mark.parametrize("inner", ["bicgstab", "gmres"])
def test_newton_chunk_replay_equals_eager(cuda, inner):
    """The chunked inner solve as graph replays (set-up graph, then trips
    graphs with no read-back inside a chunk) equals the same chunks run
    eagerly, bit for bit under deterministic algorithms."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = []
        for graphed in (True, False):
            g = _newton_flow(cuda, newtonInnerSolver=inner,
                             newtonGmresRestart=8)
            g._newton_graphed = graphed
            h = [float(r[1]) for r in g.advanceNewton(2)]
            out.append((h, g.state))
        inner_run = g._runners[("newton", 10)]
    finally:
        torch.use_deterministic_algorithms(old)
    (h_g, s_g), (h_e, s_e) = out
    assert h_g == h_e
    for k in s_g:
        assert torch.equal(s_g[k], s_e[k]), k
    assert inner_run.setup is None  # the eager run built no graph


def test_newton_mixed_views_launch_float32_kernel(cuda):
    """newtonInnerPrecision="float32": the inner solve's AMG cycles run the
    float32 dia_stencil on the float32 views; the state stays float64."""
    g = _newton_flow(cuda, newtonInnerPrecision="float32",
                     newtonKrylovTolerance=1e-3)
    dk.reset_launches()
    g.advanceNewton(1)
    torch.cuda.synchronize()
    assert dk.type_launches(torch.float32)["jacobi"] > 0
    assert dk.type_launches(torch.float32)["residual"] > 0
    inner = g._runners[("newton", 10)]
    assert sum(dk.type_launches(torch.float32,
                                inner.trips.captured[1]).values()) > 0
    assert g.state["velocity"].dtype == torch.float64


def test_newton_failed_capture_raises(cuda):
    """A set-up that reads a value back to the host cannot be captured:
    the capture raises, and nothing falls back to the eager chunks."""
    g = _newton_flow(cuda)
    surrogate = g._newton_surrogate

    def syncing(*args):
        A = surrogate(*args)
        float(A.diag.sum())  # a host read-back
        return A

    g._newton_surrogate = syncing
    with pytest.raises(RuntimeError):
        g.advanceNewton(1)
    assert g._runners[("newton", 10)].setup is None
    torch.cuda.synchronize()


def test_promotion_leaves_no_dead_graph(cuda):
    """The converge path's promotion: the float32 pair (with its coupled
    graph) is dropped before the float64 pair captures its Newton graphs;
    with the collector run at every allocation the capture still holds."""
    from fvm_tpu_torch.models.fmg import restore_state, snapshot_state

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        f, t = coupled_cavity(16, device=cuda, dtype="float32")
        for _ in range(3):
            coupled_steps(f, t, 5)
        snap = snapshot_state(f)
        del f, t
        g, _ = coupled_cavity(16, device=cuda, dtype="float64")
        restore_state(g, snap)
        g.options.update(newtonChunkIterations=10,
                         newtonInnerPrecision="float32",
                         newtonKrylovTolerance=1e-3, newtonRefreeze=True)
        h = g.advanceNewton(2)
        torch.cuda.synchronize()
        assert all(np.isfinite(float(r[1])) for r in h)
        assert g._runners[("newton", 10)].replays > 0
    finally:
        gc.set_threshold(*threshold)


# ---- the suite: immersed boundary, heated channel, electrostatics ----------

def _ib_cavity(device, chunk):
    f = FlowModel(build_device_mesh(quad_2d(20, 20), dtype="float64",
                                    device=device))
    f.options["verbose"] = False
    f.options["outerChunk"] = chunk
    f.vc["viscosity"] = 0.1
    for g in ("left", "right", "bottom", "top"):
        f.bc[g].bc_type = "NoSlipWall"
    f.bc["top"]["specifiedXVelocity"] = 1.0
    f.init()
    return f


def test_ib_set_after_a_capture_replays_the_new_step(cuda):
    """A chunk captured without the immersed boundary is dropped when it
    is set: the next chunked advance captures the step with the IB rows
    and equals the eager loop with the IB bit for bit."""
    chunked, eager = _ib_cavity(cuda, 4), _ib_cavity(cuda, 0)
    chunked.advance(8)
    eager.advance(8)
    assert chunked._runners[("chunk", 4)].graph is not None
    cc = chunked.mesh.cell_centroid[:400].cpu().numpy()
    solid = ((cc[:, 0] > 0.3) & (cc[:, 0] < 0.7) & (cc[:, 1] > 0.4)
             & (cc[:, 1] < 0.6))
    for f in (chunked, eager):
        f.set_immersed_boundary(solid, [0.0, 0.0], solid_mask=solid)
    assert chunked._runners == {}
    hc, he = chunked.advance(8), eager.advance(8)
    assert chunked._runners[("chunk", 4)].graph is not None
    assert [tuple(map(float, h)) for h in hc] == [
        tuple(map(float, h)) for h in he]
    assert torch.equal(chunked.state["velocity"], eager.state["velocity"])


def test_channel_chunk_replay_equals_eager(cuda):
    """The heated channel's flow and thermal ``outerChunk`` replays equal
    the eager loops bit for bit, and the CPU to 1e-8."""
    hist = []
    for dev, chunk in ((cuda, 0), (cuda, 5), ("cpu", 0)):
        f, t = heated_channel(device=dev, dtype="float64", nx=48, ny=16)
        f.options["outerChunk"] = t.options["outerChunk"] = chunk
        hf = [tuple(map(float, h[1:])) for h in f.advance(20)]
        t.state["massFlux"] = f.state["massFlux"]
        ht = [float(h[1]) for h in t.advance(5)]
        hist.append((hf, ht))
    assert hist[0] == hist[1]
    np.testing.assert_allclose(hist[0][0], hist[2][0], rtol=1e-8)
    np.testing.assert_allclose(hist[0][1], hist[2][1], rtol=1e-8)


def test_electrostatics_cuda_matches_plain(cuda):
    """bench's solve on the reference-size prism stand-in on the card (the
    kernel on the fine level) against the CPU (its plain version): the
    solution to 1e-8 of its largest entry, both converged."""
    dk.reset_launches()
    rg = electrostatics_run(electrostatics_standin("reference",
                                                   device=cuda), reps=1)
    assert sum(dk.type_launches(torch.float64).values()) > 0
    rc = electrostatics_run(electrostatics_standin("reference",
                                                   device="cpu"), reps=1)
    assert rg["converged"] and rc["converged"]
    xg, xc = rg["x"].cpu(), rc["x"]
    assert float((xg - xc).abs().max()) <= 1e-8 * float(xc.abs().max())


def _condensed_thermal(device, dtype, n=64):
    """The condensed matrix of the bench cavity's thermal system (the
    golden family's ILU0 and SPIKE preconditioners factor it)."""
    from fvm_tpu_torch.cases import cavity_family
    _, t = cavity_family(n, "ILU0", device=device, dtype=dtype)
    A, r = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    A2, r2, _ = A.condense(r)
    return A2.prepare(), r2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [1, 2])
def test_ilu_sweeps_launch_the_kernel_bit_for_bit(cuda, dtype, m):
    """On a CUDA tensor each ILU(0) triangular sweep is one ``dia_stencil``
    launch (residual mode, zero diagonal, D 2): the apply equals the roll
    formula on the same card bit for bit, 2 tri_sweeps launches per
    apply."""
    from fvm_tpu_torch.linear.ilu import (PackedFactors, ilu0_apply,
                                          ilu0_apply_plain, ilu0_factor)
    A, r = _condensed_thermal(cuda, dtype)
    l, u, ud = ilu0_factor(A.dia.offsets, A.dia_coef, A.diag)
    packed = PackedFactors(l, u, ud)
    rr = r if m == 1 else torch.stack([r, 2.0 * r], dim=1)
    dk.reset_launches()
    got = ilu0_apply(l, u, ud, rr, 4, packed)
    want = ilu0_apply_plain(l, u, ud, rr, 4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) == 0.0
    tag = dk.type_tag(getattr(torch, dtype))
    assert dk.dia_stencil.shapes == {
        (tag, dk.dispatch(A.n, A.diag.dtype), "residual", A.n, 2): 8}


def test_spike_apply_cuda_matches_cpu(cuda):
    from fvm_tpu_torch.linear import SpikeSolver
    A, r = _condensed_thermal(cuda, "float64")
    Ac, rc = _condensed_thermal("cpu", "float64")
    got = SpikeSolver().precond_setup(A)(r)
    want = SpikeSolver().precond_setup(Ac)(rc)
    assert float((got.cpu() - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("family", ["ILU0", "SPIKE"])
def test_cavity_family_cuda_matches_cpu(cuda, family):
    """Five coupled outers of ``cases.cavity_family`` at 32^2 float64 with
    tight inner solves on the card (the ILU sweeps on the kernel) and on
    the CPU."""
    from fvm_tpu_torch.cases import (FAMILY_TIGHT_RTOL, cavity_family,
                                     tighten_family)
    hist = []
    for dev in (cuda, "cpu"):
        flow, thermal = cavity_family(32, family, device=dev,
                                      dtype="float64")
        tighten_family(flow, thermal)
        dk.reset_launches()
        hist.append([[float(v) for v in coupled_step(flow, thermal)]
                     for _ in range(5)])
        if dev is cuda and family == "ILU0":
            assert any(k[4] == 2 for k in dk.dia_stencil.shapes)
    np.testing.assert_allclose(hist[0], hist[1],
                               rtol=FAMILY_TIGHT_RTOL[family])


def test_plate_flux_closure_chunk_replay_and_restart(cuda):
    """The two-material plate's contact-resistance closure (forward-mode
    derivatives) inside an ``outerChunk`` replay equals the eager outers
    bit for bit; a restart after the replay continues as the uninterrupted
    run."""
    from fvm_tpu_torch.cases import two_material_plate
    runs = []
    for chunk in (0, 3, 3):
        t, _ = two_material_plate(device=cuda, nx=64, ny=16)
        t.options["relativeTolerance"] = 0.0
        t.options["absoluteTolerance"] = 0.0
        t.options["outerChunk"] = chunk
        # deterministic: the fallback entries' index_add adds with atomics
        with _deterministic():
            h = [float(v[1]) for v in t.advance(3)]
            data = t.getPersistenceData()
            if len(runs) == 2:
                t.advance(3)
                t.restart(data)
            h += [float(v[1]) for v in t.advance(3)]
        runs.append((h, t.getTemperature()))
    assert runs[1][0] == runs[0][0] and runs[2][0] == runs[1][0]
    assert np.array_equal(runs[1][1], runs[0][1])
    assert np.array_equal(runs[2][1], runs[1][1])


# ---- sensitivities: the kernel's derivative rules and transpose ---------

def _stencil_operands(device, dtype, mode, m, n=3001, offs=(-64, -1, 1, 64)):
    rng = np.random.default_rng(12)
    shape = (n,) if m == 1 else (n, m)
    t = {k: torch.as_tensor(v, dtype=getattr(torch, dtype)) for k, v in (
        ("coef", rng.standard_normal((len(offs), n))),
        ("diag", 2.0 + rng.random(n)), ("x", rng.standard_normal(shape)),
        ("b", rng.standard_normal(shape)), ("dcoef",
                                            rng.standard_normal((4, n))),
        ("ddiag", rng.standard_normal(n)), ("dx", rng.standard_normal(shape)),
        ("db", rng.standard_normal(shape)), ("gy",
                                             rng.standard_normal(shape)))}
    t = {k: v.to(device) for k, v in t.items()}
    t["coef"] = dk.pack_coef(t["coef"])
    if mode == "mv":
        t["b"] = t["db"] = None
    return offs, t


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("mode", ["mv", "residual"])
def test_kernel_derivatives_match_the_plain_versions(cuda, mode, m, dtype):
    """``torch.func.jvp`` and reverse mode of the CUDA op (its rules launch
    the kernel: on the tangent's coefficients, on dx, on the transposed
    operator) against torch's derivatives of the plain version on the CPU,
    to 1e-12 (float64) or 1e-5 (float32) of the largest entry."""
    tol = 1e-12 if dtype == "float64" else 1e-5
    res = []
    for dev in (cuda, "cpu"):
        offs, t = _stencil_operands(dev, dtype, mode, m)
        names = ["coef", "diag", "x"] + (["b"] if mode == "residual" else [])

        def f(*args):
            kw = dict(zip(names, args))
            return dk.dia_stencil(offs, mode, kw["coef"], kw["diag"],
                                  kw["x"], b=kw.get("b"))

        dk.reset_launches()
        _, jv = torch.func.jvp(f, tuple(t[k] for k in names),
                               tuple(t["d" + k] for k in names))
        leaves = [t[k].clone().requires_grad_(True) for k in names]
        grads = torch.autograd.grad(f(*leaves), leaves, t["gy"])
        if dev is cuda:
            # the jvp's primal, dA x and A dx; the reverse pass's forward
            # and A^T y-bar
            assert dk.dia_stencil.launches["mv"] + dk.dia_stencil.launches[
                "residual"] == 5
        res.append([jv] + list(grads))
    for got, want in zip(*res):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol * scale


def test_kernel_derivative_raises_instead_of_falling_back(cuda):
    """On a CUDA tensor the derivative launches the kernel or raises: the
    Jacobi mode has no derivative, and the kernel's rules refuse a CPU
    tensor (they never run the plain version)."""
    offs, t = _stencil_operands(cuda, "float64", "residual", 1)
    x = t["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="jacobi"):
        dk.dia_stencil(offs, "jacobi", t["coef"], t["diag"], x, b=t["b"],
                       omega=0.7)
    offs, c = _stencil_operands("cpu", "float64", "mv", 1)
    with pytest.raises(ValueError, match="CUDA"):
        dk.DiaStencil.apply(c["coef"], c["diag"], c["x"], None, offs, "mv")


def _random_thermal_matrix(device):
    from fvm_tpu_torch.cases import two_material_plate
    t, _ = two_material_plate(device=device, nx=32, ny=16)
    A, _ = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    rng = np.random.default_rng(8)
    off = torch.as_tensor(rng.standard_normal(A.off.shape)).to(device)
    diag = torch.as_tensor(4.0 + rng.random(A.n)).to(device)
    return A.replace(off=torch.where(A.mask, off, 0.0), diag=diag)


def test_transposed_operator_launches_the_kernel(cuda):
    """The materialized A^T of a DIA matrix with fallback entries (the
    plate's interface and periodic rows) on the card: mv, residual and
    Jacobi through ``dia_stencil`` at the negated offsets, equal to the
    plain version on the CPU (max abs err 0 in the stencil; the fallback
    adds with atomics, so 1e-14 of the largest entry)."""
    from fvm_tpu_torch.linear.base import TransposedOperator
    outs = []
    for dev in (cuda, "cpu"):
        A = _random_thermal_matrix(dev)
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.standard_normal(A.n)).to(dev)
        b = torch.as_tensor(rng.standard_normal(A.n)).to(dev)
        op = TransposedOperator(A)
        dk.reset_launches()
        outs.append([op.mv(x), op.residual(x, b), op.jacobi_step(x, b, 0.7)])
        if dev is cuda:
            offs = tuple(sorted(-d for d in A.dia.offsets))
            assert op._At.offsets == offs
            assert dk.dia_stencil.launches == {"mv": 1, "residual": 1,
                                               "jacobi": 1}
    for got, want in zip(*outs):
        assert float((got.cpu() - want).abs().max()) <= 1e-14 * float(
            want.abs().max())


def test_thermal_sensitivities_cuda_match_cpu(cuda):
    """``cases.sensitivity_slab`` at 32 x 16: the tangent and the adjoint on
    the card equal the CPU's to 1e-10; the tangent launches the kernel on
    its coefficients (mv) and the adjoint's transposed solve launches it on
    A^T (residual, in its Jacobi preconditioner)."""
    from fvm_tpu_torch.cases import sensitivity_slab
    res = []
    for dev in (cuda, "cpu"):
        t = sensitivity_slab(32, device=dev, ny=16)
        t.advance(10)
        n = t.mesh.n_interior_cells
        direction = np.random.default_rng(5).standard_normal(n)
        dk.reset_launches()
        dT = t.solve_tangent({"k_cell": direction})
        tangent_mv = dk.dia_stencil.launches["mv"]
        dk.reset_launches()
        g = t.solve_adjoint(lambda T: T.mean(), ["k_cell"])["k_cell"]
        if dev is cuda:
            assert tangent_mv > 0
            assert any(k[2] == "residual" and k[3] == t.mesh.n_cells
                       for k in dk.dia_stencil.shapes)
            assert bool(t.options["linearSolver"].transpose_stats.converged)
        res.append((dT, g))
    for got, want in zip(*res):
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_flow_sensitivities_cuda_match_cpu(cuda):
    """bench's cavity at 16^2 float64 with tightened inner solves
    (``cases.tighten_cavity``), 40 outers: ``cases.cavity_sensitivities``
    on the card equals the CPU's to 1e-9 and holds the truncated
    duality."""
    from fvm_tpu_torch.cases import (cavity_sensitivities, coupled_cavity,
                                     tighten_cavity)
    res = []
    for dev in (cuda, "cpu"):
        flow, _ = coupled_cavity(16, device=dev, dtype="float64")
        tighten_cavity(flow)
        flow.advance(40)
        out = cavity_sensitivities(flow, niter=3)
        assert out["gap"] < 1e-9
        res.append(out)
    a, b = res
    np.testing.assert_allclose(a["tangent"], b["tangent"], rtol=1e-9)
    for k in b["adjoint"]:
        assert np.abs(a["adjoint"][k] - b["adjoint"][k]).max() <= 1e-9 * \
            np.abs(b["adjoint"][k]).max()


# --- the structures and MEMS family -----------------------------------------

def _both(fn):
    """``fn(device)`` on the card and on the CPU."""
    return fn(torch.device("cuda", 0)), fn(torch.device("cpu"))


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _rel_cols(a, b):
    """``_rel`` of each last-axis column on its own scale, the largest."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return max(_rel(a[..., j], b[..., j]) for j in range(b.shape[-1]))


@pytest.mark.parametrize("mode", ["graph", "reverse", "forward"])
def test_structure_cuda_matches_cpu(cuda, mode):
    """The cantilever (JFNK, each ``newton_operator`` mode on the card, the
    CPU's own there): deformation, the tangent in E and the adjoint of the
    tip."""
    from fvm_tpu_torch.cases import cantilever, tip_cells
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver

    def run(dev):
        m = cantilever(20, 4, device=dev)
        if dev.type == "cuda":
            op = m._jfnk_operator
            m._jfnk_operator = lambda *a: op(*a, mode=mode)
        # inner solves at 1e-12: at the default 1e-6 the tangent and the
        # adjoint move by ~1e-8 between devices (round-off in the solves)
        m.options["linearSolver"] = BiCGStab(
            preconditioner=JacobiSolver(sweeps=3), relative_tolerance=1e-12,
            max_iterations=1000)
        m.options["linearSolver"].exit_every = 10
        m._drop_compiled()
        m.advance(6)
        tips = torch.as_tensor(tip_cells(m), device=dev)
        g = m.solve_adjoint(lambda w: w[tips, 1].mean(), ["youngsModulus"])
        return (m.getDeformation(), m.solve_tangent({"youngsModulus": 1.0}),
                g["youngsModulus"])

    for a, b in zip(*_both(run)):
        assert _rel(a, b) <= 1e-8


def test_plate_cuda_matches_cpu(cuda):
    """The MEMS strip's lumped stiffness and a transient step."""
    from fvm_tpu_torch.cases import mems_switch

    def run(dev):
        sw = mems_switch(16, 8, device=dev)
        k = sw.lumped_stiffness()
        p = sw.plate
        p.options["transient"] = True
        p.options["timeStep"] = 2e-7
        p.init()
        p.set_pressure(np.full(p.mesh.n_cells, -1e-3))
        p.advance(3)
        return k, p.getDeflection(), p.getRotations()

    for a, b in zip(*_both(run)):
        assert _rel(a, b) <= 1e-8


def test_mems_gap_and_film_launch_the_kernel(cuda):
    """One coupling iteration of the switch and a squeeze-film solve on the
    card: both solve through ``dia_stencil`` (float64), and agree with the
    CPU."""
    from fvm_tpu_torch.cases import mems_switch

    def run(dev):
        sw = mems_switch(16, 8, device=dev)
        w = 0.1 * np.sin(np.pi * sw.xp / sw.L) ** 2
        dk.reset_launches()
        p_es = sw.electrostatic_pressure(w, 5.0)
        sw.film.set_gap(sw.g0 - w, -w)
        sw.film.advance(3)
        return p_es, sw.film.getPressure(), dk.type_launches(torch.float64)

    (pg, fg, lg), (pc, fc, _) = _both(run)
    assert lg["residual"] > 0 and lg["jacobi"] > 0
    assert _rel(pg, pc) <= 1e-8 and _rel(fg, fc) <= 1e-8


def test_fracture_and_small_models_cuda_match_cpu(cuda):
    from fvm_tpu_torch.models import (FractureModel, OneDConduction,
                                      ShockTube)

    def run(dev):
        fr = FractureModel(build_device_mesh(quad_2d(12, 12),
                                             dtype="float64", device=dev))
        fr.options["verbose"] = False
        fr.vc["fractureSource"] = 1.0
        fr.vc["fractureSourceCoef"] = 4.0
        for g in ("left", "right", "bottom", "top"):
            fr.bc[g].bc_type = "Symmetry"
        fr.bc["left"].bc_type = "Dirichlet"
        fr.init()
        for _ in range(3):
            fr.advance(5)
            fr.updateTime()
        od = OneDConduction(nx=30, device=dev)
        od.setBoundaryTemperatures(1.0, 0.0)
        ks = np.exp(np.random.default_rng(0).normal(0, 0.3, (8, 30)))
        return (fr.getPhaseFieldValue(), od.solve_mc(ks).cpu().numpy(),
                ShockTube(nx=100, device=dev).run(0.1).primitives()[0])

    for a, b in zip(*_both(run)):
        assert _rel(a, b) <= 1e-10


def test_motion_cuda_matches_cpu(cuda):
    """Mesh smoothing (index_add with atomics on the card) and the
    deformation mapping's weights."""
    from fvm_tpu_torch.models import MovingMeshModel
    from fvm_tpu_torch.models.motion import node_cell_weights

    def run(dev):
        mm = MovingMeshModel(quad_2d(16, 12), device=dev)
        mm.set_boundary_displacement("top", [0.02, 0.1])
        new, dm = mm.advance(80, dt=0.5)
        w = node_cell_weights(quad_2d(16, 12), dev)[2].cpu().numpy()
        return new.coords, mm.sweptVolDot, w, [mm.volChange]

    for a, b in zip(*_both(run)):
        assert _rel(a, b) <= 1e-12


def test_charge_transport_cuda_matches_cpu(cuda):
    """ElectricModel's charge transport (injection, capture, Poole-Frenkel
    emission and trap-band tunneling, transient) on the card against the
    CPU; the charge solve's sweeps launch ``dia_stencil``."""
    from fvm_tpu_torch.models import ElectricModel

    def run(dev):
        # 64 x 16: a mesh with DIA structure (24 x 4 has none)
        m = ElectricModel(build_device_mesh(quad_2d(64, 16, ly=0.25),
                                            dtype="float64", device=dev))
        m.options["verbose"] = False
        for k in ("chargetransport_enable", "injection_enable",
                  "trapping_enable", "poole_frenkel_enable",
                  "trapbandtunneling_enable", "transient"):
            m.options[k] = True
        m.options["timeStep"] = 0.05
        for k, v in {"dielectric_constant": 1.0 / 8.8542e-12,
                     "initialCharge": 1e-6, "mobility": 1e-3,
                     "diffusivity": 1e-4, "injectionA": 1e-5,
                     "injectionB": 5.0, "trapDensity": 1.0,
                     "captureCoefficient": 0.5, "emissionCoefficient": 0.01,
                     "emissionFrequency": 1.0, "pfBeta": 0.15,
                     "thermalVoltage": 0.5, "trapDepth": 2.0,
                     "wkbFactor": -3.0, "tunnelingRateScale": 1.0}.items():
            m.vc[k] = v
        for g, V in (("left", 0.0), ("right", 10.0)):
            m.bc[g].bc_type = "SpecifiedPotential"
            m.bc[g]["specifiedPotential"] = V
        m.bc["bottom"].bc_type = m.bc["top"].bc_type = "Symmetry"
        m.init()
        dk.reset_launches()
        for _ in range(4):
            m.advance(3)
            m.updateTime()
        return (m.getCharge(), m.getTrappedCharge(), m.getPotential(),
                dk.type_launches(torch.float64))

    (cg, tg, pg, lg), (cc, tc, pc, _) = _both(run)
    assert lg["residual"] > 0 and lg["mv"] > 0
    for a, b in ((cg, cc), (tg, tc), (pg, pc)):
        assert _rel(a, b) <= 1e-8


def test_charging_cuda_matches_cpu(cuda):
    """The charging column stand-in and a 2 x 2 membrane of it: the
    coefficient arrays, three time steps' history and the charge (the
    history's and the charge's columns each on its own scale: the band
    charge is many orders below the trapped)."""
    from fvm_tpu_torch.cases import (charging_membrane, charging_run,
                                     dielectric_column)

    def run(dev):
        m = dielectric_column(60, device=dev)
        phi, E = m._solve_potential()
        k = m._coeffs(phi, E)
        m.state["_rho_acc"].zero_()
        h = charging_run(m, 3)
        mem = charging_membrane(2, 2, 60, device=dev)
        hm = charging_run(mem, 3)
        return ([k[key].cpu().numpy() for key in sorted(k)], h,
                m.state["charge"].cpu().numpy(), hm)

    (kg, hg, xg, mg), (kc, hc, xc, mc) = _both(run)
    for a, b in zip(kg, kc):
        assert _rel(a, b) <= 1e-12
    assert _rel_cols(hg, hc) <= 1e-8 and _rel_cols(xg, xc) <= 1e-8
    assert _rel_cols(mg, hg) <= 1e-10


def test_ke_cuda_matches_cpu_and_replay_equals_eager(cuda):
    """KeModel over the 16^2 cavity's flow: cuda against cpu, the
    ``outerChunk`` graph replay against the eager loop bit for bit, and its
    solves through ``dia_stencil``."""
    from fvm_tpu_torch.cases import ke_cavity

    def run(dev, chunk=0):
        flow, thermal = coupled_cavity(16, device=dev, dtype="float64")
        for _ in range(20):
            coupled_step(flow, thermal)
        ke = ke_cavity(flow, {"outerChunk": chunk})
        dk.reset_launches()
        for _ in range(3):
            ke.advance(4)
            ke.updateTime()
        return ke.getK(), ke.getEpsilon(), dk.type_launches(torch.float64)

    (kg, eg, lg), (kc, ec, _) = _both(run)
    assert lg["residual"] > 0 and lg["mv"] > 0
    assert _rel(kg, kc) <= 1e-8 and _rel(eg, ec) <= 1e-8
    kr, er, _ = run(torch.device("cuda", 0), chunk=2)
    assert np.array_equal(kr, kg) and np.array_equal(er, eg)


@pytest.mark.parametrize("mode", ["graph", "reverse"])
def test_battery_cuda_matches_cpu(cuda, mode):
    """The demo's half cell (nx 16): two time steps, the Li balance, the
    tangent in sigma and the adjoint of the mean electrode potential, each
    Jacobian-product mode on the card."""
    from fvm_tpu_torch.cases import battery_cell, battery_steps
    from fvm_tpu_torch.linear import BiCGStab, JacobiSolver

    def run(dev):
        s = BiCGStab(preconditioner=JacobiSolver(sweeps=3),
                     relative_tolerance=1e-12, max_iterations=600)
        s.exit_every = 10
        b, el = battery_cell(16, 4, device=dev, solver=s)
        if dev.type == "cuda":
            op = b._newton_op
            b._newton_op = lambda *a: op(*a, mode=mode)
        rows = battery_steps(b, el, 2)
        w = torch.as_tensor(el / el.sum(), device=dev)
        g = b.solve_adjoint(lambda u: torch.sum(u[:, 1] * w), ("sigma",))
        return (b.getPotential(), b.getConcentration(),
                [r[3] for r in rows], b.solve_tangent({"sigma": 1.0}),
                g["sigma"])

    out_g, out_c = _both(run)
    for a, b in zip(out_g, out_c):
        assert _rel(a, b) <= 1e-8
    assert _rel(out_g[2], [-20.0 * 5.0 / 96485.33] * 2) <= 1e-8


@pytest.mark.parametrize("collision", ["BGK", "ESBGK"])
def test_kinetic_couette_cuda_matches_cpu(cuda, collision):
    """The ES-BGK model's COMET Couette (quad_2d(3, 10), Q(6, 6, 4)) with
    tight inner solves: one outer cuda against cpu (1e-8), then the slip
    profile after the plateau (1e-6)."""
    from fvm_tpu_torch.cases import couette_profile, esbgk_couette

    def run(dev):
        m = esbgk_couette(3, 10, device=dev, quad=(6, 6, 4),
                          collision=collision, tau=0.2,
                          options={"innerTolerance": 1e-12,
                                   "innerIterations": 200})
        m.advance(1)
        f1 = m.state["f"][: m.mesh.n_interior_cells].cpu().numpy()
        m.options["innerTolerance"] = 1e-8
        m.options["innerIterations"] = 60
        m._drop_compiled()
        m.advance(6)
        return f1, couette_profile(m)[0]

    (f_g, u_g), (f_c, u_c) = _both(run)
    assert _rel(f_g, f_c) <= 1e-8
    assert _rel(u_g, u_c) <= 1e-6 and u_g[-1] > 0.05


def test_kinetic_thick_dsa_launches_the_kernel(cuda):
    """The thick DSA case on quad_2d(32, 16) (whose mesh has DIA
    structure; quad_2d(48, 3)'s fine level is gather-ELL), cuda against
    cpu: one DSA application on seeded vectors at a seeded state (the two
    V-cycles, the Woodbury + DSA composition and its transpose; 1e-12 of
    the largest entry), then one outer with the inner solve at 1e-12 (its
    first residual and the state after it, 1e-10), the DSA's V-cycles
    launching dia_stencil in every mode, and the DSA's condensed
    fine-level operator against the plain version bit for bit."""
    from fvm_tpu_torch.cases import esbgk_thick
    from fvm_tpu_torch.kinetic.dsa import DSAPrecond
    from fvm_tpu_torch.kinetic.esbgk import _KineticOperator

    def run(dev):
        m = esbgk_thick(32, 16, dsa=True, device=dev)
        rng = np.random.default_rng(7)
        f0 = m.state["f"]
        f = f0 * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal(tuple(f0.shape))).to(dev)
        r = torch.as_tensor(rng.standard_normal(tuple(f0.shape))).to(dev)
        V = m.mesh.cell_volume[:, None]
        tau = m.params["tau"][:, None]
        op = _KineticOperator(m.mesh, m.params["dO"], m.params["dN"],
                              V / tau)
        M_T, wE = m._dsa_tuple()[:2]
        dsa = DSAPrecond(m._woodbury(op, f, V, tau), *m._dsa_tuple())
        applied = [M_T(r @ wE), dsa.precond_setup(op)(r),
                   dsa.precond_setup_T(op)(r)]
        m.options["innerTolerance"] = 1e-12
        m.options["innerIterations"] = 400
        m._drop_compiled()
        dk.reset_launches()
        h = m.advance(1)
        f1 = m.state["f"][: m.mesh.n_interior_cells]
        return ([a.cpu().numpy() for a in applied], h, f1.cpu().numpy(),
                dk.type_launches(torch.float64), m)

    (ag, hg, fg, lg, m), (ac, hc, fc, _, _) = _both(run)
    for a, b in zip(ag, ac):
        assert _rel(a, b) <= 1e-12
    assert all(lg[mode] > 0 for mode in dk.MODES), lg
    assert max(hg.trips[0], hc.trips[0]) < 400
    assert _rel(hg[0][1], hc[0][1]) <= 1e-10 and _rel(fg, fc) <= 1e-10
    A = m._dsa_tuple()[0].matrix.prepare()
    assert A.dia is not None
    x = torch.randn(A.n, dtype=torch.float64, device=cuda)
    for mode in dk.MODES:
        b = None if mode == "mv" else x.flip(0)
        omega = 0.7 if mode == "jacobi" else None
        y = dk._launch(A.dia.offsets, mode, A.dia_coef, A.diag, x, b, omega)
        want = dk.dia_stencil_plain(A.dia.offsets, mode, A.dia_coef, A.diag,
                                    x, b=b, omega=omega)
        assert torch.equal(y, want)


def test_kinetic_sensitivities_cuda_match_cpu(cuda):
    """solve_tangent and solve_adjoint on the converged BGK Couette
    (quad_2d(3, 6), Q(6, 6, 4)): cuda against cpu (1e-6), both transposed
    solves within their 400-trip cap, and the duality on the card
    (1e-7)."""
    from fvm_tpu_torch.cases import esbgk_couette

    def run(dev):
        m = esbgk_couette(3, 6, device=dev, quad=(6, 6, 4),
                          collision="BGK", tau=0.2)
        m.advance(12)
        ni = m.mesh.n_interior_cells
        dtau = np.random.default_rng(3).standard_normal(ni)
        tan = m.solve_tangent(param_tangents={"tau": dtau})
        q = m.quadrature
        wcx = torch.as_tensor(q.w * q.c[:, 0]).to(dev)

        def J(ff):
            return torch.sum((ff @ wcx) ** 2)

        g = m.solve_adjoint(J, param_keys=("tau",))
        f0 = m.state["f"][:ni]
        dJ = float(torch.func.jvp(J, (f0,), (torch.as_tensor(tan).to(dev),))
                   [1])
        return (tan, g["tau"],
                abs(float(np.dot(g["tau"], dtau)) - dJ) / abs(dJ),
                int(m.adjoint_stats.iterations))

    (tg, gg, dg, ig), (tc, gc_, _, ic) = _both(run)
    assert _rel(tg, tc) <= 1e-6 and _rel(gg, gc_) <= 1e-6 and dg <= 1e-7
    assert max(ig, ic) < 400


def test_kinetic_chunk_replay_equals_eager(cuda):
    """``outerChunk`` (3) replays of the COMET step against the same step
    (forward-mode products) run eagerly: bit for bit; and an immersed body
    moved with the same padding keeps the captured chunk."""
    from fvm_tpu_torch.cases import esbgk_couette, esbgk_ib_plate

    out = []
    for chunk in (0, 3):
        m = esbgk_couette(3, 6, device=cuda, quad=(6, 6, 4), collision="BGK",
                          tau=0.2, options={"outerChunk": chunk,
                                            "relativeTolerance": 1e-30})
        if not chunk:
            m._step = m._build_step("forward")
        h = m.advance(6)
        out.append(([r[1] for r in h], m.state["f"]))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
    m = esbgk_ib_plate(8, device=cuda, quad=(6, 6, 4), pad_faces=40,
                       options={"outerChunk": 2})
    m.advance(2)
    runner = m._runners[("chunk", 2)]
    cc = m.mesh.cell_centroid[: m.mesh.n_interior_cells].cpu().numpy()
    moved = (np.abs(cc[:, 0] - 0.4) < 0.25) & (np.abs(cc[:, 1] - 0.5) < 0.1)
    m.set_immersed_boundary(moved, wall_velocity=(0.2, 0.0), pad_faces=40)
    h = m.advance(2)
    assert m._runners[("chunk", 2)] is runner and np.isfinite(h[-1][1])


def test_phonon_thick_dsa_launches_the_kernel(cuda):
    """The thick phonon slab on quad_2d(32, 16) with the DSA (whose mesh
    has DIA structure; quad_2d(32, 4)'s fine level is gather-ELL), cuda
    against cpu: one DSA application on seeded vectors (the two V-cycles, the
    Woodbury + DSA composition and its transpose; 1e-12 of the largest
    entry), then one outer with the inner solve at 1e-12 (its first
    residual and the state after it, 1e-10), the DSA's V-cycles launching
    dia_stencil in every mode (counted), and the DSA's condensed
    fine-level operator against the plain version bit for bit."""
    from fvm_tpu_torch.cases import phonon_thick
    from fvm_tpu_torch.kinetic.dsa import DSAPrecond
    from fvm_tpu_torch.kinetic.esbgk import _KineticOperator

    def run(dev):
        m = phonon_thick(32, 16, dsa=True, device=dev)
        rng = np.random.default_rng(7)
        e0 = m.state["e"]
        e = e0 + torch.as_tensor(rng.standard_normal(tuple(e0.shape))).to(dev)
        r = torch.as_tensor(rng.standard_normal(tuple(e0.shape))).to(dev)
        V = m.mesh.cell_volume[:, None]
        rate = m._rate()
        op = _KineticOperator(m.mesh, m.params["dO"], m.params["dN"],
                              V * rate)
        M_T, wE = m._dsa_tuple()[:2]
        dsa = DSAPrecond(m._woodbury(op, V, rate), *m._dsa_tuple())
        applied = [M_T(r @ wE), dsa.precond_setup(op)(r),
                   dsa.precond_setup_T(op)(r)]
        m.state["e"] = e
        m.options["innerTolerance"] = 1e-12
        m.options["innerIterations"] = 400
        m._drop_compiled()
        dk.reset_launches()
        h = m.advance(1)
        e1 = m.state["e"][: m.mesh.n_interior_cells]
        return ([a.cpu().numpy() for a in applied], h, e1.cpu().numpy(),
                dk.type_launches(torch.float64), m)

    (ag, hg, eg, lg, m), (ac, hc, ec, _, _) = _both(run)
    for a, b in zip(ag, ac):
        assert _rel(a, b) <= 1e-12
    assert all(lg[mode] > 0 for mode in dk.MODES), lg
    assert max(hg.trips[0], hc.trips[0]) < 400
    assert _rel(hg[0][1], hc[0][1]) <= 1e-10 and _rel(eg, ec) <= 1e-10
    A = m._dsa_tuple()[0].matrix.prepare()
    assert A.dia is not None
    x = torch.randn(A.n, dtype=torch.float64, device=cuda)
    for mode in dk.MODES:
        b = None if mode == "mv" else x.flip(0)
        omega = 0.7 if mode == "jacobi" else None
        y = dk._launch(A.dia.offsets, mode, A.dia_coef, A.diag, x, b, omega)
        want = dk.dia_stencil_plain(A.dia.offsets, mode, A.dia_coef, A.diag,
                                    x, b=b, omega=omega)
        assert torch.equal(y, want)


def test_phonon_two_band_and_two_zone_cuda_match_cpu(cuda, tmp_path):
    """The two-band slab (quad_2d(8, 8), COMET to 1e-10) and the two-zone
    slab read from a written binary f64 Fluent case (quad_2d(12, 12),
    ballistic, DMM) converged on each device: temperatures 1e-10, the
    closed form 1e-6, the interface's energy flux balanced."""
    import sys
    from pathlib import Path

    from fvm_tpu_torch.cases import (phonon_nongray, phonon_two_zone,
                                     phonon_two_zone_exact)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from scripts.fluent_case import two_zone_split, write_fluent_case

    path = str(tmp_path / "two_zone.cas")
    mesh = quad_2d(12, 12)
    write_fluent_case(path, mesh, "f64", zones=two_zone_split(mesh))

    def run(dev):
        m = phonon_nongray(8, device=dev)
        m.advance(4)
        z = phonon_two_zone(path, device=dev)
        z.advance(8)
        q = [z.getHeatFluxIntegral(g) for g in ("mid:L", "mid:R")]
        return m.getTemperature(), z.getTemperature(), q, z

    (tg, zg, qg, z), (tc, zc, _, _) = _both(run)
    assert _rel(tg, tc) <= 1e-10 and _rel(zg, zc) <= 1e-10
    tL, tR = phonon_two_zone_exact(z)
    left = z.left_cells
    assert _rel(zg[left], np.full(left.sum(), tL)) <= 1e-6
    assert _rel(zg[~left], np.full((~left).sum(), tR)) <= 1e-6
    assert abs(qg[0] + qg[1]) < 1e-10 * abs(qg[0])


def test_phonon_adjoint_duality_on_the_card(cuda):
    """solve_tangent and solve_adjoint of the converged gray slab
    (quad_2d(12, 3), S_N(4, 8), tau 0.15): cuda against cpu (1e-8) and the
    duality on the card (1e-8)."""
    from fvm_tpu_torch.cases import phonon_slab

    def run(dev):
        m = phonon_slab(12, 3, dev, tau=0.15, T=(310.0, 290.0),
                        options={"relativeTolerance": 1e-12})
        m.advance(10)
        ni = m.mesh.n_interior_cells
        dtau = np.random.default_rng(3).standard_normal(m.D)
        tan = m.solve_tangent(param_tangents={"tau": dtau})
        xw = m.mesh.cell_centroid[:ni, 0]

        def J(ee):
            return torch.sum(m.temperature(ee) * xw)

        g = m.solve_adjoint(J, param_keys=("tau",))
        e0 = m.state["e"][:ni]
        dJ = float(torch.func.jvp(J, (e0,), (torch.as_tensor(tan).to(dev),))
                   [1])
        return tan, g["tau"], abs(float(np.dot(g["tau"], dtau)) - dJ) / abs(dJ)

    (tg, gg, dg), (tc, gc_, dc) = _both(run)
    assert _rel(tg, tc) <= 1e-8 and _rel(gg, gc_) <= 1e-8
    assert max(dg, dc) <= 1e-8


def test_phonon_chunk_replay_equals_eager(cuda):
    """``outerChunk`` (2) replays of the phonon COMET step against the same
    step (forward-mode products) run eagerly: bit for bit."""
    from fvm_tpu_torch.cases import phonon_slab

    out = []
    for chunk in (0, 2):
        m = phonon_slab(12, 3, cuda, T=(310.0, 290.0), n_polar=2,
                        n_azimuthal=4, options={"outerChunk": chunk,
                                                "relativeTolerance": 0.0,
                                                "absoluteTolerance": 0.0})
        if not chunk:
            m._step = m._build_step("forward")
        h = m.advance(4)
        out.append(([r[1] for r in h], m.state["e"]))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])


# ---- the immersed boundary's stencil rows and the material-point method

def _widened_system(device, n=96):
    """The hot cylinder's widened (n,) thermal system after its IB rows
    (``cases.ib_hot_cylinder``), prepared: DIA offsets plus the stencil's
    couplings as fallback entries."""
    from fvm_tpu_torch.cases import ib_hot_cylinder

    t = ib_hot_cylinder(n, device=device)
    A, r = t._linearize(t.mesh, t.params, t.state, t._resolve_bcvals())
    return A.prepare(), r


@pytest.mark.parametrize("variant", dk.VARIANTS)
def test_widened_ib_level_kernel_matches_plain(cuda, variant):
    """The widened level's fused op: each variant against the plain version
    on the card, bit for bit, the stencil alone and with its fallback
    entries applied (deterministic algorithms: the fallback's index_add
    adds with atomics); the solve's products launch the kernel."""
    from fvm_tpu_torch.ops.dia import apply_fallback

    A, r = _widened_system(cuda)
    d = A.dia
    assert d is not None and d.fb_rows.shape[0] > 0
    x = torch.linspace(-1.0, 1.0, A.n, dtype=A.diag.dtype, device=cuda)
    for mode in dk.MODES:
        kw = _kw(mode, r)
        y = dk._launch(d.offsets, mode, A.dia_coef, A.diag, x, kw.get("b"),
                       kw.get("omega"), variant=variant)
        y_ref = dk.dia_stencil_plain(d.offsets, mode, A.dia_coef, A.diag,
                                     x, **kw)
        with _deterministic():
            pair = [apply_fallback(t, mode, A.diag, x, kw.get("omega"),
                                   d.fb_rows, d.fb_cols, A.dia_fb_vals)
                    for t in (y, y_ref)]
        for got, want in ((y, y_ref), pair):
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) == 0.0, (variant, mode)
    before = dict(dk.dia_stencil.launches)
    A.mv(x)
    assert sum(dk.dia_stencil.launches.values()) > sum(before.values())


def test_ib_stencil_flow_cuda_matches_cpu(cuda):
    """The flow cylinder's stencil rows on the card against the CPU: 10
    SIMPLE outers at 48^2 in float64, histories to 1e-8 (the fallback's
    atomics reorder sums); the chunk replay against the eager loop under
    deterministic algorithms, bit for bit."""
    from fvm_tpu_torch.cases import ib_cylinder

    hists = []
    for dev in (cuda, "cpu"):
        f = ib_cylinder(48, device=dev, dtype="float64")
        hists.append(np.array([h[1:] for h in f.advance(10)], float))
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-8)
    with _deterministic():
        runs = []
        for chunk in (0, 5):
            f = ib_cylinder(48, device=cuda, dtype="float64")
            f.options["outerChunk"] = chunk
            for k in ("momentumTolerance", "continuityTolerance",
                      "absoluteTolerance"):
                f.options[k] = 0.0
            runs.append(np.array([h[1:] for h in f.advance(10)], float))
    assert np.array_equal(runs[0], runs[1])


def test_mpm_substeps_cuda_match_cpu(cuda):
    """``MPMSolver`` at 32^2 (the two-block collision), 20 substeps as one
    graph replay on the card against the CPU's eager loop, float64: x, v,
    F, C to 1e-12 of their scales (P2G adds with atomics on the card);
    bit for bit under deterministic algorithms against the card's own
    deterministic replay of another solver."""
    from fvm_tpu_torch.cases import mpm_block

    states = []
    for dev in (cuda, "cpu"):
        s = mpm_block(32, device=dev, dtype="float64")
        s.advance(0.1, substeps=20)
        states.append({k: v.cpu().numpy() for k, v in s.state.items()})
    g, c = states
    v_scale = float(np.abs(c["v"]).max())
    for k, scale in (("x", 1.0), ("v", v_scale), ("F", 1.0),
                     ("C", 32 * v_scale)):
        np.testing.assert_allclose(g[k], c[k], rtol=0, atol=1e-12 * scale)
    with _deterministic():
        runs = []
        for _ in range(2):
            s = mpm_block(32, device=cuda, dtype="float64")
            s.advance(0.1, substeps=20)
            runs.append(s.state["x"].cpu().numpy())
    assert np.array_equal(runs[0], runs[1])


def test_gloo_halo_exchange_on_cuda_tensors(cuda):
    """Two gloo ranks on the card (``parallel.run_ranks``; first
    ``cases.dist_probe_rank``, which holds each collective of CUDA tensors
    to its exact result): the halo exchange of CUDA
    tensors equals the CPU world's bit for bit (a copy), and its
    transpose's dot-product test holds to 1e-15."""
    from fvm_tpu_torch.parallel import run_ranks

    def world(device):
        return run_ranks("dist_suite_rank", 2, {"cases": [
            ("probe", "dist_probe_rank", {}),
            ("halo", "dist_halo_rank", {"mesh": ("quad_2d", (12, 8))})]},
            device=device, backend="gloo", timeout=120.0)

    gpu, cpu = world("cuda"), world("cpu")
    for g, c in zip(gpu, cpu):
        for k in ("Ex", "ETy", "grad", "restored"):
            np.testing.assert_array_equal(g[f"halo/{k}"], c[f"halo/{k}"])
    lhs = sum(float((r["halo/Ex"] * r["halo/y"]).sum()) for r in gpu)
    rhs = sum(float((r["halo/x"] * r["halo/ETy"]).sum()) for r in gpu)
    assert abs(lhs - rhs) <= 4e-15 * abs(lhs)
