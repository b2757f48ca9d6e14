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
