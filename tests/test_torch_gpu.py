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

import numpy as np
import pytest
import torch

from fvm_tpu_torch import hostlib
from fvm_tpu_torch.cases import coupled_cavity, coupled_cavity_3d, coupled_step
from fvm_tpu_torch.linear import AMG
from fvm_tpu_torch.linear.amg import aggregate_plain
from fvm_tpu_torch.mesh import build_device_mesh
from fvm_tpu_torch.mesh.generate import hex_3d, quad_2d, tri_2d
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
        ("narrow", "residual", small): 1, ("narrow", "mv", small): 1,
        ("wide", "residual", large): 1, ("wide", "mv", large): 1,
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
