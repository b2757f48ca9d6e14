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

from fvm_tpu_torch.cases import coupled_cavity, coupled_step
from fvm_tpu_torch.ops import dia_kernel as dk
from fvm_tpu_torch.tools.kernel_bench import cavity_level_shapes

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
    levels = cavity_level_shapes(1024)
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


def test_coupled_slice_cuda_matches_cpu(cuda):
    def history(device):
        flow, thermal = coupled_cavity(32, device=device, dtype="float64")
        return [[float(v) for v in coupled_step(flow, thermal)]
                for _ in range(3)]

    before = sum(dk.dia_stencil.launches.values())
    h_gpu = history(cuda)
    assert sum(dk.dia_stencil.launches.values()) > before
    np.testing.assert_allclose(h_gpu, history("cpu"), rtol=1e-8)
