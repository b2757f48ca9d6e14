"""The CUDA ``dia_stencil`` kernel against its plain version, on the card.

These tests need an NVIDIA GPU (marker ``gpu``) and skip elsewhere; whether
a card exists is decided inside the fixture, never at import, so every
test-runner worker collects the same tests.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest``: ``tests/conftest.py`` imports jax, which a GPU machine
need not have.)

The kernel rounds like the plain version (built without FMA contraction,
same summation order), so the tolerances only cover reordering.
"""

import numpy as np
import pytest
import torch

from fvm_tpu_torch.cases import coupled_cavity, coupled_step
from fvm_tpu_torch.ops import dia_kernel as dk

pytestmark = pytest.mark.gpu

EDGE = 512
RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _operator(n, offsets, dtype, device, m):
    rng = np.random.default_rng(3)
    coef = -rng.random((len(offsets), n))
    idx = np.arange(n)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = 4.0 + rng.random(n)
    shape = (n,) if m == 1 else (n, m)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    return [torch.from_numpy(a).to(device, dtype) for a in (coef, diag, x, b)]


@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2])
def test_kernel_matches_plain_512(cuda, mode, dtype, m):
    n = EDGE * EDGE
    offsets = (-EDGE, -1, 1, EDGE)
    coef, diag, x, b = _operator(n, offsets, dtype, cuda, m)
    kw = {} if mode == "mv" else {"b": b}
    if mode == "jacobi":
        kw["omega"] = 0.8
    before = dk.dia_stencil.launches[mode]
    y = dk.dia_stencil(offsets, mode, coef, diag, x, **kw)
    torch.cuda.synchronize()
    assert dk.dia_stencil.launches[mode] == before + 1
    y_ref = dk.dia_stencil_plain(offsets, mode, coef, diag, x, **kw)
    scale = float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) <= RTOL[dtype] * scale


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


def test_coupled_slice_cuda_matches_cpu(cuda):
    def history(device):
        flow, thermal = coupled_cavity(32, device=device, dtype="float64")
        return [[float(v) for v in coupled_step(flow, thermal)]
                for _ in range(3)]

    before = sum(dk.dia_stencil.launches.values())
    h_gpu = history(cuda)
    assert sum(dk.dia_stencil.launches.values()) > before
    np.testing.assert_allclose(h_gpu, history("cpu"), rtol=1e-8)
