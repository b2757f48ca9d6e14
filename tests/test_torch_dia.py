"""The plain ``dia_stencil`` and the port's DIA operators against fvm_tpu.

The plain PyTorch version of the fused DIA stencil (the CPU path, and the
oracle the CUDA kernel is held against on the card) is compared with the
JAX package's XLA roll formula (``fvm_tpu.ops.dia.fused_apply``) and with
its Pallas TPU kernel (``pallas_kernels.dia_apply``, run in interpret mode
as ``tests/test_pallas.py`` runs it), on that file's cases.  Inputs are
made with a seeded numpy generator; the out-of-range coefficients are zero
(as ``analyze_offsets`` guarantees), which is where roll and zero-padding
agree.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from fvm_tpu.ops import pallas_kernels as jpk
from fvm_tpu.ops.dia import fused_apply as j_fused_apply
from fvm_tpu_torch.ops import dia_kernel as dk
from fvm_tpu_torch.ops.dia import DIAMatrix, fused_apply as t_fused_apply

# float32: summation order and the TPU kernel's fused multiply-adds;
# float64: the same arithmetic, rounding differences only
RTOL32 = 2e-5
RTOL64 = 1e-13


def _case(n, offsets, nrhs, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    coef = rng.normal(size=(len(offsets), n)).astype(dtype)
    idx = np.arange(n)
    for j, d in enumerate(offsets):
        coef[j, (idx + d < 0) | (idx + d >= n)] = 0.0
    diag = (rng.normal(size=n) + 4.0).astype(dtype)
    shape = (n,) if nrhs == 0 else (n, nrhs)
    x = rng.normal(size=shape).astype(dtype)
    b = rng.normal(size=shape).astype(dtype)
    return coef, diag, x, b


def _kw(mode, b, omega=0.8):
    kw = {} if mode == "mv" else {"b": b}
    if mode == "jacobi":
        kw["omega"] = omega
    return kw


def _plain(offsets, mode, coef, diag, x, b, omega=0.8):
    t = torch.from_numpy
    y = dk.dia_stencil(offsets, mode, t(coef), t(diag), t(x),
                       **_kw(mode, None if b is None else t(b), omega))
    return y.numpy()


def _xla(offsets, mode, coef, diag, x, b, omega=0.8):
    j = jnp.asarray
    return np.asarray(j_fused_apply(offsets, j(diag), j(coef), j(x), mode=mode,
                                    **_kw(mode, j(b), omega)))


def _pallas(offsets, mode, coef, diag, x, b, omega=0.8):
    j = jnp.asarray
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpk.dia_apply(offsets, mode, j(coef), j(diag), j(x),
                                        **_kw(mode, j(b), omega)))


@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("nrhs", [0, 2])
def test_plain_matches_fused_apply_and_pallas(mode, nrhs):
    offsets = (-70, -1, 1, 70)
    coef, diag, x, b = _case(5000, offsets, nrhs)
    before = dict(dk.dia_stencil.launches)
    got = _plain(offsets, mode, coef, diag, x, b)
    assert dk.dia_stencil.launches == before  # the CPU path launches nothing
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _xla(offsets, mode, coef, diag, x, b),
                               rtol=RTOL32, atol=RTOL32)
    np.testing.assert_allclose(got, _pallas(offsets, mode, coef, diag, x, b),
                               rtol=RTOL32, atol=RTOL32)


def test_plain_multiblock_halo_matches_pallas():
    n = 3 * 512 * 128 + 777
    offsets = (-640, -128, -1, 1, 128, 640)
    coef, diag, x, b = _case(n, offsets, 0, seed=1)
    got = _plain(offsets, "jacobi", coef, diag, x, b, omega=0.7)
    np.testing.assert_allclose(
        got, _xla(offsets, "jacobi", coef, diag, x, b, omega=0.7),
        rtol=RTOL32, atol=RTOL32)
    np.testing.assert_allclose(
        got, _pallas(offsets, "jacobi", coef, diag, x, b, omega=0.7),
        rtol=RTOL32, atol=RTOL32)


@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("nrhs", [0, 2])
def test_plain_float64_matches_fused_apply(mode, nrhs):
    offsets = (-640, -128, -1, 1, 128, 640)
    coef, diag, x, b = _case(20000, offsets, nrhs, dtype=np.float64, seed=2)
    got = _plain(offsets, mode, coef, diag, x, b)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _xla(offsets, mode, coef, diag, x, b),
                               rtol=RTOL64, atol=RTOL64)


@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("nrhs", [0, 2])
def test_fallback_scatter_sums_repeated_rows(mode, nrhs):
    """Rare-offset entries outside the kernel: rows repeat, and every
    contribution must land (a plain index assignment would drop all but
    one per row)."""
    n = 300
    offsets = (-1, 1)
    coef, diag, x, b = _case(n, offsets, nrhs, dtype=np.float64, seed=3)
    rng = np.random.default_rng(4)
    fb_rows = np.array([5, 5, 5, 17, 17, 299, 0], dtype=np.int64)
    fb_cols = rng.integers(0, n, size=fb_rows.shape[0])
    fb_vals = rng.normal(size=fb_rows.shape[0])
    j, t = jnp.asarray, torch.from_numpy
    want = j_fused_apply(offsets, j(diag), j(coef), j(x), mode=mode,
                         fb_rows=j(fb_rows.astype(np.int32)),
                         fb_cols=j(fb_cols.astype(np.int32)),
                         fb_vals=j(fb_vals), **_kw(mode, j(b)))
    got = t_fused_apply(offsets, t(diag), t(coef), t(x), mode=mode,
                        fb_rows=t(fb_rows), fb_cols=t(fb_cols),
                        fb_vals=t(fb_vals), **_kw(mode, t(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL64,
                               atol=RTOL64)
    # the repeated rows really carry several contributions
    plain = _plain(offsets, mode, coef, diag, x, b)
    assert not np.allclose(got.numpy()[5], plain[5])


def test_dia_matrix_matches_dense():
    offsets = (-7, -1, 1, 7)
    coef, diag, x, b = _case(49, offsets, 2, dtype=np.float64, seed=5)
    t = torch.from_numpy
    A = DIAMatrix(t(diag), t(coef), offsets).prepare()
    dense = A.to_dense().numpy()
    np.testing.assert_allclose(A.mv(t(x)).numpy(), dense @ x, rtol=RTOL64,
                               atol=RTOL64)
    np.testing.assert_allclose(A.residual(t(x), t(b)).numpy(), b - dense @ x,
                               rtol=RTOL64, atol=RTOL64)
    want = x + 0.6 * (b - dense @ x) / diag[:, None]
    np.testing.assert_allclose(A.jacobi_step(t(x), t(b), 0.6).numpy(), want,
                               rtol=RTOL64, atol=RTOL64)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    offsets = (-1, 1)
    coef, diag, x, b = _case(10, offsets, 0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="mode"):
        dk.dia_stencil(offsets, "gauss_seidel", t(coef), t(diag), t(x))
    with pytest.raises(ValueError, match="device"):
        dk.dia_stencil(offsets, "mv", t(coef), t(diag),
                       torch.empty(10, device="meta"))
