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


def _plain(offsets, mode, coef, diag, x, b, omega=0.8, layout="padded"):
    """The port's CPU path; ``layout`` "padded" hands it the (D, n) view of
    the kernel's padded coefficient storage (``pack_coef``), "contiguous"
    a plain contiguous (D, n) tensor."""
    t = torch.from_numpy
    c = dk.pack_coef(t(coef)) if layout == "padded" else t(coef)
    y = dk.dia_stencil(offsets, mode, c, t(diag), t(x),
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


@pytest.mark.parametrize("layout", ["contiguous", "padded"])
@pytest.mark.parametrize("mode", dk.MODES)
@pytest.mark.parametrize("nrhs", [0, 2])
def test_plain_matches_fused_apply_and_pallas(mode, nrhs, layout):
    offsets = (-70, -1, 1, 70)
    coef, diag, x, b = _case(5000, offsets, nrhs)
    before = dict(dk.dia_stencil.launches)
    got = _plain(offsets, mode, coef, diag, x, b, layout=layout)
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


def test_pack_coef_layout():
    """The kernel's coefficient layout: a (D, n) view of (D, ld) storage,
    ld the next multiple of COEF_ALIGN, a 16-byte aligned base, the same
    values."""
    coef = torch.from_numpy(_case(1027, (-33, -1, 1, 33), 0)[0])
    packed = dk.pack_coef(coef)
    assert packed.shape == coef.shape and torch.equal(packed, coef)
    assert packed.stride() == (1056, 1) and dk.coef_ld(1027) == 1056
    assert dk.coef_packed(packed) and not dk.coef_packed(coef)
    assert dk.coef_packed(dk.pack_coef(coef[:, :64]))  # n a multiple of 32
    assert dk.coef_ld(1) == dk.COEF_ALIGN


def test_check_operands_takes_and_refuses():
    """The wrapper's operand check is a function of dtypes, devices,
    shapes, strides and base alignment, so it runs here on CPU tensors."""
    n, offsets = 1027, (-33, -1, 1, 33)
    coef, diag, x, b = (torch.from_numpy(a)
                        for a in _case(n, offsets, 0, dtype=np.float64))
    coef = dk.pack_coef(coef)
    x3 = torch.zeros((n, 3), dtype=torch.float64)
    assert dk.check_operands(offsets, "mv", coef, diag, x) == 1
    assert dk.check_operands(offsets, "jacobi", coef, diag, x3, b=x3,
                             omega=0.7) == 3
    # x and b at any base address
    xs = torch.zeros(n + 1, dtype=torch.float64)
    assert dk.check_operands(offsets, "residual", coef, diag, xs[1:],
                             b=xs[:n]) == 1
    wide = torch.zeros((4, n + 1), dtype=torch.float64)
    bad = [
        (dict(coef=coef.contiguous()), "layout"),
        (dict(coef=dk.pack_coef(wide)[:, 1:]), "layout"),
        (dict(diag=torch.zeros(n + 1, dtype=torch.float64)[1:]), "aligned"),
        (dict(x=torch.zeros((n, 2), dtype=torch.float64)[:, 0]), "contiguous"),
        (dict(x=x.float()), "float64"),
        (dict(x=torch.zeros((n, 4), dtype=torch.float64)), "m <= 3"),
        (dict(x=x.to(torch.int64)), "dtype"),
        (dict(offsets=tuple(range(1, 18))), "offsets"),
        (dict(mode="residual"), "needs b"),
        (dict(mode="jacobi", b=b), "needs omega"),
        (dict(diag=diag[:-1]), "shape"),
    ]
    for change, match in bad:
        kw = dict(offsets=offsets, mode="mv", coef=coef, diag=diag, x=x)
        kw.update(change)
        with pytest.raises(ValueError, match=match):
            dk.check_operands(**kw)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    offsets = (-1, 1)
    coef, diag, x, b = _case(10, offsets, 0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="mode"):
        dk.dia_stencil(offsets, "gauss_seidel", t(coef), t(diag), t(x))
    with pytest.raises(ValueError, match="device"):
        dk.dia_stencil(offsets, "mv", t(coef), t(diag),
                       torch.empty(10, device="meta"))
