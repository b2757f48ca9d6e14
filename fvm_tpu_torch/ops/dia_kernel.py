"""The fused DIA stencil: a hand-written CUDA kernel and its plain version.

Replaces the JAX package's only TPU kernel, ``_dia_kernel`` launched by
``_dia_apply_packed`` (``fvm_tpu/ops/pallas_kernels.py:125-232``,
``pl.pallas_call`` at line 218).  It computes, for a static set of signed
offsets d (D <= 16),

    Ax[i] = diag[i] * x[i] + sum_d coef[d, i] * x[i + d]     (x = 0 outside [0, n))

in three fused modes: ``mv`` y = Ax, ``residual`` y = b - Ax and ``jacobi``
y = x + omega (b - Ax) / diag, on x, b of shape (n,) or (n, m), m <= 3,
row-major (the port's public layout: no transpose, unlike the Pallas
wrapper's (m, n)), in float32 or float64 (Hopper has native f64).

Bound on this card: bytes.  Each call must read diag (n), the D
coefficient rows (D n), x (n m) and, for residual/jacobi, b (n m), and
write y (n m), at 4 or 8 bytes; it does ~2 (D + 1) m flops per row, under
one flop per byte, where an H100 stops being memory-bound only at ~20
float32 flops per byte (67 TFLOP/s over 3.35 TB/s, NVIDIA's data sheet).
So the least time is those bytes over 3.35 TB/s.

Design (``csrc/dia_stencil.cu``): one thread per row, looping over the m
right-hand sides with m accumulators in registers; each coef[d, i] and
diag[i] is loaded once per row, coalesced across the warp.  The x reads at
i + d are coalesced too; their reuse across the D + 1 offsets of
neighbouring rows is left to L2 (50 MB holds the whole 1M-cell x), instead
of the TPU kernel's 128-lane row blocks, halo DMA and lane rolls: here the
halo is up to +-nx = 1024 rows, so a shared-memory tile would be mostly
halo.  TMA/cp.async staging is left for a later change.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version.  There is no other switch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

MODES = ("mv", "residual", "jacobi")
MAX_OFFSETS = 16
MAX_RHS = 3

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "dia_stencil.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# -fmad=false: no FMA contraction, so the kernel rounds like the plain
# version and the two agree bit for bit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


_C_OFFSETS = {}


def _c_offsets(offsets):
    """The offsets as the C int array the launcher copies into the kernel's
    parameter block, made once per offsets tuple."""
    arr = _C_OFFSETS.get(offsets)
    if arr is None:
        arr = (ctypes.c_int * max(len(offsets), 1))(*offsets)
        _C_OFFSETS[offsets] = arr
    return arr


def dia_stencil_plain(offsets, mode, coef, diag, x, b=None, omega=None):
    """Plain PyTorch version: zero-padded shifts (``F.pad`` + slices), the
    same accumulation order as the kernel and as the JAX roll formula
    (diag term first, then the offsets in order)."""
    n = x.shape[0]
    maxd = max((abs(int(d)) for d in offsets), default=0)
    pad = (maxd, maxd) if x.ndim == 1 else (0, 0, maxd, maxd)
    xp = F.pad(x, pad)
    ax = diag * x if x.ndim == 1 else diag[:, None] * x
    for j, d in enumerate(offsets):
        c = coef[j] if x.ndim == 1 else coef[j][:, None]
        ax = ax + c * xp[maxd + d: maxd + d + n]
    if mode == "mv":
        return ax
    if mode == "residual":
        return b - ax
    dg = diag if x.ndim == 1 else diag[:, None]
    return x + omega * (b - ax) / dg


_lib = None
_lib_lock = threading.Lock()


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/dia_stencil.cu`` with nvcc into ``build/kernels`` (on
    first use, from the repository's sources only) and load it.  With
    ``verbose`` the ptxas register/spill report is printed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, "libdia_stencil.so")
        # build under a private name, then rename: a process that loads the
        # library never sees another process's half-written file
        tmp = f"{so}.{os.getpid()}.tmp"
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        lib = ctypes.CDLL(so)
        for name in ("dia_stencil_f32", "dia_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,  # coef diag x b y
                ctypes.c_longlong, ctypes.c_int,  # n m
                ctypes.c_void_p, ctypes.c_int,  # host offsets, D
                ctypes.c_int, ctypes.c_double,  # mode omega
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(name, t, dtype, device, shape):
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"dia_stencil: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dia_stencil: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"dia_stencil: {name} is not contiguous")


def _launch(offsets, mode, coef, diag, x, b, omega):
    n = x.shape[0]
    m = 1 if x.ndim == 1 else x.shape[1]
    offsets = tuple(int(d) for d in offsets)
    D = len(offsets)
    dtype, device = x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dia_stencil: unsupported dtype {dtype}")
    if x.ndim not in (1, 2) or not 1 <= m <= MAX_RHS:
        raise ValueError(f"dia_stencil: x of shape {tuple(x.shape)} "
                         f"(need (n,) or (n, m), m <= {MAX_RHS})")
    if D > MAX_OFFSETS:
        raise ValueError(f"dia_stencil: {D} offsets > {MAX_OFFSETS}")
    _check("x", x, dtype, device, x.shape)
    _check("coef", coef, dtype, device, (D, n))
    _check("diag", diag, dtype, device, (n,))
    if mode != "mv":
        if b is None:
            raise ValueError(f"dia_stencil: mode {mode!r} needs b")
        _check("b", b, dtype, device, x.shape)
    if mode == "jacobi" and omega is None:
        raise ValueError("dia_stencil: mode 'jacobi' needs omega")
    lib = _lib if _lib is not None else build()
    fn = lib.dia_stencil_f32 if dtype == torch.float32 else lib.dia_stencil_f64
    y = torch.empty_like(x)
    args = (coef.data_ptr(), diag.data_ptr(), x.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            n, m, _c_offsets(offsets), D, MODES.index(mode),
            0.0 if omega is None else float(omega))
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):  # launch on the operands' card
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_stencil launch failed: CUDA error {err}")
    dia_stencil.launches[mode] += 1
    return y


def dia_stencil(offsets, mode, coef, diag, x, b=None, omega=None):
    """Fused DIA op on (n,) or (n, m) vectors; returns x's shape.

    ``coef`` (D, n) and ``diag`` (n,) are the matrix's prepared, contiguous
    operands (``ELLMatrix.prepare``, ``DIAMatrix.prepare``).  A CUDA ``x``
    launches the CUDA kernel (raising on anything it does not take); a CPU
    ``x`` runs :func:`dia_stencil_plain`."""
    if mode not in MODES:
        raise ValueError(f"dia_stencil: unknown mode {mode!r}")
    if x.device.type == "cpu":
        return dia_stencil_plain(offsets, mode, coef, diag, x, b=b, omega=omega)
    if x.device.type != "cuda":
        raise ValueError(f"dia_stencil: unsupported device {x.device}")
    return _launch(offsets, mode, coef, diag, x, b, omega)


# launches of the CUDA kernel, per mode (the plain version counts nothing)
dia_stencil.launches = {m: 0 for m in MODES}


def reset_launches() -> None:
    for m in MODES:
        dia_stencil.launches[m] = 0
