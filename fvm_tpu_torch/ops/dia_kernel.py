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

Two hand-written variants of one source (``csrc/dia_stencil.cu``; the
design notes and measurements are in the source), chosen by n alone with
one compare (``WIDE_MIN_ROWS``):

- ``wide`` for the large levels, bound by HBM bytes: several consecutive
  rows per thread with 16-byte loads and stores, every load of a thread's
  rows issued before the first product (the offset loop unrolled at
  compile time);
- ``narrow`` for the small levels, bound by latency: one row per thread,
  the same unrolled, all-loads-first form.

For m >= 2 right-hand sides ``wide`` also takes one row per thread, so
there the two variants are the same code under two names.

Operand layout: ``coef`` is the (D, n) view ``storage[:, :n]`` of a
(D, ld) storage whose row stride ld is a multiple of ``COEF_ALIGN``
elements (``empty_coef``, ``pack_coef``), as the Pallas ``pack`` pads, so
every coefficient row starts 16-byte aligned; ``diag`` is contiguous and
16-byte aligned.  x, b and y may lie at any base address.

Dispatch is by the tensor's device: a CUDA tensor launches a kernel (or
raises), a CPU tensor takes the plain version.  There is no other switch.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

MODES = ("mv", "residual", "jacobi")
VARIANTS = ("narrow", "wide")
MAX_OFFSETS = 16
MAX_RHS = 3
# coefficient row stride granule in elements (128 B in float32)
COEF_ALIGN = 32
# levels with at least this many rows take the wide variant (measured
# crossover on the 1024^2 cavity's hierarchy: 131072 rows narrow, 262144
# wide; PERF.md)
WIDE_MIN_ROWS = 1 << 18

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "dia_stencil.cu")
_VARIANT_FLAGS = {"narrow": ["-DDIA_NARROW"], "wide": []}
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# -fmad=false: no FMA contraction, so the kernel rounds like the plain
# version and the two agree bit for bit
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_DTYPES = {torch.float32: ("f32", []), torch.float64: ("f64", ["-DDIA_F64"])}
_MODE_INDEX = {m: i for i, m in enumerate(MODES)}


def coef_ld(n: int) -> int:
    """Row stride of the coefficient storage for n rows."""
    return -(-max(n, 1) // COEF_ALIGN) * COEF_ALIGN


def empty_coef(D: int, n: int, dtype, device) -> torch.Tensor:
    """An uninitialised (D, n) coefficient operand in the kernel's layout."""
    return torch.empty((D, coef_ld(n)), dtype=dtype, device=device)[:, :n]


def pack_coef(coef: torch.Tensor) -> torch.Tensor:
    """``coef`` (D, n) copied into the kernel's layout."""
    out = empty_coef(coef.shape[0], coef.shape[1], coef.dtype, coef.device)
    return out.copy_(coef)


def coef_packed(coef: torch.Tensor) -> bool:
    """Whether a (D, n) tensor is in the kernel's layout: unit column
    stride, row stride a multiple of ``COEF_ALIGN`` and at least n, a
    16-byte aligned base."""
    return (coef.ndim == 2 and coef.stride(1) == 1
            and coef.stride(0) % COEF_ALIGN == 0
            and coef.stride(0) >= coef.shape[1]
            and coef.data_ptr() % 16 == 0)


def diag_ready(diag: torch.Tensor) -> bool:
    """Whether ``diag`` is contiguous with a 16-byte aligned base."""
    return diag.is_contiguous() and diag.data_ptr() % 16 == 0


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


_fns = None
_lib_lock = threading.Lock()
_C_OFFSETS = {}


def _c_offsets(offsets):
    """(C int array of the offsets, D), made once per offsets tuple."""
    spec = _C_OFFSETS.get(offsets)
    if spec is None:
        offs = tuple(int(d) for d in offsets)
        spec = ((ctypes.c_int * max(len(offs), 1))(*offs), len(offs))
        _C_OFFSETS[offsets] = spec
    return spec


def _bind(so: str, name: str):
    """The C entry point ``name`` of the library ``so``, with its
    argument types."""
    fn = getattr(ctypes.CDLL(so), name)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,  # coef ld
        ctypes.c_void_p, ctypes.c_void_p,  # diag x
        ctypes.c_void_p, ctypes.c_void_p,  # b y
        ctypes.c_longlong, ctypes.c_int,  # n m
        ctypes.c_void_p, ctypes.c_int,  # host offsets, D
        ctypes.c_int, ctypes.c_double,  # mode omega
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def ptxas_summary(report: str) -> str:
    """One line from a ptxas ``-v`` report: kernels, registers per thread
    (range) and the largest spill."""
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", report)]
    spill = [int(v) for v in re.findall(r"(\d+) bytes spill stores", report)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"largest spill {max(spill, default=0)} bytes")


def build(verbose: bool = False) -> dict:
    """Compile the two variants, once per element type, with nvcc into
    ``build/kernels`` (on first use, from the repository's sources only;
    the four compilations run in parallel) and load them.  Returns the
    entry points keyed by (variant, dtype).  With ``verbose`` one ptxas
    summary line per library is printed."""
    global _fns
    with _lib_lock:
        if _fns is not None:
            return _fns
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        jobs = []
        for variant, vdefs in _VARIANT_FLAGS.items():
            for dtype, (suffix, defs) in _DTYPES.items():
                so = os.path.join(BUILD_DIR,
                                  f"libdia_{variant}_{suffix}.so")
                # build under a private name, then rename: a process that
                # loads the library never sees another's half-written file
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [nvcc, *_NVCC_FLAGS, *vdefs, *defs, "-Xptxas", "-v",
                       "-o", tmp, SOURCE]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                jobs.append((variant, dtype, suffix, so, tmp, proc))
        fns, failed, report = {}, [], []
        for variant, dtype, suffix, so, tmp, proc in jobs:
            out = proc.communicate()[0]
            report.append(f"{variant}/{suffix}: {ptxas_summary(out)}\n")
            if proc.returncode != 0:
                failed.append(f"{variant}/{suffix} ({proc.returncode}):\n"
                              f"{out}")
                continue
            os.replace(tmp, so)
            fns[variant, dtype] = _bind(so, f"dia_{variant}_{suffix}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        if verbose:
            print("".join(report), end="")
        _fns = fns
        return fns


def check_operands(offsets, mode, coef, diag, x, b=None, omega=None) -> int:
    """Raise ``ValueError`` on what the kernel does not take (a pure
    function of dtypes, devices, shapes, strides and base alignment);
    returns the number of right-hand sides m."""
    if mode not in _MODE_INDEX:
        raise ValueError(f"dia_stencil: unknown mode {mode!r}")
    dtype, device = x.dtype, x.device
    if dtype not in _DTYPES:
        raise ValueError(f"dia_stencil: unsupported dtype {dtype}")
    if x.ndim == 1:
        m = 1
    elif x.ndim == 2 and 1 <= x.shape[1] <= MAX_RHS:
        m = x.shape[1]
    else:
        raise ValueError(f"dia_stencil: x of shape {tuple(x.shape)} "
                         f"(need (n,) or (n, m), m <= {MAX_RHS})")
    n = x.shape[0]
    D = len(offsets)
    if D > MAX_OFFSETS:
        raise ValueError(f"dia_stencil: {D} offsets > {MAX_OFFSETS}")
    for name, t, shape in (("x", x, x.shape), ("coef", coef, (D, n)),
                           ("diag", diag, (n,)), ("b", b, x.shape)):
        if t is None:
            continue
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"dia_stencil: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {device}")
        if t.shape != shape:
            raise ValueError(f"dia_stencil: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous() or (b is not None and not b.is_contiguous()):
        raise ValueError("dia_stencil: x and b must be contiguous")
    if not coef_packed(coef):
        raise ValueError(
            f"dia_stencil: coef with strides {coef.stride()} at base "
            f"{coef.data_ptr() % 16} mod 16 is not in the kernel layout "
            f"(row stride a multiple of {COEF_ALIGN} elements, 16-byte "
            f"aligned base: pack_coef)")
    if not diag_ready(diag):
        raise ValueError("dia_stencil: diag must be contiguous with a "
                         "16-byte aligned base")
    if mode != "mv" and b is None:
        raise ValueError(f"dia_stencil: mode {mode!r} needs b")
    if mode == "jacobi" and omega is None:
        raise ValueError("dia_stencil: mode 'jacobi' needs omega")
    return m


def _launch(offsets, mode, coef, diag, x, b, omega, variant=None):
    """Launch one kernel.  ``variant`` None is the dispatch by n; a name
    forces that variant (to hold each against the plain version)."""
    m = check_operands(offsets, mode, coef, diag, x, b, omega)
    c_offs, D = _c_offsets(offsets)
    n = x.shape[0]
    if variant is None:
        variant = "wide" if n >= WIDE_MIN_ROWS else "narrow"
    fn = (_fns if _fns is not None else build())[variant, x.dtype]
    y = torch.empty_like(x)
    args = (coef.data_ptr(), coef.stride(0), diag.data_ptr(), x.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), n, m, c_offs,
            D, _MODE_INDEX[mode], 0.0 if omega is None else float(omega))
    idx = x.device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):  # launch on the operands' card
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"dia_stencil launch failed: CUDA error {err}")
    dia_stencil.launches[mode] += 1
    key = (variant, mode, n)
    dia_stencil.shapes[key] = dia_stencil.shapes.get(key, 0) + 1
    return y


def dia_stencil(offsets, mode, coef, diag, x, b=None, omega=None):
    """Fused DIA op on (n,) or (n, m) vectors; returns x's shape.

    ``coef`` (D, n) and ``diag`` (n,) are the matrix's prepared operands
    in the kernel's layout (``ELLMatrix.prepare``, ``DIAMatrix.prepare``).
    A CUDA ``x`` launches a CUDA kernel (raising on anything it does not
    take); a CPU ``x`` runs :func:`dia_stencil_plain`."""
    if mode not in _MODE_INDEX:
        raise ValueError(f"dia_stencil: unknown mode {mode!r}")
    if x.device.type == "cpu":
        return dia_stencil_plain(offsets, mode, coef, diag, x, b=b, omega=omega)
    if x.device.type != "cuda":
        raise ValueError(f"dia_stencil: unsupported device {x.device}")
    return _launch(offsets, mode, coef, diag, x, b, omega)


# launches of the CUDA kernels per mode, and per (variant, mode, rows): the
# second shows which variant took each level (the plain version counts
# nothing)
dia_stencil.launches = {m: 0 for m in MODES}
dia_stencil.shapes = {}


def variant_launches() -> dict:
    """Launches per variant since the last reset."""
    out = {v: 0 for v in VARIANTS}
    for (variant, _, _), count in dia_stencil.shapes.items():
        out[variant] += count
    return out


def reset_launches() -> None:
    for m in MODES:
        dia_stencil.launches[m] = 0
    dia_stencil.shapes.clear()
