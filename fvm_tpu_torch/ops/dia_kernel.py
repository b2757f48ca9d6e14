"""The fused DIA stencil: a hand-written CUDA kernel and its plain version.

Replaces the JAX package's only TPU kernel, ``_dia_kernel`` launched by
``_dia_apply_packed`` (``fvm_tpu/ops/pallas_kernels.py:125-232``,
``pl.pallas_call`` at line 218).  It computes, for a static set of signed
offsets d (D <= 16),

    Ax[i] = diag[i] * x[i] + sum_d coef[d, i] * x[i + d]     (x = 0 outside [0, n))

in three fused modes: ``mv`` y = Ax, ``residual`` y = b - Ax and ``jacobi``
y = x + omega (b - Ax) / diag, on x, b of shape (n,) or (n, m), m <= 3,
row-major (the port's public layout: no transpose, unlike the Pallas
wrapper's (m, n)), in float32, float64 (Hopper has native f64) or
bfloat16 (``AMG(precision="bf16")``).

bfloat16 rounds in one place: the operands are read as bfloat16, every
product and sum is taken in float32 in the float32 order, and the result
is rounded to bfloat16 once, on the store.  The plain version does the
same (float32 arithmetic on the widened operands, one rounding at the
end), so kernel and plain version agree bit for bit in bfloat16 too.

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
there the two variants are the same code under two names.  bfloat16 has
one variant, ``narrow`` (``csrc/dia_stencil_bf16.cu``, one row per
thread), at every n.

Operand layout: ``coef`` is the (D, n) view ``storage[:, :n]`` of a
(D, ld) storage whose row stride ld is a multiple of ``COEF_ALIGN``
elements (``empty_coef``, ``pack_coef``), as the Pallas ``pack`` pads, so
every coefficient row starts 16-byte aligned; ``diag`` is contiguous and
16-byte aligned.  x, b and y may lie at any base address.

Dispatch is by the tensor's device: a CUDA tensor launches a kernel (or
raises), a CPU tensor takes the plain version.  There is no other switch.

Derivatives (the sensitivities, ``models/sensitivity.py``): torch
differentiates the plain version of a CPU tensor.  A CUDA ``mv`` or
``residual`` whose derivative may be asked goes through ``DiaStencil``,
whose rules launch the kernel again: the jvp on the tangent's diagonal
and coefficients and on dx, the backward on the transposed operator
(``transpose_coef``: offsets negated, rows shifted); ``jacobi`` runs
only inside solves, which are differentiated implicitly
(``linear/base.solve_fn_implicit``), and raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading

import torch
import torch.autograd.forward_ad as fwAD
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
SOURCE_BF16 = os.path.join(_PKG_DIR, "csrc", "dia_stencil_bf16.cu")
_VARIANT_FLAGS = {"narrow": ["-DDIA_NARROW"], "wide": []}
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# -fmad=false: no FMA contraction, so the kernel rounds like the plain
# version and the two agree bit for bit
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_DTYPES = {torch.float32: ("f32", []), torch.float64: ("f64", ["-DDIA_F64"]),
           torch.bfloat16: ("bf16", ["-DDIA_BF16"])}
# the (variant, dtype) libraries built, and the source of each
_BUILDS = {(v, dt): SOURCE for v in VARIANTS
           for dt in (torch.float32, torch.float64)}
_BUILDS["narrow", torch.bfloat16] = SOURCE_BF16
_MODE_INDEX = {m: i for i, m in enumerate(MODES)}


def coef_ld(n: int) -> int:
    """Row stride of the coefficient storage for n rows."""
    return -(-max(n, 1) // COEF_ALIGN) * COEF_ALIGN


def empty_coef(D: int, n: int, dtype, device) -> torch.Tensor:
    """An uninitialised (D, n) coefficient operand in the kernel's layout."""
    return torch.empty((D, coef_ld(n)), dtype=dtype, device=device)[:, :n]


def pack_coef(coef: torch.Tensor) -> torch.Tensor:
    """``coef`` (D, n) copied into the kernel's layout."""
    return cast_coef(coef, coef.dtype)


def cast_coef(coef: torch.Tensor, dtype) -> torch.Tensor:
    """``coef`` (D, n) converted to ``dtype`` in the kernel's layout."""
    out = empty_coef(coef.shape[0], coef.shape[1], dtype, coef.device)
    return out.copy_(coef)


def variants(dtype) -> tuple:
    """The variants built for an element type."""
    return tuple(v for v in VARIANTS if (v, dtype) in _BUILDS)


def dispatch(n: int, dtype) -> str:
    """The variant a call on n rows takes: by n alone, but bfloat16 has
    only ``narrow``."""
    if n >= WIDE_MIN_ROWS and ("wide", dtype) in _BUILDS:
        return "wide"
    return "narrow"


def coef_packed(coef: torch.Tensor) -> bool:
    """Whether a (D, n) tensor is in the kernel's layout: unit column
    stride, row stride a multiple of ``COEF_ALIGN`` and at least n, a
    16-byte aligned base."""
    return (coef.ndim == 2 and coef.stride(1) == 1
            and coef.stride(0) % COEF_ALIGN == 0
            and coef.stride(0) >= coef.shape[1]
            and _aligned(coef))


def diag_ready(diag: torch.Tensor) -> bool:
    """Whether ``diag`` is contiguous with a 16-byte aligned base."""
    return diag.is_contiguous() and _aligned(diag)


def _aligned(t: torch.Tensor) -> bool:
    """Whether the base is 16-byte aligned; False for a ``torch.func``
    wrapper, which has no storage of its own (the Function that takes it
    brings the unwrapped tensor to the layout)."""
    try:
        return t.data_ptr() % 16 == 0
    except RuntimeError:
        return False


def dia_stencil_plain(offsets, mode, coef, diag, x, b=None, omega=None):
    """Plain PyTorch version: zero-padded shifts (``F.pad`` + slices), the
    same accumulation order as the kernel and as the JAX roll formula
    (diag term first, then the offsets in order).  bfloat16 operands are
    widened to float32 and the result rounded once (module docstring)."""
    if x.dtype == torch.bfloat16:
        f = torch.float32
        return dia_stencil_plain(
            offsets, mode, coef.to(f), diag.to(f), x.to(f),
            b=None if b is None else b.to(f), omega=omega).to(x.dtype)
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
    """Compile the two variants in float32 and float64 and the bfloat16
    one with nvcc into ``build/kernels`` (on first use, from the
    repository's sources only; the five compilations run in parallel) and
    load them.  Returns the entry points keyed by (variant, dtype).  With
    ``verbose`` one ptxas summary line per library is printed."""
    global _fns
    with _lib_lock:
        if _fns is not None:
            return _fns
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        jobs = []
        for (variant, dtype), source in _BUILDS.items():
            suffix, defs = _DTYPES[dtype]
            so = os.path.join(BUILD_DIR, f"libdia_{variant}_{suffix}.so")
            # build under a private name, then rename: a process that
            # loads the library never sees another's half-written file
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *_NVCC_FLAGS, *_VARIANT_FLAGS[variant], *defs,
                   "-Xptxas", "-v", "-o", tmp, source]
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
        variant = dispatch(n, x.dtype)
    elif (variant, x.dtype) not in _BUILDS:
        raise ValueError(f"dia_stencil: no {variant} variant for {x.dtype}")
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
    key = (_DTYPES[x.dtype][0], variant, mode, n, D)
    dia_stencil.shapes[key] = dia_stencil.shapes.get(key, 0) + 1
    if _scopes:
        key = (_scopes[-1], mode)
        dia_stencil.scoped[key] = dia_stencil.scoped.get(key, 0) + 1
    return y


_scopes: list = []


@contextlib.contextmanager
def launch_scope(name: str):
    """Count the launches made inside the block also under
    ``dia_stencil.scoped[(name, mode)]`` (the innermost scope): which part
    of a computation launched them, e.g. a tangent's dA x products and an
    adjoint's transposed solves (``linear/base.py``)."""
    _scopes.append(name)
    try:
        yield
    finally:
        _scopes.pop()


def dia_stencil(offsets, mode, coef, diag, x, b=None, omega=None):
    """Fused DIA op on (n,) or (n, m) vectors; returns x's shape.

    ``coef`` (D, n) and ``diag`` (n,) are the matrix's prepared operands
    in the kernel's layout (``ELLMatrix.prepare``, ``DIAMatrix.prepare``).
    A CUDA ``x`` launches a CUDA kernel (raising on anything it does not
    take); a CPU ``x`` runs :func:`dia_stencil_plain`.

    Derivatives: on a CPU tensor torch differentiates the plain version.
    On a CUDA tensor whose derivative may be asked (``tracked``), ``mv``
    and ``residual`` go through :class:`DiaStencil`, whose forward- and
    reverse-mode rules launch the kernel again; ``jacobi`` runs only inside
    solves and raises there."""
    if mode not in _MODE_INDEX:
        raise ValueError(f"dia_stencil: unknown mode {mode!r}")
    if x.device.type == "cpu":
        return dia_stencil_plain(offsets, mode, coef, diag, x, b=b, omega=omega)
    if x.device.type != "cuda":
        raise ValueError(f"dia_stencil: unsupported device {x.device}")
    if tracked(coef, diag, x, b):
        if mode == "jacobi":
            raise RuntimeError(
                "dia_stencil: mode 'jacobi' has no derivative (it runs only "
                "inside solves, which are differentiated implicitly)")
        return DiaStencil.apply(coef, diag, x, b, tuple(offsets), mode)
    return _launch(offsets, mode, coef, diag, x, b, omega)


def tracked(*tensors) -> bool:
    """Whether a derivative may be asked of an op on these operands:
    reverse mode (grad enabled and an operand requiring it), a forward-mode
    dual level, or a ``torch.func`` transform active; never inside
    ``untracked``."""
    if _untracked:
        return False
    if fwAD._current_level >= 0 or _transforms_active():
        return True
    if torch.is_grad_enabled():
        for t in tensors:
            if t is not None and t.requires_grad:
                return True
    return False


_transforms_active = torch._C._are_functorch_transforms_active
_untracked: list = []


@contextlib.contextmanager
def untracked():
    """Inside, ``tracked`` is False: the forward of an autograd Function,
    whose operands are plain tensors and whose derivative is the Function's
    own rule (some torch versions report a ``torch.func`` transform as
    active there)."""
    _untracked.append(True)
    try:
        yield
    finally:
        _untracked.pop()


def transpose_coef(offsets, coef):
    """The DIA coefficients of A^T: (offsets, coef) with the offsets
    negated and sorted, and each coefficient row shifted, zero-filled, in
    the kernel's layout.  (A^T)[i, i - d] = A[i - d, i] = coef_d[i - d]."""
    n = coef.shape[1]
    order = sorted(range(len(offsets)), key=lambda j: -int(offsets[j]))
    out = empty_coef(len(order), n, coef.dtype, coef.device)
    out.zero_()
    for row, j in enumerate(order):
        d = int(offsets[j])
        if 0 <= d < n:
            out[row, d:] = coef[j, : n - d]
        elif -n < d < 0:
            out[row, : n + d] = coef[j, -d:]
    return tuple(-int(offsets[j]) for j in order), out


def stencil_jvp(call, offsets, mode, coef, diag, x, dcoef, ddiag, dx, db):
    """Forward-mode rule of the ``mv`` / ``residual`` op: d(Ax) = dA x +
    A dx, two calls ``call(offsets, mode, coef, diag, x, b)`` of the op
    (the kernel's, or the plain version's in the tests): one on the
    tangent's diagonal and coefficients, one on dx.  ``residual`` is
    d(b - Ax) = (db - A dx) - dA x.  Absent tangents (None) are zero."""
    dax = None
    if dcoef is not None or ddiag is not None:
        dax = call(offsets, "mv",
                   torch.zeros_like(coef) if dcoef is None else dcoef,
                   torch.zeros_like(diag) if ddiag is None else ddiag,
                   x, None)
    if mode == "mv":
        out = None if dx is None else call(offsets, "mv", coef, diag, dx,
                                            None)
    elif dx is None:
        out = db
    else:
        out = call(offsets, "residual", coef, diag, dx,
                   torch.zeros_like(x) if db is None else db)
    if dax is not None:
        out = (dax if mode == "mv" else -dax) if out is None else (
            out + dax if mode == "mv" else out - dax)
    return torch.zeros_like(x) if out is None else out


def stencil_vjp(call, offsets, mode, coef, diag, x, gy, need):
    """Reverse-mode rule of the ``mv`` / ``residual`` op for the inputs
    (coef, diag, x, b) flagged in ``need``: x-bar = A^T y-bar is one call
    of the op on the transposed operator (``transpose_coef``); diag-bar =
    y-bar * x and coef-bar[d, i] = y-bar[i] x[i + d] (0 outside [0, n))
    are elementwise, as the JAX package computes them in XLA outside its
    Pallas kernel; ``residual`` negates them and gives b-bar = y-bar."""
    neg = mode == "residual"
    gc = gd = gx = gb = None
    if need[2]:
        t_offs, t_coef = transpose_coef(offsets, coef)
        gx = call(t_offs, "mv", t_coef, diag, gy, None)
        gx = -gx if neg else gx
    if need[1]:
        gd = gy * x if x.ndim == 1 else (gy * x).sum(dim=1)
        gd = -gd if neg else gd
    if need[0]:
        n = x.shape[0]
        maxd = max((abs(int(d)) for d in offsets), default=0)
        xp = F.pad(x, (maxd, maxd) if x.ndim == 1 else (0, 0, maxd, maxd))
        rows = [gy * xp[maxd + int(d): maxd + int(d) + n] for d in offsets]
        gc = torch.stack([r if x.ndim == 1 else r.sum(dim=1) for r in rows])
        gc = -gc if neg else gc
    if need[3] and neg:
        gb = gy
    return gc, gd, gx, gb


def stencil_function(apply):
    """An autograd Function of the ``mv`` / ``residual`` op whose forward
    calls ``apply(offsets, mode, coef, diag, x, b, omega)`` on operands
    brought to the kernel's layout, and whose derivative rules call the
    Function again (under ``torch.func`` the rules see wrapped tensors,
    which only a Function's forward unwraps).  ``DiaStencil`` is the one
    over the kernel; the tests build one over the plain version to hold
    the rules on the CPU."""

    class _Stencil(torch.autograd.Function):
        @staticmethod
        def forward(coef, diag, x, b, offsets, mode):
            if not coef_packed(coef):
                coef = pack_coef(coef)
            if not diag_ready(diag):
                diag = diag.clone(memory_format=torch.contiguous_format)
            with untracked():
                return apply(offsets, mode, coef, diag, x.contiguous(),
                             None if b is None else b.contiguous(), None)

        @staticmethod
        def setup_context(ctx, inputs, output):
            coef, diag, x, _, offsets, mode = inputs
            ctx.offsets, ctx.mode = offsets, mode
            ctx.save_for_forward(coef, diag, x)
            ctx.save_for_backward(coef, diag, x)

        @staticmethod
        def jvp(ctx, dcoef, ddiag, dx, db, *_):
            coef, diag, x = ctx.saved_tensors
            with launch_scope("stencil jvp"):
                return stencil_jvp(_call, ctx.offsets, ctx.mode, coef, diag,
                                   x, dcoef, ddiag, dx, db)

        @staticmethod
        def backward(ctx, gy):
            coef, diag, x = ctx.saved_tensors
            with launch_scope("stencil vjp"):
                grads = stencil_vjp(_call, ctx.offsets, ctx.mode, coef, diag,
                                    x, gy, ctx.needs_input_grad[:4])
            return (*grads, None, None)

    def _call(offsets, mode, coef, diag, x, b):
        return _Stencil.apply(coef, diag, x, b, offsets, mode)

    return _Stencil


def _kernel_apply(offsets, mode, coef, diag, x, b, omega):
    if x.device.type != "cuda":
        raise ValueError(f"dia_stencil: the kernel's derivative needs a "
                         f"CUDA tensor, got {x.device}")
    return _launch(offsets, mode, coef, diag, x, b, omega)


# the op with derivative rules, over the kernel (CUDA tensors only: it
# launches the kernel or raises, never the plain version)
DiaStencil = stencil_function(_kernel_apply)


# launches of the CUDA kernels per mode and per (element type "f32" /
# "f64" / "bf16", variant, mode, rows, number of offsets D): the second
# shows which variant took each level, and its D tells the ILU triangular
# sweeps (D 2, linear/ilu.py) from the matrix products at the same rows
# (the plain version counts nothing)
dia_stencil.launches = {m: 0 for m in MODES}
dia_stencil.shapes = {}
dia_stencil.scoped = {}


def variant_launches() -> dict:
    """Launches per variant since the last reset."""
    out = {v: 0 for v in VARIANTS}
    for (_, variant, _, _, _), count in dia_stencil.shapes.items():
        out[variant] += count
    return out


def type_tag(dtype) -> str:
    """The element type's tag in ``dia_stencil.shapes`` ("f32", ...)."""
    return _DTYPES[dtype][0]


def type_launches(dtype, shapes: dict | None = None) -> dict:
    """Launches per mode of one element type in ``shapes`` (a dict keyed
    as ``dia_stencil.shapes``; default the live counter)."""
    out = {m: 0 for m in MODES}
    for (tag, _, mode, _, _), count in (
            dia_stencil.shapes if shapes is None else shapes).items():
        if tag == type_tag(dtype):
            out[mode] += count
    return out


def reset_launches() -> None:
    for m in MODES:
        dia_stencil.launches[m] = 0
    dia_stencil.shapes.clear()
    dia_stencil.scoped.clear()
