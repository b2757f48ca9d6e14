"""Global configuration for fvm_tpu_torch: default dtype and device.

Counterpart of ``fvm_tpu/config.py``.  float64 stays the default
(correctness first; the golden histories are f64) and benchmarks opt into
float32.  The device is explicit: every entry point takes ``device=`` and
runs on ``"cuda"`` unless the caller asks for the CPU.  With no GPU and no
explicit CPU request, :func:`resolve_device` raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

import torch

from .exceptions import DeviceError

# Full-precision float32 matmuls: TF32/bf16 matmul inputs cost ~13-16
# mantissa bits, which diverged the AMG coarse correction of the coupled
# f32 flow+thermal step in the JAX package (fvm_tpu/config.py:24-31).  The
# hot path is the DIA stencil, not matmuls, so "highest" costs nothing.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "f32": torch.float32,
    "f64": torch.float64,
}


class Config:
    """Process-wide numeric configuration (default floating dtype)."""

    def __init__(self) -> None:
        self.dtype = torch.float64

    def set_dtype(self, dtype) -> None:
        self.dtype = as_dtype(dtype)


config = Config()


def as_dtype(dtype=None) -> torch.dtype:
    """A floating torch dtype from a name or dtype; None is the default."""
    if dtype is None:
        return config.dtype
    if isinstance(dtype, str):
        dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype!r}")
    return dtype


def set_default_dtype(dtype) -> None:
    """Set the default floating dtype for subsequently built device state."""
    config.set_dtype(dtype)


def default_dtype():
    return config.dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless given.

    Raises DeviceError when CUDA is asked for (explicitly or by default)
    and no GPU is present; there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "fvm_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise DeviceError(f"unsupported device {dev}")
    return dev
