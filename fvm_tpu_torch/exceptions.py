"""Error types (counterpart of ``fvm_tpu/exceptions.py``)."""


class FVMError(RuntimeError):
    """Base error for fvm_tpu_torch."""


class MeshError(FVMError):
    """Malformed or inconsistent mesh input."""


class SolverError(FVMError):
    """Linear or nonlinear solver failure (divergence, NaN residuals)."""


class ConfigError(FVMError):
    """Invalid model option / BC / VC configuration."""


class DeviceError(FVMError):
    """The requested device is unavailable or unsupported."""
