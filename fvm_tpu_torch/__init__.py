"""fvm_tpu_torch: the PyTorch/CUDA port of fvm_tpu.

A finite-volume multiphysics framework on unstructured meshes, running on
an NVIDIA GPU through PyTorch, with hand-written CUDA kernels where the
JAX package (``fvm_tpu``, the unchanged reference) used Pallas kernels.
The module tree and names mirror ``fvm_tpu``.  The port imports torch and
numpy, never jax and nothing of ``fvm_tpu``.

Every entry point runs on ``"cuda"`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises.

Quick start::

    import fvm_tpu_torch as fvm
    mesh = fvm.mesh.generate.quad_2d(32, 32)
    dmesh = fvm.mesh.build_device_mesh(mesh, device="cpu")
    thermal = fvm.models.ThermalModel(dmesh)
    thermal.bc['left'].bc_type = 'SpecifiedTemperature'
    thermal.bc['left']['specifiedTemperature'] = 400.0
    ...
    thermal.init()
    thermal.advance(10)
"""

from .config import config, set_default_dtype, default_dtype, resolve_device
from .exceptions import FVMError, MeshError, SolverError, ConfigError, DeviceError

from . import mesh
from . import ops
from . import linear
from . import models

__version__ = "0.1.0"
