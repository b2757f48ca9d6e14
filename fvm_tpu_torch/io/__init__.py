"""Mesh import and result export (counterpart of ``fvm_tpu/io``): the
Fluent case reader, the VTK, Tecplot, Fluent-data, netCDF and
MatrixMarket writers, and checkpoints.  Host numpy; the writers take host
arrays or device tensors (a tensor is copied to the host once)."""

from .fluent import read_fluent_mesh, read_fluent_meshes
from .exporters import write_tecplot, write_fluent_data
from .vtk import write_vtk
from .matrixmarket import read_matrix_market, write_matrix_market
from .persistence import Persistence
from .netcdf import write_netcdf, read_netcdf
