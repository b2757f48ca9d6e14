from .connectivity import CRConnectivity
from .mesh import Mesh, FaceGroup
from .metrics import MeshGeometry, compute_geometry
from .device import DeviceMesh, build_device_mesh, assemble_device_mesh
from . import generate
