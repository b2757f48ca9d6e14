from .connectivity import CRConnectivity
from .mesh import BoundaryMesh, Mesh, FaceGroup
from .metrics import MeshGeometry, compute_geometry
from .device import DeviceMesh, build_device_mesh, assemble_device_mesh
from . import generate
from .assemble import extract_region, merge_meshes
