from .ell import ELLMatrix
from .assembly import FaceFlux, assemble, cells_to_faces_distance_weighted
from .gradients import ls_gradient_coefficients, gradient
