from .base import LinearSolver, SolveStats, norm
from .krylov import CG, GMRES, BiCGStab, JacobiSolver
from .amg import AMG, DirectSolver
