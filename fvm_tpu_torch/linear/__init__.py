from .base import LinearSolver, SolveStats, norm
from .krylov import BiCGStab, JacobiSolver
from .amg import AMG, DirectSolver
