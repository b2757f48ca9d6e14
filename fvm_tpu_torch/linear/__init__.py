from .base import LinearSolver, SolveStats, norm
from .krylov import CG, GMRES, BiCGStab, JacobiSolver
from .amg import AMG, DirectSolver
from .ilu import ILU0Solver
from .spike import SpikeSolver
from .coupled import CoupledSIMPLE
from .anderson import Anderson
