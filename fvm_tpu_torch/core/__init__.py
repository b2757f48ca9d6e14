from .options import FloatVarDict, BoundaryCondition, ModelOptions
