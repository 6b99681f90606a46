from .base import (SolverSetup, SolveResult,  # noqa: F401
                   explicit_residual_norm, preprocessing_device,
                   solve)
from .factory import make_method  # noqa: F401
