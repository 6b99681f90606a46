from .base import (SolverSetup, SolveResult,  # noqa: F401
                   explicit_residual_norm, preprocessing,
                   preprocessing_device, residual_f64,
                   solve)
from .factory import make_method  # noqa: F401
