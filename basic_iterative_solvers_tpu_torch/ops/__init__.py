from .spmv import spmv, compute_residual  # noqa: F401
from .blas1 import (  # noqa: F401
    dot, euclidean_vec_norm, infty_vec_norm, subtract_vectors, sum_vectors,
    elemwise_mult_vectors, elemwise_div_vectors, scale,
)
