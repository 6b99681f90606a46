"""Row-sharded solves over a 1-D device mesh (the JAX package's
parallel/): `Mesh` and `make_mesh`, `shard_setup` (the shard_map mode, the
hand-written kernels run per shard with halo exchange), and the standalone
distributed CG (`make_sharded_cg`)."""
from .sharded import (  # noqa: F401
    AXIS, Mesh, make_mesh, make_sharded_cg, shard_dia, shard_setup,
    shard_vector, sharded_spmv_dia,
)
