"""Row-sharded solves over a 1-D device mesh (the JAX package's
parallel/): `Mesh` and `make_mesh` (the single-controller mesh of the
shard_map mode, over every CUDA card or n shards of one device) with its
row-sharded `MeshVector`, `make_device_mesh` (a torch.distributed
DeviceMesh, one process a shard, for the GSPMD mode), `shard_setup`
(either mode: the hand-written kernels run per shard with halo exchange),
the standalone distributed CG (`make_sharded_cg`) and the collective
censuses of both modes (parallel/census.py)."""
from .census import (  # noqa: F401
    COLLECTIVES, collective_census, fused_collective_census, mesh_census,
)
from .gspmd import HALO_COUNTS, make_device_mesh  # noqa: F401
from .mesh_vector import MeshVector, RowBlocks  # noqa: F401
from .sharded import (  # noqa: F401
    AXIS, Mesh, make_mesh, make_sharded_cg, shard_dia, shard_setup,
    shard_vector, sharded_spmv_dia,
)
