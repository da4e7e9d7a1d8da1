"""Scale-out over several devices: the mesh, the sharded transform step
and the sample-sort ST step (counterpart of the JAX package's
``parallel/``); ``parallel.distributed`` stripes a file's blocks over
processes."""

from .pipeline import (  # noqa: F401
    Mesh,
    batch_bwt_encode,
    batch_st_encode,
    make_mesh,
    make_sharded_st_step,
    make_transform_step,
    shard,
    unshard,
)
