"""Scale-out over several devices: the mesh and the sharded transform
step (counterpart of the JAX package's ``parallel/``)."""

from .pipeline import (  # noqa: F401
    Mesh,
    batch_bwt_encode,
    batch_st_encode,
    make_mesh,
    make_transform_step,
    shard,
    unshard,
)
