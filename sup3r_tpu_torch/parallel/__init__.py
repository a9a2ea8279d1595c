"""Meshes of ranks and their collectives (one process per device)."""

from sup3r_tpu_torch.parallel.mesh import (  # noqa: F401
    allreduce_bytes_from_compiled,
    get_mesh,
    get_mesh_2d,
    halo_bytes_from_compiled,
    init_multihost,
    replicate,
    shard_batch,
    shard_batch_spatial,
    shard_spatial,
)
