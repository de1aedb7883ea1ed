"""Several cards: a ("b", "r") mesh of ranks, z-slab fusion, ray tiles.

Port of ``tsdf_tpu/parallel/``, its rigid half (the sharded surface,
non-rigid and gradient paths are not ported yet). One process per rank
over ``torch.distributed``: NCCL between cards, gloo on the CPU or for
several ranks that share one card. Mesh axes, as in the JAX package:

  * ``"b"`` (bricks): the volume's z extent is cut into slabs, one a
    position on the axis; each rank integrates and marches its own slab
    with the single-card kernels;
  * ``"r"`` (rays): image rows are tiled over this axis for the raycast,
    and over the whole mesh for the ICP residuals, whose sums are added
    over the mesh.
"""

from .mesh import make_mesh, replicated, volume_sharding
from .ops import (
    get_incremental_transformation_sharded,
    integrate_sharded,
    raycast_sharded,
    raycast_sharded_bricked,
    shard_volume,
    track_and_fuse_frames_sharded,
)

__all__ = [
    "make_mesh",
    "volume_sharding",
    "replicated",
    "shard_volume",
    "integrate_sharded",
    "raycast_sharded",
    "raycast_sharded_bricked",
    "get_incremental_transformation_sharded",
    "track_and_fuse_frames_sharded",
]
