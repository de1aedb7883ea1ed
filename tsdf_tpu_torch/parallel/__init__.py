"""Several cards: a ("b", "r") mesh of ranks, z-slab fusion, ray tiles.

Port of ``tsdf_tpu/parallel/``. One process per rank over
``torch.distributed``: NCCL between cards, gloo on the CPU or for several
ranks that share one card. Mesh axes, as in the JAX package:

  * ``"b"`` (bricks): the volume's z extent is cut into slabs, one a
    position on the axis; each rank integrates, marches, extracts the
    surface of, deforms and differentiates its own slab with the
    single-card kernels;
  * ``"r"`` (rays): image rows are tiled over this axis for the raycast,
    and over the whole mesh for the ICP residuals, whose sums are added
    over the mesh.
"""

from .mesh import make_mesh, replicated, volume_sharding
from .ops import (
    extract_surface_sharded,
    get_incremental_transformation_sharded,
    integrate_pose_sharded,
    integrate_sharded,
    merge_brick_soups,
    raycast_sharded,
    raycast_sharded_bricked,
    scenefusion_frame_sharded,
    shard_volume,
    track_and_fuse_frames_sharded,
    update_deformation_sharded,
)

__all__ = [
    "make_mesh",
    "volume_sharding",
    "replicated",
    "shard_volume",
    "integrate_pose_sharded",
    "integrate_sharded",
    "raycast_sharded",
    "raycast_sharded_bricked",
    "get_incremental_transformation_sharded",
    "track_and_fuse_frames_sharded",
    "extract_surface_sharded",
    "merge_brick_soups",
    "update_deformation_sharded",
    "scenefusion_frame_sharded",
]
