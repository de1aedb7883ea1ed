"""Pose tracking: projective point-to-plane ICP (port of
``tsdf_tpu/tracking``)."""

from .icp import (
    ICPResult,
    depth_pyramid,
    get_incremental_transformation,
    icp_step,
    normal_map_planes,
    vertex_map_planes,
)

__all__ = [
    "ICPResult",
    "depth_pyramid",
    "vertex_map_planes",
    "normal_map_planes",
    "icp_step",
    "get_incremental_transformation",
]
