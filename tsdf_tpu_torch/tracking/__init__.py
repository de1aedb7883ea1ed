"""Pose tracking: projective point-to-plane ICP (port of
``tsdf_tpu/tracking``)."""

from .icp import (
    ICPResult,
    depth_pyramid,
    get_incremental_transformation,
    icp_step,
    icp_step_banded,
    normal_map,
    normal_map_planes,
    vertex_map,
    vertex_map_planes,
)

__all__ = [
    "ICPResult",
    "depth_pyramid",
    "vertex_map",
    "normal_map",
    "vertex_map_planes",
    "normal_map_planes",
    "icp_step",
    "icp_step_banded",
    "get_incremental_transformation",
]
