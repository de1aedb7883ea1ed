"""Raycasting: the CUDA kernel ``csrc/raycast.cu`` and its wrapper.

Replaces ``tsdf_tpu/kernels/raycast.py:raycast_pallas`` (the slab sweep)
together with the ``lane_gather_op`` calls inside it. The kernel marches
one ray per thread through the ``ops/raycast.py:march_rays`` contract in
its default sphere-traced mode (step scale 0.75, at most
``REFERENCE_MAX_STEPS`` samples), as ``raycast_pallas`` does; the plain
twin's fixed-step mode has no kernel. The normals stay plain PyTorch
(``compute_normals_from_vertices``).
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from ..ops.raycast import (
    REFERENCE_MAX_STEPS,
    compute_normals_from_vertices,
    raycast_vertices,
    vertices_to_depth_image,
)
from ..volume import TSDFVolume
from ._build import Kernel, check_same_device, check_tensor, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "tsdf_raycast",
    # tsdf, verts, params, sx, sy, sz, width, height, max_steps, stream
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


def kernel_params(vol: TSDFVolume, camera: Camera) -> torch.Tensor:
    """The kernel's 31 f32 parameters, assembled on the volume's device:
    K^-1 (9, row-major), camera->world rotation (9), ray origin (3),
    space min (3), space max (3), voxel size (3), truncation distance."""
    return torch.cat(
        [
            camera.k_inv.reshape(-1),
            camera.rotation.reshape(-1),
            camera.position,
            vol.space_min,
            vol.space_max,
            vol.voxel_size,
            vol.truncation_distance.reshape(1),
        ]
    ).contiguous()


def raycast_vertices_cuda(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    max_steps: int = REFERENCE_MAX_STEPS,
) -> torch.Tensor:
    """(H, W, 3) f32 surface points of ``vol`` seen from ``camera``, NaN
    on a miss; a ray stops after at most ``max_steps`` samples.

    On CUDA tensors this is the kernel; on CPU tensors it is the plain
    twin ``ops.raycast.raycast_vertices``.
    """
    dev = vol.tsdf.device
    check_same_device(dev, k_inv=camera.k_inv, pose=camera.pose)
    check_tensor("tsdf", vol.tsdf, torch.float32, ndim=3)
    if width <= 0 or height <= 0:
        raise ValueError(f"bad raycast size {width}x{height}")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    if dev.type == "cpu":
        return raycast_vertices(vol, camera, width, height,
                                max_steps=max_steps)

    params = kernel_params(vol, camera)
    verts = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    sz, sy, sx = vol.tsdf.shape
    with torch.cuda.device(dev):
        KERNEL(
            vol.tsdf.data_ptr(), verts.data_ptr(), params.data_ptr(),
            sx, sy, sz, width, height, max_steps,
            stream_handle(dev),
        )
    return verts


def raycast_cuda(
    vol: TSDFVolume, camera: Camera, width: int = 640, height: int = 480
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raycast ``vol`` from ``camera``: (vertices, normals), both
    (H, W, 3) f32, vertices NaN on a miss. The march is
    :func:`raycast_vertices_cuda`; the normals are plain PyTorch."""
    verts = raycast_vertices_cuda(vol, camera, width, height)
    return verts, compute_normals_from_vertices(verts)


def render_to_depth_image_cuda(
    vol: TSDFVolume, camera: Camera, width: int = 640, height: int = 480
) -> torch.Tensor:
    """(H, W) u16 depth image in mm (camera z) of ``vol`` seen from
    ``camera``: :func:`raycast_vertices_cuda`, then the tail of
    ``ops.raycast.render_to_depth_image``."""
    return vertices_to_depth_image(
        raycast_vertices_cuda(vol, camera, width, height), camera
    )
