"""Raycasting: the CUDA kernel ``csrc/raycast.cu`` and its wrapper.

Replaces ``tsdf_tpu/kernels/raycast.py:raycast_pallas`` (the slab sweep)
together with the ``lane_gather_op`` calls inside it. The kernel marches
one ray per thread through the ``ops/raycast.py:march_rays`` contract in
its default sphere-traced mode (step scale 0.75, at most
``REFERENCE_MAX_STEPS`` samples), as ``raycast_pallas`` does; the plain
twin's fixed-step mode has no kernel. The root ``raycast`` and
``render_to_depth_image`` (``api.py``) call this wrapper and finish in plain
PyTorch (normals, depth image).

Inside its one counted launch the kernel first writes a table of the
volume's uniform bricks into scratch after its parameters; a sample in a
uniform brick takes the brick's value for its eight taps and reads no
voxel. ``uniform_bricks`` is that table in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from ..ops.raycast import REFERENCE_MAX_STEPS, raycast_vertices
from ..volume import TSDFVolume
from ._build import (
    Kernel,
    check_same_device,
    check_tensor,
    storage_dtype,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "tsdf_raycast",
    # tsdf, verts, params, sx, sy, sz, width, height, max_steps, stream,
    # row origin
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I],
)
# the bfloat16-storage instance (a volume of ``TSDFVolume.astype(bf16)``)
KERNEL_BF16 = Kernel("tsdf_raycast_bf16", KERNEL.argtypes)
# the edge, in voxels, of csrc/raycast.cu's uniform bricks
RAY_BRICK = 8


def kernel_params(
    vol: TSDFVolume, camera: Camera, scratch: int = 0, row0: int = 0
) -> torch.Tensor:
    """The kernel's 47 f32 parameters, assembled on the volume's device:
    K^-1 (9, row-major), camera->world rotation (9), ray origin (3),
    space min (3), space max (3), voxel size (3), truncation distance,
    world->camera rows 0-2 (12), fx, fy, cx, cy - row0; then ``scratch``
    words the kernel writes before it reads them (its tile counter and its
    brick table). The last four serve only the pre-pass's frustum test,
    which sees a tile of rows from ``row0`` as an image of its own."""
    k = camera.k
    parts = [
        camera.k_inv.reshape(-1),
        camera.rotation.reshape(-1),
        camera.position,
        vol.space_min,
        vol.space_max,
        vol.voxel_size,
        vol.truncation_distance.reshape(1),
        camera.pose_inv[0:3, :].reshape(-1),
        torch.stack([k[0, 0], k[1, 1], k[0, 2], k[1, 2] - row0]),
    ]
    if scratch:
        parts.append(torch.empty(scratch, dtype=torch.float32,
                                 device=vol.tsdf.device))
    return torch.cat(parts).contiguous()


def brick_table_shape(shape, brick: int = RAY_BRICK) -> tuple[int, int, int]:
    """The (z, y, x) count of ``brick``^3 bricks that cover a volume of
    ``shape`` (Z, Y, X), the last of each axis ragged."""
    return tuple(-(-n // brick) for n in shape)


def uniform_bricks(tsdf: torch.Tensor, brick: int = RAY_BRICK) -> torch.Tensor:
    """The brick table of ``csrc/raycast.cu``'s pre-pass, in plain
    PyTorch: a ``brick_table_shape`` f32 tensor holding, for each brick of
    ``brick``^3 voxels, the brick's value when every voxel of the brick and
    of a one-voxel apron on the high side of each axis (clamped at the
    volume's edge, as the sampler clamps its taps) is bitwise equal to the
    others, and NaN ("load") otherwise. A bfloat16 volume is compared on
    its 16-bit words and its value widened to float32.

    A trilinear sample whose lower corner lies in a brick reads only voxels
    of that closed box, so in a uniform brick its eight taps all equal the
    brick's value, bit for bit. A NaN voxel makes its brick NaN. The
    kernel also marks NaN, without reading them, the bricks no ray of the
    view can reach: a NaN entry only costs the loads.
    """
    dev = tsdf.device
    nb = brick_table_shape(tsdf.shape, brick)
    # voxel indices 0 .. n*brick, clamped to the last voxel: the apron of
    # the last brick of an axis, and the ragged part past the edge, repeat it
    idx = [torch.clamp(torch.arange(n * brick + 1, device=dev), max=s - 1)
           for n, s in zip(nb, tsdf.shape)]
    word = torch.int16 if tsdf.dtype == torch.bfloat16 else torch.int32
    bits = tsdf.contiguous().view(word)
    padded = bits[idx[0]][:, idx[1]][:, :, idx[2]]
    win = padded
    for axis in range(3):
        win = win.unfold(axis, brick + 1, brick)
    first = win[..., :1, :1, :1]
    uniform = (win == first).flatten(3).all(-1)
    value = first.reshape(nb).view(tsdf.dtype).to(torch.float32)
    return torch.where(uniform, value, float("nan"))


def raycast_vertices_cuda(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    max_steps: int = REFERENCE_MAX_STEPS,
    row0: int = 0,
) -> torch.Tensor:
    """(H, W, 3) f32 surface points of ``vol`` seen from ``camera``, NaN
    on a miss; a ray stops after at most ``max_steps`` samples. With
    ``row0`` the H rows are the image's rows row0 .. row0 + H - 1, each
    equal to the same row of a whole render bit for bit (a tile of a
    sharded render).

    On CUDA tensors this is the kernel (its bf16 instance for a bfloat16
    tsdf); on CPU tensors it is the plain twin
    ``ops.raycast.raycast_vertices``.
    """
    dev = vol.tsdf.device
    check_same_device(dev, k_inv=camera.k_inv, pose=camera.pose)
    dtype = storage_dtype(vol.tsdf)
    check_tensor("tsdf", vol.tsdf, dtype, ndim=3)
    if width <= 0 or height <= 0:
        raise ValueError(f"bad raycast size {width}x{height}")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if dev.type == "cpu":
        return raycast_vertices(vol, camera, width, height,
                                max_steps=max_steps, row0=row0)
    if vol.tsdf.numel() >= 2**31:
        raise ValueError(
            f"tsdf: {vol.tsdf.numel()} voxels; the kernel indexes in 32 bits "
            "and takes fewer than 2**31")

    # the scratch: the march's tile counter and the brick table
    nb = brick_table_shape(vol.tsdf.shape)
    params = kernel_params(vol, camera, scratch=1 + nb[0] * nb[1] * nb[2],
                           row0=row0)
    verts = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    sz, sy, sx = vol.tsdf.shape
    kernel = KERNEL_BF16 if dtype == torch.bfloat16 else KERNEL
    with torch.cuda.device(dev):
        kernel(
            vol.tsdf.data_ptr(), verts.data_ptr(), params.data_ptr(),
            sx, sy, sz, width, height, max_steps,
            stream_handle(dev), row0,
        )
    return verts

