"""Rigid TSDF integration: the CUDA kernel ``csrc/integrate.cu`` and its
wrapper.

Replaces ``tsdf_tpu/kernels/integrate.py:integrate_pallas`` (modes
"exact" and "line"). The kernel computes the ``ops/integrate.py``
contract exactly: one thread per voxel reads its pixel directly, so no
voxel is skipped and there is no miss count to return.
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from ..ops.integrate import integrate as integrate_plain
from ..volume import TSDFVolume
from ._build import Kernel, check_same_device, check_tensor, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "tsdf_integrate",
    # tsdf, weight, depth, params, sx, sy, sz, width, height, cap, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


def kernel_params(vol: TSDFVolume, camera: Camera) -> torch.Tensor:
    """The kernel's 24 f32 parameters, assembled on the volume's device:
    pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3), voxel size (3),
    truncation distance, max weight."""
    k = camera.k
    return torch.cat(
        [
            camera.pose_inv[0:3, :].reshape(-1),
            torch.stack([k[0, 0], k[1, 1], k[0, 2], k[1, 2]]),
            vol.offset,
            vol.voxel_size,
            vol.truncation_distance.reshape(1),
            vol.max_weight.reshape(1),
        ]
    ).contiguous()


def integrate_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
) -> TSDFVolume:
    """Fuse one depth frame into ``vol``, updating ``vol.tsdf`` and
    ``vol.weight`` IN PLACE (at 512^3 a functional update would copy
    1 GiB per frame); returns ``vol``.

    On CUDA tensors this launches the kernel; on CPU tensors it runs the
    plain twin ``ops.integrate.integrate`` and copies its result back.

    Args:
      vol: float32 volume, tsdf/weight contiguous (Z, Y, X).
      depth: (H, W) float32 depth in mm, contiguous; 0 means no data.
      camera: the frame's camera, on the volume's device.
      cap_weight: clamp the accumulated weight at vol.max_weight.
    """
    dev = vol.tsdf.device
    check_same_device(
        dev, weight=vol.weight, depth=depth, pose_inv=camera.pose_inv
    )
    shape = tuple(vol.tsdf.shape)
    check_tensor("tsdf", vol.tsdf, torch.float32, ndim=3)
    check_tensor("weight", vol.weight, torch.float32, shape=shape)
    check_tensor("depth", depth, torch.float32, ndim=2)
    if vol.deform is not None:
        raise NotImplementedError(
            "integrating into a deformed volume is not ported yet "
            "(ROADMAP.md: integrate_warped_pallas)"
        )
    if dev.type == "cpu":
        out = integrate_plain(vol, depth, camera, cap_weight=cap_weight)
        vol.tsdf.copy_(out.tsdf)
        vol.weight.copy_(out.weight)
        return vol

    params = kernel_params(vol, camera)
    sz, sy, sx = shape
    h, w = depth.shape
    with torch.cuda.device(dev):
        KERNEL(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), depth.data_ptr(),
            params.data_ptr(), sx, sy, sz, w, h, int(bool(cap_weight)),
            stream_handle(dev),
        )
    return vol
