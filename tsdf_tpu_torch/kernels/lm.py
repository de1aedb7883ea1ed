"""The Levenberg-Marquardt linearisation: the CUDA kernel
``csrc/lm_linearise.cu`` and its wrapper.

Replaces no TPU kernel: the JAX package leaves config 4's Jacobian to
``jax.jacfwd`` through the Newton correction, which XLA fuses. In one
counted launch (two on the stream: the rays, then a one-block sum of the
blocks' partials in a fixed order) the kernel takes every ray's
residual and row of the Jacobian and sums the normal equations;
``ops.lm_linearise.linearise`` is its plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from ..ops.lm_linearise import SUMS, linearise
from ..utils.profiling import count
from ..volume import TSDFVolume
from ._build import (
    Kernel,
    check_same_device,
    check_tensor,
    storage_dtype,
    stream_handle,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "tsdf_lm_linearise",
    # tsdf, t0, hit, target, xi, pose0, pose, pose_inv, k_inv, space_min,
    # voxel_size, out, rows, sx, sy, sz, width, height, band, stream
    [_P] * 13 + [_I] * 5 + [_F, _P],
)
# the bfloat16-storage instance (a volume of ``TSDFVolume.astype(bf16)``)
KERNEL_BF16 = Kernel("tsdf_lm_linearise_bf16", KERNEL.argtypes)
# rays a block of the kernel takes, and the float64 partials it writes
# after the SUMS
RAYS_PER_BLOCK = 1280
TERMS = 29


def lm_linearise(
    vol: TSDFVolume,
    camera: Camera,
    cam: Camera,
    xi: torch.Tensor,
    t0: torch.Tensor,
    hit: torch.Tensor,
    target: torch.Tensor,
    band_mm: float,
    rows: bool = False,
):
    """The normal equations of the banded depth residuals at the twist
    ``xi`` of ``camera``'s pose, as ``ops.lm_linearise.linearise`` defines
    them: (SUMS,) float64 (and with ``rows`` the (H*W, 8) float32 rows).
    ``cam`` is the camera at the twisted pose that marched ``t0`` and
    ``hit``.

    On CUDA tensors this is the kernel (its bf16 instance for a bfloat16
    tsdf), which adds one to the counter ``lm.linearised``; on CPU tensors
    it is the plain twin.
    """
    dev = vol.tsdf.device
    check_same_device(dev, t0=t0, hit=hit, target=target, xi=xi,
                      pose0=camera.pose, pose=cam.pose, pose_inv=cam.pose_inv,
                      k_inv=cam.k_inv)
    dtype = storage_dtype(vol.tsdf)
    check_tensor("tsdf", vol.tsdf, dtype, ndim=3)
    h, w = target.shape
    n = h * w
    target = target.to(torch.float32)
    check_tensor("t0", t0, torch.float32, shape=(n,))
    check_tensor("hit", hit, torch.bool, shape=(n,))
    if dev.type == "cpu":
        return linearise(vol, camera, cam, xi, t0, hit, target, band_mm, rows)
    if vol.tsdf.numel() >= 2**31:
        raise ValueError(
            f"tsdf: {vol.tsdf.numel()} voxels; the kernel indexes in 32 bits "
            "and takes fewer than 2**31")
    if n >= 2**31 - RAYS_PER_BLOCK:
        raise ValueError(f"{w}x{h} rays: the kernel counts rays in 32 bits")
    small = [t.to(torch.float32).contiguous() for t in (
        xi, camera.pose, cam.pose, cam.pose_inv, cam.k_inv, vol.space_min,
        vol.voxel_size)]
    for name, t, shape in zip(
            ("xi", "pose0", "pose", "pose_inv", "k_inv", "space_min", "voxel_size"),
            small, ((6,), (4, 4), (4, 4), (4, 4), (3, 3), (3,), (3,))):
        check_tensor(name, t, torch.float32, shape=shape)
    target = target.contiguous()
    out = torch.empty(SUMS + TERMS * -(-n // RAYS_PER_BLOCK), dtype=torch.float64,
                      device=dev)
    per_ray = (torch.empty((n, 8), dtype=torch.float32, device=dev)
               if rows else None)
    sz, sy, sx = vol.tsdf.shape
    kernel = KERNEL_BF16 if dtype == torch.bfloat16 else KERNEL
    with torch.cuda.device(dev):
        kernel(
            vol.tsdf.data_ptr(), t0.data_ptr(), hit.data_ptr(), target.data_ptr(),
            *(t.data_ptr() for t in small), out.data_ptr(),
            None if per_ray is None else per_ray.data_ptr(),
            sx, sy, sz, w, h, float(band_mm), stream_handle(dev),
        )
    count("lm.linearised")
    sums = out[:SUMS]
    return (sums, per_ray) if rows else sums
