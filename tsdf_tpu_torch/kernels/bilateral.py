"""Bilateral depth filter: the CUDA kernel ``csrc/bilateral.cu`` and its
wrapper.

Replaces ``tsdf_tpu/kernels/bilateral.py:bilateral_filter_pallas``. The
kernel computes the ``ops/bilateral.py`` contract tap for tap: one thread
per pixel over a shared-memory tile with a halo of the filter radius. The
(2r+1)^2 spatial weights are computed on the host in double and handed to
the kernel as a float32 array; the last few (sigma_space, device) pairs
stay on the card so that a frame loop uploads them once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.bilateral import (
    bilateral_filter,
    filter_radius,
    range_constant,
    spatial_weights,
)
from ._build import Kernel, check_tensor, stream_handle

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "tsdf_bilateral",
    # in, out, weights, height, width, radius, range_c, is_u16, tile_w,
    # tile_h, shared_bytes, stream
    [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P],
)

# One thread per pixel of a 32x8 tile: a warp reads one row of the tile.
TILE_W, TILE_H = 32, 8
# What a block may take without opting in to more dynamic shared memory.
MAX_SHARED_BYTES = 48 * 1024

_DTYPES = (torch.float32, torch.uint16)


def shared_bytes(radius: int) -> int:
    """Shared memory of one block: the tile with its halo, then the
    spatial weights, float32 each."""
    side = 2 * radius + 1
    return 4 * ((TILE_W + 2 * radius) * (TILE_H + 2 * radius) + side * side)


@functools.lru_cache(maxsize=8)
def _device_weights(sigma_space: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(
        spatial_weights(sigma_space), dtype=torch.float32, device=dev
    )


def bilateral_filter_cuda(
    depth: torch.Tensor,
    sigma_colour: float = 20.0,
    sigma_space: float = 3.0,
) -> torch.Tensor:
    """Filter a (H, W) depth image in mm (zero = no data); same dtype out.

    On a CUDA tensor (float32 or uint16, contiguous) this launches the
    kernel; on a CPU tensor it runs the plain twin
    ``ops.bilateral.bilateral_filter``. A ``sigma_space`` whose tile and
    halo exceed a block's shared memory raises ValueError.
    """
    if not isinstance(depth, torch.Tensor):
        raise TypeError(f"depth: expected a tensor, got {type(depth).__name__}")
    dev = depth.device
    if dev.type == "cpu":
        return bilateral_filter(depth, sigma_colour, sigma_space)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if depth.dtype not in _DTYPES:
        raise TypeError(f"depth: dtype {depth.dtype}, expected f32 or u16")
    check_tensor("depth", depth, depth.dtype, ndim=2)
    radius = filter_radius(sigma_space)
    need = shared_bytes(radius)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"sigma_space {sigma_space} gives radius {radius}: the tile and "
            f"its halo take {need} bytes of shared memory, more than "
            f"{MAX_SHARED_BYTES}"
        )
    out = torch.empty_like(depth)
    h, w = depth.shape
    if out.numel() == 0:
        return out
    weights = _device_weights(float(sigma_space), dev)
    with torch.cuda.device(dev):
        KERNEL(
            depth.data_ptr(), out.data_ptr(), weights.data_ptr(),
            h, w, radius, range_constant(sigma_colour),
            int(depth.dtype == torch.uint16), TILE_W, TILE_H, need,
            stream_handle(dev),
        )
    return out
