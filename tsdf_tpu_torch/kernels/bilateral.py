"""Bilateral depth filter: the CUDA kernel ``csrc/bilateral.cu`` and its
wrapper.

Replaces ``tsdf_tpu/kernels/bilateral.py:bilateral_filter_pallas``. The
kernel computes the ``ops/bilateral.py`` contract tap for tap over a
shared-memory tile with a halo of the filter radius; a thread filters a
vertical strip of ``ROWS`` pixels. The radii the paths use are compiled
instances (``COMPILED_RADII``: unrolled taps); any other radius, and a
range constant of 0, runs the kernel's runtime-radius instance.
:func:`launch_plan` is the host's choice of instance, grid and shared
memory, in plain Python. The (2r+1)^2 spatial weights are computed on the
host in double and handed to the kernel as a float32 array on the card
(:func:`weight_block`); the last few (sigma_space, device) pairs are kept,
so that a frame loop uploads them once.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
    # tile_h, shared_bytes, stream, rows, instance
    [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P, _I, _I],
)

# The block is 32x8 threads, and each thread filters 2 rows: a tile of
# 32x16 pixels, so 640x480 gives 600 blocks (csrc/bilateral.cu: BX, BY, K).
TILE_W, TILE_H, ROWS = 32, 8, 2
# Radii compiled with unrolled taps: the default sigma_space 3.0 and 1.7.
COMPILED_RADII = (5, 3)
# What a block may take once it opts in to more dynamic shared memory
# (sm_90: 227 KB).
MAX_SHARED_BYTES = 232448

_DTYPES = (torch.float32, torch.uint16)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of the kernel: ``instance`` is the compiled radius that
    runs, or 0 for the runtime-radius kernel (which also takes a range
    constant of 0: ``csrc/bilateral.cu`` says why); ``block`` is (x, y)
    threads, each filtering ``rows`` pixels of a column; ``grid`` is (x, y)
    blocks; ``shared_bytes`` is a block's dynamic shared memory."""

    radius: int
    instance: int
    block: tuple[int, int]
    rows: int
    grid: tuple[int, int]
    shared_bytes: int


def shared_bytes(radius: int) -> int:
    """Shared memory of one block: the tile with its halo, then the
    spatial weights, float32 each."""
    side = 2 * radius + 1
    return 4 * (
        (TILE_W + 2 * radius) * (TILE_H * ROWS + 2 * radius) + side * side
    )


def launch_plan(
    radius: int, height: int, width: int, range_c: float = 1.0
) -> LaunchPlan:
    """The launch for a (height, width) image at ``radius`` and range
    constant ``range_c``. Raises ValueError when the tile, its halo and the
    weights exceed a block's shared memory."""
    need = shared_bytes(radius)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"radius {radius}: the tile, its halo and the weights take "
            f"{need} bytes of shared memory, more than {MAX_SHARED_BYTES}"
        )
    pixels_h = TILE_H * ROWS
    return LaunchPlan(
        radius=radius,
        instance=radius if radius in COMPILED_RADII and range_c > 0 else 0,
        block=(TILE_W, TILE_H),
        rows=ROWS,
        grid=(-(-width // TILE_W), -(-height // pixels_h)),
        shared_bytes=need,
    )


@functools.lru_cache(maxsize=8)
def weight_block(sigma_space: float, dev: torch.device) -> torch.Tensor:
    """The kernel's (2r+1)^2 spatial weights on ``dev``, float32, dy outer
    and dx inner."""
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
    h, w = depth.shape
    range_c = _F(range_constant(sigma_colour)).value  # what the kernel gets
    plan = launch_plan(filter_radius(sigma_space), h, w, range_c)
    out = torch.empty_like(depth)
    if out.numel() == 0:
        return out
    weights = weight_block(float(sigma_space), dev)
    with torch.cuda.device(dev):
        KERNEL(
            depth.data_ptr(), out.data_ptr(), weights.data_ptr(),
            h, w, plan.radius, range_c, int(depth.dtype == torch.uint16),
            *plan.block, plan.shared_bytes, stream_handle(dev), plan.rows,
            plan.instance,
        )
    return out
