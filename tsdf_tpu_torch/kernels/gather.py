"""Lane gather: the CUDA kernel ``csrc/gather.cu`` and its wrapper.

Replaces ``tsdf_tpu/kernels/gather.py:lane_gather_op``:
out[s, c] = table[s, idx[s, c]], and 0 where the index is outside
[0, W). The kernel moves 32-bit words, so float32 and int32 tables go
through it unchanged. A table whose rows are one row broadcast (row
stride 0, as ``expand`` gives) is read without being copied.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, check_same_device, check_tensor, stream_handle

_P, _L = ctypes.c_void_p, ctypes.c_longlong
KERNEL = Kernel(
    "tsdf_lane_gather",
    # table, idx, out, rows, cols, width, row_stride, stream
    [_P, _P, _P, _L, _L, _L, _L, _P],
)

_WORD_TYPES = (torch.float32, torch.int32)


def take_or_zero(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin: out[s, c] = table[s, idx[s, c]], 0 out of range.
    A ``where``, not a mask multiply, so a NaN or inf in the table never
    leaks into an out-of-range slot."""
    w = table.shape[1]
    in_range = (idx >= 0) & (idx < w)
    g = torch.gather(table, 1, idx.clamp(0, w - 1).to(torch.int64))
    return torch.where(in_range, g, torch.zeros_like(g))


def lane_gather_op(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s, c] = table[s, idx[s, c]]; an out-of-range index gives 0.

    Args:
      table: (S, W) float32 or int32, unit stride along W and a row stride
        of W (contiguous) or 0 (one row broadcast over S).
      idx: (S, C) int32, contiguous.

    Returns (S, C) of table's dtype. CUDA tensors go through the kernel,
    CPU tensors through ``take_or_zero``.
    """
    dev = table.device
    check_same_device(dev, idx=idx)
    if table.dtype not in _WORD_TYPES:
        raise TypeError(f"table: dtype {table.dtype}, expected f32 or i32")
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected 2-D")
    s, w = table.shape
    if table.stride(1) != 1 or table.stride(0) not in (0, w):
        raise ValueError(
            f"table: strides {table.stride()} are neither contiguous nor "
            "a broadcast row"
        )
    check_tensor("idx", idx, torch.int32, ndim=2)
    if idx.shape[0] != s:
        raise ValueError(f"table has {s} rows, idx {idx.shape[0]}")
    if dev.type == "cpu":
        return take_or_zero(table, idx)

    c = idx.shape[1]
    out = torch.empty((s, c), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        KERNEL(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            s, c, w, table.stride(0), stream_handle(dev),
        )
    return out


def lookup_flat(image: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """out[s, c] = image.flatten()[lin[s, c]], 0 where ``lin`` is outside
    the image: a 2-D lookup by linear pixel index ``y * W + x``.

    The image (H, W), float32 or int32 and contiguous, is viewed as one
    row broadcast over ``lin``'s rows (row stride 0), so nothing is
    copied; ``lin`` is (S, C) int32. One call of :func:`lane_gather_op`:
    the kernel on CUDA tensors, ``take_or_zero`` on CPU tensors.
    """
    check_tensor("image", image, image.dtype, ndim=2)
    return lane_gather_op(image.reshape(1, -1).expand(lin.shape[0], -1), lin)
