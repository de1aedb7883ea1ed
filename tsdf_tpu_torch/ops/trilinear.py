"""Trilinear TSDF sampling: the 8-tap stencil every raycast step uses.

Port of ``tsdf_tpu/ops/trilinear.py``. The border rules are the
reference's, exactly:

  * points past the far face are pulled back by voxel_size/10;
  * negative coords clamp to 0;
  * the lower cell index clamps to 0 while u, v, w are computed against
    the *clamped* lower centre, so border samples extrapolate linearly;
  * out-of-range taps clamp to the border voxel.

The raycast kernel (``csrc/raycast.cu``) evaluates the same expressions
in the same order.
"""

from __future__ import annotations

import torch


def trilinear_sample(values: torch.Tensor, points, voxel_size) -> torch.Tensor:
    """Sample ``values`` at grid-local points.

    Args:
      values: (Z, Y, X) f32 volume.
      points: (..., 3) f32 grid-local mm coords (world - space_min),
        components (x, y, z).
      voxel_size: (3,) f32 mm.

    Returns:
      (...,) f32 interpolated values.
    """
    sz, sy, sx = values.shape
    dev = values.device
    size = torch.tensor([sx, sy, sz], dtype=torch.float32, device=dev)
    voxel_size = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    p = torch.as_tensor(points, dtype=torch.float32, device=dev)

    max_values = size * voxel_size
    p = torch.where(p >= max_values, max_values - voxel_size / 10.0, p)
    p = torch.where(p < 0.0, torch.zeros_like(p), p)

    g = p / voxel_size - 0.5
    lower = torch.clamp(torch.floor(g), min=0.0)
    uvw = g - lower
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    lower = lower.to(torch.int64)

    flat = values.reshape(-1)
    size_i = torch.tensor([sx, sy, sz], dtype=torch.int64, device=dev)

    def tap(dx, dy, dz):
        off = torch.tensor([dx, dy, dz], dtype=torch.int64, device=dev)
        idx = torch.minimum(lower + off, size_i - 1)
        lin = (idx[..., 2] * sy + idx[..., 1]) * sx + idx[..., 0]
        return flat[lin]

    c000 = tap(0, 0, 0)
    c001 = tap(0, 0, 1)
    c010 = tap(0, 1, 0)
    c011 = tap(0, 1, 1)
    c100 = tap(1, 0, 0)
    c101 = tap(1, 0, 1)
    c110 = tap(1, 1, 0)
    c111 = tap(1, 1, 1)

    return (
        c000 * (1 - u) * (1 - v) * (1 - w)
        + c001 * (1 - u) * (1 - v) * w
        + c010 * (1 - u) * v * (1 - w)
        + c011 * (1 - u) * v * w
        + c100 * u * (1 - v) * (1 - w)
        + c101 * u * (1 - v) * w
        + c110 * u * v * (1 - w)
        + c111 * u * v * w
    )


def trilinear_weights_and_indices(values_shape, points, voxel_size):
    """The 8 tap indices and weights of each point, under the border rules
    of :func:`trilinear_sample` (the deformation-field interpolation).

    Args:
      values_shape: (Z, Y, X) of the sampled grid.
      points: (..., 3) f32 tensor of grid-local mm coords.
      voxel_size: (3,) f32 tensor on the points' device.

    Returns:
      lin: (..., 8) int32 flat indices into the grid, taps ordered x, y, z
        with z fastest.
      wts: (..., 8) f32 interpolation weights (they sum to 1).
    """
    sz, sy, sx = values_shape
    dev = points.device
    size = torch.tensor([sx, sy, sz], dtype=torch.float32, device=dev)
    p = points.to(torch.float32)

    max_values = size * voxel_size
    p = torch.where(p >= max_values, max_values - voxel_size / 10.0, p)
    p = torch.where(p < 0.0, torch.zeros_like(p), p)

    g = p / voxel_size - 0.5
    lower = torch.clamp(torch.floor(g), min=0.0)
    u, v, w = (g - lower).unbind(-1)
    lx, ly, lz = lower.to(torch.int32).unbind(-1)

    lins, wts = [], []
    for dx in (0, 1):
        ix = torch.clamp(lx + dx, max=sx - 1)
        for dy in (0, 1):
            iy = torch.clamp(ly + dy, max=sy - 1)
            for dz in (0, 1):
                iz = torch.clamp(lz + dz, max=sz - 1)
                lins.append((iz * sy + iy) * sx + ix)
                wts.append(
                    (u if dx else 1 - u)
                    * (v if dy else 1 - v)
                    * (w if dz else 1 - w)
                )
    return torch.stack(lins, dim=-1), torch.stack(wts, dim=-1)
