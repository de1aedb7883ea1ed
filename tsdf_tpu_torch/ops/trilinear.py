"""Trilinear TSDF sampling: the 8-tap stencil every raycast step uses.

Port of ``tsdf_tpu/ops/trilinear.py``. The border rules are the
reference's, exactly:

  * points past the far face are pulled back by voxel_size/10;
  * negative coords clamp to 0;
  * the lower cell index clamps to 0 while u, v, w are computed against
    the *clamped* lower centre, so border samples extrapolate linearly;
  * out-of-range taps clamp to the border voxel (from below too: a NaN
    point's taps stay in the grid, and it samples NaN as in JAX).

The raycast kernel (``csrc/raycast.cu``) evaluates the same expressions
in the same order.
"""

from __future__ import annotations

import torch


def _stencil(values: torch.Tensor, points, voxel_size):
    """The eight f32 taps c000 .. c111 (x, y, z indices) of each point and
    its fractions u, v, w under the border rules, and the points as f32."""
    sz, sy, sx = values.shape
    dev = values.device
    voxel_size = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    p = torch.as_tensor(points, dtype=torch.float32, device=dev)

    # the sizes stay Python numbers: a tensor of them made on a card would
    # be a blocking host-to-device copy in every call
    max_values = torch.stack(
        [voxel_size[0] * sx, voxel_size[1] * sy, voxel_size[2] * sz]
    )
    q = torch.where(p >= max_values, max_values - voxel_size / 10.0, p)
    q = torch.where(q < 0.0, torch.zeros_like(q), q)

    g = q / voxel_size - 0.5
    lower = torch.clamp(torch.floor(g), min=0.0)
    uvw = g - lower
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    lx, ly, lz = lower.to(torch.int64).unbind(-1)
    # a NaN point's lower corner casts to a huge negative index: clamped
    # from below too, its taps stay in the grid and its sample is NaN
    ixs = [torch.clamp(lx + d, 0, sx - 1) for d in (0, 1)]
    iys = [torch.clamp(ly + d, 0, sy - 1) for d in (0, 1)]
    izs = [torch.clamp(lz + d, 0, sz - 1) for d in (0, 1)]

    flat = values.reshape(-1)

    def tap(dx, dy, dz):
        # cast AFTER the gather: a bf16 volume is read at half the bytes
        # and the blend still runs in f32
        return flat[(izs[dz] * sy + iys[dy]) * sx + ixs[dx]].to(torch.float32)

    taps = [tap(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return taps, u, v, w, p, max_values, voxel_size


def _blend(taps, u, v, w):
    c000, c001, c010, c011, c100, c101, c110, c111 = taps
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


def trilinear_sample(values: torch.Tensor, points, voxel_size) -> torch.Tensor:
    """Sample ``values`` at grid-local points.

    Args:
      values: (Z, Y, X) f32 or bf16 volume.
      points: (..., 3) f32 grid-local mm coords (world - space_min),
        components (x, y, z).
      voxel_size: (3,) f32 mm.

    Returns:
      (...,) f32 interpolated values.
    """
    taps, u, v, w, *_ = _stencil(values, points, voxel_size)
    return _blend(taps, u, v, w)


def trilinear_sample_and_grad(values: torch.Tensor, points, voxel_size):
    """:func:`trilinear_sample` (the same bits) and its gradient in the
    point, (..., 3) f32 mm^-1: the derivative of the blend in each
    fraction over the voxel size, and 0 along a coordinate the border
    rules hold (pulled back from the far face or clamped at 0); the lower
    corner's ``floor`` has none. ``csrc/lm_linearise.cu`` evaluates the
    same expressions in the same order."""
    taps, u, v, w, p, max_values, voxel_size = _stencil(values, points, voxel_size)
    c000, c001, c010, c011, c100, c101, c110, c111 = taps
    fu = ((c100 - c000) * (1 - v) * (1 - w) + (c101 - c001) * (1 - v) * w
          + (c110 - c010) * v * (1 - w) + (c111 - c011) * v * w)
    fv = ((c010 - c000) * (1 - u) * (1 - w) + (c011 - c001) * (1 - u) * w
          + (c110 - c100) * u * (1 - w) + (c111 - c101) * u * w)
    fw = ((c001 - c000) * (1 - u) * (1 - v) + (c011 - c010) * (1 - u) * v
          + (c101 - c100) * u * (1 - v) + (c111 - c110) * u * v)
    free = (p >= 0.0) & (p < max_values)
    grad = torch.where(free, torch.stack([fu, fv, fw], dim=-1) / voxel_size, 0.0)
    return _blend(taps, u, v, w), grad


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
        ix = torch.clamp(lx + dx, 0, sx - 1)
        for dy in (0, 1):
            iy = torch.clamp(ly + dy, 0, sy - 1)
            for dz in (0, 1):
                iz = torch.clamp(lz + dz, 0, sz - 1)
                lins.append((iz * sy + iy) * sx + ix)
                wts.append(
                    (u if dx else 1 - u)
                    * (v if dy else 1 - v)
                    * (w if dz else 1 - w)
                )
    return torch.stack(lins, dim=-1), torch.stack(wts, dim=-1)
