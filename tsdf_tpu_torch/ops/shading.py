"""Lambertian shading, normal-map and fused-colour images (port of
``tsdf_tpu/ops/shading.py``; plain PyTorch)."""

from __future__ import annotations

import torch


def scene_image(vertices, normals, light_source) -> torch.Tensor:
    """(H, W) u8 greyscale: 0.2 + 0.8 * max(0, n . normalize(light - v)),
    floored; missed rays (NaN vertices) render black."""
    r = light_source - vertices
    r = r / torch.sqrt((r * r).sum(dim=-1, keepdim=True))
    shade = torch.clamp((normals * r).sum(dim=-1), min=0.0)
    shade = 0.2 + 0.8 * shade
    valid = torch.isfinite(vertices).all(dim=-1)
    shade = torch.where(valid, shade, torch.zeros_like(shade))
    return torch.floor(shade * 255.0).to(torch.uint8)


def normals_image(normals) -> torch.Tensor:
    """(H, W, 3) u8 RGB normal map: n/2 + 0.5, z folded positive."""
    n = normals.clone()
    n[..., 2] = n[..., 2].abs()
    img = torch.floor(((n / 2.0) + 0.5) * 255.0)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def color_image(vol, vertices) -> torch.Tensor:
    """(H, W, 3) u8 render of the fused per-voxel colour at raycast hits:
    each channel sampled trilinearly at the hit vertex, rounded half to
    even; missed rays (NaN vertices) render black."""
    from .trilinear import trilinear_sample

    if vol.color is None:
        raise ValueError("volume has no colour field (use with_color())")
    valid = torch.isfinite(vertices).all(dim=-1)
    pts = torch.where(
        valid[..., None], vertices, torch.zeros_like(vertices)
    ) - vol.space_min
    vs = vol.voxel_size
    rgb = torch.stack(
        [
            trilinear_sample(vol.color[..., c].to(torch.float32), pts, vs)
            for c in range(3)
        ],
        dim=-1,
    )
    rgb = torch.where(valid[..., None], rgb, torch.zeros_like(rgb))
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)
