"""Depth-frame integration into the TSDF volume, in plain PyTorch.

Port of ``tsdf_tpu/ops/integrate.py`` (rigid, depth only). This is the
plain twin of the CUDA kernel in ``kernels/integrate.py``: the CPU path
and the oracle the kernel is held against on the card.

Math per voxel:
  * centre c (world, mm) -> camera point X = R c + t with
    (R | t) = pose_inv[0:3];
  * pixel p = round((K X) / Z): ``(fx*X + cx*Z) / Z``, rounded half to
    even;
  * gate: p inside the image, Z > 0, depth(p) > 0, sdf >= -trunc where
    sdf = depth(p) - Z;
  * running mean: d' = (d*w + min(sdf, trunc)) / (w+1), w' = w+1
    (optionally capped at max_weight).

Every product and sum is a separate elementwise op written in the order
the kernel evaluates it (no 3x3 matmul), so on the card the twin and the
kernel round identically.
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..volume import TSDFVolume


def integrate(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
) -> TSDFVolume:
    """Fuse one depth frame; returns a new volume (inputs untouched).

    Args:
      vol: the volume.
      depth: (H, W) depth in mm, any numeric dtype. Zero means no data.
      camera: Camera with pose = camera->world.
      cap_weight: clamp the accumulated weight at vol.max_weight.
    """
    if vol.deform is not None:
        raise NotImplementedError(
            "integrating into a deformed volume is not ported yet "
            "(ROADMAP.md: integrate_warped_pallas)"
        )
    h, w = depth.shape
    depth_f = depth.to(torch.float32).reshape(-1)

    cz, cy, cx = vol.axis_centres()
    cx = cx[None, None, :]
    cy = cy[None, :, None]
    cz = cz[:, None, None]
    pi = camera.pose_inv
    cam = [
        pi[i, 0] * cx + pi[i, 1] * cy + pi[i, 2] * cz + pi[i, 3]
        for i in range(3)
    ]
    k = camera.k
    z = cam[2]
    px = torch.round((k[0, 0] * cam[0] + k[0, 2] * z) / z)
    py = torch.round((k[1, 1] * cam[1] + k[1, 2] * z) / z)

    in_frustum = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # outside the image (or NaN at Z == 0) the sample is never used:
    # read pixel 0 there
    lin = torch.where(in_frustum, py * w + px, 0.0).to(torch.int64)
    surface = depth_f[lin]

    sdf = surface - z
    trunc = vol.truncation_distance
    update = in_frustum & (z > 0) & (surface > 0) & (sdf >= -trunc)
    tsdf_obs = torch.minimum(sdf, trunc)

    prior_d = vol.tsdf
    prior_w = vol.weight
    new_w = prior_w + 1.0
    new_d = (prior_d * prior_w + tsdf_obs) / new_w
    if cap_weight:
        new_w = torch.minimum(new_w, vol.max_weight)
    return vol.replace(
        tsdf=torch.where(update, new_d, prior_d),
        weight=torch.where(update, new_w, prior_w),
    )
