"""Warping points through the deformation field (the SceneFusion mesh
warp).

Port of ``tsdf_tpu/ops/deform.py``: each point blends the translations of
the 8 deformation nodes around it trilinearly, then the volume's global
Euler rotation and translation apply. As there, a point outside the volume
comes back unwarped with its ``valid`` flag cleared, and taps clamp to the
grid.

The 8 taps of every point are rows of the (Z*Y*X, 3) field: one call of
``kernels.gather.row_gather_op``, the CUDA row-gather kernel on a CUDA
volume and its plain twin on the CPU.
"""

from __future__ import annotations

import torch

from ..kernels.gather import row_gather_op
from ..utils.se3 import euler_to_matrix
from ..volume import TSDFVolume
from .trilinear import trilinear_weights_and_indices


def deform_points(vol: TSDFVolume, points) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp world-space points through the volume's deformation field.

    Args:
      vol: volume with a ``deform`` field.
      points: (..., 3) world-space points in mm, tensor or array.

    Returns:
      (warped (..., 3) f32, valid (...,) bool), on the volume's device.
      Points outside the volume pass through unchanged.
    """
    if vol.deform is None:
        raise ValueError("volume has no deformation field")
    dev = vol.device
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    local = points - vol.offset

    size = torch.tensor(vol.size, dtype=torch.float32, device=dev)
    max_values = size * vol.voxel_size
    valid = ((local >= 0.0) & (local <= max_values)).all(dim=-1)

    lin, wts = trilinear_weights_and_indices(
        vol.tsdf.shape, local, vol.voxel_size
    )
    taps = row_gather_op(
        vol.deform.view(-1, 3), lin.reshape(-1).contiguous()
    ).reshape(*lin.shape, 3)
    warped = (taps * wts[..., None]).sum(dim=-2)

    rot = euler_to_matrix(vol.global_rotation)
    warped = warped @ rot.T + vol.global_translation
    return torch.where(valid[..., None], warped, points), valid
