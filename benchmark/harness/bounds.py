"""The least time the card could take for a kernel's work.

Frozen copy of ``chip_smoke.py``'s bound arithmetic (``bound``,
``voxels_in_front``, ``INTEGRATE_OPS``, ``POSE_GRAD_OPS`` and the published
peaks), so that a later change to the program cannot move the yardstick.
The counts come from the inputs and the volume's geometry, never from
what a kernel did.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations the kernels' functions need, counted from their
# expressions (a compare, a min/max, a floor and a division count as one):
# every voxel is projected (27), a voxel in front of the camera is divided
# and rounded to its pixel (12), an updated voxel blends (8).
INTEGRATE_OPS = dict(voxel=27, in_front=12, updated=8)
# the pose adjoint: the same projection, an updated voxel's volume
# cotangents (10), a voxel in the band its image term and the twelve
# products and float64 sums (41)
POSE_GRAD_OPS = dict(voxel=27, in_front=12, updated=10, band=41)


def bound_s(bytes_moved: float, operations: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 peak, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, operations / F32_OPS_PER_S)


def integrate_bound_s(n_voxels: int, in_front: int, updated: int,
                      pixels: int) -> float:
    """One depth integrate: an updated voxel reads and writes tsdf and
    weight (16 B), the depth frame is read once."""
    o = INTEGRATE_OPS
    return bound_s(16 * updated + 4 * pixels,
                   o["voxel"] * n_voxels + o["in_front"] * in_front
                   + o["updated"] * updated)


def pose_grad_bound_s(n_voxels: int, in_front: int, updated: int,
                      in_band: int, pixels: int) -> float:
    """One pose adjoint: the two volume cotangents in and out at every
    voxel (16 B), tsdf and weight at an updated one (8 B), the depth and
    its two gradient images once."""
    o = POSE_GRAD_OPS
    return bound_s(16 * n_voxels + 8 * updated + 3 * 4 * pixels,
                   o["voxel"] * n_voxels + o["in_front"] * in_front
                   + o["updated"] * updated + o["band"] * in_band)


def voxels_in_front(axis_centres, pose_inv: torch.Tensor) -> int:
    """How many voxel centres have a positive camera z; ``axis_centres``
    is (z, y, x) of the grid."""
    zc, yc, xc = axis_centres
    pi = pose_inv
    camz = (pi[2, 0] * xc[None, None, :] + pi[2, 1] * yc[None, :, None]
            + pi[2, 2] * zc[:, None, None] + pi[2, 3])
    return int((camz > 0).sum())
