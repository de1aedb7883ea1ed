"""KinectFusion with ground-truth poses: fuse a stream of depth frames.

Port of ``tsdf_tpu/pipelines/kinfu.py:FusionConfig`` and ``fuse_frames``
as a plain per-frame loop; each frame is one launch of the integrate
kernel on a CUDA volume. The tracked loop (bilateral filter + ICP) is not
ported yet (ROADMAP.md, still to port).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from ..camera import Camera
from ..kernels.integrate import integrate_cuda
from ..volume import TSDFVolume, make_volume


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """The GT-pose fusion settings."""

    volume_size: tuple[int, int, int] = (200, 200, 200)
    physical_size_mm: float = 3000.0
    offset_mm: Optional[tuple[float, float, float]] = None
    cap_weight: bool = False
    # "exact" and "line" both run the exact kernel: on the card every
    # voxel reads its own pixel, so there is no line approximation.
    integrate_mode: str = "line"

    def make_volume(self, *, device) -> TSDFVolume:
        return make_volume(
            self.volume_size, self.physical_size_mm, offset=self.offset_mm,
            device=device,
        )


def fuse_frames(
    vol: TSDFVolume,
    camera: Camera,
    frames: Iterable[tuple[torch.Tensor, torch.Tensor]],
    config: FusionConfig = FusionConfig(),
) -> tuple[TSDFVolume, Camera]:
    """Fuse (depth, pose) frames with ground-truth poses.

    Args:
      vol: the volume; its tsdf/weight are updated in place.
      camera: intrinsics; its pose is replaced by each frame's.
      frames: iterable of (depth (H, W) f32 mm, pose (4, 4) camera->world),
        on the volume's device.

    Returns (volume, camera at the last pose).
    """
    if config.integrate_mode == "fast":
        raise NotImplementedError(
            "integrate_mode='fast' (the decimated-depth kernel) is not "
            "ported yet; see ROADMAP.md"
        )
    if config.integrate_mode not in ("exact", "line"):
        raise ValueError(f"unknown integrate_mode {config.integrate_mode!r}")
    for depth, pose in frames:
        camera = camera.set_pose(pose)
        vol = integrate_cuda(vol, depth, camera, cap_weight=config.cap_weight)
    return vol, camera
