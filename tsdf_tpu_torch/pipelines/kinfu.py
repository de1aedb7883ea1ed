"""KinectFusion pipelines: GT-pose fusion and tracked fusion.

Port of ``tsdf_tpu/pipelines/kinfu.py``: ``FusionConfig``,
``fuse_frames`` (ground-truth poses) and ``track_and_fuse_frames`` (the
full loop: bilateral filter -> model raycast -> ICP -> gated integrate) as
plain per-frame loops. On a CUDA volume each frame launches the
hand-written kernels: bilateral, raycast, the lane gather inside every
ICP iteration, and the integrate kernel its frame and
``FusionConfig.integrate_mode`` select (depth or depth + colour, exact or
the decimated "fast" convention).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Optional

import torch

from ..camera import Camera
from ..kernels.bilateral import bilateral_filter_cuda
from ..kernels.integrate import (
    MODES,
    integrate_color_cuda,
    integrate_cuda,
    integrate_fast_cuda,
    integrate_warped_cuda,
)
from ..kernels.raycast import raycast_vertices_cuda
from ..ops.raycast import vertices_to_camera_depth
from ..tracking.icp import get_incremental_transformation
from ..utils.se3 import matmul_small
from ..volume import TSDFVolume, make_volume


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """The fusion settings, with the JAX package's defaults.

    The JAX ``FusionConfig`` fields ``use_pallas``, ``integrate_nk``,
    ``fuse_chunk`` and ``track_chunk`` select or shape TPU kernels and
    dispatches and have no counterpart here: a CUDA volume always runs
    the kernels, one frame at a time.
    """

    volume_size: tuple[int, int, int] = (200, 200, 200)
    physical_size_mm: float = 3000.0
    offset_mm: Optional[tuple[float, float, float]] = None
    cap_weight: bool = False
    use_bilateral_filter: bool = False
    sigma_colour: float = 20.0
    sigma_space: float = 3.0
    width: int = 640
    height: int = 480
    # Row band of the banded ICP association at level 0 (0 = the exact
    # association only).
    icp_band: int = 32
    # "exact" and "line" both run the exact kernels: on the card every
    # voxel reads its own pixel, so there is no line approximation.
    # "fast" samples a (2 x 4)-decimated image on each voxel column's
    # image line: a resampling convention within ~3 px of the exact pixel,
    # not exact, which skips (and counts) columns steeper than |beta| = 1.
    integrate_mode: str = "line"
    # The banded association drops correspondences displaced vertically
    # by more than icp_band pixels (fast motion). If the final inlier
    # count falls below this fraction of the image, the frame is tracked
    # again with the exact association; if it is still below, tracking
    # is lost for the frame.
    icp_min_inliers_frac: float = 0.02
    # ICP early exit: stop a pyramid level once the SE3 update magnitude
    # |v|_mm + 1000*|w|_rad falls below this. 0.0 runs the full 10/5/4
    # schedule.
    icp_conv_eps: float = 0.0

    def make_volume(self, *, device) -> TSDFVolume:
        return make_volume(
            self.volume_size, self.physical_size_mm, offset=self.offset_mm,
            device=device,
        )


def _check_integrate_mode(config: FusionConfig) -> None:
    if config.integrate_mode not in MODES:
        raise ValueError(f"unknown integrate_mode {config.integrate_mode!r}")


def integrate_frame(vol, depth, camera, *, mode="line", cap_weight=False,
                    rgb=None):
    """Fuse one frame with the kernel the frame and ``mode`` select:
    depth in mode "exact", "line" or "fast", depth and colour with ``rgb``,
    a volume with a deformation field at its deformed centres (exact
    pixels, no miss; the "fast" convention has no deformed variant).
    Returns (volume, miss): the kernel's miss count, a 0-d tensor left on
    the device, or None where the kernel counts none."""
    if vol.deform is not None:
        if mode == "fast":
            raise ValueError(
                "integrate_mode='fast' is the rigid path; a deformed "
                "volume needs 'exact' or 'line'"
            )
        return integrate_warped_cuda(
            vol, depth, camera, cap_weight=cap_weight, rgb=rgb
        ), None
    if rgb is not None:
        return integrate_color_cuda(
            vol, depth, rgb, camera, cap_weight=cap_weight, mode=mode
        )
    if mode == "fast":
        return integrate_fast_cuda(vol, depth, camera, cap_weight=cap_weight)
    return integrate_cuda(vol, depth, camera, cap_weight=cap_weight), None


def _integrate(vol, depth, camera, config: FusionConfig, miss_log, rgb=None):
    """``integrate_frame`` in the config's mode; a miss count goes to
    ``miss_log``, where ``_check_misses`` reads the run's counts once."""
    vol, miss = integrate_frame(
        vol, depth, camera, mode=config.integrate_mode,
        cap_weight=config.cap_weight, rgb=rgb,
    )
    if miss is not None:
        miss_log.append(miss)
    return vol


def _check_misses(miss_log, config: FusionConfig) -> None:
    """One reduction on the device and one scalar read over the run's miss
    counts: non-zero means some voxels lost observations (only the "fast"
    mode can skip a voxel here)."""
    if not miss_log:
        return
    total = int(torch.stack(miss_log).sum())
    if total:
        warnings.warn(
            f"{total} voxel observations skipped by the line-warp "
            f"integrate (mode={config.integrate_mode}, nk=1); re-run with "
            "FusionConfig(integrate_mode='exact') -- the fast mode skips "
            "columns steeper than |beta| = 1 (extreme camera roll)."
        )


def _rgb_on(device, rgb):
    """A frame's colour image as a contiguous uint8 tensor on ``device``
    (None stays None)."""
    if rgb is None:
        return None
    return torch.as_tensor(rgb).to(device).contiguous()


def fuse_frames(
    vol: TSDFVolume,
    camera: Camera,
    frames: Iterable[tuple],
    config: FusionConfig = FusionConfig(),
) -> tuple[TSDFVolume, Camera]:
    """Fuse (depth, pose) or (depth, pose, rgb) frames with ground-truth
    poses.

    With ``use_bilateral_filter`` the fused depth is filtered first
    (denoising for raw sensor data; the tracked pipeline instead filters
    only the tracker's input and fuses raw depth).

    Args:
      vol: the volume; its tsdf/weight (and colour) are updated in place.
      camera: intrinsics; its pose is replaced by each frame's.
      frames: iterable of (depth (H, W) mm, float32 or uint16, pose (4, 4)
        camera->world), on the volume's device. A uint16 frame is filtered
        as uint16 (rounded back to whole mm) and converted for the fuse.
        A third element, rgb (H, W, 3) uint8, fuses per-voxel colour into
        a volume with a colour field; a frame whose rgb is None fuses
        depth only.

    Returns (volume, camera at the last pose). Warns if the "fast" mode
    skipped voxels (one host read of the miss counts, after the last
    frame).
    """
    _check_integrate_mode(config)
    miss_log: list = []
    for depth, pose, *rest in frames:
        camera = camera.set_pose(pose)
        if config.use_bilateral_filter:
            depth = bilateral_filter_cuda(
                depth, config.sigma_colour, config.sigma_space
            )
        rgb = _rgb_on(vol.device, rest[0]) if rest else None
        vol = _integrate(
            vol, depth.to(torch.float32), camera, config, miss_log, rgb=rgb
        )
    _check_misses(miss_log, config)
    return vol, camera


@torch.no_grad()
def track_and_fuse_frames(
    vol: TSDFVolume,
    camera: Camera,
    frames: Iterable,
    config: FusionConfig = FusionConfig(),
):
    """Full KinectFusion: bilateral -> ICP against the raycast model ->
    integrate.

    The first frame is integrated at the camera's current pose. Each later
    frame is tracked against a render of the model from the previous pose
    (frame-to-model tracking):

    * the bilateral-smoothed depth feeds the tracker only; the raw depth
      is fused (the TSDF's weighted average is itself the noise filter);
    * the model depth is the camera-space z of the raycast vertices,
      float32, 0 on a miss;
    * ICP runs with the banded association (``icp_band`` rows); if its
      inlier count falls below ``icp_min_inliers_frac`` of the image it
      runs again with the exact association;
    * a frame still below that count is lost: the pose is kept exactly as
      it was and the frame is not fused. A zero depth frame is therefore
      an exact no-op.

    Host syncs: one per tracked frame, the read of the inlier count that
    decides the fallback (two on a frame that takes the fallback: the
    second decides whether it is lost); with ``icp_conv_eps > 0`` one more
    per executed ICP iteration (``tracking.icp.run_level``); one after the
    last frame for the miss counts of colour or "fast" fusion.

    Args:
      vol: the volume; its tsdf/weight (and colour) are updated in place.
      camera: intrinsics and the first frame's pose.
      frames: iterable of depth images (H, W) in mm: tensors on the
        volume's device, or numpy arrays, of any real dtype; or of
        (depth, rgb) pairs, rgb (H, W, 3) uint8, which fuse per-voxel
        colour into a volume with a colour field at the tracked pose (the
        tracker itself stays depth-only; a lost frame fuses neither).
        Either every frame carries an rgb image or none does.

    Returns:
      (volume, camera at the final pose, list of (4, 4) per-frame poses,
       list of (error_mm, inliers) tracking stats as 0-d tensors).
    """
    _check_integrate_mode(config)
    if vol.deform is not None:
        raise ValueError(
            "track_and_fuse_frames does not support deformation-enabled "
            "volumes: it integrates rigidly. Use pipelines.scenefusion for "
            "non-rigid fusion."
        )
    dev = vol.device
    k = camera.k
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    band = config.icp_band if config.icp_band > 0 else None
    min_inl = config.icp_min_inliers_frac * config.width * config.height
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def track(depth_icp, model_depth, band):
        return get_incremental_transformation(
            depth_icp, model_depth, fx, fy, cx, cy, band=band,
            conv_eps=config.icp_conv_eps,
        )

    poses = []
    stats = []
    miss_log: list = []
    has_rgb = None
    for frame in frames:
        frame, rgb = frame if isinstance(frame, tuple) else (frame, None)
        rgb = _rgb_on(dev, rgb)
        if has_rgb is None:
            has_rgb = rgb is not None
        elif (rgb is not None) != has_rgb:
            raise ValueError(
                "track_and_fuse_frames needs a consistent rgb presence "
                "across frames"
            )
        depth = torch.as_tensor(frame).to(dev).to(torch.float32).contiguous()
        if not poses:
            stats.append((zero, zero))
            vol = _integrate(vol, depth, camera, config, miss_log, rgb=rgb)
            poses.append(camera.pose)
            continue

        if config.use_bilateral_filter:
            depth_icp = bilateral_filter_cuda(
                depth, config.sigma_colour, config.sigma_space
            )
        else:
            depth_icp = depth
        verts = raycast_vertices_cuda(
            vol, camera, config.width, config.height
        )
        model_depth = vertices_to_camera_depth(verts, camera.pose_inv)

        res = track(depth_icp, model_depth, band)
        lost = bool(res.inliers < min_inl)  # the frame's host sync
        if lost and band is not None:
            res = track(depth_icp, model_depth, None)
            lost = bool(res.inliers < min_inl)
        stats.append((res.error, res.inliers))
        if not lost:
            # res.pose maps current-camera into previous-camera
            # coordinates: new camera->world = previous pose o T_prev_curr
            camera = camera.set_pose(matmul_small(camera.pose, res.pose))
            vol = _integrate(vol, depth, camera, config, miss_log, rgb=rgb)
        poses.append(camera.pose)
    _check_misses(miss_log, config)
    return vol, camera, poses, stats
