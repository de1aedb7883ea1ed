"""What the rigid KinectFusion drivers share: the frame cycle of a
configuration, the program's fusion settings, the reference's grid."""

from __future__ import annotations

import torch

from reference import fusion as ref

from . import scene
from .common import Ctx


def make_inputs(ctx: Ctx):
    """The configuration's cycle: (period, H, W) float32 frames and their
    (period, 4, 4) float32 camera->world poses, on the device."""
    cfg = ctx.config
    period = int(cfg["trajectory"]["period"])
    poses = scene.trajectory(cfg["trajectory"], period, ctx.seed, ctx.device)
    depth = scene.depth_stream(cfg, poses, ctx.seed)
    return depth, poses.to(torch.float32).contiguous()


def fusion_config(ctx: Ctx, tracked: bool):
    """The program's settings for the configuration; the GT replay fuses
    the raw frames, as the reference's ``kinfu -m N -d dir`` does."""
    from tsdf_tpu_torch.pipelines import kinfu

    cfg = ctx.config
    vol, cam, fu = cfg["volume"], cfg["camera"], cfg["fusion"]
    if tracked and tuple(fu["icp_iterations"]) != (10, 5, 4):
        raise ValueError("the program's tracker runs the 10/5/4 schedule")
    return kinfu.FusionConfig(
        volume_size=(vol["size"],) * 3, physical_size_mm=vol["physical_mm"],
        offset_mm=vol.get("offset_mm"), width=cam["width"], height=cam["height"],
        use_bilateral_filter=tracked and fu["use_bilateral_filter"],
        sigma_colour=fu["sigma_colour"], sigma_space=fu["sigma_space"],
        icp_band=fu["icp_band"], icp_conv_eps=fu["icp_conv_eps"],
        icp_min_inliers_frac=fu["icp_min_inliers_frac"])


def make_volume(ctx: Ctx, fusion):
    volume = fusion.make_volume(device=ctx.device)
    if ctx.storage != torch.float32:
        volume = volume.astype(ctx.storage)
    return volume


def reference_grid(ctx: Ctx) -> ref.Grid:
    vol = ctx.config["volume"]
    return ref.make_grid(vol["size"], vol["physical_mm"], vol.get("offset_mm"),
                         device=ctx.device)
