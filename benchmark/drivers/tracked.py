"""KinectFusion tracked from the first frame's pose:
``tsdf_tpu_torch.pipelines.kinfu.track_and_fuse_frames`` over the
configuration's frame cycle, one frame in flight.

Set-up makes the cycle on the device; the first ``warmup`` frames of the
loop are set-up, the rest of the same loop is the window. A frame the
tracker loses counts as failed.

The check follows the program's poses, as a served model's check follows
its served tokens: the reference fuses every frame the program fused, at
the pose the program returned, into a volume of its own, and compares
that volume with the program's at the end. At ``check_frames`` frames of
the run, drawn from the seed, it first tracks the frame itself, from the
program's previous pose against a render of its own volume, and compares
the pose it finds with the program's.
"""

from __future__ import annotations

import numpy as np

from harness import rigid
from harness.common import Ctx, FrameWindow, Outcome, memory_peak, sample
from reference import fusion as ref
from reference import tracking


def run(ctx: Ctx) -> Outcome:
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines import kinfu

    depth, poses = rigid.make_inputs(ctx)
    period = depth.shape[0]
    fusion = rigid.fusion_config(ctx, tracked=True)
    volume = rigid.make_volume(ctx, fusion)
    cam = ctx.config["camera"]
    camera = Camera.from_intrinsics(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                    poses[0], device=ctx.device)
    mix = ctx.traffic
    window = FrameWindow(ctx, warmup=int(mix["warmup_frames"]),
                         one_in_flight=True,
                         trace_frames=int(mix["trace_frames"]))
    volume, camera, out_poses, stats = kinfu.track_and_fuse_frames(
        volume, camera, window.frames(lambda i: depth[i % period]), fusion)
    window.close()
    peak = memory_peak(ctx)

    summary = None
    if window.tracer:
        summary = window.tracer.summarize(window.trace_frames, {})

    min_inl = fusion.icp_min_inliers_frac * fusion.width * fusion.height
    lost = [i > 0 and bool(s[1] < min_inl) for i, s in enumerate(stats)]
    checks = check(ctx, volume, depth, out_poses, lost, min_inl)
    return Outcome(attempted=window.handed, failed=sum(lost),
                   metrics={"frames_per_s": window.rate(),
                            "frame_ms_p95": window.p95_ms()},
                   checks=checks, window_start=window.start,
                   memory_peak_bytes=peak, trace=summary)


def check(ctx: Ctx, volume, depth, out_poses, lost, min_inl) -> list:
    cfg = ctx.config
    cam = cfg["camera"]
    h, w = cam["height"], cam["width"]
    k = ref.intrinsics(cam, ctx.device)
    period = depth.shape[0]
    n = len(out_poses)
    rng = np.random.default_rng(ctx.seed)
    checked = {i + 1 for i in sample(rng, n - 1, int(ctx.traffic["check_frames"]))}
    grid = rigid.reference_grid(ctx)
    gap_mm = gap_mrad = 0.0
    lost_mismatch = 0
    for i in range(n):
        d = depth[i % period]
        if i in checked:
            prev = out_poses[i - 1]
            model = tracking.render_depth(grid, prev, ref.inverse(prev), k, h, w)
            t, _inl, lost_ref = tracking.track(d, model, k, cfg["fusion"], min_inl)
            found = tracking.matmul(prev, t)
            lost_mismatch += int(lost_ref != lost[i])
            if not lost_ref:
                g_mm, g_mrad = tracking.pose_gap(found, out_poses[i])
                gap_mm, gap_mrad = max(gap_mm, g_mm), max(gap_mrad, g_mrad)
        if not lost[i]:
            ref.integrate(grid, d, ref.inverse(out_poses[i]), k)
    mismatch, tsdf_gap = ref.volume_gaps(volume.tsdf, volume.weight,
                                         grid.tsdf, grid.weight)
    lim = ctx.limits
    return [("pose_gap_mm", gap_mm, lim["pose_gap_mm"]),
            ("pose_gap_mrad", gap_mrad, lim["pose_gap_mrad"]),
            ("lost_mismatch", lost_mismatch, lim["lost_mismatch"]),
            ("weight_mismatch", mismatch, lim["weight_mismatch"]),
            ("tsdf_gap_mm", tsdf_gap, lim["tsdf_gap_mm"])]
