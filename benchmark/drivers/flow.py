"""Non-rigid fusion of a moving scene:
``tsdf_tpu_torch.pipelines.scenefusion.SceneFusion.process_frames``, one
frame in flight, each frame with its scene flow from a provider that
hands over the precomputed flow.

Set-up makes one period of depth and flow on the device and fuses
``warmup`` frames; the window cycles the period. A frame whose extraction
overflowed ``max_cubes`` counts as failed.

The check follows the program from its own state, one frame at a time,
since each frame's update starts from all frames before it: at
``check_frames`` points of the window, drawn from the seed as shares of
its time, the harness copies the volume (tsdf, weight, deformation)
before the frame there and before the next; the reference makes the frame
from the first copy and is held to the second, and to the frame's count
of corresponding vertices. The start, which this skips, is checked apart:
the reference makes the warm-up frames from an empty volume and is held
to the state the window starts from. The copies go to pinned host
buffers made in set-up, each once the device has finished the frames
before it and before the next frame's hand-over, so that they hold no
device memory and lie in no frame's latency; their time is in the
window's and goes to standard error.
"""

from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch

from harness import flowscene
from harness.common import Ctx, FrameWindow, Outcome, memory_peak
from reference import fusion as ref
from reference import scenefusion as ref_sf


class _Frames:
    """The RGB-D source the class observes; the harness calls it."""

    def add_observer(self, callback) -> None:
        self.callback = callback


class _Flow:
    """The scene-flow provider: hands over the current frame's flow."""

    current = None

    def compute_scene_flow(self, depth, colour=None):
        return None, None, self.current


class _Copies:
    """Pinned host buffers for the check's copies of the volume's state
    (tsdf, weight, deformation), made in set-up."""

    def __init__(self, volume, n: int):
        pin = volume.tsdf.device.type == "cuda"
        self.free = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                           for t in (volume.tsdf, volume.weight, volume.deform))
                     for _ in range(n)]
        self.seconds = 0.0
        self.count = 0

    def take(self, volume, window: FrameWindow) -> tuple:
        t0 = time.perf_counter()
        bufs = self.free.pop()
        for buf, t in zip(bufs, (volume.tsdf, volume.weight, volume.deform)):
            buf.copy_(t, non_blocking=True)
        window.ctx.sync()
        if window.tracer and window.tracer.active:
            window.tracer.harness_syncs += 1
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return bufs


def run(ctx: Ctx) -> Outcome:
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.scenefusion import SceneFusion, SceneFusionConfig

    cfg = ctx.config
    vol, cam, sfc = cfg["volume"], cfg["camera"], cfg["scenefusion"]
    depth, flow = flowscene.make_cycle(cfg, ctx.seed, ctx.device)
    period = depth.shape[0]
    config = SceneFusionConfig(
        volume_size=(vol["size"],) * 3, physical_size_mm=vol["physical_mm"],
        offset_mm=tuple(vol["offset_mm"]), threshold_mm=sfc["threshold_mm"],
        max_cubes=sfc["max_cubes"], max_vertices=sfc["max_vertices"])
    camera = Camera.from_intrinsics(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                    device=ctx.device)
    provider, source = _Flow(), _Frames()
    sf = SceneFusion(provider, source, config=config, camera=camera,
                     device=ctx.device)
    if ctx.storage != torch.float32:
        sf.volume = sf.volume.astype(ctx.storage)

    mix = ctx.traffic
    window = FrameWindow(ctx, warmup=int(mix["warmup_frames"]),
                         one_in_flight=True,
                         trace_frames=int(mix["trace_frames"]))
    rng = np.random.default_rng(ctx.seed)
    shares = sorted(rng.uniform(0.0, 0.95, size=int(mix["check_frames"])))
    copies = _Copies(sf.volume, 1 + 2 * len(shares))
    states: dict = {}
    checked: list = []

    def frame_at(i):
        # copies at frame boundaries, before the frame is handed over
        if i == window.warmup or (checked and checked[-1] == i - 1):
            states[i] = copies.take(sf.volume, window)
        elif i > window.warmup and shares and (
                time.perf_counter() - window.start >= shares[0] * ctx.seconds):
            while shares and (time.perf_counter() - window.start
                              >= shares[0] * ctx.seconds):
                shares.pop(0)
            checked.append(i)
            states[i] = copies.take(sf.volume, window)
        provider.current = flow[i % period]
        return depth[i % period]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for d in window.frames(frame_at):
            source.callback(d)
        window.close()
    overflowed = sum("max_cubes" in str(w.message) for w in caught)
    peak = memory_peak(ctx)
    print(f"flow check: {copies.count} copies of the state in the window, "
          f"{copies.seconds!r} s of its {window.seconds!r} s", file=sys.stderr)
    n = window.handed
    if checked and checked[-1] == n - 1:
        states[n] = copies.take(sf.volume, window)

    summary = None
    if window.tracer:
        summary = window.tracer.summarize(window.trace_frames, {})
    counts = [int(c) for c in sf.correspondence_counts]  # frame i at i - 1
    del sf
    checks = check(ctx, depth, flow, states, checked, counts, window.warmup)
    return Outcome(attempted=n, failed=overflowed,
                   metrics={"frames_per_s": window.rate(),
                            "frame_ms_p95": window.p95_ms()},
                   checks=checks, window_start=window.start,
                   memory_peak_bytes=peak, trace=summary)


def _grid(ctx: Ctx, state=None) -> ref.Grid:
    vol = ctx.config["volume"]
    grid = ref.make_grid(vol["size"], vol["physical_mm"], vol["offset_mm"],
                         device=ctx.device, deformation=True)
    if state is not None:
        grid.tsdf = state[0].to(ctx.device, torch.float32, copy=True)
        grid.weight = state[1].to(ctx.device, torch.float32, copy=True)
        grid.deform = state[2].to(ctx.device, copy=True)
    return grid


def _gaps(grid: ref.Grid, state) -> tuple[int, float, float]:
    tsdf, weight, deform = (t.to(grid.tsdf.device) for t in state)
    mismatch, tsdf_gap = ref.volume_gaps(tsdf, weight, grid.tsdf, grid.weight)
    deform_gap = float((deform - grid.deform).abs().nan_to_num(
        nan=float("inf")).max())
    return mismatch, tsdf_gap, deform_gap


def check(ctx: Ctx, depth, flow, states, checked, counts, warmup) -> list:
    cfg = ctx.config
    sfc = cfg["scenefusion"]
    k = ref.intrinsics(cfg["camera"], ctx.device)
    pose_inv = ref.inverse(torch.eye(4, dtype=torch.float32, device=ctx.device))
    period = depth.shape[0]
    corr_gap = 0
    worst = [0, 0.0, 0.0]

    def step(grid, i):
        nonlocal corr_gap
        if i == 0:
            ref.integrate(grid, depth[0], pose_inv, k)
            return
        n_corr, _over = ref_sf.frame(grid, depth[i % period], flow[i % period],
                                     pose_inv, k, sfc["max_cubes"],
                                     sfc["threshold_mm"])
        corr_gap += abs(n_corr - counts[i - 1])

    def hold(grid, state, what):
        gaps = _gaps(grid, state)
        print(f"flow check {what}: weight mismatch {gaps[0]}, tsdf gap "
              f"{gaps[1]!r} mm, deformation gap {gaps[2]!r} mm, "
              f"correspondences off by {corr_gap} so far", file=sys.stderr)
        for n, v in enumerate(gaps):
            worst[n] = max(worst[n], v)

    # the start: the warm-up frames from an empty volume
    grid = _grid(ctx)
    for i in range(warmup):
        step(grid, i)
    hold(grid, states[warmup], f"frames 0-{warmup - 1} from an empty volume")
    # the window: one frame from the program's own state
    for i in checked:
        grid = _grid(ctx, states[i])
        step(grid, i)
        hold(grid, states[i + 1], f"frame {i}")
    lim = ctx.limits
    return [("weight_mismatch", worst[0], lim["weight_mismatch"]),
            ("tsdf_gap_mm", worst[1], lim["tsdf_gap_mm"]),
            ("deform_gap_mm", worst[2], lim["deform_gap_mm"]),
            ("corr_mismatch", corr_gap, lim["corr_mismatch"])]
