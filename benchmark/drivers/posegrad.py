"""Pose refinement through differentiable fusion:
``tsdf_tpu_torch.pipelines.pose_recovery.descend_through_fusion``, called
again and again, each call a recovery of config4b's formulation.

Set-up draws ``problems`` recoveries from the seed: a frame of the
configuration's cycle, its true pose, and a twist of config4b's size
(``twist_mm`` and ``twist_mrad`` in random directions) to start from; the
program fuses each target at the true pose into an empty volume, and one
recovery warms up. The window cycles the recoveries. A value-and-grad
step with a non-finite loss counts as failed.

The check: each problem's descent is fixed by its inputs, so the
reference runs it once, from its own target, and every recovery of the
run is held to it at its start: the loss of the first
``compare_loss_steps`` steps, and the norms of the twist after each of the
first ``compare_steps``. Its end is held from the program's own twist:
the reference's loss at the best twist the program returns has to be the
loss the program returns with it, and no worse than any loss the program
reported on the way.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from harness import bounds, rigid
from harness.common import Ctx, Outcome, Tracer, memory_peak
from reference import fusion as ref
from reference import posegrad as ref_pg


def problems(ctx: Ctx, depth, poses):
    """[(frame index, (6,) float32 twist (omega, v))] drawn from the seed."""
    mix = ctx.traffic
    rng = np.random.default_rng(ctx.seed)
    frames = rng.choice(depth.shape[0], size=int(mix["problems"]), replace=False)
    out = []
    for j in frames:
        w = rng.normal(size=3)
        v = rng.normal(size=3)
        w = w / np.linalg.norm(w) * mix["twist_mrad"] * 1e-3
        v = v / np.linalg.norm(v) * mix["twist_mm"]
        out.append((int(j), torch.tensor(np.concatenate([w, v]), dtype=torch.float32,
                                         device=ctx.device)))
    return out


def run(ctx: Ctx) -> Outcome:
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.kernels.integrate import integrate_pose
    from tsdf_tpu_torch.pipelines.pose_recovery import descend_through_fusion

    depth, poses = rigid.make_inputs(ctx)
    mix = ctx.traffic
    steps = int(mix["steps"])
    fusion = rigid.fusion_config(ctx, tracked=False)
    base = rigid.make_volume(ctx, fusion)
    cam = ctx.config["camera"]
    probs = problems(ctx, depth, poses)
    inputs = []
    with torch.no_grad():
        for j, delta0 in probs:
            camera = Camera.from_intrinsics(cam["fx"], cam["fy"], cam["cx"],
                                            cam["cy"], poses[j], device=ctx.device)
            target, _miss = integrate_pose(base, depth[j], camera,
                                           torch.zeros(6, device=ctx.device))
            inputs.append((depth[j], camera, target, delta0))

    runs = []  # (problem, history, best delta, best loss)

    def recover(p):
        d, camera, target, delta0 = inputs[p]
        best, best_loss, history = descend_through_fusion(
            base, d, camera, target, delta0, steps=steps)
        runs.append((p, history, best, best_loss))

    recover(0)  # set-up
    ctx.sync()
    tracer = Tracer(ctx) if ctx.trace else None
    traced = int(mix["trace_recoveries"]) if tracer else 0
    if tracer:
        tracer.start()
    start = time.perf_counter()
    n = 0
    while time.perf_counter() - start < ctx.seconds:
        recover((n + 1) % len(inputs))
        n += 1
        if n == traced:
            tracer.stop()
    ctx.sync()
    window_s = time.perf_counter() - start
    if tracer and n < traced:
        tracer.stop()
    peak = memory_peak(ctx)

    references = reference_descents(ctx, depth, poses, probs, steps)
    summary = None
    if tracer:
        summary = tracer.summarize(
            min(n, traced) * (steps + 1),
            {"pose_grad_bound_s": adjoint_bound(references,
                                                [(m + 1) % len(inputs)
                                                 for m in range(min(n, traced))])})
    failed = sum(not math.isfinite(h["loss"]) for _p, hist, _b, _l in runs
                 for h in hist)
    checks = check(ctx, runs, references)
    return Outcome(attempted=len(runs) * (steps + 1), failed=failed,
                   metrics={"steps_per_s": n * (steps + 1) / window_s},
                   checks=checks, window_start=start,
                   memory_peak_bytes=peak, trace=summary)


def reference_descents(ctx: Ctx, depth, poses, probs, steps):
    """The reference's descent of each problem: (problem, best loss,
    history, deltas)."""
    k = ref.intrinsics(ctx.config["camera"], ctx.device)
    grid = rigid.reference_grid(ctx)
    mix = ctx.traffic
    out = []
    for j, delta0 in probs:
        problem = ref_pg.Problem(grid, depth[j], poses[j], k)
        best_loss, _best, history, deltas = ref_pg.descend(
            problem, delta0, steps, mix["rot_step"], mix["trans_step_mm"])
        out.append((problem, best_loss, history, deltas))
    return out


def adjoint_bound(references, traced) -> float:
    """The least time of the traced recoveries' pose adjoints: one a
    value-and-grad step, at the twist the step starts from."""
    cache: dict = {}
    total = 0.0
    for p in traced:
        if p not in cache:
            problem, _bl, _h, deltas = references[p]
            n_vox = problem.grid.tsdf.numel()
            cache[p] = sum(
                bounds.pose_grad_bound_s(
                    n_vox,
                    bounds.voxels_in_front(problem.grid.axis_centres(),
                                           ref_pg.twisted_inverse(problem, d)),
                    *ref_pg.counts(problem, d), problem.depth.numel())
                for d in deltas)
        total += cache[p]
    return total


def check(ctx: Ctx, runs, references) -> list:
    """Every recovery against the reference: its first steps against the
    reference's descent, and its best twist and loss from the program's
    own twist.

    The first ``compare_loss_steps`` losses and the first
    ``compare_steps`` twists' norms are held to the reference's descent
    (the loss of step 2 is taken at the twist the first step made, so it
    holds that step's direction). Later steps start from twists that
    rounding has parted, and a gradient whose direction turns on a few
    voxels parts them further, so they have no reading that holds (every
    step's gaps go to standard error). The end is held instead at the
    program's own best twist: ``best_gap`` is the larger of the gap
    between the loss the program returns and the reference's loss at its
    twist, and the amount by which that loss exceeds the least loss the
    program reported, both relative to the reference's loss."""
    mix = ctx.traffic
    compare, compare_loss = int(mix["compare_steps"]), int(mix["compare_loss_steps"])
    loss_gap = v_gap = w_gap = best_gap = 0.0
    seen = set()
    at_best: dict = {}
    for p, history, best, best_loss in runs:
        problem, _ref_best, ref_hist, _deltas = references[p]
        gaps = [(_rel(h["loss"], lv), _abs(h["v_mm"], v), _abs(h["w_mrad"], w))
                for h, (lv, v, w) in zip(history, ref_hist, strict=True)]
        if p not in seen:
            seen.add(p)
            print(f"posegrad problem {p}: gaps a step (loss, mm, mrad) "
                  f"{[tuple(f'{x:.3g}' for x in g) for g in gaps]}", file=sys.stderr)
        loss_gap = max([loss_gap] + [lg for lg, _v, _w in gaps[:compare_loss]])
        v_gap = max([v_gap] + [vg for _l, vg, _w in gaps[:compare]])
        w_gap = max([w_gap] + [wg for _l, _v, wg in gaps[:compare]])
        key = (p, tuple(best.tolist()))
        if key not in at_best:
            ref_loss = at_best[key] = float(problem.loss_and_grad(best.detach())[0])
            losses = [h["loss"] for h in history]
            least = min(losses) if all(map(math.isfinite, losses)) else math.inf
            gap = max(_abs(best_loss, ref_loss), ref_loss - least) / max(abs(ref_loss), 1e-30)
            print(f"posegrad problem {p}: best loss {best_loss!r}, the reference's "
                  f"at its twist {ref_loss!r}, least reported {least!r}: "
                  f"gap {gap!r}", file=sys.stderr)
            best_gap = max(best_gap, gap)
    print(f"posegrad check: {len(at_best)} distinct best twists over "
          f"{len(seen)} problems", file=sys.stderr)
    lim = ctx.limits
    return [("loss_gap", loss_gap, lim["loss_gap"]),
            ("step_gap_mm", v_gap, lim["step_gap_mm"]),
            ("step_gap_mrad", w_gap, lim["step_gap_mrad"]),
            ("best_gap", best_gap, lim["best_gap"])]


def _abs(a: float, b: float) -> float:
    """|a - b|; a non-finite reading on either side is the largest gap."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return float("inf")
    return abs(a - b)


def _rel(a: float, b: float) -> float:
    """|a - b| relative to |b|."""
    return _abs(a, b) / max(abs(b), 1e-30)
