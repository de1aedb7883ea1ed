"""Pose refinement through the differentiable render of a fused model:
``tsdf_tpu_torch.pipelines.pose_recovery.recover_pose_lm``, config 4's
Levenberg-Marquardt, called again and again.

Set-up fuses the model with the program's ``fuse_frames``: the even
frames of the cycle's first ``model_frames`` at their true poses. It
draws ``problems`` target frames from the seed among the odd frames of
that stretch, which the model never saw, each started from its true pose
composed with a twist of ``twist_mm`` and ``twist_mrad`` in random
directions; one recovery warms up. The window cycles the problems, one
recovery in flight, each ``iters`` steps with no early stop. A step with
a non-finite rms or proposal counts as failed.

The check follows the program's own state, as the tracked cell's follows
its poses. The reference fuses the same frames into its own grid, held to
the program's model. For every distinct (problem, step) of the run it
takes a step of its own from the twist and the damping the program's step
started from, and compares the rms, the proposed twist and the band's
inlier count (the program's ``lm.inliers`` counter, one a step). The
program's history must follow the configuration's trust rule from its own
rms and proposals (``chain_mismatch``), and every recovery of a problem
must repeat the first exactly (``repeat_mismatch``).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from harness import rigid, spans
from harness.common import Ctx, Outcome, Tracer, memory_peak
from reference import fusion as ref
from reference import lm as ref_lm
from reference.tracking import matmul, se3_exp


def problems(ctx: Ctx, stretch: int):
    """[(frame index, (6,) float32 twist (omega, v))] drawn from the seed
    among the odd frames of [0, stretch)."""
    mix = ctx.traffic
    rng = np.random.default_rng(ctx.seed)
    frames = rng.choice(np.arange(1, stretch, 2), size=int(mix["problems"]),
                        replace=False)
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
    from tsdf_tpu_torch.pipelines import kinfu
    from tsdf_tpu_torch.pipelines.pose_recovery import recover_pose_lm
    from tsdf_tpu_torch.utils.profiling import counting

    depth, poses = rigid.make_inputs(ctx)
    mix, lm = ctx.traffic, ctx.config["lm"]
    iters = int(mix["iters"])
    stretch = min(int(mix["model_frames"]), depth.shape[0])
    model = range(0, stretch, 2)
    fusion = rigid.fusion_config(ctx, tracked=False)
    volume = rigid.make_volume(ctx, fusion)
    cam = ctx.config["camera"]
    camera = Camera.from_intrinsics(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                    poses[0], device=ctx.device)
    volume, camera = kinfu.fuse_frames(volume, camera,
                                       ((depth[i], poses[i]) for i in model), fusion)
    inputs = []  # (start camera, target depth, start pose)
    for j, xi0 in problems(ctx, stretch):
        start = matmul(se3_exp(xi0), poses[j])
        inputs.append((camera.set_pose(start), depth[j], start))

    runs = []  # (problem, history, the run's counters)

    def recover(p):
        start_camera, target, _start = inputs[p]
        with counting() as counts:
            _xi, history = recover_pose_lm(volume, start_camera, target, iters=iters,
                                           max_steps=int(lm["max_steps"]), stop=None)
        runs.append((p, history, counts))

    recover(0)  # set-up
    if "xi" not in runs[0][1][0]:
        raise SystemExit("recover_pose_lm records no twists (xi, xi_new) in its "
                         "history: the check cannot take the program's steps")
    ctx.sync()
    tracer = Tracer(ctx) if ctx.trace else None
    traced = int(mix["trace_recoveries"]) if tracer else 0
    if tracer:
        tracer.start()
    start = time.perf_counter()
    n, ends = 0, []
    while time.perf_counter() - start < ctx.seconds:
        recover((n + 1) % len(inputs))
        n += 1
        ends.append(time.perf_counter())
        if n == traced:
            tracer.stop()
    ctx.sync()
    window_s = time.perf_counter() - start
    print_stretches(ends, start, iters)
    if tracer and n < traced:
        tracer.stop()
    peak = memory_peak(ctx)

    summary = None
    if tracer:
        counters: dict = {}
        for _p, _h, counts in runs[1:1 + min(n, traced)]:
            for name, value in counts.totals().items():
                counters[name] = counters.get(name, 0) + value
        extras = {"counters": counters, "rays_per_step": cam["width"] * cam["height"]}
        summary = spans.summarize(tracer, min(n, traced) * iters, extras, "lm.")
    records = read_back(runs)
    failed = sum(not (math.isfinite(r["rms"]) and bool(torch.isfinite(r["xi_new"]).all()))
                 for _p, recs in records for r in recs)
    checks = check(ctx, volume, depth, poses, model, inputs, records)
    return Outcome(attempted=len(runs) * iters, failed=failed,
                   metrics={"steps_per_s": n * iters / window_s},
                   checks=checks, window_start=start,
                   memory_peak_bytes=peak, trace=summary)


def print_stretches(ends, start: float, iters: int, stretch_s: float = 5.0) -> None:
    """The window's rate in steps a second over each ``stretch_s`` of it
    (by the recoveries that ended in it), to standard error: whether the
    host's speed moved within the run."""
    counts: dict = {}
    for t in ends:
        k = int((t - start) // stretch_s)
        counts[k] = counts.get(k, 0) + iters
    rates = [round(counts.get(k, 0) / stretch_s, 3) for k in range(max(counts, default=-1) + 1)]
    print(f"lm window: steps/s by {stretch_s:g} s stretch {rates}", file=sys.stderr)


def read_back(runs):
    """[(problem, [record a step])] on the host, after the window: each
    record the program's rms, damping after the step, acceptance, the
    twist the step started from, its proposal, and its band inliers."""
    out = []
    for p, history, counts in runs:
        xi = torch.stack([h["xi"] for h in history]).cpu()
        xi_new = torch.stack([h["xi_new"] for h in history]).cpu()
        inliers = counts.tensors.get("lm.inliers", [])
        inliers = (torch.stack([t.reshape(()) for t in inliers]).cpu().tolist()
                   if len(inliers) == len(history) else [-1] * len(history))
        out.append((p, [dict(rms=h["rms"], lam=h["lam"], accepted=h["accepted"],
                             xi=xi[k], xi_new=xi_new[k], inliers=int(inliers[k]))
                        for k, h in enumerate(history)]))
    return out


def chain_gaps(lm: dict, recs) -> tuple[int, list]:
    """(steps whose record breaks the trust rule, the damping each step
    started from): from xi = 0 and lam0, a step within ``accept_ratio``
    of the best rms is taken (the next step starts from its proposal, lam
    falls to ``lam_down`` of itself, not below ``lam_min``), else lam
    grows ``lam_up`` times, to at most ``lam_max``."""
    lam, best = float(lm["lam0"]), math.inf
    xi = torch.zeros(6, dtype=recs[0]["xi"].dtype)
    bad, used = 0, []
    for r in recs:
        used.append(lam)
        accept = r["rms"] <= best * lm["accept_ratio"]
        ok = torch.equal(r["xi"], xi) and accept == r["accepted"]
        if accept:
            xi, best = r["xi_new"], min(best, r["rms"])
            lam = max(lam * lm["lam_down"], lm["lam_min"])
        else:
            lam = min(lam * lm["lam_up"], lm["lam_max"])
        bad += int(not (ok and lam == r["lam"]))
    return bad, used


def _same(a, b) -> bool:
    """Two recoveries of one problem alike step for step: rms, acceptance,
    proposal and band inliers."""
    return (len(a) == len(b)
            and all(x["inliers"] == y["inliers"] and x["accepted"] == y["accepted"]
                    and (x["rms"] == y["rms"] or (math.isnan(x["rms"]) and math.isnan(y["rms"])))
                    and torch.equal(x["xi_new"], y["xi_new"])
                    for x, y in zip(a, b)))


def check(ctx: Ctx, volume, depth, poses, model, inputs, records) -> list:
    cfg = ctx.config
    cam, lm = cfg["camera"], cfg["lm"]
    k = ref.intrinsics(cam, ctx.device)
    grid = rigid.reference_grid(ctx)
    for i in model:
        ref.integrate(grid, depth[i], ref.inverse(poses[i]), k)
    mismatch, tsdf_gap = ref.volume_gaps(volume.tsdf, volume.weight,
                                         grid.tsdf, grid.weight)
    first: dict = {}
    repeats = chains = 0
    for p, recs in records:
        bad, _used = chain_gaps(lm, recs)
        chains += bad
        if p in first:
            repeats += int(not _same(first[p], recs))
        else:
            first[p] = recs
    rms_gap = v_gap = w_gap = 0.0
    inl = 0
    for p, recs in sorted(first.items()):
        _cam, target, start = inputs[p]
        _bad, used = chain_gaps(lm, recs)
        gaps = []
        for r, lam in zip(recs, used):
            out = ref_lm.step(grid, target, start, r["xi"].to(ctx.device), lam, k,
                              float(lm["band_mm"]), int(lm["max_steps"]))
            d = out.xi_new.cpu() - r["xi_new"].to(torch.float64)
            finite = bool(torch.isfinite(d).all())
            g = (_rel(r["rms"], out.rms),
                 float(d[3:].norm()) if finite else math.inf,
                 float(d[:3].norm()) * 1e3 if finite else math.inf,
                 abs(r["inliers"] - out.inliers))
            gaps.append(g)
            rms_gap, v_gap = max(rms_gap, g[0]), max(v_gap, g[1])
            w_gap, inl = max(w_gap, g[2]), max(inl, g[3])
        print(f"lm problem {p}: gaps a step (rms, mm, mrad, inliers) "
              f"{[(f'{a:.3g}', f'{b:.3g}', f'{c:.3g}', e) for a, b, c, e in gaps]}; "
              f"rms {[round(r['rms'], 4) for r in recs]}", file=sys.stderr)
    print(f"lm check: {len(records)} recoveries of {len(first)} problems; "
          f"{repeats} repeats differ from their first; {chains} steps off the trust rule",
          file=sys.stderr)
    lim = ctx.limits
    return [("rms_gap", rms_gap, lim["rms_gap"]),
            ("step_gap_mm", v_gap, lim["step_gap_mm"]),
            ("step_gap_mrad", w_gap, lim["step_gap_mrad"]),
            ("inlier_mismatch", inl, lim["inlier_mismatch"]),
            ("weight_mismatch", mismatch, lim["weight_mismatch"]),
            ("tsdf_gap_mm", tsdf_gap, lim["tsdf_gap_mm"]),
            ("repeat_mismatch", repeats, lim["repeat_mismatch"]),
            ("chain_mismatch", chains, lim["chain_mismatch"])]


def _rel(a: float, b: float) -> float:
    """|a - b| relative to |b|; a non-finite reading on either side is the
    largest gap."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)
