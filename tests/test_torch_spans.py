"""The program's spans and counters (``tsdf_tpu_torch/utils/profiling.py``:
``trace``, ``count``, ``count_tensor``, ``counting``) at the layer
boundaries of the tracked loop, SceneFusion, the pose step through fusion
and the Levenberg-Marquardt step through the raycast, on the CPU.

Under a CPU ``torch.profiler`` each pipeline emits its named spans, nested as
the layers call each other and carrying their frame or step index; with no
profiler and counting closed nothing is recorded and no operator is
added; the counters equal what the host knows; ``fuse --profile`` and
``sfusion --profile`` write a trace and ``counters.json``.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tsdf_tpu_torch import Camera
from tsdf_tpu_torch.cli import main as torch_main
from tsdf_tpu_torch.io.png import save_png
from tsdf_tpu_torch.kernels.integrate import integrate_pose
from tsdf_tpu_torch.pipelines import kinfu, pose_recovery
from tsdf_tpu_torch.pipelines import scenefusion as tsf
from tsdf_tpu_torch.pipelines.kinfu import FusionConfig
from tsdf_tpu_torch.utils import fixtures, profiling

CPU = torch.device("cpu")
W, H = 80, 60
INTR = (73.9, 73.8, 41.4, 29.3)
PROGRAM = ("kinfu.", "icp.", "sfusion.", "pose.", "lm.")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera():
    return (Camera.from_intrinsics(*INTR, device=CPU)
            .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))


def _depth():
    """(H, W) float32 mm: a sphere bump in front of a wall at 1500 mm."""
    d = fixtures.sphere_depth_map(W, H, 25.0, 800.0, 1400.0).astype(np.float32)
    return np.where(d > 0, d, 1500.0).astype(np.float32)


def _config(**kw):
    return FusionConfig(volume_size=(32,) * 3, physical_size_mm=2000.0,
                        offset_mm=(-1000.0, -1000.0, 0.0), width=W, height=H,
                        **kw)


def _spans(prof):
    """[(name, index or None, parent span's name or None)] of the
    program's spans in the order they began."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PROGRAM):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(PROGRAM):
            parent = parent.cpu_parent
        out.append((e.name, e.kwinputs.get("index"),
                    None if parent is None else parent.name))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    return out, _spans(prof)


def _tracked(frames, **kw):
    cfg = _config(use_bilateral_filter=True, **kw)
    return kinfu.track_and_fuse_frames(
        cfg.make_volume(device=CPU), _camera(),
        [torch.from_numpy(f) for f in frames], cfg)


def test_tracked_loop_spans_nest_with_their_frame():
    base = _depth()
    (_vol, _cam, _poses, _stats), spans = _profiled(
        lambda: _tracked([base, np.roll(base, 2, axis=0), base]))
    frames = [(n, i) for n, i, p in spans if n == "kinfu.frame"]
    assert frames == [("kinfu.frame", 0), ("kinfu.frame", 1), ("kinfu.frame", 2)]
    assert all(p is None for n, _i, p in spans if n == "kinfu.frame")
    # the first frame is integrated at the camera's pose: no tracking
    first = spans[:2]
    assert first == [("kinfu.frame", 0, None), ("kinfu.integrate", None, "kinfu.frame")]
    tracked = [(n, p) for n, _i, p in spans[2:] if n != "kinfu.frame"]
    per_frame = [
        ("kinfu.bilateral", "kinfu.frame"), ("kinfu.raycast", "kinfu.frame"),
        ("kinfu.icp", "kinfu.frame"), ("icp.maps", "kinfu.icp"),
        ("icp.level2", "kinfu.icp"), ("icp.level1", "kinfu.icp"),
        ("icp.level0", "kinfu.icp"), ("kinfu.integrate", "kinfu.frame"),
    ]
    assert tracked == per_frame * 2


def test_fallback_span_holds_the_exact_icp():
    base = _depth()
    _out, spans = _profiled(lambda: _tracked(
        [base, np.roll(base, 12, axis=0)], icp_band=1, icp_min_inliers_frac=0.5))
    names = [(n, p) for n, _i, p in spans]
    assert ("kinfu.icp_exact", "kinfu.frame") in names
    exact = names[names.index(("kinfu.icp_exact", "kinfu.frame")):]
    assert exact[1:5] == [("icp.maps", "kinfu.icp_exact"),
                          ("icp.level2", "kinfu.icp_exact"),
                          ("icp.level1", "kinfu.icp_exact"),
                          ("icp.level0", "kinfu.icp_exact")]


def test_fuse_frames_spans():
    cfg = _config(use_bilateral_filter=True)
    depth = torch.from_numpy(_depth())
    pose = _camera().pose
    with profiling.counting() as counts:
        _out, spans = _profiled(lambda: kinfu.fuse_frames(
            cfg.make_volume(device=CPU), _camera(), [(depth, pose)] * 2, cfg))
    assert spans == [("kinfu.frame", 0, None),
                     ("kinfu.bilateral", None, "kinfu.frame"),
                     ("kinfu.integrate", None, "kinfu.frame"),
                     ("kinfu.frame", 1, None),
                     ("kinfu.bilateral", None, "kinfu.frame"),
                     ("kinfu.integrate", None, "kinfu.frame")]
    assert counts.totals() == {"kinfu.frames": 2}


class _Frames:
    def add_observer(self, callback):
        self.callback = callback


class _Flow:
    def compute_scene_flow(self, depth, colour=None):
        return None, None, np.full((H, W, 3), (4.0, 0.0, 0.0), np.float32)


def _scenefusion():
    cfg = tsf.SceneFusionConfig(volume_size=(32,) * 3, physical_size_mm=2000.0,
                                offset_mm=(-1000.0, -1000.0, 0.0),
                                max_cubes=1 << 12, max_vertices=1 << 14)
    source = _Frames()
    sf = tsf.SceneFusion(_Flow(), source, cfg, camera=_camera(), device=CPU)
    return sf, source


def test_scenefusion_spans_and_counters():
    sf, source = _scenefusion()
    depth = _depth()
    with profiling.counting() as counts:
        _out, spans = _profiled(lambda: [source.callback(depth) for _ in range(3)])
    assert [(n, i) for n, i, _p in spans if n == "sfusion.frame"] == [
        ("sfusion.frame", 0), ("sfusion.frame", 1), ("sfusion.frame", 2)]
    # the first frame integrates; each later one is scenefusion_step
    step = [("sfusion.extract", "sfusion.frame"),
            ("sfusion.update", "sfusion.frame"),
            ("sfusion.correspond", "sfusion.update"),
            ("sfusion.scatter", "sfusion.update"),
            ("sfusion.integrate", "sfusion.frame")]
    inner = [(n, p) for n, _i, p in spans if n != "sfusion.frame"]
    assert inner == step * 2
    totals = counts.totals()
    n_corr = [int(n) for n in sf.correspondence_counts]
    assert min(n_corr) > 0
    assert totals == {"sfusion.correspondences": sum(n_corr),
                      "sfusion.frames": 3, "sfusion.overflows": 0,
                      # 24 vertex slots a cube in the masked layout
                      "sfusion.slots": 2 * 24 * (1 << 12)}


def test_pose_step_spans():
    cfg = _config()
    depth = torch.from_numpy(_depth())
    camera = _camera()
    base = cfg.make_volume(device=CPU)
    target, _miss = integrate_pose(base, depth, camera, torch.zeros(6))
    delta0 = torch.tensor([1e-3, 0.0, 0.0, 5.0, 0.0, 0.0])
    with profiling.counting() as counts:
        (_best, _loss, history), spans = _profiled(
            lambda: pose_recovery.descend_through_fusion(
                base, depth, camera, target, delta0, steps=2))
    assert len(history) == 2
    one = [("pose.forward", None, "pose.step"), ("pose.loss", None, "pose.step"),
           ("pose.backward", None, "pose.step"), ("pose.update", None, "pose.step")]
    assert spans == sum(([("pose.step", i, None)] + one for i in range(3)), [])
    assert counts.totals() == {"pose.steps": 3}


def _lm_problem():
    """(volume, start camera, target) of the Levenberg-Marquardt tests:
    the sphere and wall fused at the camera, recovered from 20 mm off."""
    cfg = _config()
    camera = _camera()
    depth = torch.from_numpy(_depth())
    vol, _ = kinfu.fuse_frames(cfg.make_volume(device=CPU), camera,
                               [(depth, camera.pose)] * 2, cfg)
    return vol, camera.move_to([20.0, 0.0, -400.0]), depth


LM_STEP = [("lm.march", None, "lm.step"), ("lm.jacobian", None, "lm.step"),
           ("lm.solve", None, "lm.step"), ("lm.update", None, "lm.step")]


def test_lm_step_spans_and_counters(monkeypatch):
    vol, start, target = _lm_problem()
    masks = []
    linearise = pose_recovery.lm_linearise

    def spy(*args, **kwargs):
        sums, rows = linearise(*args, rows=True, **kwargs)
        masks.append(int(rows[:, 7].sum()))
        return sums

    monkeypatch.setattr(pose_recovery, "lm_linearise", spy)
    with profiling.counting() as counts:
        (_xi, history), spans = _profiled(
            lambda: pose_recovery.recover_pose_lm(vol, start, target, iters=3))
    assert spans == sum(([("lm.step", i, None)] + LM_STEP for i in range(3)), [])
    # one linearisation a step, on the CPU its plain twin: lm.linearised
    # counts only the kernel's
    assert len(masks) == 3
    totals = counts.totals()
    assert totals == {"lm.accepted": sum(h["accepted"] for h in history),
                      "lm.inliers": sum(masks), "lm.steps": 3}
    assert 0 < totals["lm.inliers"] <= 3 * W * H
    assert isinstance(totals["lm.inliers"], int)


class _Reads(TorchDispatchMode):
    """Counts the host reads of tensor values (a scalar read is the sync
    on the card), except inside the CPU twin of the raycast march: on the
    card the march is one kernel launch with no read."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default and not self.paused:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("traced", [False, True])
def test_lm_step_reads_the_host_once(traced, monkeypatch):
    vol, start, target = _lm_problem()
    march = pose_recovery.march
    mode = _Reads()

    def twin(*args, **kwargs):
        mode.paused = True
        try:
            return march(*args, **kwargs)
        finally:
            mode.paused = False

    monkeypatch.setattr(pose_recovery, "march", twin)
    ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with ctx, profiling.counting(), mode:
        _xi, history = pose_recovery.recover_pose_lm(vol, start, target, iters=3)
    assert len(history) == 3 and mode.n == 3


def test_lm_history_holds_the_twists_the_steps_used(monkeypatch):
    vol, start, target = _lm_problem()
    calls = []
    step = pose_recovery.lm_step

    def spy(vol, camera, target, xi, lam, max_steps):
        out = step(vol, camera, target, xi, lam, max_steps)
        calls.append((xi, lam, out[0]))
        return out

    monkeypatch.setattr(pose_recovery, "lm_step", spy)
    xi, history = pose_recovery.recover_pose_lm(vol, start, target, iters=4)
    assert len(calls) == len(history) == 4
    lam = pose_recovery.LAM0
    for h, (xi_in, lam_in, xi_new) in zip(history, calls):
        assert h["xi"] is xi_in and h["xi_new"] is xi_new
        assert lam_in == lam
        lam = h["lam"]
    assert torch.equal(history[0]["xi"], torch.zeros(6))
    for a, b in zip(history, history[1:]):
        assert b["xi"] is (a["xi_new"] if a["accepted"] else a["xi"])
    taken = [h["xi_new"] for h in history if h["accepted"]]
    assert xi is (taken[-1] if taken else history[0]["xi"])


def test_off_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    assert profiling.trace("x") is profiling.trace("y", 3)
    profiling.count("x", 2)
    profiling.count_tensor("x", torch.ones(()))
    base = _depth()
    _tracked([base, np.roll(base, 2, axis=0)])
    sf, source = _scenefusion()
    source.callback(base)
    source.callback(base)
    with pytest.raises(AssertionError, match="tracing off"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.trace("x"):
                pass


class _Ops(TorchDispatchMode):
    """Counts the operators that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_tracing_adds_no_operator():
    base = _depth()
    frames = [base, np.roll(base, 2, axis=0)]

    def ops(traced):
        ctx = (profile(activities=[ProfilerActivity.CPU]) if traced
               else contextlib.nullcontext())
        with ctx, profiling.counting(), _Ops() as mode:
            _tracked(frames)
        return mode.n

    off = ops(False)
    assert off > 0 and ops(True) == off


def test_counters_equal_what_the_host_knows(monkeypatch):
    calls = []
    icp = kinfu.get_incremental_transformation

    def spy(*args, **kwargs):
        calls.append(kwargs.get("band"))
        return icp(*args, **kwargs)

    monkeypatch.setattr(kinfu, "get_incremental_transformation", spy)
    base = _depth()
    # a frame the band misses (the exact rerun tracks it), a frame with no
    # depth (the rerun loses it), then the first frame again
    frames = [base, np.roll(base, 12, axis=0), np.zeros_like(base), base]
    with profiling.counting() as counts:
        _vol, _cam, _poses, stats = _tracked(frames, icp_band=1,
                                             icp_min_inliers_frac=0.5)
    totals = counts.totals()
    min_inl = 0.5 * W * H
    inliers = [float(s[1]) for s in stats[1:]]
    assert totals["kinfu.frames"] == len(frames)
    assert totals["kinfu.icp_fallbacks"] == calls.count(None) >= 2
    assert totals["kinfu.lost"] == sum(i < min_inl for i in inliers) >= 1
    assert totals["icp.inliers"] == sum(inliers)
    assert isinstance(totals["icp.inliers"], float)


def test_count_tensor_totals_sum_the_tensors():
    ints = [torch.tensor(3, dtype=torch.int32), torch.tensor(4, dtype=torch.int32)]
    floats = [torch.tensor(0.5), torch.tensor(2.25)]
    with profiling.counting() as outer:
        profiling.count("frames")
        with profiling.counting() as inner:
            profiling.count("frames", 5)
            for t in ints:
                profiling.count_tensor("slots", t)
        for t in floats:
            profiling.count_tensor("inliers", t)
        profiling.count("frames", 2)
    profiling.count("frames")  # closed: nothing counts
    assert inner.totals() == {"frames": 5, "slots": 7}
    assert isinstance(inner.totals()["slots"], int)
    assert outer.totals() == {"frames": 3, "inliers": 2.75}
    # kept by reference: no copy is made
    assert inner.tensors["slots"][0] is ints[0]
    assert profiling._COUNTS is None


def _tum_dir(root, n):
    os.makedirs(root / "depth")
    lines = []
    for i in range(n):
        save_png(root / "depth" / f"{i}.0.png", (_depth() * 5).astype(np.uint16))
        lines.append(f"{i}.0 0 0 -0.4 0 0 0 1")
    (root / "ground_truth.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def _trace_names(directory):
    traces = [p for p in os.listdir(directory) if p.endswith(".json")
              and p != "counters.json"]
    assert len(traces) == 1
    with open(os.path.join(directory, traces[0])) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_fuse_profile_writes_trace_and_counters(tmp_path, capsys):
    data = _tum_dir(tmp_path / "tum", 2)
    out = tmp_path / "out"
    os.makedirs(out)
    prof = str(tmp_path / "prof")
    args = ["fuse", "-d", data, "-m", "2", "-s", "16", "--device", "cpu",
            "--track", "--scene", str(out / "s.png"), "--normals",
            str(out / "n.png"), "--mesh", str(out / "m.ply"),
            "--fx", "73.9", "--fy", "73.8", "--cx", "41.4", "--cy", "29.3",
            "--width", str(W), "--height", str(H), "--profile", prof]
    assert torch_main(args) == 0
    names = _trace_names(prof)
    assert {"kinfu.frame", "kinfu.icp", "icp.level0", "kinfu.integrate"} <= names
    with open(os.path.join(prof, "counters.json")) as f:
        counters = json.load(f)
    assert counters["kinfu.frames"] == 2 and counters["kinfu.icp_fallbacks"] in (0, 1)
    assert "counters.json" in capsys.readouterr().out
    assert torch_main(args + ["--devices", "1x1"]) == 1
    assert "--profile" in capsys.readouterr().err


def _write_pdflow(path, flow_mm):
    ys, xs = np.mgrid[0:H, 0:W]
    fx_, fy_, fz_ = (v / 1000.0 for v in flow_mm)
    rows = np.stack([ys.ravel(), xs.ravel(), np.full(H * W, fz_),
                     np.full(H * W, fx_), np.full(H * W, fy_)], axis=1)
    np.savetxt(path, rows, fmt=["%d", "%d", "%.6f", "%.6f", "%.6f"])


def test_sfusion_profile_writes_trace_and_counters(tmp_path):
    data = tmp_path / "rgbd"
    os.makedirs(data)
    for i in range(3):
        save_png(data / f"depth_{i:05d}.png", _depth().astype(np.uint16))
        save_png(data / f"colour_{i:05d}.png", np.zeros((H, W, 3), np.uint8))
        _write_pdflow(data / f"sflow_{i:05d}_results01.txt", (4.0, 0.0, 0.0))
    prof = str(tmp_path / "prof")
    assert torch_main(["sfusion", str(data), str(data), "-s", "32",
                       "--physical", "2000", "--max-cubes", str(1 << 12),
                       "--mesh", str(tmp_path / "m.ply"), "--device", "cpu",
                       "--fx", "73.9", "--fy", "73.8", "--cx", "41.4",
                       "--cy", "29.3", "--width", str(W), "--height", str(H),
                       "--profile", prof]) == 0
    assert {"sfusion.frame", "sfusion.update", "sfusion.scatter"} <= _trace_names(prof)
    with open(os.path.join(prof, "counters.json")) as f:
        counters = json.load(f)
    assert counters["sfusion.frames"] == 3 and counters["sfusion.overflows"] == 0
    assert counters["sfusion.correspondences"] > 0
