"""config 4's Levenberg-Marquardt step (``pipelines/pose_recovery.py``:
``lm_step``, ``recover_pose_lm``) against the benchmark's plain reference
(``benchmark/reference/lm.py``), on the CPU at 64^3 / 80x60.

Each case draws a scene of spheres and boxes in front of a wall from its
seed, fuses depth frames of it from a few poses into the program's volume
(``fuse_frames``) and into the reference's grid, and starts from the true
pose of an unseen view composed with a seeded twist. The program's step
and the reference's (its own march, Newton correction, reverse-mode
Jacobian and float64 solve) must agree on the rms, the proposed twist and
the band's inlier count; the reference's Jacobian must be the central
finite difference of its residuals; and a volume stored in bfloat16 must
land outside the tolerances.
"""

import importlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tsdf_tpu_torch import Camera
from tsdf_tpu_torch.pipelines import kinfu, pose_recovery
from tsdf_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "benchmark"


def _load(name, path, package=False):
    """The benchmark's module at ``path`` under a private name, so that
    sys.path is left alone and no other test sees ``harness`` or
    ``reference``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if package else None)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


scene = _load("_lm_bench_scene", BENCH / "harness" / "scene.py")
_load("_lm_bench_reference", BENCH / "reference" / "__init__.py", package=True)
ref = importlib.import_module("_lm_bench_reference.fusion")
ref_lm = importlib.import_module("_lm_bench_reference.lm")
tracking = importlib.import_module("_lm_bench_reference.tracking")
matmul, se3_exp = tracking.matmul, tracking.se3_exp

W, H = 80, 60
CAM = {"width": W, "height": H, "fx": 73.9, "fy": 73.8, "cx": 39.5, "cy": 29.5}
SIZE, PHYSICAL = 64, 2400.0
OFFSET = (-1200.0, -1200.0, 0.0)
NOISE = {"sigma_scale": 1.425e-6, "edge_thresh_mm": 50.0, "shadow_px": 1,
         "dropout_frac": 0.002}
BAND, MAX_STEPS = pose_recovery.BAND_MM, 4400
# Program against reference here: the rms within 6e-6 (relative), the
# proposal within 7e-4 mm and 5e-4 mrad, every inlier count equal (the
# CPU runs the march's plain twin, whose hits are the reference's). A
# bfloat16 volume moves a proposal by 0.02-1.8 mm and 0.05-3.7 mrad.
TOL = {"rms_gap": 1e-4, "step_gap_mm": 5e-3, "step_gap_mrad": 5e-3,
       "inlier_mismatch": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(rng):
    """A wall, two spheres and a box at places drawn from ``rng``."""
    spheres = [[float(rng.uniform(-350, 350)), float(rng.uniform(-250, 250)),
                float(rng.uniform(1100, 1500)), float(rng.uniform(150, 260))]
               for _ in range(2)]
    x, y, z = rng.uniform(-500, 300), rng.uniform(-400, 100), rng.uniform(1200, 1500)
    box = [float(x), float(y), float(z), float(x + 250), float(y + 300), float(z + 200)]
    return {"planes": [["z", float(rng.uniform(1800, 2000))]],
            "spheres": spheres, "boxes": [box]}


def _poses(rng, n):
    """(n, 4, 4) float32 camera->world poses looking into the scene from
    around (0, 0, 200)."""
    pos = torch.tensor(rng.uniform([-150, -100, 150], [150, 100, 300], size=(n, 3)))
    tgt = torch.tensor(rng.uniform([-100, -80, 1400], [100, 80, 1600], size=(n, 3)))
    return scene.look_at(pos, tgt).to(torch.float32)


def _twist(rng, mm=25.0, mrad=13.7):
    w, v = rng.normal(size=3), rng.normal(size=3)
    return torch.tensor(np.concatenate([w / np.linalg.norm(w) * mrad * 1e-3,
                                        v / np.linalg.norm(v) * mm]),
                        dtype=torch.float32)


def _problem(seed, dtype=torch.float32):
    """(program volume, reference grid, start camera, target depth,
    start pose, K) of a seeded scene: 6 fused views, the 7th the target."""
    rng = np.random.default_rng(seed)
    sc = _scene(rng)
    poses = _poses(rng, 7)
    clean = scene.analytic_depth(poses.to(torch.float64), sc, CAM)
    depth = scene.kinect_noise(clean, scene.make_generator(seed, "cpu"), NOISE)
    cfg = kinfu.FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                             offset_mm=OFFSET, width=W, height=H)
    camera = Camera.from_intrinsics(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                                    poses[0], device="cpu")
    vol = cfg.make_volume(device="cpu")
    if dtype != torch.float32:
        vol = vol.astype(dtype)
    vol, _ = kinfu.fuse_frames(vol, camera, [(depth[i], poses[i]) for i in range(6)], cfg)
    k = ref.intrinsics(CAM, "cpu")
    grid = ref.make_grid(SIZE, PHYSICAL, OFFSET, device="cpu")
    for i in range(6):
        ref.integrate(grid, depth[i], ref.inverse(poses[i]), k)
    start = matmul(se3_exp(_twist(rng)), poses[6])
    return vol, grid, camera.set_pose(start), depth[6], start, k


def _gaps(out, rms, xi_new, inliers):
    d = out.xi_new - xi_new.to(torch.float64)
    return (abs(rms - out.rms) / out.rms, float(d[3:].norm()),
            float(d[:3].norm()) * 1e3, abs(int(inliers) - out.inliers))


def _within(gaps) -> bool:
    rms, mm, mrad, inl = gaps
    return (rms <= TOL["rms_gap"] and mm <= TOL["step_gap_mm"]
            and mrad <= TOL["step_gap_mrad"] and inl <= TOL["inlier_mismatch"])


def _inliers_by_step(monkeypatch) -> list:
    """Each later ``lm_step``'s band inlier count, as its ``lm.inliers``
    counter reads it."""
    counts = []
    step = pose_recovery.lm_step

    def counted(*args, **kwargs):
        with profiling.counting() as c:
            out = step(*args, **kwargs)
        counts.append(c.totals()["lm.inliers"])
        return out

    monkeypatch.setattr(pose_recovery, "lm_step", counted)
    return counts


@pytest.mark.parametrize("seed,lam", [(11, 1e-2), (12, 1e-2), (13, 0.8), (14, 1e-4)])
def test_lm_step_matches_the_reference(seed, lam, monkeypatch):
    vol, grid, cam0, target, start, k = _problem(seed)
    xi = _twist(np.random.default_rng(seed + 100), mm=3.0, mrad=2.0)
    inliers = _inliers_by_step(monkeypatch)
    xi_new, rms = pose_recovery.lm_step(vol, cam0, target, xi, lam, MAX_STEPS)
    out = ref_lm.step(grid, target, start, xi, lam, k, BAND, MAX_STEPS)
    assert out.inliers > 0.3 * W * H
    gaps = _gaps(out, float(rms), xi_new, inliers[0])
    assert _within(gaps), gaps


@pytest.mark.parametrize("seed", [21, 22])
def test_recover_pose_lm_steps_match_the_reference(seed, monkeypatch):
    vol, grid, cam0, target, start, k = _problem(seed)
    inliers = _inliers_by_step(monkeypatch)
    xi, history = pose_recovery.recover_pose_lm(vol, cam0, target, iters=4,
                                                max_steps=MAX_STEPS)
    assert len(history) == len(inliers) == 4
    lam = pose_recovery.LAM0
    for h, n in zip(history, inliers):
        out = ref_lm.step(grid, target, start, h["xi"], lam, k, BAND, MAX_STEPS)
        gaps = _gaps(out, h["rms"], h["xi_new"], n)
        assert _within(gaps), gaps
        lam = h["lam"]
    # the recovery moves toward the true pose: the rms falls
    assert history[-1]["rms"] < history[0]["rms"]
    assert torch.equal(xi, [h["xi_new"] for h in history if h["accepted"]][-1])


@pytest.mark.parametrize("seed,column", [(31, 0), (31, 4), (32, 2), (32, 5)])
def test_reference_jacobian_is_the_central_difference(seed, column):
    _vol, grid, _cam0, target, start, k = _problem(seed)
    xi = torch.zeros(6)
    out = ref_lm.step(grid, target, start, xi, 1e-2, k, BAND, MAX_STEPS)
    pose = ref_lm.pose_of(start, xi)
    d_cam = ref_lm.camera_rays(k, H, W)
    dirs = ref_lm.directions(pose[0:3, 0:3], d_cam)
    t0, hit = ref_lm.march(grid, pose[0:3, 3], dirs, MAX_STEPS)
    fp = ref_lm.slope(grid, pose[0:3, 3], dirs, t0)
    mask = out.residuals != 0
    r0 = ref_lm.residuals_at(grid, target, start, xi, k, t0, hit, fp, mask)
    assert torch.allclose(r0.double(), out.residuals)
    # small enough that few rays cross a trilinear kink, large enough that
    # float32 rounding of a 1.5 m depth stays a few thousandths of the slope
    h = 5e-5 if column < 3 else 0.05  # rad, mm
    e = torch.zeros(6)
    e[column] = h
    plus = ref_lm.residuals_at(grid, target, start, xi + e, k, t0, hit, fp, mask)
    minus = ref_lm.residuals_at(grid, target, start, xi - e, k, t0, hit, fp, mask)
    fd = (plus - minus).double() / (2 * h)
    col = out.jac[:, column]
    err = (fd - col).abs()
    close = err <= 1e-2 * col.abs() + 1e-3 * col.abs().max()
    assert float(close.double().mean()) >= 0.99
    assert float(err.norm()) <= 2e-2 * float(col.norm())


@pytest.mark.parametrize("allowed", [True, False])
def test_the_reference_step_leaves_the_tf32_flags_as_it_found_them(allowed, monkeypatch):
    _vol, grid, _cam0, target, start, k = _problem(33)
    seen = []
    march = ref_lm.march

    def watched(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return march(*args)

    monkeypatch.setattr(ref_lm, "march", watched)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allowed)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allowed)
    ref_lm.step(grid, target, start, torch.zeros(6), 1e-2, k, BAND, MAX_STEPS)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 is allowed
    assert torch.backends.cudnn.allow_tf32 is allowed


@pytest.mark.parametrize("seed", [41, 42])
def test_a_bfloat16_volume_lands_outside_the_tolerances(seed, monkeypatch):
    vol, grid, cam0, target, start, k = _problem(seed, dtype=torch.bfloat16)
    assert vol.tsdf.dtype == torch.bfloat16
    inliers = _inliers_by_step(monkeypatch)
    _xi, history = pose_recovery.recover_pose_lm(vol, cam0, target, iters=2,
                                                 max_steps=MAX_STEPS)
    lam, outside = pose_recovery.LAM0, []
    for h, n in zip(history, inliers, strict=True):
        assert math.isfinite(h["rms"])
        out = ref_lm.step(grid, target, start, h["xi"], lam, k, BAND, MAX_STEPS)
        outside.append(not _within(_gaps(out, h["rms"], h["xi_new"], n)))
        lam = h["lam"]
    assert all(outside)


@pytest.mark.cuda
def test_a_step_syncs_once_on_the_card():
    """On the card a step's one host sync is the rms read of the trust
    rule: every other part of it is queued without a wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import warnings

    rng = np.random.default_rng(51)
    sc = _scene(rng)
    poses = _poses(rng, 2)
    depth = scene.analytic_depth(poses.to(torch.float64), sc, CAM).cuda()
    cfg = kinfu.FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                             offset_mm=OFFSET, width=W, height=H)
    camera = Camera.from_intrinsics(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                                    poses[0].cuda(), device="cuda")
    vol, _ = kinfu.fuse_frames(cfg.make_volume(device="cuda"), camera,
                               [(depth[0], poses[0].cuda())], cfg)
    start = camera.set_pose(matmul(se3_exp(_twist(rng)), poses[1]).cuda())
    pose_recovery.recover_pose_lm(vol, start, depth[1], iters=1)  # builds, warms
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _xi, history = pose_recovery.recover_pose_lm(vol, start, depth[1], iters=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(history) == 3 and len(syncs) == 3, [str(w.message) for w in syncs]
