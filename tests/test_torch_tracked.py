"""The tracked KinectFusion loop of the port vs the JAX package, on the
CPU (CPU tensors run the plain twins of the four kernels).

The same numpy depth frames (a wall and two spheres rendered along a short
camera path) go through:

  * the port's ``track_and_fuse_frames``;
  * the recipe of ``tsdf_tpu/pipelines/kinfu.py:_tracked_step_body``,
    assembled here from the JAX package's plain functions
    (``ops.bilateral``, ``ops.raycast.raycast``, camera z by row 2 of
    ``pose_inv``, ``get_incremental_transformation`` with the banded and
    the exact association, the two gates, ``ops.integrate``; in the
    decimated "fast" mode, which has no plain JAX form, the fast kernel
    ``integrate_pallas(mode="fast")`` in interpret mode);
  * ``tsdf_tpu.pipelines.track_and_fuse_frames(use_pallas=False)``, whose
    model depth is rounded to u16 and whose association is exact.

Tolerances: against the recipe, poses within 0.05 mm and 1e-5 in
rotation (the ICP solve's float32 noise, tests/test_torch_icp.py, fed
back through a few frames), weights equal on >= 99.9% of the voxels and
tsdf within 5e-3 mm there (the integrate gate of
tests/test_torch_integrate.py). Against the JAX lax pipeline, whose
model depth differs by up to half a millimetre: poses within 0.5 mm.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.cli import main as jax_main
from tsdf_tpu.io.png import save_png
from tsdf_tpu.io.tsdf_file import load_tsdf as jax_load_tsdf, save_tsdf as jax_save_tsdf
from tsdf_tpu.kernels.integrate import integrate_pallas
from tsdf_tpu.ops.bilateral import bilateral_filter as jax_bilateral
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.ops.raycast import raycast as jax_raycast
from tsdf_tpu.ops.raycast import render_to_depth_image as jax_render_depth
from tsdf_tpu.pipelines import kinfu as jax_kinfu
from tsdf_tpu.tracking.icp import get_incremental_transformation as jax_icp
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera
from tsdf_tpu_torch import kernels
from tsdf_tpu_torch.cli import main as torch_main
from tsdf_tpu_torch.pipelines import FusionConfig, fuse_frames, track_and_fuse_frames

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)
CAM_ARGS = ["--fx", "147.775", "--fy", "147.525", "--cx", "82.75",
            "--cy", "58.65", "--width", str(W), "--height", str(H)]
GRID, PHYSICAL, OFFSET = 64, 2000.0, (-1000.0, -1000.0, 0.0)
N_FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene():
    vol = tsdf_tpu.make_volume((GRID,) * 3, PHYSICAL, offset=OFFSET)
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = jax_fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    tsdf = jnp.minimum(jnp.minimum(wall.tsdf, s1.tsdf), s2.tsdf)
    return vol.replace(tsdf=tsdf, weight=jnp.ones_like(vol.weight))


def _jax_cam(i):
    t = i / 2.0
    return (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([20.0 * t, -8.0 * t, -400.0 + 5.0 * t])
            .look_at([0.0, 0.0, 1000.0]))


@pytest.fixture(scope="module")
def frames():
    """(list of (H, W) float32 numpy depth in whole mm, list of poses)."""
    scene = _jax_scene()
    cams = [_jax_cam(i) for i in range(N_FRAMES)]
    depths = [np.asarray(jax_render_depth(scene, c, width=W, height=H),
                         np.float32) for c in cams]
    return depths, [np.asarray(c.pose) for c in cams]


def _port_volume_and_camera(pose):
    cfg = FusionConfig(volume_size=(GRID,) * 3, physical_size_mm=PHYSICAL,
                       offset_mm=OFFSET, width=W, height=H,
                       use_bilateral_filter=True)
    cam = Camera.from_intrinsics(*INTR, pose=torch.from_numpy(pose.copy()),
                                 device=CPU)
    return cfg, cfg.make_volume(device=CPU), cam


def _jax_recipe(depths, pose0, band=32, min_frac=0.02, mode="exact"):
    """_tracked_step_body from the JAX package's plain functions; with
    ``mode="fast"``, each frame fuses through the decimated line
    convention of ``integrate_pallas(mode="fast")`` (interpret mode, as the
    JAX package runs it on the CPU), which must skip no voxel."""

    def fuse(vol, depth, cam):
        if mode != "fast":
            return jax_integrate(vol, depth, cam)
        vol, miss = integrate_pallas(vol, depth, cam, mode="fast",
                                     interpret=True)
        assert int(miss) == 0
        return vol

    vol = tsdf_tpu.make_volume((GRID,) * 3, PHYSICAL, offset=OFFSET)
    cam = tsdf_tpu.Camera.from_intrinsics(*INTR).set_pose(jnp.asarray(pose0))
    fx, fy, cx, cy = INTR
    min_inl = min_frac * W * H
    poses, stats, fused = [], [], []
    for i, d in enumerate(depths):
        depth = jnp.asarray(d, jnp.float32)
        if i == 0:
            vol = fuse(vol, depth, cam)
            poses.append(np.asarray(cam.pose))
            stats.append((0.0, 0.0))
            fused.append(True)
            continue
        depth_icp = jax_bilateral(depth)
        verts, _ = jax_raycast(vol, cam, width=W, height=H)
        pi = cam.pose_inv
        w = jnp.where(jnp.isfinite(verts), verts, 0.0)
        camz = (pi[2, 0] * w[..., 0] + pi[2, 1] * w[..., 1]
                + pi[2, 2] * w[..., 2] + pi[2, 3])
        model = jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0)
        res = jax_icp(depth_icp, model, fx, fy, cx, cy, band=band)
        if float(res.inliers) < min_inl:
            res = jax_icp(depth_icp, model, fx, fy, cx, cy, band=None)
        lost = float(res.inliers) < min_inl
        if not lost:
            cam = cam.set_pose(cam.pose @ res.pose)
            vol = fuse(vol, depth, cam)
        poses.append(np.asarray(cam.pose))
        stats.append((float(res.error), float(res.inliers)))
        fused.append(not lost)
    return vol, poses, stats, fused


def _pose_close(got, want, trans_mm, rot):
    got, want = np.asarray(got), np.asarray(want)
    assert np.linalg.norm(got[:3, 3] - want[:3, 3]) < trans_mm
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0, atol=rot)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_tracked_loop_matches_the_jax_recipe(frames, mode):
    """The port's tracked loop against the JAX recipe, fusing each frame
    by each pixel's own projection (the port's default "line" mode against
    the JAX ``ops.integrate``) or by the decimated "fast" convention on
    both sides: poses, ICP statistics, weights and tsdf."""
    depths, gt = frames
    jvol, jposes, jstats, fused = _jax_recipe(depths, gt[0], mode=mode)
    assert all(fused)
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    if mode == "fast":
        cfg = dataclasses.replace(cfg, integrate_mode="fast")
    kernels.reset_launch_counts()
    vol, cam_fin, poses, stats = track_and_fuse_frames(
        vol, cam, [d.copy() for d in depths], cfg)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert len(poses) == len(stats) == N_FRAMES
    assert torch.equal(cam_fin.pose, poses[-1])
    assert float(stats[0][0]) == 0.0 and float(stats[0][1]) == 0.0
    # both track the true motion; the decimated convention itself drifts
    # further (the JAX recipe's own fast poses are 4.0, 6.4 and 7.7 mm off
    # after 1-3 frames at this 31 mm voxel, against 0.4-0.8 exact)
    gt_mm = {"exact": 5.0, "fast": 10.0}[mode]
    for p, jp, g in zip(poses, jposes, gt):
        _pose_close(p.numpy(), jp, 0.05, 1e-5)
        assert np.linalg.norm(p.numpy()[:3, 3] - g[:3, 3]) < gt_mm
    for (e, n), (je, jn) in zip(stats[1:], jstats[1:]):
        assert abs(float(n) - jn) <= 1e-3 * jn and jn > 0.02 * W * H
        assert float(e) == pytest.approx(je, rel=1e-3)
    wj, wt = np.asarray(jvol.weight), vol.weight.numpy()
    assert wj.max() == N_FRAMES
    same = wj == wt
    assert same.mean() >= 0.999
    np.testing.assert_allclose(vol.tsdf.numpy()[same],
                               np.asarray(jvol.tsdf)[same], rtol=0, atol=5e-3)


def test_tracked_loop_close_to_the_jax_lax_pipeline(frames):
    depths, gt = frames
    jcfg = jax_kinfu.FusionConfig(
        volume_size=(GRID,) * 3, physical_size_mm=PHYSICAL, offset_mm=OFFSET,
        width=W, height=H, use_bilateral_filter=True, use_pallas=False)
    jcam = tsdf_tpu.Camera.from_intrinsics(*INTR).set_pose(jnp.asarray(gt[0]))
    _, _, jposes, _ = jax_kinfu.track_and_fuse_frames(
        jcfg.make_volume(), jcam, [jnp.asarray(d) for d in depths], jcfg)
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    _, _, poses, _ = track_and_fuse_frames(
        vol, cam, [torch.from_numpy(d.copy()) for d in depths], cfg)
    for p, jp in zip(poses, jposes):
        _pose_close(p.numpy(), jp, 0.5, 1e-3)


@pytest.mark.parametrize("band", [32, 0])
def test_lost_frame_keeps_pose_and_volume(frames, band):
    """A zero depth frame finds no inlier under either association: the
    pose is kept bit for bit and nothing is fused."""
    depths, gt = frames
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    cfg = dataclasses.replace(cfg, icp_band=band)
    vol, cam, _, _ = track_and_fuse_frames(vol, cam, depths[:2], cfg)
    tsdf, weight, pose = vol.tsdf.clone(), vol.weight.clone(), cam.pose.clone()
    seq = [depths[1], np.zeros((H, W), np.float32), depths[2]]
    vol2, cam2, poses, stats = track_and_fuse_frames(vol, cam, seq, cfg)
    # frame 0 of this call is fused at the camera's pose; frame 1 is lost
    assert torch.equal(poses[1], poses[0]) and torch.equal(poses[0], pose)
    assert float(stats[1][1]) == 0.0
    assert float(stats[2][1]) > 0.02 * W * H
    assert not torch.equal(poses[2], poses[1])
    # the lost frame alone leaves the volume untouched
    vol.tsdf.copy_(tsdf)
    vol.weight.copy_(weight)
    cam = cam.set_pose(pose)
    dummy_first = np.zeros((H, W), np.float32)  # fuses nothing either
    vol3, cam3, poses3, _ = track_and_fuse_frames(
        vol, cam, [dummy_first, dummy_first], cfg)
    assert torch.equal(vol3.tsdf, tsdf) and torch.equal(vol3.weight, weight)
    assert torch.equal(cam3.pose, pose) and torch.equal(poses3[1], pose)


def test_banded_fallback_on_fast_motion():
    """Fast vertical motion defeats a narrow band: the loop must track
    the frame again with the exact association and end where the JAX
    recipe ends."""
    scene = tsdf_tpu.make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
    wall = jax_fixtures.wall_tsdf(scene, 2500.0)
    sph = jax_fixtures.sphere_tsdf(scene, 500.0, centre=(0.0, 200.0, 1500.0))
    scene = scene.replace(tsdf=jnp.minimum(wall.tsdf, sph.tsdf),
                          weight=jnp.ones_like(scene.weight))

    def jcam(ty):
        return (tsdf_tpu.Camera.from_intrinsics(*INTR)
                .move_to([0.0, ty, -500.0]).look_at([0.0, 200.0, 1500.0]))

    depths = [np.asarray(jax_render_depth(scene, jcam(t), width=W, height=H),
                         np.float32) for t in (0.0, 220.0)]
    cfg = FusionConfig(width=W, height=H, volume_size=(64,) * 3,
                       icp_band=8, icp_min_inliers_frac=0.05)
    pose0 = np.asarray(jcam(0.0).pose)
    cam = Camera.from_intrinsics(*INTR, pose=torch.from_numpy(pose0.copy()),
                                 device=CPU)
    _, _, poses, stats = track_and_fuse_frames(
        cfg.make_volume(device=CPU), cam, depths, cfg)
    assert float(stats[-1][1]) > 0.05 * W * H
    dy = float(poses[-1][1, 3] - poses[0][1, 3])
    assert abs(dy - 220.0) < 80.0, dy


@pytest.mark.parametrize("exact_inliers,fused", [(5000.0, True), (10.0, False)])
def test_fallback_and_lost_gates(frames, monkeypatch, exact_inliers, fused):
    """Too few inliers under the banded association -> one more solve
    with the exact one; still too few -> lost: pose kept, nothing fused."""
    from tsdf_tpu_torch.pipelines import kinfu
    from tsdf_tpu_torch.tracking.icp import ICPResult

    depths, gt = frames
    calls = []
    step = torch.eye(4)
    step[0, 3] = 3.0

    def fake(depth_curr, depth_prev, fx, fy, cx, cy, band=None, conv_eps=0.0):
        calls.append(band)
        inl = 10.0 if band is not None else exact_inliers
        return ICPResult(step, torch.tensor(1.5), torch.tensor(inl))

    monkeypatch.setattr(kinfu, "get_incremental_transformation", fake)
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    vol, cam, poses, stats = track_and_fuse_frames(vol, cam, depths[:2], cfg)
    assert calls == [32, None]
    assert float(stats[1][1]) == exact_inliers
    assert float(vol.weight.max()) == (2.0 if fused else 1.0)
    if fused:
        np.testing.assert_allclose(
            poses[1].numpy(), gt[0] @ step.numpy(), rtol=1e-6, atol=1e-4)
    else:
        assert torch.equal(poses[1], poses[0])
    calls.clear()
    track_and_fuse_frames(vol, cam, depths[:2],
                          dataclasses.replace(cfg, icp_band=0))
    assert calls == [None]


def test_rgb_frames_and_deformed_volume_raise(frames):
    depths, gt = frames
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    rgb = np.zeros((H, W, 3), np.uint8)
    # a colour frame needs a volume with a colour field
    with pytest.raises(ValueError, match="no colour field"):
        track_and_fuse_frames(vol, cam, [(depths[0], rgb)], cfg)
    deformed = vol.replace(deform=vol.voxel_centres())
    with pytest.raises(ValueError, match="deformation"):
        track_and_fuse_frames(deformed, cam, depths[:1], cfg)
    with pytest.raises(ValueError, match="integrate_mode"):
        track_and_fuse_frames(
            vol, cam, depths[:1], dataclasses.replace(cfg, integrate_mode="nearest"))
    assert float(vol.weight.sum()) == 0.0
    # with a colour field the (depth, rgb) frame fuses, and "fast" runs
    coloured, _, poses, _ = track_and_fuse_frames(
        vol.with_color(), cam, [(depths[0], rgb + 9)], cfg)
    assert int(coloured.color.max()) == 9 and len(poses) == 1
    fast, _, _, _ = track_and_fuse_frames(
        cfg.make_volume(device=CPU), cam, depths[:1],
        dataclasses.replace(cfg, integrate_mode="fast"))
    assert float(fast.weight.sum()) > 0.0


def test_fuse_frames_filters_the_fused_depth(frames):
    """use_bilateral_filter in the GT-pose loop filters what is fused; a
    u16 frame is filtered as u16, as the JAX loop does."""
    depths, gt = frames
    jcfg = jax_kinfu.FusionConfig(
        volume_size=(GRID,) * 3, physical_size_mm=PHYSICAL, offset_mm=OFFSET,
        use_bilateral_filter=True)
    jvol, _ = jax_kinfu.fuse_frames(
        jcfg.make_volume(), tsdf_tpu.Camera.from_intrinsics(*INTR),
        [(jnp.asarray(d.astype(np.uint16)), jnp.asarray(p))
         for d, p in zip(depths, gt)], jcfg)
    cfg, vol, cam = _port_volume_and_camera(gt[0])
    vol, _ = fuse_frames(
        vol, cam, [(torch.from_numpy(d.astype(np.uint16)), torch.from_numpy(p.copy()))
                   for d, p in zip(depths, gt)], cfg)
    plain, _ = fuse_frames(
        cfg.make_volume(device=CPU), cam,
        [(torch.from_numpy(d.copy()), torch.from_numpy(p.copy()))
         for d, p in zip(depths, gt)],
        dataclasses.replace(cfg, use_bilateral_filter=False))
    wj, wt = np.asarray(jvol.weight), vol.weight.numpy()
    same = wj == wt
    assert same.mean() >= 0.999
    # a filtered u16 pixel may round to the neighbouring count (see
    # tests/test_torch_bilateral.py): 1 mm of depth on those voxels
    d = np.abs(vol.tsdf.numpy()[same] - np.asarray(jvol.tsdf)[same])
    assert (d > 5e-3).mean() < 1e-3 and d.max() <= 1.0 + 5e-3
    assert not torch.equal(vol.tsdf, plain.tsdf)


# -- the CLI ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory, frames):
    depths, gt = frames
    d = tmp_path_factory.mktemp("tum")
    (d / "depth").mkdir()
    lines = []
    for i, (depth, pose) in enumerate(zip(depths, gt)):
        save_png(d / "depth" / f"{i}.0.png", (depth * 5).astype(np.uint16))
        tx, ty, tz = pose[:3, 3] / 1000.0
        r = pose[:3, :3]
        qw = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
        qx = (r[2, 1] - r[1, 2]) / (4 * qw)
        qy = (r[0, 2] - r[2, 0]) / (4 * qw)
        qz = (r[1, 0] - r[0, 1]) / (4 * qw)
        lines.append(f"{i}.0 {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    (d / "ground_truth.txt").write_text("\n".join(lines) + "\n")
    return d


def _numbers(line):
    return [float(v) for v in re.findall(r"=(-?[0-9.]+)(?:mm|mrad)?", line)]


def _fuse_cli(main, tum_dir, out, extra):
    out.mkdir()
    rc = main(["fuse", "-d", str(tum_dir), "-m", str(N_FRAMES), "-s", str(GRID),
               "--physical", str(PHYSICAL), "-o", str(out / "out.tsdf"),
               "--scene", str(out / "s.png"), "--normals", str(out / "n.png"),
               "--mesh", ""] + CAM_ARGS + extra)
    assert not rc
    return out / "out.tsdf"


def test_cli_fuse_track_filter_prints_the_jax_lines(tum_dir, tmp_path, capsys):
    _fuse_cli(jax_main, tum_dir, tmp_path / "jax", ["--track", "--filter"])
    jout = capsys.readouterr().out
    tsdf = _fuse_cli(torch_main, tum_dir, tmp_path / "torch",
                     ["--track", "--filter", "--device", "cpu"])
    tout = capsys.readouterr().out

    def line(out, start):
        (found,) = [l for l in out.splitlines() if l.startswith(start)]
        return found

    jt, tt = line(jout, "tracked "), line(tout, f"tracked {N_FRAMES} frames;")
    assert re.fullmatch(
        r"tracked 4 frames; lastError=[0-9.]+mm lastInliers=[0-9]+", tt)
    assert jt.split(";")[0] == tt.split(";")[0]
    (je, ji), (te, ti) = _numbers(jt), _numbers(tt)
    # the JAX CLI without --pallas associates exactly against a u16 model
    assert abs(te - je) < 0.5 and abs(ti - ji) <= 0.05 * ji
    ja, ta = line(jout, "ATE rmse="), line(tout, "ATE rmse=")
    assert re.sub(r"[0-9.]+", "#", ja) == re.sub(r"[0-9.]+", "#", ta)
    for a, b in zip(_numbers(ja), _numbers(ta)):
        assert abs(a - b) < 0.5
    assert _numbers(ta)[0] < 5.0
    assert float(jnp.sum(jax_load_tsdf(str(tsdf)).weight)) > 0


def test_cli_fuse_filter_without_track_matches_jax(tum_dir, tmp_path):
    j = _fuse_cli(jax_main, tum_dir, tmp_path / "jax", ["--filter"])
    t = _fuse_cli(torch_main, tum_dir, tmp_path / "torch",
                  ["--filter", "--device", "cpu"])
    plain = _fuse_cli(torch_main, tum_dir, tmp_path / "plain", ["--device", "cpu"])
    vj, vt, vp = (jax_load_tsdf(str(p)) for p in (j, t, plain))
    same = np.asarray(vj.weight) == np.asarray(vt.weight)
    assert same.mean() >= 0.999
    d = np.abs(np.asarray(vt.tsdf)[same] - np.asarray(vj.tsdf)[same])
    assert (d > 5e-3).mean() < 1e-3 and d.max() <= 1.0 + 5e-3
    assert not np.array_equal(np.asarray(vt.tsdf), np.asarray(vp.tsdf))


def test_cli_icp_prints_the_jax_lines(frames, tmp_path, capsys):
    depths, _ = frames
    scene = _jax_scene()
    f = tmp_path / "scene.tsdf"
    jax_save_tsdf(scene, str(f))
    cam = tsdf_tpu.Camera.from_intrinsics(*INTR).move_to([6.0, -4.0, 3.0])
    depth = np.asarray(jax_render_depth(scene, cam, width=W, height=H))
    save_png(tmp_path / "d.png", depth.astype(np.uint16))
    argv = ["icp", "-v", str(f), "-d", str(tmp_path / "d.png")] + CAM_ARGS
    assert not jax_main(argv)
    jout = capsys.readouterr().out.splitlines()
    assert torch_main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out.splitlines()
    assert jout[0] == tout[0] == "incremental transformation (T_prev_curr):"

    def matrix(lines):
        rows = " ".join(lines[1:5]).replace("[", " ").replace("]", " ")
        return np.array(rows.split(), float).reshape(4, 4)

    jm, tm = matrix(jout), matrix(tout)
    # both render the model to u16 depth; a pixel may differ by a count
    assert np.linalg.norm(tm[:3, 3] - jm[:3, 3]) < 0.05
    np.testing.assert_allclose(tm[:3, :3], jm[:3, :3], rtol=0, atol=2e-5)
    (je, ji), (te, ti) = _numbers(jout[5]), _numbers(tout[5])
    assert re.fullmatch(r"lastError=[0-9.]+mm lastInliers=[0-9]+", tout[5])
    assert abs(te - je) < 0.01 and abs(ti - ji) <= 1e-3 * ji


@pytest.mark.parametrize("verb", ["fuse", "icp"])
def test_cuda_without_a_card_raises(tum_dir, tmp_path, verb):
    """No entry point moves to the CPU when it finds no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    argv = {
        "fuse": ["fuse", "-d", str(tum_dir), "-s", "8", "--track", "--filter",
                 "--scene", str(tmp_path / "s.png")],
        "icp": ["icp", "-v", str(tmp_path / "none.tsdf"),
                "-d", str(tmp_path / "none.png")],
    }[verb]
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(argv + ["--device", "cuda"])
    assert not (tmp_path / "s.png").exists()
