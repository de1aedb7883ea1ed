"""Colour fusion in tsdf_tpu_torch vs the JAX package, on the CPU (CPU
tensors run the kernels' plain twins).

The same numpy inputs go through the JAX function and its counterpart:

  * ``ops.integrate.integrate(rgb=)`` vs ``tsdf_tpu.ops.integrate(rgb=)``
    over frames, with and without ``cap_weight``: weights equal on
    >= 99.9% of the voxels, tsdf within 5e-3 mm where they agree (the
    integrate gate), colour within one level on >= 99.9% of the bytes.
    Seen here: every weight and every colour byte equal;
  * ``color_image`` and ``sample_color_at`` vs JAX: within one level on
    >= 99.9% (a trilinear weight may round differently); the golden
    ``tests/goldens/color.png`` under tests/test_golden.py's gate;
  * ``iter_with_rgb``, ``write_ply`` (byte-equal with the JAX writer,
    plain and coloured) and the ``.tsdf`` round trip with colour;
  * the slice as a whole: ``fuse --fuse-color`` with ground-truth poses
    and with ``--track`` through both CLIs on one fabricated TUM
    directory. GT poses: the voxel gates above, colour PNG under the
    golden gate. Tracked: the JAX CLI (no ``--pallas``) renders its model
    depth to u16 and associates exactly, so poses differ by up to 0.5 mm
    (tests/test_torch_tracked.py) and 42 mm voxels at a silhouette or at
    the wrapped edge of a shifted colour frame take the other side's
    colour: weights equal on >= 98% (seen 98.6%), colour PNG mean
    difference under 4 levels with under 3% of the channels off by more
    than 32 (seen 2.26 and 1.2%).
"""

import dataclasses
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.cli import main as jax_main
from tsdf_tpu.io.ply import write_ply as jax_write_ply
from tsdf_tpu.io.png import load_png, save_png
from tsdf_tpu.io.tsdf_file import load_tsdf as jax_load_tsdf
from tsdf_tpu.io.tsdf_file import save_tsdf as jax_save_tsdf
from tsdf_tpu.io.tum import TUMDataLoader as JaxTUMDataLoader
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.ops.marching_cubes import sample_color_at as jax_sample_color_at
from tsdf_tpu.ops.raycast import raycast as jax_raycast
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.ops.shading import color_image as jax_color_image
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, kernels, make_volume
from tsdf_tpu_torch.cli import main as torch_main
from tsdf_tpu_torch.io.ply import write_ply
from tsdf_tpu_torch.io.tsdf_file import load_tsdf, save_tsdf
from tsdf_tpu_torch.io.tum import TUMDataLoader
from tsdf_tpu_torch.kernels import integrate as kint
from tsdf_tpu_torch.ops.integrate import integrate, integrate_fast
from tsdf_tpu_torch.ops.marching_cubes import sample_color_at
from tsdf_tpu_torch.ops.raycast import raycast
from tsdf_tpu_torch.ops.shading import color_image
from tsdf_tpu_torch.pipelines.kinfu import (
    FusionConfig,
    fuse_frames,
    track_and_fuse_frames,
)
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)
CAM_ARGS = ["--fx", "147.775", "--fy", "147.525", "--cx", "82.75",
            "--cy", "58.65", "--width", str(W), "--height", str(H)]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(jvol):
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


def _cam_to_port(jcam):
    return Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")),
        device=CPU,
    )


def _assert_volume_gate(tsdf, weight, color, jvol, min_agree=0.999):
    wj = np.asarray(jvol.weight)
    same = weight == wj
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_allclose(tsdf[same], np.asarray(jvol.tsdf)[same],
                               rtol=0, atol=5e-3)
    d = np.abs(np.asarray(jvol.color).astype(int) - color.astype(int))
    assert (d <= 1).mean() >= min_agree, (d.max(), (d > 1).mean())


def _jax_scene(grid=64):
    vol = tsdf_tpu.make_volume((grid,) * 3, 2000.0,
                               offset=(-1000.0, -1000.0, 0.0), with_color=True)
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    return vol, vol.replace(tsdf=jnp.minimum(wall.tsdf, s1.tsdf),
                            weight=jnp.ones_like(vol.weight))


def _jax_cam(i=0):
    return (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([15.0 * i, -6.0 * i, -400.0 + 4.0 * i])
            .look_at([0.0, 0.0, 1000.0]))


# -- volume and fixtures --------------------------------------------------------


def test_volume_colour_field():
    plain = make_volume((6, 5, 4), 600.0, device=CPU)
    assert plain.color is None
    vol = make_volume((6, 5, 4), 600.0, with_color=True, device=CPU)
    jvol = tsdf_tpu.make_volume((6, 5, 4), 600.0, with_color=True)
    assert vol.color.shape == tuple(jvol.color.shape) == (4, 5, 6, 3)
    assert vol.color.dtype == torch.uint8 and int(vol.color.sum()) == 0
    again = plain.with_color()
    assert again.tsdf is plain.tsdf and again.color.shape == (4, 5, 6, 3)
    dirty = vol.replace(tsdf=vol.tsdf * 0.5, weight=vol.weight + 3.0,
                        color=vol.color + 7)
    cleared = dirty.clear()
    jcleared = jvol.replace(color=jvol.color + 7).clear()
    for field in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(cleared, field).numpy(),
                                      np.asarray(getattr(jcleared, field)))
    assert int(dirty.color.sum()) > 0  # clear() returns a copy
    assert plain.clear().color is None


@pytest.mark.parametrize("diagonal", [False, True])
def test_gradient_rgb_is_the_jax_tests_pattern(diagonal):
    if diagonal:  # tests/test_integrate_pallas.py:498-509
        ys, xs = np.arange(480)[:, None], np.arange(640)[None, :]
        want = np.stack([np.broadcast_to(ys * 255 // 480, (480, 640)),
                         np.broadcast_to(xs * 255 // 640, (480, 640)),
                         (ys + xs) * 255 // 1120], axis=-1).astype(np.uint8)
        got = fixtures.gradient_rgb(640, 480, diagonal=True)
    else:  # tests/test_golden.py:83-92
        ys = np.arange(120, dtype=np.float32)[:, None]
        xs = np.arange(160, dtype=np.float32)[None, :]
        want = np.stack([np.broadcast_to(255.0 * ys / 119.0, (120, 160)),
                         np.broadcast_to(255.0 * xs / 159.0, (120, 160)),
                         np.full((120, 160), 96.0)], axis=-1).astype(np.uint8)
        got = fixtures.gradient_rgb(160, 120)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# -- the integrate twin -----------------------------------------------------------


@pytest.mark.parametrize("cap_weight", [False, True], ids=["nocap", "cap"])
@pytest.mark.parametrize("size", [(48, 48, 48), (40, 32, 36)],
                         ids=["48", "40x32x36"])
def test_colour_twin_matches_jax_over_frames(size, cap_weight):
    """Three noisy frames from moving poses and shifted colour frames; the
    later ones blend into coloured voxels. max_weight 2, so with
    cap_weight the rate uses the capped weight, and without it the floor
    1/max_weight takes over on the third frame."""
    rng = np.random.default_rng(0)
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                                max_weight=2.0, with_color=True)
    tvol = _to_port(jvol)
    for i in range(3):
        jcam = _jax_cam(i)
        depth = np.where(
            jax_fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0) > 0,
            1200.0, 1700.0).astype(np.float32)
        depth += rng.uniform(-4.0, 4.0, depth.shape).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.02] = 0.0
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 31 * i, axis=1)
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam,
                             cap_weight=cap_weight, rgb=jnp.asarray(rgb))
        tvol = integrate(tvol, torch.from_numpy(depth), _cam_to_port(jcam),
                         cap_weight=cap_weight, rgb=torch.from_numpy(rgb.copy()))
    assert float(tvol.weight.max()) == (2.0 if cap_weight else 3.0)
    assert int((tvol.color > 0).any(-1).sum()) > 1000
    _assert_volume_gate(tvol.tsdf.numpy(), tvol.weight.numpy(),
                        tvol.color.numpy(), jvol)


@pytest.mark.parametrize("mode", ["exact", "line", "fast"])
def test_colour_wrapper_runs_twin_in_place_on_cpu(mode):
    jvol, _ = _jax_scene(24)
    vol, cam = _to_port(jvol), _cam_to_port(_jax_cam())
    depth = torch.full((H, W), 1100.0)
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H))
    if mode == "fast":
        want, want_miss = integrate_fast(vol, depth, cam, rgb=rgb)
    else:
        want, want_miss = integrate(vol, depth, cam, rgb=rgb), 0
    ptrs = (vol.tsdf.data_ptr(), vol.color.data_ptr())
    kernels.reset_launch_counts()
    out, miss = kint.integrate_color_cuda(vol, depth, rgb, cam, mode=mode)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert out is vol and (vol.tsdf.data_ptr(), vol.color.data_ptr()) == ptrs
    assert miss.dtype == torch.int32 and int(miss) == int(want_miss) == 0
    for field in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(vol, field), getattr(want, field))
    assert int(vol.color.sum()) > 0


@pytest.mark.parametrize(
    "bad,error,match",
    [
        ("rgb_shape", ValueError, "does not match depth"),
        ("no_colour_field", ValueError, "no colour field"),
        ("rgb_float", TypeError, "rgb"),
        ("rgb_numpy", TypeError, "rgb"),
        ("rgb_strided", ValueError, "contiguous"),
        ("mode", ValueError, "mode must be"),
        ("rgb_meta", ValueError, "rgb is on"),
        ("deformed", ValueError, "rigid path"),
    ],
)
def test_colour_wrapper_rejects_bad_inputs(bad, error, match):
    jvol, _ = _jax_scene(16)
    vol, cam = _to_port(jvol), _cam_to_port(_jax_cam())
    depth = torch.full((H, W), 1100.0)
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H))
    mode = "line"
    if bad == "rgb_shape":
        rgb = rgb[:-1].contiguous()
    elif bad == "no_colour_field":
        vol = vol.replace(color=None)
    elif bad == "rgb_float":
        rgb = rgb.to(torch.float32)
    elif bad == "rgb_numpy":
        rgb = rgb.numpy()
    elif bad == "rgb_strided":
        rgb = torch.from_numpy(fixtures.gradient_rgb(H, W)).transpose(0, 1)
    elif bad == "mode":
        mode = "nearest"
    elif bad == "rgb_meta":
        rgb = rgb.to("meta")
    elif bad == "deformed":
        vol = vol.replace(deform=(vol.voxel_centres() + 20.0).contiguous())
    with pytest.raises(error, match=match):
        kint.integrate_color_cuda(vol, depth, rgb, cam, mode=mode)
    assert float(vol.weight.sum()) == 0.0
    if bad == "deformed":
        # the rigid colour kernel refuses it with the JAX reason; the
        # warped wrapper fuses depth + colour at the deformed centres, and
        # is held against tsdf_tpu.ops.integrate(rgb=)
        jvol = jvol.replace(deform=jnp.asarray(vol.deform.numpy()))
        want = jax_integrate(jvol, jnp.asarray(depth.numpy()), _jax_cam(),
                             rgb=jnp.asarray(rgb.numpy()))
        out = kint.integrate_warped_cuda(vol, depth, cam, rgb=rgb)
        assert float(out.weight.sum()) > 0 and int(out.color.sum()) > 0
        _assert_volume_gate(out.tsdf.numpy(), out.weight.numpy(),
                            out.color.numpy(), want)


@pytest.mark.parametrize("fn", [integrate, integrate_fast], ids=["exact", "fast"])
def test_twins_reject_mismatched_colour_frames(fn):
    """The JAX messages' meaning: an rgb frame of another size than the
    depth frame, and a colour frame into a volume without colour."""
    jvol, _ = _jax_scene(16)
    vol, cam = _to_port(jvol), _cam_to_port(_jax_cam())
    depth = torch.full((H, W), 1100.0)
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H))
    with pytest.raises(ValueError, match="does not match depth"):
        fn(vol, depth, cam, rgb=rgb[:, :-1])
    with pytest.raises(ValueError, match="no colour field"):
        fn(vol.replace(color=None), depth, cam, rgb=rgb)
    with pytest.raises(ValueError, match="does not match depth"):
        jax_integrate(jvol, jnp.asarray(depth.numpy()), _jax_cam(),
                      rgb=jnp.asarray(rgb.numpy()[:, :-1]))


# -- render and mesh colours --------------------------------------------------------


def _fused_pair(grid=64):
    """One colour frame fused by the JAX package, and its copy in the
    port: the recipe of tests/test_golden.py:_render_color."""
    vol, scene = _jax_scene(grid)
    cam = (tsdf_tpu.Camera.from_intrinsics(*INTR)
           .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))
    depth = render_to_depth_image(scene, cam, width=W, height=H)
    rgb = fixtures.gradient_rgb(W, H)
    fused = jax_integrate(vol, depth, cam, rgb=jnp.asarray(rgb))
    return fused, cam, np.asarray(depth), rgb


def test_color_image_matches_jax():
    fused, jcam, _, _ = _fused_pair()
    verts, _ = jax_raycast(fused, jcam, width=W, height=H)
    want = np.asarray(jax_color_image(fused, verts))
    got = color_image(_to_port(fused), torch.from_numpy(np.array(verts)))
    assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.999 and want.max() > 100, (d.max(), d.mean())
    assert not got.numpy()[~np.isfinite(np.asarray(verts)).all(-1)].any()
    with pytest.raises(ValueError, match="no colour field"):
        color_image(_to_port(fused).replace(color=None),
                    torch.from_numpy(np.array(verts)))


def test_color_render_matches_golden_through_the_port():
    """tests/test_golden.py:_render_color with every step in the port."""
    _, scene = _jax_scene()
    tscene = _to_port(scene)
    cam = (Camera.from_intrinsics(*INTR, device=CPU)
           .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))
    from tsdf_tpu_torch.ops.raycast import render_to_depth_image as render

    depth = render(tscene, cam, width=W, height=H)
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      with_color=True, device=CPU)
    fused = integrate(vol, depth, cam,
                      rgb=torch.from_numpy(fixtures.gradient_rgb(W, H)))
    verts, _ = raycast(fused, cam, width=W, height=H)
    img = color_image(fused, verts).numpy()
    golden = load_png(os.path.join(GOLDEN_DIR, "color.png"))
    d = np.abs(img.astype(int) - golden.astype(int))
    assert d.mean() < 0.5 and (d > 8).mean() < 0.001, (d.mean(), d.max())


def test_sample_color_at_matches_jax():
    fused, _, _, _ = _fused_pair(48)
    rng = np.random.default_rng(2)
    pts = rng.uniform([-1100.0, -1100.0, -100.0], [1100.0, 1100.0, 2100.0],
                      (4000, 3)).astype(np.float32)
    # and points right on coloured voxels
    idx = np.argwhere(np.asarray(fused.color).any(-1))[:2000]
    vs = 2000.0 / 48
    centres = (idx[:, ::-1] + 0.5) * vs + np.array([-1000.0, -1000.0, 0.0])
    pts = np.concatenate([pts, (centres + rng.uniform(-20, 20, centres.shape))
                          .astype(np.float32)])
    want = jax_sample_color_at(fused, pts)
    got = sample_color_at(_to_port(fused), pts)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.999 and want.max() > 100, (d.max(), d.mean())
    assert len(sample_color_at(_to_port(fused), pts[:0])) == 0
    with pytest.raises(ValueError, match="no colour field"):
        sample_color_at(_to_port(fused).replace(color=None), pts)


# -- host I/O ---------------------------------------------------------------------


@pytest.mark.parametrize("colored", [False, True], ids=["plain", "coloured"])
def test_write_ply_is_byte_equal_with_the_jax_writer(tmp_path, colored):
    """Coordinates of every magnitude, the float32 values whose repr is
    longest and shortest, signed zeros and non-finite values."""
    rng = np.random.default_rng(5)
    n = 3000
    v = (rng.normal(size=(n, 3)) * 10 ** rng.uniform(-8, 12, (n, 3))).astype(
        np.float32)
    v[:20] = np.array(
        [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, 3.4e38, 1e16, 1e-5,
         123456.7, 0.1, 1.0, 16777216.0, 9999999.0, 1e-4, 0.001, 1e15, 1e17,
         2.5, -1.5], np.float32)[:, None]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    colors = rng.integers(0, 256, (n, 3)).astype(np.uint8) if colored else None
    jax_write_ply(tmp_path / "j.ply", v, tris, colors=colors)
    write_ply(tmp_path / "t.ply", v, tris, colors=colors)
    assert filecmp.cmp(tmp_path / "j.ply", tmp_path / "t.ply", shallow=False)
    jax_write_ply(tmp_path / "j0.ply", v[:0], tris[:0], colors=None)
    write_ply(tmp_path / "t0.ply", v[:0], tris[:0], colors=None)
    assert filecmp.cmp(tmp_path / "j0.ply", tmp_path / "t0.ply", shallow=False)
    if colored:
        with pytest.raises(ValueError, match="colours for"):
            write_ply(tmp_path / "bad.ply", v, tris, colors=colors[:-1])


def test_tsdf_round_trip_with_colour(tmp_path):
    fused, _, _, _ = _fused_pair(24)
    jax_save_tsdf(fused, str(tmp_path / "j.tsdf"))
    vol = load_tsdf(str(tmp_path / "j.tsdf"), device=CPU)
    assert vol.color.dtype == torch.uint8 and int(vol.color.sum()) > 0
    np.testing.assert_array_equal(vol.color.numpy(), np.asarray(fused.color))
    save_tsdf(vol, str(tmp_path / "t.tsdf"))
    assert filecmp.cmp(tmp_path / "j.tsdf", tmp_path / "t.tsdf", shallow=False)
    back = jax_load_tsdf(str(tmp_path / "t.tsdf"))
    np.testing.assert_array_equal(np.asarray(back.color),
                                  np.asarray(fused.color))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """Four frames of the wall-and-sphere scene with rgb/<stamp>.png: RGB
    for frames 0, 1 and 3, a greyscale PNG for frame 2."""
    d = tmp_path_factory.mktemp("tum")
    (d / "depth").mkdir()
    (d / "rgb").mkdir()
    _, scene = _jax_scene(48)
    lines = []
    for i in range(4):
        cam = _jax_cam(i)
        depth_mm = np.asarray(render_to_depth_image(scene, cam, width=W, height=H))
        save_png(d / "depth" / f"{i}.0.png", (depth_mm * 5).astype(np.uint16))
        rgb = np.roll(fixtures.gradient_rgb(W, H), 9 * i, axis=1)
        save_png(d / "rgb" / f"{i}.0.png", rgb[..., 1] if i == 2 else rgb)
        pose = np.asarray(cam.pose)
        tx, ty, tz = pose[:3, 3] / 1000.0
        r = pose[:3, :3]
        qw = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
        qx = (r[2, 1] - r[1, 2]) / (4 * qw)
        qy = (r[0, 2] - r[2, 0]) / (4 * qw)
        qz = (r[1, 0] - r[0, 1]) / (4 * qw)
        lines.append(f"{i}.0 {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    (d / "ground_truth.txt").write_text("\n".join(lines) + "\n")
    return d


def test_iter_with_rgb_matches_jax(tum_dir, tmp_path):
    import shutil

    work = tmp_path / "tum"
    shutil.copytree(tum_dir, work)
    os.remove(work / "rgb" / "1.0.png")
    got = list(TUMDataLoader(str(work)).iter_with_rgb())
    want = list(JaxTUMDataLoader(str(work)).iter_with_rgb())
    assert len(got) == len(want) == 4
    for (gd, gp, grgb), (wd, wp, wrgb) in zip(got, want):
        np.testing.assert_array_equal(gd.data, wd.data)
        np.testing.assert_array_equal(gp, wp)
        assert (grgb is None) == (wrgb is None)
        if grgb is not None:
            assert grgb.dtype == np.uint8 and grgb.shape == (H, W, 3)
            np.testing.assert_array_equal(grgb, wrgb)
    assert got[1][2] is None
    grey = got[2][2]
    assert (grey[..., 0] == grey[..., 1]).all() and grey.max() > 100


# -- the pipelines -------------------------------------------------------------------


def _port_frames(tum_dir):
    frames = list(TUMDataLoader(str(tum_dir)).iter_with_rgb())
    depths = [torch.from_numpy(d.data.astype(np.float32)) for d, _, _ in frames]
    poses = [torch.from_numpy(p.copy()) for _, p, _ in frames]
    rgbs = [torch.from_numpy(c) for _, _, c in frames]
    return depths, poses, rgbs


def _cfg(**kw):
    return FusionConfig(volume_size=(48,) * 3, physical_size_mm=2000.0,
                        width=W, height=H, **kw)


def test_fuse_frames_with_colour_triples(tum_dir):
    """(depth, pose, rgb) triples fuse colour; a triple whose rgb is None
    fuses depth only."""
    depths, poses, rgbs = _port_frames(tum_dir)
    cfg = _cfg()
    cam = Camera.from_intrinsics(*INTR, device=CPU)
    rgbs[1] = None
    vol, last = fuse_frames(cfg.make_volume(device=CPU).with_color(), cam,
                            list(zip(depths, poses, rgbs)), cfg)
    want = cfg.make_volume(device=CPU).with_color()
    for d, p, c in zip(depths, poses, rgbs):
        want = integrate(want, d, cam.set_pose(p), rgb=c)
    for field in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(vol, field), getattr(want, field))
    assert torch.equal(last.pose, poses[-1]) and int(vol.color.sum()) > 0
    with pytest.raises(ValueError, match="no colour field"):
        fuse_frames(cfg.make_volume(device=CPU), cam,
                    list(zip(depths, poses, rgbs))[:1], cfg)


def test_tracked_colour_fuses_at_the_tracked_pose(tum_dir):
    """The tracker stays depth-only: (depth, rgb) frames end at the poses
    of the depth-only run, bit for bit, and the colour is what the twin
    fuses at those poses; a lost frame fuses neither depth nor colour."""
    depths, poses, rgbs = _port_frames(tum_dir)
    cfg = _cfg(use_bilateral_filter=True)
    cam = Camera.from_intrinsics(*INTR, pose=poses[0], device=CPU)
    plain, _, plain_poses, _ = track_and_fuse_frames(
        cfg.make_volume(device=CPU), cam, depths, cfg)
    vol, cam_fin, got_poses, stats = track_and_fuse_frames(
        cfg.make_volume(device=CPU).with_color(), cam,
        list(zip(depths, rgbs)), cfg)
    assert len(got_poses) == 4 and torch.equal(cam_fin.pose, got_poses[-1])
    for a, b in zip(got_poses, plain_poses):
        assert torch.equal(a, b)
    assert torch.equal(vol.tsdf, plain.tsdf) and torch.equal(vol.weight, plain.weight)
    want = cfg.make_volume(device=CPU).with_color()
    for d, p, c in zip(depths, got_poses, rgbs):
        want = integrate(want, d, cam.set_pose(p), rgb=c)
    assert torch.equal(vol.color, want.color) and int(vol.color.sum()) > 0

    lost = [(depths[0], rgbs[0]), (torch.zeros_like(depths[1]), rgbs[1])]
    one, _, lost_poses, lost_stats = track_and_fuse_frames(
        cfg.make_volume(device=CPU).with_color(), cam, lost, cfg)
    first = integrate(cfg.make_volume(device=CPU).with_color(), depths[0], cam,
                      rgb=rgbs[0])
    assert float(lost_stats[1][1]) == 0.0
    assert torch.equal(lost_poses[1], lost_poses[0])
    assert torch.equal(one.color, first.color) and torch.equal(one.weight, first.weight)


@pytest.mark.parametrize("first_has_rgb", [True, False])
def test_tracked_mixed_rgb_presence_raises(tum_dir, first_has_rgb):
    depths, poses, rgbs = _port_frames(tum_dir)
    cfg = _cfg()
    cam = Camera.from_intrinsics(*INTR, pose=poses[0], device=CPU)
    if first_has_rgb:
        frames = [(depths[0], rgbs[0]), depths[1]]
    else:
        frames = [(depths[0], None), (depths[1], rgbs[1])]
    with pytest.raises(ValueError, match="consistent rgb presence"):
        track_and_fuse_frames(cfg.make_volume(device=CPU).with_color(), cam,
                              frames, cfg)
    with pytest.raises(ValueError, match="no colour field"):
        track_and_fuse_frames(cfg.make_volume(device=CPU), cam,
                              [(depths[0], rgbs[0])], cfg)


# -- the slice as a whole: both CLIs -----------------------------------------------


def _fuse_cli(main, tum_dir, out, extra):
    out.mkdir()
    paths = {k: str(out / f) for k, f in (
        ("tsdf", "out.tsdf"), ("scene", "s.png"), ("normals", "n.png"),
        ("color", "c.png"), ("mesh", "m.ply"))}
    rc = main(["fuse", "-d", str(tum_dir), "-m", "4", "-s", "48",
               "--physical", "2000", "--fuse-color", "-o", paths["tsdf"],
               "--scene", paths["scene"], "--normals", paths["normals"],
               "--color", paths["color"], "--mesh", paths["mesh"],
               "--max-cubes", str(1 << 14), "--max-vertices", str(1 << 16)]
              + CAM_ARGS + extra)
    assert not rc
    return paths


def _ply_header(path):
    header = []
    with open(path) as f:
        for line in f:
            header.append(line.strip())
            if header[-1] == "end_header":
                return header
    raise AssertionError("no end_header")


@pytest.mark.parametrize("extra", [[], ["--filter"]], ids=["gt", "gt-filter"])
def test_cli_fuse_color_matches_jax(tum_dir, tmp_path, capsys, extra):
    j = _fuse_cli(jax_main, tum_dir, tmp_path / "jax", extra)
    jout = capsys.readouterr().out
    t = _fuse_cli(torch_main, tum_dir, tmp_path / "torch",
                  extra + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert "fused 4 frames with colour" in jout
    assert "fused 4 frames with colour" in tout
    vj, vt = jax_load_tsdf(j["tsdf"]), jax_load_tsdf(t["tsdf"])
    assert int(np.asarray(vj.color).sum()) > 0
    tsdf_t, tsdf_j = np.asarray(vt.tsdf), np.asarray(vj.tsdf)
    if extra:  # a filtered u16 pixel may round to the neighbouring count
        same = np.asarray(vj.weight) == np.asarray(vt.weight)
        assert same.mean() >= 0.999
        d = np.abs(tsdf_t[same] - tsdf_j[same])
        assert (d > 5e-3).mean() < 1e-3 and d.max() <= 1.0 + 5e-3
        dc = np.abs(np.asarray(vj.color).astype(int)
                    - np.asarray(vt.color).astype(int))
        assert (dc <= 1).mean() >= 0.999
    else:
        _assert_volume_gate(tsdf_t, np.asarray(vt.weight),
                            np.asarray(vt.color), vj)
    for key in ("scene", "normals", "color"):
        a, b = load_png(j[key]), load_png(t[key])
        assert a.shape == b.shape and a.dtype == b.dtype
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.mean() < 0.5 and (d > 8).mean() < 0.001, (key, d.mean())
    assert load_png(t["color"]).shape == (H, W, 3)
    assert load_png(t["color"]).max() > 100
    hj, ht = _ply_header(j["mesh"]), _ply_header(t["mesh"])
    assert ht[3:9] == hj[3:9] == [
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue"]
    nj, nt = int(hj[2].split()[-1]), int(ht[2].split()[-1])
    assert nj > 1000 and abs(nj - nt) <= 0.01 * nj, (nj, nt)


def test_cli_fuse_color_track_matches_jax(tum_dir, tmp_path, capsys):
    j = _fuse_cli(jax_main, tum_dir, tmp_path / "jax", ["--track"])
    jout = capsys.readouterr().out
    t = _fuse_cli(torch_main, tum_dir, tmp_path / "torch",
                  ["--track", "--device", "cpu"])
    tout = capsys.readouterr().out

    def line(out):
        (found,) = [l for l in out.splitlines()
                    if l.startswith("tracked 4 colour frames;")]
        return found

    assert line(jout).split(";")[0] == line(tout).split(";")[0]
    assert "ATE rmse=" in tout
    vj, vt = jax_load_tsdf(j["tsdf"]), jax_load_tsdf(t["tsdf"])
    same = np.asarray(vj.weight) == np.asarray(vt.weight)
    assert same.mean() >= 0.98, same.mean()
    assert int(np.asarray(vt.color).sum()) > 0
    a, b = load_png(j["color"]), load_png(t["color"])
    d = np.abs(a.astype(int) - b.astype(int))
    assert a.shape == b.shape == (H, W, 3)
    assert d.mean() < 4.0 and (d > 32).mean() < 0.03, (d.mean(), (d > 32).mean())
    assert "property uchar red" in _ply_header(t["mesh"])


def test_cli_frames_without_rgb_fuse_depth_only(tum_dir, tmp_path):
    """GT poses: a frame whose rgb file is missing fuses depth only, in
    both CLIs; with --track the port wants all frames or none."""
    import shutil

    work = tmp_path / "tum"
    shutil.copytree(tum_dir, work)
    os.remove(work / "rgb" / "1.0.png")
    j = _fuse_cli(jax_main, work, tmp_path / "jax", [])
    t = _fuse_cli(torch_main, work, tmp_path / "torch", ["--device", "cpu"])
    vj, vt = jax_load_tsdf(j["tsdf"]), jax_load_tsdf(t["tsdf"])
    assert float(np.asarray(vt.weight).max()) == 4.0
    _assert_volume_gate(np.asarray(vt.tsdf), np.asarray(vt.weight),
                        np.asarray(vt.color), vj)
    with pytest.raises(ValueError, match="consistent rgb presence"):
        _fuse_cli(torch_main, work, tmp_path / "tracked",
                  ["--track", "--device", "cpu"])


def test_cli_render_and_mesh_color_verbs(tum_dir, tmp_path, capsys):
    t = _fuse_cli(torch_main, tum_dir, tmp_path / "fuse", ["--device", "cpu"])
    capsys.readouterr()
    for main, tag in ((jax_main, "jax"), (torch_main, "torch")):
        dev = [] if tag == "jax" else ["--device", "cpu"]
        assert not main(["render", "-f", t["tsdf"],
                         "--scene", "", "--normals", "",
                         "--color", str(tmp_path / f"{tag}_c.png"),
                         "--look-from", "0,0,-400", "--look-at", "0,0,1000"]
                        + CAM_ARGS + dev)
        assert not main(["mesh", "-f", t["tsdf"], "--color",
                         "-o", str(tmp_path / f"{tag}.ply"),
                         "--max-cubes", str(1 << 14),
                         "--max-vertices", str(1 << 16)] + dev)
    a, b = load_png(tmp_path / "jax_c.png"), load_png(tmp_path / "torch_c.png")
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.mean() < 0.5 and (d > 8).mean() < 0.001 and b.max() > 100

    def rows(path):
        with open(path) as f:
            lines = f.read().splitlines()
        body = lines[lines.index("end_header") + 1:]
        n = int(lines[2].split()[-1])
        return np.array([l.split() for l in body[:n]], float)

    rj, rt = rows(tmp_path / "jax.ply"), rows(tmp_path / "torch.ply")
    assert rj.shape == rt.shape and rj.shape[1] == 6 and len(rj) > 1000
    np.testing.assert_allclose(rt[:, :3], rj[:, :3], rtol=2.5e-7, atol=1e-4)
    dc = np.abs(rt[:, 3:] - rj[:, 3:])
    assert (dc <= 1).mean() >= 0.999 and rt[:, 3:].max() > 100

    # a volume without a colour field (a .tsdf file always carries one):
    # position-only PLY and a warning, as in the JAX CLI
    from tsdf_tpu_torch.cli import _write_mesh

    capsys.readouterr()
    plain = load_tsdf(t["tsdf"], device=CPU).replace(color=None)
    _write_mesh(plain, str(tmp_path / "p.ply"), 1 << 14, 1 << 16, color=True)
    assert "position-only PLY" in capsys.readouterr().err
    assert "property uchar red" not in _ply_header(tmp_path / "p.ply")


def test_cli_fuse_color_track_devices_is_refused(tum_dir, capsys):
    rc = torch_main(["fuse", "-d", str(tum_dir), "--fuse-color", "--track",
                     "--devices", "2x1", "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1 and "--fuse-color --track --devices is not supported" in err
    jrc = jax_main(["fuse", "-d", str(tum_dir), "--fuse-color", "--track",
                    "--devices", "2x1"])
    assert jrc == 1
    assert capsys.readouterr().err.strip() == err.strip()
