"""The decimated line convention (``integrate_mode="fast"``) of
tsdf_tpu_torch vs the JAX package.

The JAX package has no plain oracle for this mode: the convention *is*
``_kernel_fast`` (and the ``dr``/``dc`` branch of ``_kernel_color``), so
the port's plain twin ``ops.integrate.integrate_fast`` is held against
``integrate_pallas(mode="fast", interpret=True)`` and
``integrate_color_pallas(mode="fast", interpret=True)`` on the same numpy
inputs.

Tolerances: the same update decisions (equal weights) on >= 99.9% of the
voxels, equal miss counts, tsdf within 5e-3 mm where the weights agree
(the integrate gate of tests/test_torch_integrate.py), colour within one
level on >= 99.9% of the bytes. Seen here: every voxel and every colour
byte equal, tsdf within 2.5e-4 mm (XLA may fuse a multiply-add where
PyTorch rounds twice).
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.integrate import integrate_color_pallas, integrate_pallas
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, kernels
from tsdf_tpu_torch.kernels import integrate as kint
from tsdf_tpu_torch.ops.integrate import (
    fit_column_lines,
    integrate,
    integrate_fast,
)
from tsdf_tpu_torch.pipelines.kinfu import (
    FusionConfig,
    fuse_frames,
    track_and_fuse_frames,
)
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
W, H = 640, 480


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


def _jax_cam(i=0, roll=0.0):
    """The camera of tests/test_integrate_pallas.py's fast-mode fixture,
    moved a little per frame and rolled about its optical axis."""
    cam = (tsdf_tpu.Camera.default_depth_camera()
           .move_to([400.0 + 30.0 * i, -250.0, -600.0 + 10.0 * i])
           .look_at([-100.0, 150.0, 1200.0]))
    if roll:
        c, s = np.cos(roll), np.sin(roll)
        r = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                     np.float32)
        cam = cam.set_pose(jnp.asarray(np.asarray(cam.pose) @ r))
    return cam


def _scene_depth(rng=None):
    """A sphere bump over a far plane, so most of the frustum is updated."""
    d = jax_fixtures.sphere_depth_map(W, H, 120.0, 800.0, 1600.0).astype(
        np.float32)
    d = np.where(d > 0, d, 1900.0).astype(np.float32)
    if rng is not None:
        d = d + rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
        d[rng.uniform(size=d.shape) < 0.02] = 0.0
    return d


def _assert_same(tvol, tmiss, jvol, jmiss, color):
    assert int(tmiss) == int(jmiss)
    wj, wt = np.asarray(jvol.weight), tvol.weight.numpy()
    same = wj == wt
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(tvol.tsdf.numpy()[same],
                               np.asarray(jvol.tsdf)[same], rtol=0, atol=5e-3)
    if color:
        d = np.abs(np.asarray(jvol.color).astype(int)
                   - tvol.color.numpy().astype(int))
        assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


@pytest.mark.parametrize("color", [False, True], ids=["depth", "color"])
@pytest.mark.parametrize("size", [(64, 64, 64), (40, 50, 36)],
                         ids=["64", "40x50x36"])
def test_fast_twin_matches_pallas_interpret(size, color):
    """The JAX fixture (tests/test_integrate_pallas.py:457-525) and a grid
    that is no multiple of 128, whose line fit runs to the padded Y."""
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                                with_color=color)
    jcam = _jax_cam()
    depth = jax_fixtures.sphere_depth_map(W, H, 120.0, 800.0, 1600.0)
    rgb = fixtures.gradient_rgb(W, H, diagonal=True)
    tdepth = torch.from_numpy(depth.astype(np.float32))
    if color:
        jout, jmiss = integrate_color_pallas(
            jvol, jnp.asarray(depth), jnp.asarray(rgb), jcam, mode="fast",
            interpret=True)
        tout, tmiss = integrate_fast(_to_port(jvol), tdepth, _cam_to_port(jcam),
                                     rgb=torch.from_numpy(rgb))
        assert int((tout.color > 0).sum()) > 500
    else:
        jout, jmiss = integrate_pallas(jvol, jnp.asarray(depth), jcam,
                                       mode="fast", interpret=True)
        tout, tmiss = integrate_fast(_to_port(jvol), tdepth, _cam_to_port(jcam))
    assert int(jmiss) == 0 and float(tout.weight.sum()) > 500
    _assert_same(tout, tmiss, jout, jmiss, color)


@pytest.mark.parametrize("cap_weight", [False, True], ids=["nocap", "cap"])
def test_fast_twin_matches_pallas_over_frames(cap_weight):
    """Three noisy frames with holes from moving poses: the later ones blend
    into weighted, coloured voxels; max_weight 2 so the cap and the floored
    colour rate both bite."""
    rng = np.random.default_rng(3)
    jvol = tsdf_tpu.make_volume((48, 40, 44), 2000.0,
                                offset=(-1000.0, -1000.0, 0.0),
                                max_weight=2.0, with_color=True)
    tvol = _to_port(jvol)
    for i in range(3):
        jcam = _jax_cam(i)
        depth = _scene_depth(rng)
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 40 * i, axis=1)
        jvol, jmiss = integrate_color_pallas(
            jvol, jnp.asarray(depth), jnp.asarray(rgb), jcam, mode="fast",
            cap_weight=cap_weight, interpret=True)
        tvol, tmiss = integrate_fast(
            tvol, torch.from_numpy(depth), _cam_to_port(jcam),
            cap_weight=cap_weight, rgb=torch.from_numpy(rgb.copy()))
        assert int(tmiss) == int(jmiss) == 0
    assert float(tvol.weight.max()) == (2.0 if cap_weight else 3.0)
    assert float((tvol.weight > 0).float().mean()) > 0.2
    _assert_same(tvol, tmiss, jvol, jmiss, color=True)


@pytest.mark.parametrize("color", [False, True], ids=["depth", "color"])
def test_rolled_camera_is_skipped_and_counted(color):
    """A camera rolled by 1.2 rad: every voxel column's image line is
    steeper than |beta| = 1, so both implementations update nothing and
    count the same in-image voxels."""
    jvol = tsdf_tpu.make_volume((32, 40, 24), 2000.0,
                                offset=(-1000.0, -1000.0, 0.0),
                                with_color=color)
    jcam = _jax_cam(roll=1.2)
    depth = _scene_depth()
    rgb = fixtures.gradient_rgb(W, H, diagonal=True)
    tcam, tdepth = _cam_to_port(jcam), torch.from_numpy(depth)
    if color:
        jout, jmiss = integrate_color_pallas(
            jvol, jnp.asarray(depth), jnp.asarray(rgb), jcam, mode="fast",
            interpret=True)
        tout, tmiss = integrate_fast(_to_port(jvol), tdepth, tcam,
                                     rgb=torch.from_numpy(rgb))
        assert int(tout.color.sum()) == 0
    else:
        jout, jmiss = integrate_pallas(jvol, jnp.asarray(depth), jcam,
                                       mode="fast", interpret=True)
        tout, tmiss = integrate_fast(_to_port(jvol), tdepth, tcam)
    assert int(tmiss) == int(jmiss) > 1000
    assert float(tout.weight.sum()) == float(jnp.sum(jout.weight)) == 0.0
    _alpha, beta = fit_column_lines(_to_port(jvol), tcam)
    assert bool((beta.abs() > 1.0).all())
    # the exact contract fuses the same frame
    assert float(integrate(_to_port(jvol), tdepth, tcam).weight.sum()) > 1000


def test_fast_is_close_to_exact():
    """The JAX package's own gate for the convention
    (tests/test_integrate_pallas.py:473-479): >= 99.9% equal update
    decisions, mean |tsdf difference| under 0.1 voxel, p99 under 0.5."""
    jvol = tsdf_tpu.make_volume((64,) * 3, 2000.0,
                                offset=(-1000.0, -1000.0, 0.0))
    tcam = _cam_to_port(_jax_cam())
    depth = torch.from_numpy(jax_fixtures.sphere_depth_map(
        W, H, 120.0, 800.0, 1600.0).astype(np.float32))
    ref = integrate(_to_port(jvol), depth, tcam)
    out, miss = integrate_fast(_to_port(jvol), depth, tcam)
    assert int(miss) == 0
    rw, ow = ref.weight.numpy(), out.weight.numpy()
    assert (rw == ow).mean() > 0.999
    both = (rw > 0) & (ow > 0)
    d = np.abs(ref.tsdf.numpy()[both] - out.tsdf.numpy()[both])
    voxel = 2000.0 / 64
    assert d.mean() < 0.1 * voxel and np.percentile(d, 99) < 0.5 * voxel


def test_line_fit_guards():
    """A camera looking along the voxel columns (+y): both fitted points
    project to one pixel, so the fit degenerates; alpha and beta stay
    finite and clipped."""
    jvol = tsdf_tpu.make_volume((8, 8, 8), 1000.0, offset=(-500.0, 0.0, -500.0))
    jcam = tsdf_tpu.Camera.default_depth_camera().move_to(
        [0.0, -800.0, 0.0]).look_at([0.0, 500.0, 0.0])
    alpha, beta = fit_column_lines(_to_port(jvol), _cam_to_port(jcam))
    assert alpha.shape == beta.shape == (8, 1, 8)
    assert bool(torch.isfinite(alpha).all() and torch.isfinite(beta).all())
    assert float(alpha.abs().max()) <= 1e6 and float(beta.abs().max()) <= 1e6


def _small(color=False):
    jvol = tsdf_tpu.make_volume((16, 16, 16), 1000.0,
                                offset=(-500.0, -500.0, 0.0), with_color=color)
    jcam = tsdf_tpu.Camera.default_depth_camera().move_to(
        [0.0, 0.0, -300.0]).look_at([0.0, 0.0, 500.0])
    depth = np.full((48, 64), 600.0, np.float32)
    return _to_port(jvol), _cam_to_port(jcam), torch.from_numpy(depth)


def test_fast_wrapper_runs_twin_in_place_on_cpu():
    vol, cam, depth = _small()
    want, want_miss = integrate_fast(vol, depth, cam)
    ptr = vol.tsdf.data_ptr()
    kernels.reset_launch_counts()
    out, miss = kint.integrate_fast_cuda(vol, depth, cam)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert out is vol and vol.tsdf.data_ptr() == ptr
    assert miss.dtype == torch.int32 and miss.dim() == 0
    assert int(miss) == int(want_miss) == 0
    assert torch.equal(vol.tsdf, want.tsdf)
    assert torch.equal(vol.weight, want.weight)
    assert float(vol.weight.sum()) > 0
    with pytest.raises(TypeError):
        kint.integrate_fast_cuda(vol, depth.to(torch.int32), cam)
    # a deformed column has no straight image line: refused with the
    # reason of the JAX integrate_pallas
    with pytest.raises(ValueError, match="rigid path"):
        kint.integrate_fast_cuda(
            vol.replace(deform=vol.voxel_centres()), depth, cam)


def test_fuse_frames_fast_mode_and_miss_warning():
    """``FusionConfig(integrate_mode="fast")`` runs through ``fuse_frames``
    and ``track_and_fuse_frames``; a rolled camera's skipped voxels come
    back as one warning after the run."""
    vol, cam, depth = _small()
    cfg = FusionConfig(volume_size=(16,) * 3, physical_size_mm=1000.0,
                       offset_mm=(-500.0, -500.0, 0.0), width=64, height=48,
                       integrate_mode="fast")
    want, _ = integrate_fast(vol, depth, cam)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, last = fuse_frames(cfg.make_volume(device=CPU), cam,
                                [(depth, cam.pose)], cfg)
        tracked, _, poses, _ = track_and_fuse_frames(
            cfg.make_volume(device=CPU), cam, [depth], cfg)
    assert torch.equal(out.tsdf, want.tsdf) and torch.equal(last.pose, cam.pose)
    assert torch.equal(tracked.tsdf, want.tsdf) and len(poses) == 1

    c, s = float(np.cos(1.2)), float(np.sin(1.2))
    roll = torch.tensor([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1.0]])
    with pytest.warns(UserWarning, match=r"voxel observations skipped.*fast"):
        out, _ = fuse_frames(cfg.make_volume(device=CPU), cam,
                             [(depth, cam.pose @ roll)], cfg)
    assert float(out.weight.sum()) == 0.0
