"""The brick cull of ``csrc/integrate_bricks.cuh`` (the walk of the exact
and the colour integrate kernels), as its plain PyTorch predicate
``kernels.integrate.brick_cull``, against the voxels the integrate twins
update.

The kernel skips a brick of voxels before any of them reads depth or
volume memory, so the cull must never skip a voxel that the exact
contract updates: for each frame below, every voxel that
``ops.integrate.integrate`` (the twin the kernel is bit-equal with on the
card) or the JAX ``tsdf_tpu.ops.integrate.integrate`` updates lies in a
brick the predicate keeps. No tolerance: a single such voxel fails. The
predicate must also cull (it is not vacuous): everything for a camera
that looks away or a frame without depth, and much of the volume in the
smoke's view.

The fast convention (``brick_cull(..., fast=True)``, the colour-fast
kernel's cull) is held the same way against ``ops.integrate.integrate_fast``
with a colour frame (the twin the kernel is bit-equal with; it is held
against the JAX kernel in tests/test_torch_integrate_fast.py): no voxel it
updates lies in a culled brick, and when it counts misses (a column steeper
than |beta| = 1) no brick is culled, so the kernel's count is whole.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume
from tsdf_tpu_torch.kernels.integrate import (
    BRICK,
    CULL_MARGIN_PX,
    FAST_CULL_MARGIN_PX,
    brick_cull,
    brick_grid,
)
from tsdf_tpu_torch.ops.integrate import (
    fit_column_lines,
    integrate,
    integrate_fast,
)
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
W, H = 160, 120
FX, FY, CX, CY = 147.775, 147.525, 82.75, 58.65


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


def _rolled_pose(jcam, angle):
    """The camera's pose rolled about its optical axis by ``angle``."""
    c, s = np.cos(angle), np.sin(angle)
    roll = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return (np.asarray(jcam.pose, np.float64) @ roll).astype(np.float32)


def _depth(kind, rng):
    if kind == "far":  # every voxel in view is in front of the surface
        return np.full((H, W), 3500.0, np.float32)
    if kind == "near":  # the far plane of the cull bites
        return np.full((H, W), 700.0, np.float32)
    d = jax_fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
    d = d.astype(np.float32)
    d = d + (d > 0) * rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.05] = 0.0  # holes
    return d


def _bricks_of(mask):
    """The (z, y, x) brick index of every True voxel of ``mask``."""
    z, y, x = np.nonzero(mask)
    bz, by, bx = BRICK
    return z // bz, y // by, x // bx


def _check_never_culls_an_update(jvol, jcam, depth):
    """Fuse ``depth`` with both twins; return (culled bricks, voxels the
    port's twin updated), after asserting no update lies in a culled
    brick."""
    vol = _to_port(jvol)
    cam = Camera.from_numpy(np.asarray(jcam.k), np.asarray(jcam.pose),
                            device=CPU)
    d = torch.from_numpy(depth)
    culled = brick_cull(vol, d, cam).numpy()
    sz, sy, sx = vol.tsdf.shape
    assert culled.shape == brick_grid(vol.tsdf.shape) == tuple(
        -(-n // b) for n, b in zip((sz, sy, sx), BRICK))
    updated = integrate(vol, d, cam).weight.numpy() > 0
    jax_vol = jax_integrate(jvol, jnp.asarray(depth), jcam)
    jax_updated = np.asarray(jax_vol.weight) > 0
    for what, mask in (("port twin", updated), ("JAX", jax_updated)):
        lost = culled[_bricks_of(mask)]
        assert not lost.any(), (
            f"{int(lost.sum())} voxels the {what} updates are culled")
    return culled, updated


@pytest.mark.parametrize("depth_kind", ["far", "sphere", "near"])
@pytest.mark.parametrize(
    "size,at,target,roll",
    [
        # outside the volume, looking in
        ((64, 48, 40), [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0], 0.0),
        ((40, 32, 36), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 0.0),
        # inside the volume
        ((64, 48, 40), [100.0, -50.0, 900.0], [400.0, 200.0, 2000.0], 0.0),
        # behind the volume, looking back through it
        ((64, 48, 40), [150.0, 100.0, 2600.0], [0.0, 0.0, 500.0], 0.0),
        # a 1.2 rad roll
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 1.2),
        # odd shapes: ragged bricks on every axis
        ((33, 50, 21), [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0], 0.3),
        ((21, 33, 50), [-200.0, 100.0, 500.0], [100.0, -50.0, 1800.0], -1.2),
    ],
    ids=["outside", "oblique", "inside", "behind", "roll", "odd", "odd-inside"],
)
def test_cull_never_skips_an_updated_voxel(size, at, target, roll, depth_kind):
    rng = np.random.default_rng(len(depth_kind) + size[0])
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0))
    jcam = tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY).move_to(at)
    jcam = jcam.look_at(target)
    jcam = jcam.set_pose(jnp.asarray(_rolled_pose(jcam, roll)))
    culled, updated = _check_never_culls_an_update(
        jvol, jcam, _depth(depth_kind, rng))
    assert updated.sum() > 100  # the frame exercises the test
    assert 0.0 < culled.mean() < 1.0


def test_cull_keeps_voxels_on_half_pixel_slivers():
    """Voxel centres that project exactly onto a half-pixel edge: u/Z =
    -0.5 rounds (half to even) to column 0 and is kept by the exact gate;
    u/Z = W - 0.5 with W odd rounds to W - 1 and is kept too; the same on
    the rows. Volume and camera are chosen so these quotients are exact in
    float32: voxel size 1 mm, integer centres, the camera at the origin
    looking along +z."""
    w, h = 7, 5
    fx = fy = 16.0
    cx, cy = 3.5, 2.5
    # centres x = -12..11, y = -6..5, z = 0..19
    jvol = tsdf_tpu.make_volume((24, 12, 20), (24.0, 12.0, 20.0),
                                offset=(-12.5, -6.5, -0.5))
    jcam = tsdf_tpu.Camera.from_intrinsics(fx, fy, cx, cy)
    depth = np.full((h, w), 100.0, np.float32)
    vol = _to_port(jvol)
    cam = Camera.from_numpy(np.asarray(jcam.k), np.asarray(jcam.pose), device=CPU)
    d = torch.from_numpy(depth)
    culled = brick_cull(vol, d, cam).numpy()
    updated = integrate(vol, d, cam).weight.numpy() > 0
    # (x, z) with (fx x + cx z) / z = -0.5 (x = -z / 4), and = w - 0.5 =
    # 6.5 (x = 3 z / 16); (y, z) with (fy y + cy z) / z = -0.5 (y = -3 z / 16)
    for x, y, z in ((-1, 0, 4), (-4, 0, 16), (3, 0, 16), (0, -3, 16)):
        assert updated[z, y + 6, x + 12], (x, y, z)
    # one column past the right sliver: (16 * 4 + 3.5 * 16) / 16 = 7.5
    # rounds to 8, outside
    assert not updated[16, 6, 4 + 12]
    assert not culled[_bricks_of(updated)].any()


def test_cull_is_everything_without_a_view_or_depth():
    jvol = tsdf_tpu.make_volume((40, 32, 36), 2000.0, offset=(-1000.0, -800.0, 0.0))
    vol = _to_port(jvol)
    away = Camera.from_intrinsics(FX, FY, CX, CY, device=CPU).move_to(
        [0.0, 0.0, -500.0]).look_at([0.0, 0.0, -2000.0])
    depth = torch.full((H, W), 1500.0)
    assert not bool((integrate(vol, depth, away).weight > 0).any())
    assert bool(brick_cull(vol, depth, away).all())
    ahead = away.look_at([0.0, 0.0, 1000.0])
    for empty in (torch.zeros((H, W)), torch.full((H, W), float("nan")),
                  torch.full((H, W), -5.0)):
        assert bool(brick_cull(vol, empty, ahead).all())
    assert not bool(brick_cull(vol, depth, ahead).all())


def test_cull_skips_much_of_the_smoke_view():
    """The smoke's first frame at a cut-down size (64^3 over the same
    3000 mm, 640x480 at the smoke's intrinsics): a camera at z ~ -400 mm
    looking at a wall at z = 2500 mm. Bricks left and right of the frustum
    near the camera and every brick beyond the wall plus the truncation are
    culled; none that the twin updates is."""
    jvol = tsdf_tpu.make_volume((64, 64, 64), 3000.0, offset=(-1500.0, -1500.0, 0.0))
    jcam = tsdf_tpu.Camera.from_intrinsics(591.1, 590.1, 331.0, 234.6).move_to(
        [-59.9, -14.3, -403.6]).look_at([0.0, 0.0, 1500.0])
    depth = np.full((480, 640), 2500.0, np.float32)
    culled, updated = _check_never_culls_an_update(jvol, jcam, depth)
    assert updated.sum() > 10000
    assert culled.mean() > 0.5, culled.mean()


def _check_fast_never_culls_an_update(jvol, jcam, depth):
    """Fuse ``depth`` and a colour frame with the fast twin; return (culled
    bricks, updated voxels, miss count) after asserting that no update lies
    in a culled brick and that a frame with misses culls nothing."""
    vol = _to_port(jvol).with_color()
    cam = Camera.from_numpy(np.asarray(jcam.k), np.asarray(jcam.pose),
                            device=CPU)
    d = torch.from_numpy(depth)
    h, w = depth.shape
    rgb = torch.from_numpy(fixtures.gradient_rgb(w, h, diagonal=True))
    culled = brick_cull(vol, d, cam, fast=True).numpy()
    out, miss = integrate_fast(vol, d, cam, rgb=rgb)
    updated = out.weight.numpy() > 0
    coloured = (out.color.numpy() > 0).any(-1)
    assert not (coloured & ~updated).any()
    lost = culled[_bricks_of(updated)]
    assert not lost.any(), f"{int(lost.sum())} updated voxels are culled"
    _alpha, beta = fit_column_lines(vol, cam)
    steep = bool((~(beta.abs() <= 1.0)).any())
    assert steep or int(miss) == 0
    if steep:
        assert not culled.any(), "a frame with a steep column culls a brick"
    return culled, updated, int(miss), steep


@pytest.mark.parametrize("depth_kind", ["far", "sphere", "near"])
@pytest.mark.parametrize(
    "size,at,target,roll",
    [
        ((64, 48, 40), [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0], 0.0),
        ((40, 32, 36), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 0.0),
        ((64, 48, 40), [100.0, -50.0, 900.0], [400.0, 200.0, 2000.0], 0.0),
        ((64, 48, 40), [150.0, 100.0, 2600.0], [0.0, 0.0, 500.0], 0.0),
        # a 1.2 rad roll: every column is steeper than |beta| = 1
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 1.2),
        # a roll at which some columns are steep and others not
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 0.72),
        ((33, 50, 21), [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0], 0.3),
        ((21, 33, 50), [-200.0, 100.0, 500.0], [100.0, -50.0, 1800.0], -1.2),
    ],
    ids=["outside", "oblique", "inside", "behind", "roll", "half-roll", "odd",
         "odd-inside"],
)
def test_fast_cull_never_skips_an_updated_or_missed_voxel(
        size, at, target, roll, depth_kind):
    rng = np.random.default_rng(len(depth_kind) + size[0])
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0))
    jcam = tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY).move_to(at)
    jcam = jcam.look_at(target)
    jcam = jcam.set_pose(jnp.asarray(_rolled_pose(jcam, roll)))
    culled, updated, miss, steep = _check_fast_never_culls_an_update(
        jvol, jcam, _depth(depth_kind, rng))
    if abs(roll) < 1.0:
        assert updated.sum() > 100  # the frame exercises the test
    if not steep:
        assert 0.0 < culled.mean() < 1.0
    if abs(roll) >= 1.0:
        assert miss > 0 and updated.sum() == 0


def test_fast_pixel_reaches_past_the_exact_margin_and_stays_in_its_own():
    """The premise of the fast cull's margin: a voxel the fast twin updates
    projects (u / Z, v / Z) within 3.5 pixels of the image in x and 0.5 in
    y, so ``FAST_CULL_MARGIN_PX`` leaves 1.5. Sub-pixel voxels (3 mm at
    2.4 m, ~0.2 px) on the image's left edge under a roll that tilts the
    columns' lines to |beta| ~ 0.55: here the decimated pixel reaches
    voxels more than ``CULL_MARGIN_PX`` left of the image, which the exact
    margin alone would not bound."""
    jvol = tsdf_tpu.make_volume((96, 64, 32), (300.0, 200.0, 100.0),
                                offset=(-150.0, -100.0, 2400.0))
    x0 = CX / FX * 2450.0
    jcam = tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY).move_to(
        [x0, 0.0, 0.0]).look_at([x0, 0.0, 2450.0])
    jcam = jcam.set_pose(jnp.asarray(_rolled_pose(jcam, -0.5)))
    depth = np.full((H, W), 2600.0, np.float32)
    culled, updated, miss, steep = _check_fast_never_culls_an_update(
        jvol, jcam, depth)
    assert not steep and miss == 0 and updated.sum() > 1000
    vol = _to_port(jvol)
    cam = Camera.from_numpy(np.asarray(jcam.k), np.asarray(jcam.pose),
                            device=CPU)
    zc, yc, xc = vol.axis_centres()
    pi, k = cam.pose_inv, cam.k
    x, y, z = (pi[i, 0] * xc[None, None, :] + pi[i, 1] * yc[None, :, None]
               + pi[i, 2] * zc[:, None, None] + pi[i, 3] for i in range(3))
    u = ((k[0, 0] * x + k[0, 2] * z) / z).expand(updated.shape)
    v = ((k[1, 1] * y + k[1, 2] * z) / z).expand(updated.shape)
    mask = torch.from_numpy(updated)
    slack = FAST_CULL_MARGIN_PX - 1.5
    assert float(u[mask].min()) < -CULL_MARGIN_PX
    assert float(u[mask].min()) >= -slack
    assert float(u[mask].max()) <= W - 1 + slack
    assert float(v[mask].min()) >= -0.5 - 1e-3
    assert float(v[mask].max()) <= H - 0.5 + 1e-3
