"""CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), so they skip elsewhere. On the card, run them without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: the kernels are built with --fmad=false and evaluate the
twins' expressions in the same order, so integrate (exact, brick-culled,
colour, fast,
colour-fast and warped, miss counts included), the gathers (lane, row and
windowed, its miss count included), the gather probe, bilateral and the
raycast (hit masks equal, vertices equal where hit) must agree bit for
bit. The
pose adjoint's dd and dw are bit-equal; its pose_inv cotangent, float64
sums of the same float32 terms in another order, is within 1e-6 of its
largest entry, and equals bit for bit the plain model of its reduction
order (``kernels.integrate.pose_grad_partials``) summed on the card; its
slab instance's per-brick partials equal that model's rows bit for bit.
Each kernel's bf16-storage instance (a bf16 volume, ``TSDFVolume.astype``)
is held bit for bit to the twin on the same bf16 volume in the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tsdf_tpu_torch import Camera, make_volume
from tsdf_tpu_torch.kernels import bilateral, gather, integrate, raycast
from tsdf_tpu_torch.ops.bilateral import bilateral_filter as bilateral_plain
from tsdf_tpu_torch.ops.bilateral import filter_radius
from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain
from tsdf_tpu_torch.ops.integrate import integrate_fast as integrate_fast_plain
from tsdf_tpu_torch.ops.raycast import raycast as raycast_plain
from tsdf_tpu_torch.utils import fixtures

pytestmark = pytest.mark.cuda

W, H = 160, 120
FX, FY, CX, CY = 147.775, 147.525, 82.75, 58.65


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _camera(dev, at, target):
    return (
        Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
        .move_to(at)
        .look_at(target)
    )


@pytest.mark.parametrize(
    "at,target",
    [
        ([0.0, 0.0, -500.0], [0.0, 0.0, 1000.0]),
        ([400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0]),
    ],
)
def test_integrate_kernel_matches_twin(dev, at, target):
    vol = make_volume((64, 48, 40), 2000.0, offset=(-1000.0, -800.0, 0.0),
                      device=dev)
    cam = _camera(dev, at, target)
    rng = np.random.default_rng(0)
    depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
    depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
        np.float32
    ) * (depth > 0)
    depth = torch.from_numpy(depth).to(dev)
    ref = vol
    for _ in range(3):
        ref = integrate_plain(ref, depth, cam)
        before = integrate.KERNEL.launches
        vol = integrate.integrate_cuda(vol, depth, cam)
        assert integrate.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(vol.weight, ref.weight)
    assert torch.equal(vol.tsdf, ref.tsdf)
    assert float(vol.weight.sum()) > 0


def _rolled(cam, angle):
    """``cam`` rolled about its optical axis: at about a radian every
    voxel column's image line is steeper than |beta| = 1."""
    c, s = float(np.cos(angle)), float(np.sin(angle))
    roll = torch.tensor(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]],
        device=cam.pose.device)
    return cam.set_pose(cam.pose @ roll)


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("mode", ["exact", "line", "fast"])
@pytest.mark.parametrize(
    "size,roll", [((64, 48, 40), 0.0), ((33, 50, 21), 0.0), ((64, 48, 40), 1.2)]
)
def test_color_and_fast_kernels_match_twins(dev, size, roll, mode, cap_weight):
    """The colour kernel in its three modes and the depth-only fast kernel
    against their twins over three frames (the later ones blend into
    coloured, weighted voxels; max_weight 2 so the cap and the floored
    rate both bite): tsdf, weight, colour bytes and miss counts equal. A
    grid that is no multiple of the block or of 128, and a rolled camera
    whose columns the fast convention skips and counts."""
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      max_weight=2.0, with_color=True, device=dev)
    rng = np.random.default_rng(1)
    depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
    depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
        np.float32) * (depth > 0)
    depth = torch.from_numpy(depth).to(dev)
    fast = mode == "fast"
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                      color=vol.color.clone())
    plain = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                        color=None)
    plain_ref = plain
    kernel = integrate.KERNEL_COLOR_FAST if fast else integrate.KERNEL_COLOR
    misses = []
    for i in range(3):
        cam = _rolled(_camera(dev, [400.0 + 30 * i, -250.0, -600.0],
                              [-100.0, 150.0, 1200.0]), roll)
        rgb = torch.from_numpy(
            np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 17 * i, axis=1)
        ).contiguous().to(dev)
        if fast:
            ref, want_miss = integrate_fast_plain(
                ref, depth, cam, cap_weight=cap_weight, rgb=rgb)
            plain_ref, want_plain_miss = integrate_fast_plain(
                plain_ref, depth, cam, cap_weight=cap_weight)
        else:
            ref = integrate_plain(ref, depth, cam, cap_weight=cap_weight,
                                  rgb=rgb)
            want_miss = torch.zeros((), dtype=torch.int32)
        before = kernel.launches
        vol, miss = integrate.integrate_color_cuda(
            vol, depth, rgb, cam, cap_weight=cap_weight, mode=mode)
        assert kernel.launches == before + 1
        assert int(miss) == int(want_miss)
        misses.append(int(miss))
        if fast:
            before = integrate.KERNEL_FAST.launches
            plain, miss = integrate.integrate_fast_cuda(
                plain, depth, cam, cap_weight=cap_weight)
            assert integrate.KERNEL_FAST.launches == before + 1
            assert int(miss) == int(want_plain_miss) == int(want_miss)
    torch.cuda.synchronize()
    assert torch.equal(vol.weight, ref.weight)
    assert torch.equal(vol.tsdf, ref.tsdf)
    assert torch.equal(vol.color, ref.color)
    if fast:
        assert torch.equal(plain.weight, plain_ref.weight)
        assert torch.equal(plain.tsdf, plain_ref.tsdf)
        assert torch.equal(plain.weight, vol.weight)
    if fast and roll:
        assert min(misses) > 0 and float(vol.weight.sum()) == 0
    else:
        assert misses == [0, 0, 0]
        assert float(vol.weight.max()) == (2.0 if cap_weight else 3.0)
        assert int((vol.color > 0).sum()) > 100


@pytest.mark.parametrize("roll", [0.0, 1.2])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_color_kernels_leave_the_volume_on_a_zero_depth_frame(dev, mode, roll):
    """A frame with no depth after a real one: tsdf, weight and colour
    bytes are untouched, and the miss count equals the twin's (a rolled
    camera's steep columns are counted whatever the depth)."""
    vol = make_volume((33, 50, 21), 2000.0, offset=(-1000.0, -800.0, 0.0),
                      with_color=True, device=dev)
    depth = torch.from_numpy(
        fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32)
    ).to(dev)
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H, diagonal=True)).to(dev)
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    vol, _ = integrate.integrate_color_cuda(vol, depth, rgb, cam, mode=mode)
    cam = _rolled(cam, roll)
    zero = torch.zeros_like(depth)
    if mode == "fast":
        _, want_miss = integrate_fast_plain(vol, zero, cam, rgb=rgb)
    else:
        want_miss = torch.zeros((), dtype=torch.int32)
    before = [t.clone() for t in (vol.tsdf, vol.weight, vol.color)]
    vol, miss = integrate.integrate_color_cuda(vol, zero, rgb, cam, mode=mode)
    torch.cuda.synchronize()
    assert int(miss) == int(want_miss)
    assert (int(miss) > 0) == (mode == "fast" and roll > 0)
    for got, want in zip((vol.tsdf, vol.weight, vol.color), before):
        assert torch.equal(got, want)
    assert float(vol.weight.sum()) > 0


def test_color_kernel_refuses_what_it_does_not_take(dev):
    vol = make_volume((16,) * 3, 1000.0, with_color=True, device=dev)
    cam = _camera(dev, [0.0, 0.0, -300.0], [0.0, 0.0, 500.0])
    depth = torch.zeros((H, W), device=dev)
    rgb = torch.zeros((H, W, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="does not match depth"):
        integrate.integrate_color_cuda(vol, depth, rgb[:-1], cam)
    with pytest.raises(ValueError, match="no colour field"):
        integrate.integrate_color_cuda(vol.replace(color=None), depth, rgb, cam)
    with pytest.raises(TypeError):
        integrate.integrate_color_cuda(vol, depth, rgb.to(torch.float32), cam)
    with pytest.raises(ValueError, match="mode"):
        integrate.integrate_color_cuda(vol, depth, rgb, cam, mode="nearest")
    with pytest.raises(ValueError):
        integrate.integrate_color_cuda(vol, depth, rgb.cpu(), cam)
    assert float(vol.weight.sum()) == 0.0


def _raycast_scene(dev, size=(64, 64, 64), wall=1500.0):
    vol = make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    w = fixtures.wall_tsdf(vol, wall)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    return vol.replace(tsdf=torch.minimum(w.tsdf, s1.tsdf).contiguous())


def _fused_raycast_volume(dev):
    """64^3 over 375 mm (the voxel of 512^3 over 3000 mm) fused by the
    integrate kernel from twelve frames: observed free space lies a few
    ulps off the truncation distance."""
    vol = make_volume((64,) * 3, 375.0, offset=(-187.5, -187.5, 0.0),
                      device=dev)
    rng = np.random.default_rng(3)
    bump = fixtures.sphere_depth_map(W, H, 40.0, 260.0, 330.0)
    base = np.where(bump > 0, bump, 330).astype(np.float32)
    for i in range(12):
        depth = base + (base > 0) * rng.uniform(-1.0, 1.0, base.shape).astype(
            np.float32)
        cam = _camera(dev, [-11.0 + 2.0 * i, 3.0, -100.0], [0.0, 0.0, 300.0])
        vol = integrate.integrate_cuda(vol, torch.from_numpy(depth).to(dev),
                                       cam)
    return vol


def _assert_same_render(vk, vp):
    """Hit masks equal, vertices bit-equal where hit."""
    hk = torch.isfinite(vk).all(-1)
    hp = torch.isfinite(vp).all(-1)
    assert torch.equal(hk, hp)
    assert torch.equal(vk[hk].view(torch.int32), vp[hp].view(torch.int32))
    return int(hk.sum())


@pytest.mark.parametrize("case", ["scene", "ragged", "inside", "fused", "nan"])
def test_raycast_kernel_matches_twin(dev, case):
    """The kernel's vertices equal the twin's bit for bit: the 64^3 wall
    and sphere seen from outside and from inside, the same scene at a size
    that is no multiple of the brick, a fused volume, and NaN voxels where
    no ray samples (their bricks are read, not substituted)."""
    at, target = [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0]
    if case == "ragged":
        vol = _raycast_scene(dev, size=(45, 37, 29))
    elif case == "inside":
        vol, at = _raycast_scene(dev), [100.0, -80.0, 200.0]
    elif case == "fused":
        vol = _fused_raycast_volume(dev)
        at, target = [0.0, 2.0, -90.0], [0.0, 0.0, 300.0]
    elif case == "nan":
        vol = _raycast_scene(dev, wall=1200.0)
        tsdf = vol.tsdf.clone()
        tsdf[57, 41, 25] = float("nan")
        tsdf[48, 16, 16] = float("nan")
        vol = vol.replace(tsdf=tsdf)
    else:
        vol = _raycast_scene(dev)
    cam = _camera(dev, at, target)
    before = raycast.KERNEL.launches
    vk, nk = raycast.raycast_cuda(vol, cam, W, H)
    assert raycast.KERNEL.launches == before + 1
    vp, npl = raycast_plain(vol, cam, W, H)
    torch.cuda.synchronize()
    hits = _assert_same_render(vk, vp)
    assert torch.equal(nk, npl)
    assert hits > 0.2 * W * H


def test_depth_image_through_the_raycast_kernel(dev):
    """The ``icp`` verb's model depth: one raycast launch, then the u16
    tail the twin shares; equal to the twin's image."""
    from tsdf_tpu_torch.ops.raycast import render_to_depth_image

    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = fixtures.sphere_tsdf(vol, 400.0)
    cam = _camera(dev, [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    before = raycast.KERNEL.launches
    got = raycast.render_to_depth_image_cuda(vol, cam, W, H)
    assert raycast.KERNEL.launches == before + 1
    want = render_to_depth_image(vol, cam, W, H)
    assert got.dtype == torch.uint16 and got.shape == (H, W)
    got, want = got.cpu().to(torch.int32), want.cpu().to(torch.int32)
    assert torch.equal(got, want)
    assert int((got > 0).sum()) > 1000


def test_lane_gather_kernel_matches_twin(dev):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(300, 37)).astype(np.float32))
    table[3, 5] = float("nan")
    idx = torch.from_numpy(rng.integers(-5, 45, (300, 50)).astype(np.int32))
    want = gather.take_or_zero(table, idx)
    got = gather.lane_gather_op(table.to(dev), idx.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    ints = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, 256,
                                         dtype=np.int64).astype(np.int32))
    idx1 = torch.from_numpy(rng.integers(-3, 260, (1000, 3)).astype(np.int32))
    want = gather.take_or_zero(ints[None, :].expand(1000, 256), idx1)
    got = gather.lane_gather_op(
        ints.to(dev)[None, :].expand(1000, 256), idx1.to(dev)
    ).cpu()
    assert torch.equal(got, want)


def _noisy_depth(shape, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(1000.0, 4.0, shape).astype(np.float32)
    d[:, shape[1] // 2:] += 700.0
    d[rng.uniform(size=shape) < 0.1] = 0.0
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16])
@pytest.mark.parametrize(
    "shape", [(120, 160), (37, 91), (5, 7), (1, 1), (8, 32), (9, 33)]
)
def test_bilateral_kernel_matches_twin(dev, shape, dtype):
    """Odd shapes, an image smaller than one 32x8 tile, both dtypes."""
    d = torch.from_numpy(_noisy_depth(shape, seed=shape[0])).to(dev).to(dtype)
    before = bilateral.KERNEL.launches
    got = bilateral.bilateral_filter_cuda(d)
    assert bilateral.KERNEL.launches == before + 1
    want = bilateral_plain(d)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == d.shape
    if dtype == torch.float32:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:  # uint16 has few CUDA ops: compare as int32
        assert torch.equal(got.to(torch.int32), want.to(torch.int32))
    assert not ((d == 0) & (got.to(torch.float32) != 0)).any()


@pytest.mark.parametrize("sigmas", [(8.0, 1.5), (35.0, 4.2), (20.0, 0.5)])
def test_bilateral_kernel_non_default_sigmas(dev, sigmas):
    d = torch.from_numpy(_noisy_depth((64, 128), seed=2)).to(dev)
    got = bilateral.bilateral_filter_cuda(d, *sigmas)
    want = bilateral_plain(d, *sigmas)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_bilateral_kernel_refuses_what_it_does_not_take(dev):
    d = torch.zeros((16, 16), device=dev)
    # sigma_space 40 (r = 60) fits once a block opts in to 227 KB; 80 does not
    with pytest.raises(ValueError, match="shared memory"):
        bilateral.bilateral_filter_cuda(d, sigma_space=80.0)
    with pytest.raises(TypeError):
        bilateral.bilateral_filter_cuda(d.to(torch.float64))
    with pytest.raises(ValueError):
        bilateral.bilateral_filter_cuda(d.t()[:, ::2])
    before = bilateral.KERNEL.launches
    assert bilateral.bilateral_filter_cuda(d[:0]).shape == (0, 16)
    assert bilateral.KERNEL.launches == before

def _bilateral_equal(got, want):
    if got.dtype == torch.uint16:  # few CUDA ops: compare as int32
        return torch.equal(got.to(torch.int32), want.to(torch.int32))
    # NaN included: the card writes one NaN pattern for every NaN result
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


# sigma_space 3.0 and 1.7 run the compiled radii 5 and 3; 1.0 (r = 2), 6.0
# (r = 9) and 40.0 (r = 60, above 48 KB of shared memory) the runtime radius
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16])
@pytest.mark.parametrize("sigma_space", [3.0, 1.7, 1.0, 6.0, 40.0])
def test_bilateral_kernel_every_instance(dev, sigma_space, dtype):
    d = torch.from_numpy(_noisy_depth((120, 160), seed=9)).to(dev).to(dtype)
    radius = filter_radius(sigma_space)
    plan = bilateral.launch_plan(radius, *d.shape)
    assert plan.instance == (radius if radius in bilateral.COMPILED_RADII else 0)
    before = bilateral.KERNEL.launches
    got = bilateral.bilateral_filter_cuda(d, 20.0, sigma_space)
    assert bilateral.KERNEL.launches == before + 1
    want = bilateral_plain(d, 20.0, sigma_space)
    assert got.dtype == dtype and _bilateral_equal(got, want)


@pytest.mark.parametrize(
    "sigmas", [(20.0, 3.0), (20.0, 1.7), (20.0, 6.0), (float("inf"), 3.0)]
)
def test_bilateral_kernel_nan_inf_and_negative_depths(dev, sigmas):
    """NaN, +inf, -inf and negative taps: NaN where the twin has NaN. An
    infinite sigma_colour (range constant 0) runs the runtime radius."""
    d = _noisy_depth((96, 128), seed=11)
    rng = np.random.default_rng(12)
    for v in (np.nan, np.inf, -np.inf, -250.0):
        d[rng.uniform(size=d.shape) < 0.003] = v
    d = torch.from_numpy(d).to(dev)
    got = bilateral.bilateral_filter_cuda(d, *sigmas)
    want = bilateral_plain(d, *sigmas)
    assert bool(torch.isnan(want).any())
    assert _bilateral_equal(got, want)


@pytest.mark.parametrize("sigma_space", [3.0, 1.7, 6.0])
@pytest.mark.parametrize(
    "shape", [(17, 33), (15, 40), (1, 700), (481, 641), (3, 3)]
)
def test_bilateral_kernel_ragged_strips(dev, shape, sigma_space):
    """Heights where a thread's strip of rows runs past the last row, and
    widths that end inside a tile."""
    d = torch.from_numpy(_noisy_depth(shape, seed=shape[1])).to(dev)
    before = bilateral.KERNEL.launches
    got = bilateral.bilateral_filter_cuda(d, 20.0, sigma_space)
    assert bilateral.KERNEL.launches == before + 1
    assert _bilateral_equal(got, bilateral_plain(d, 20.0, sigma_space))


@pytest.mark.parametrize("h,w", [(120, 160), (240, 320), (37, 91)])
def test_lookup_flat_kernel_matches_twin(dev, h, w):
    """The ICP association's lookup: three taps by linear pixel index
    over the image as one broadcast row."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(1.0, 9.0, (h, w)).astype(np.float32))
    img[5, 7] = float("nan")
    lin = torch.from_numpy(
        rng.integers(-2 * w, h * w + 2 * w, (h, w)).astype(np.int32))
    idx = torch.cat([lin, lin + 1, lin + w], dim=1)
    want = gather.lookup_flat(img, idx)
    before = gather.KERNEL.launches
    got = gather.lookup_flat(img.to(dev), idx.to(dev)).cpu()
    assert gather.KERNEL.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    flat = img.flatten()
    ok = (idx >= 0) & (idx < h * w)
    assert torch.equal(
        got[ok].view(torch.int32), flat[idx[ok].long()].view(torch.int32))
    assert not got[~ok].any()


# -- the warped integrate, the row gather, the windowed lane gather ---------------


def _warped_volume(dev, size, color=False):
    """A volume whose field is warped by a smooth bump plus noise, with a
    few centres that can never be updated (NaN, infinite, on the camera
    plane)."""
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      with_deformation=True, with_color=color, max_weight=2.0,
                      device=dev)
    gen = torch.Generator(device="cpu").manual_seed(3)
    c = vol.deform.cpu()
    bump = torch.exp(-((c[..., 0] / 500.0) ** 2 + ((c[..., 2] - 900.0) / 400.0) ** 2))
    c[..., 0] += 70.0 * bump
    c[..., 1] -= 25.0 * bump
    c += torch.rand(c.shape, generator=gen) - 0.5
    c[0, 0, 0] = float("nan")
    c[0, 0, 1, 2] = float("inf")
    c[0, 0, 2, 2] = 0.0
    return vol.replace(deform=c.to(dev).contiguous())


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("color", [False, True], ids=["depth", "colour"])
@pytest.mark.parametrize("size", [(64, 48, 40), (33, 50, 21)])
def test_warped_integrate_kernel_matches_twin(dev, size, color, cap_weight):
    vol = _warped_volume(dev, size, color)
    rng = np.random.default_rng(0)
    name = "integrate_warped_color" if color else "integrate_warped"
    kern = integrate.KERNEL_WARPED_COLOR if color else integrate.KERNEL_WARPED
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                      color=None if vol.color is None else vol.color.clone())
    for i in range(3):
        cam = _camera(dev, [40.0 * i, -25.0 * i, -500.0 + 10.0 * i],
                      [0.0, 0.0, 1000.0])
        depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
        depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
            np.float32) * (depth > 0)
        depth = torch.from_numpy(depth).to(dev)
        rgb = None
        if color:
            rgb = torch.from_numpy(np.roll(
                fixtures.gradient_rgb(W, H, diagonal=True), 31 * i, axis=1
            ).copy()).to(dev)
        ref = integrate_plain(ref, depth, cam, cap_weight=cap_weight, rgb=rgb)
        before = kern.launches
        vol = integrate.integrate_warped_cuda(vol, depth, cam,
                                              cap_weight=cap_weight, rgb=rgb)
        assert kern.launches == before + 1, name
    torch.cuda.synchronize()
    assert torch.equal(vol.weight, ref.weight)
    assert torch.equal(vol.tsdf, ref.tsdf)
    assert float(vol.weight.max()) == (2.0 if cap_weight else 3.0)
    assert float(vol.weight[0, 0, :3].sum()) == 0.0  # the non-finite centres
    if color:
        assert torch.equal(vol.color, ref.color)
        assert int((vol.color.to(torch.int32) > 0).sum()) > 100


def test_warped_integrate_kernel_refuses_what_it_does_not_take(dev):
    vol = _warped_volume(dev, (16, 16, 16))
    cam = _camera(dev, [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0])
    depth = torch.full((H, W), 1100.0, device=dev)
    big = torch.zeros((16, 16, 16, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        integrate.integrate_warped_cuda(
            vol.replace(deform=big[..., :3]), depth, cam)
    with pytest.raises(ValueError, match="needs vol.deform"):
        integrate.integrate_warped_cuda(vol.replace(deform=None), depth, cam)
    with pytest.raises(ValueError, match="deform is on"):
        integrate.integrate_warped_cuda(
            vol.replace(deform=vol.deform.cpu()), depth, cam)
    with pytest.raises(ValueError, match="rigid path"):
        integrate.integrate_cuda(vol, depth, cam)
    assert float(vol.weight.sum()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8,
                                   torch.float64, torch.int16])
@pytest.mark.parametrize("n,w,j", [(307, 4, 5001), (1001, 3, 777), (20, 130, 17),
                                   (9, 1, 300), (5, 7, 1)])
def test_row_gather_kernel_matches_twin(dev, dtype, n, w, j):
    """Rows of 16, 12, 520, 4 and 28 bytes (f32) and every vector width
    down to one byte (u8 rows of 3 and 7); indices outside [0, n) clamp."""
    rng = np.random.default_rng(n + w + j)
    if dtype.is_floating_point:
        table = torch.from_numpy(rng.standard_normal((n, w))).to(dtype)
    else:
        hi = 255 if dtype == torch.uint8 else 30000
        table = torch.from_numpy(rng.integers(0, hi, (n, w))).to(dtype)
    table = table.to(dev)
    idx = torch.from_numpy(rng.integers(-5, n + 5, j).astype(np.int32)).to(dev)
    before = gather.KERNEL_ROWS.launches
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert gather.KERNEL_ROWS.launches == before + 1
    assert got.dtype == dtype and got.shape == (j, w)
    assert torch.equal(got, gather.take_rows(table, idx))
    assert torch.equal(got.cpu(), table.cpu()[idx.cpu().clamp(0, n - 1).long()])


def test_row_gather_kernel_unaligned_view_and_empty(dev):
    """A table that starts 4 bytes into an allocation takes the 4-byte
    path although its rows are 16 bytes; an empty index list launches
    nothing."""
    base = torch.arange(4 * 50 + 1, dtype=torch.float32, device=dev)
    table = base[1:].view(50, 4)
    assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    idx = torch.tensor([49, 0, 7, 7, 60, -1], dtype=torch.int32, device=dev)
    assert gather.row_gather_instance(table, idx) == "generic 4 B"
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.take_rows(table, idx))
    before = gather.KERNEL_ROWS.launches
    out = gather.row_gather_op(table, idx[:0])
    assert out.shape == (0, 4) and gather.KERNEL_ROWS.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        gather.row_gather_op(table.t(), idx)
    with pytest.raises(ValueError, match="idx is on"):
        gather.row_gather_op(table, idx.cpu())


def _f32_rows(dev, rng, n, w):
    """Random float32 rows with a -0.0 and a NaN: bytes that arithmetic
    would not keep."""
    table = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
    table[0, 0] = -0.0
    table[1, -1] = float("nan")
    return table.to(dev)


def _same_bytes(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("w,instance", [(3, "rows12"), (4, "rows16")],
                         ids=["rows12", "rows16"])
@pytest.mark.parametrize("j", [1, 2, 3, 4, 5, 7, 8, 9, 4097])
def test_row_gather_kernel_group_tails(dev, w, instance, j):
    """J around the kernel's groups at its two compiled widths: a pair of
    12-byte rows a thread (an odd J leaves one row to the tail) and 128
    16-byte rows a warp (a ragged last group is masked)."""
    rng = np.random.default_rng(10 * j + w)
    n = 61
    table = _f32_rows(dev, rng, n, w)
    idx = torch.from_numpy(rng.integers(-3, n + 3, j).astype(np.int32)).to(dev)
    assert gather.row_gather_instance(table, idx) == instance
    before = gather.KERNEL_ROWS.launches
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert gather.KERNEL_ROWS.launches == before + 1
    assert _same_bytes(got, gather.take_rows(table, idx))


@pytest.mark.parametrize("w,instance", [(3, "rows12"), (4, "rows16")],
                         ids=["rows12", "rows16"])
def test_row_gather_kernel_unaligned_index_view(dev, w, instance):
    """An idx view that starts one element into its allocation: no 8-byte
    index load is possible, so the 12-byte instance loads its indices one
    at a time (the 16-byte one loads them 4 bytes a lane anyway). Indices
    at INT32_MIN, -1, N-1, N and INT32_MAX clamp."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rng = np.random.default_rng(w)
    n = 50
    table = _f32_rows(dev, rng, n, w)
    wild = rng.integers(-3, n + 3, 4097).astype(np.int32)
    wild[:9] = [lo, -1, n - 1, n, hi, 0, lo + 1, hi - 1, 5]
    base = torch.from_numpy(np.concatenate([[0], wild]).astype(np.int32)).to(dev)
    idx = base[1:]
    assert idx.data_ptr() % 16 == 4 and idx.is_contiguous()
    scalar = ", scalar indices" if w == 3 else ""
    assert gather.row_gather_instance(table, idx) == instance + scalar
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert _same_bytes(got, gather.take_rows(table, idx))
    assert _same_bytes(got[:5], table[[0, 0, n - 1, n - 1, n - 1]])


@pytest.mark.parametrize("dtype,w,instance", [
    (torch.uint8, 3, "generic 1 B"), (torch.uint8, 33, "generic 1 B"),
    (torch.uint8, 12, "rows12"), (torch.int16, 5, "generic 2 B"),
    (torch.int16, 8, "rows16"), (torch.float64, 3, "generic 8 B"),
    (torch.float64, 65, "generic 8 B"), (torch.float64, 2, "rows16"),
], ids=["u8x3", "u8x33", "u8x12", "i16x5", "i16x8", "f64x3", "f64x65", "f64x2"])
def test_row_gather_kernel_other_dtypes(dev, dtype, w, instance):
    """Rows of other types: widths that are neither 12 nor 16 bytes run the
    generic instance (a row of 65 words is wider than a block's 32 lanes);
    12- and 16-byte rows of any type run the compiled ones."""
    rng = np.random.default_rng(w)
    n, j = 300, 1001
    if dtype.is_floating_point:
        table = torch.from_numpy(rng.standard_normal((n, w))).to(dtype)
    else:
        hi = 255 if dtype == torch.uint8 else 30000
        table = torch.from_numpy(rng.integers(0, hi, (n, w))).to(dtype)
    table = table.to(dev)
    idx = torch.from_numpy(rng.integers(-5, n + 5, j).astype(np.int32)).to(dev)
    assert gather.row_gather_instance(table, idx) == instance
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (j, w)
    assert _same_bytes(got, gather.take_rows(table, idx))


def test_row_gather_kernel_output_past_4_gib(dev):
    """J = 2^28 + 3 rows of 16 bytes: the output passes 2^32 bytes, so no
    offset may wrap at 32 bits; the last three rows are the tail."""
    j, n = (1 << 28) + 3, 1000
    table = torch.arange(4 * n, dtype=torch.int32, device=dev).view(n, 4)
    idx = (torch.arange(j, dtype=torch.int64, device=dev) * 7919 % (n + 10)
           - 5).to(torch.int32)
    got = gather.row_gather_op(table, idx)
    torch.cuda.synchronize()
    assert got.numel() * 4 > 1 << 32
    assert torch.equal(got, gather.take_rows(table, idx))
    tail = idx[-3:].clamp(0, n - 1).long()
    assert torch.equal(got[-3:], table[tail])
    del got, idx
    torch.cuda.empty_cache()


def _narrow_idx(s, c, w):
    return (((np.arange(c)[None, :] % 100)
             + (np.arange(s)[:, None] // 64) * 128).astype(np.int32) % w)


@pytest.mark.parametrize(
    "s,c,w,kw",
    [
        (96, 200, 512, {}),
        (93, 200, 512, {}),
        (50, 130, 640, {"window_blocks": 1, "block_rows": 16}),
        (24, 300, 256, {"window_blocks": 4}),
        (40, 64, 1024, {"block_rows": 48}),
        (7, 1, 128, {}),
        (300, 257, 2048, {"window_blocks": 3}),
        # tilings the staging kernel refused or never ran: tiles of 128
        # and 256 rows, whose indices the kernel reads again
        (512, 200, 1024, {"window_blocks": 8, "block_rows": 128}),
        (256, 130, 512, {"block_rows": 256}),
        # more tiles (1200, a row each) than the blocks the card holds at
        # once, the guarded fallback's grid: its blocks stride over the rest
        (1200, 2048, 256, {}),
    ],
)
@pytest.mark.parametrize("case", ["narrow", "wild", "out_of_range"])
def test_windowed_gather_kernel_matches_twin(dev, s, c, w, kw, case):
    """out AND the miss count equal the twin's, on coherent indices (miss
    0), wild ones (miss > 0) and indices all out of range (0 everywhere,
    no miss); the checked and fast wrappers equal the full gather with no
    host sync."""
    rng = np.random.default_rng(s * c + w)
    tab = torch.from_numpy(rng.standard_normal((s, w)).astype(np.float32))
    tab[0, 0] = float("nan")
    if case == "narrow":
        idx = _narrow_idx(s, c, w)
    elif case == "wild":
        idx = rng.integers(-10, w + 10, (s, c)).astype(np.int32)
    else:
        idx = np.where(rng.uniform(size=(s, c)) < 0.5, -3, w + 4).astype(np.int32)
    tab, idx = tab.to(dev), torch.from_numpy(idx).to(dev)
    want, want_miss = gather.take_windowed(tab, idx, **kw)
    before = gather.KERNEL_WINDOWED.launches
    got, miss = gather.lane_gather_windowed_op(tab, idx, **kw)
    torch.cuda.synchronize()
    assert gather.KERNEL_WINDOWED.launches == before + 1
    assert miss.dtype == torch.int32 and miss.dim() == 0
    assert int(miss) == int(want_miss)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # narrow indices stay in one 256-wide window per 64 rows, so a tile of
    # at most 64 rows never misses
    bs, _ = gather.window_tiling(s, w, kw.get("window_blocks", 2),
                                 kw.get("block_rows", 64))
    if case == "out_of_range" or (case == "narrow" and bs <= 64):
        assert int(miss) == 0
    full = gather.take_or_zero(tab, idx)
    counts = (gather.KERNEL_WINDOWED.launches, gather.KERNEL_IF_MISSED.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        checked = gather.lane_gather_checked(tab, idx, **kw)
        fast = gather.lane_gather_fast(tab, idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (gather.KERNEL_WINDOWED.launches,
            gather.KERNEL_IF_MISSED.launches) == (counts[0] + 2, counts[1] + 2)
    assert torch.equal(checked.view(torch.int32), full.view(torch.int32))
    assert torch.equal(fast.view(torch.int32), full.view(torch.int32))


def test_windowed_gather_kernel_int32_empty_and_refusals(dev):
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(
        rng.integers(0, 1 << 30, (8, 256)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 100, (8, 40)).astype(np.int32)).to(dev)
    out, miss = gather.lane_gather_windowed_op(tab, idx)
    assert out.dtype == torch.int32 and int(miss) == 0
    assert torch.equal(out, gather.take_or_zero(tab, idx))
    before = gather.KERNEL_WINDOWED.launches
    empty, miss = gather.lane_gather_windowed_op(tab, idx[:, :0].contiguous())
    assert empty.shape == (8, 0) and int(miss) == 0
    assert gather.lane_gather_checked(tab, idx[:, :0].contiguous()).shape == (8, 0)
    assert gather.KERNEL_WINDOWED.launches == before
    with pytest.raises(ValueError, match="multiple of 128"):
        gather.lane_gather_windowed_op(tab[:, :130].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather.lane_gather_windowed_op(tab[:1].expand(8, 256), idx)
    # a window of 128 rows by 1024 words: more than a block could stage
    # before the kernel read the covered words in place; now it runs
    wide = torch.from_numpy(
        rng.standard_normal((512, 1024)).astype(np.float32)).to(dev)
    wide_idx = torch.from_numpy(
        rng.integers(-5, 1030, (512, 8)).astype(np.int32)).to(dev)
    got, miss = gather.lane_gather_windowed_op(wide, wide_idx, window_blocks=8,
                                               block_rows=128)
    want, want_miss = gather.take_windowed(wide, wide_idx, window_blocks=8,
                                           block_rows=128)
    assert int(miss) == int(want_miss)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the pose adjoint (csrc/integrate_pose_grad.cu) ------------------------

def _adjoint_inputs(dev, size, seed):
    """A weighted, filled volume (weights 10..14, so w + 1 == max_weight
    15 is the tie on some voxels), a noisy depth frame with holes, and
    two cotangents."""
    rng = np.random.default_rng(seed)
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0), device=dev)
    shape = vol.tsdf.shape
    vol = vol.replace(
        tsdf=torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                              * 10).to(dev),
        weight=torch.from_numpy(rng.integers(10, 15, shape)
                                .astype(np.float32)).to(dev))
    depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
    depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
        np.float32) * (depth > 0)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    gd, gw = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              .to(dev) for _ in range(2))
    return vol, torch.from_numpy(depth).to(dev), gd, gw


def _assert_adjoint_equals_twin(vol, depth, cam, gd, gw, **kw):
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad

    before = integrate.KERNEL_POSE_GRAD.launches
    dd, dw, dp = integrate.pose_grad_cuda(vol, depth, cam, gd, gw, **kw)
    dd2, dw2, dp2 = integrate.pose_grad_cuda(vol, depth, cam, gd, gw, **kw)
    assert integrate.KERNEL_POSE_GRAD.launches == before + 2
    rd, rw, rp = integrate_pose_grad(vol, depth, cam, gd, gw, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dd, rd) and torch.equal(dw, rw)
    # float64 sums of the same float32 terms in another order
    tol = 1e-6 * float(rp.abs().max()) + 1e-6
    assert float((dp - rp).abs().max()) <= tol
    # two launches, the same bits
    for a, b in ((dd, dd2), (dw, dw2), (dp, dp2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return dd, rp


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("image_term", [False, True])
@pytest.mark.parametrize(
    "size", [(64, 48, 40), (33, 50, 21), (45, 130, 3), (70, 37, 13)])
def test_pose_grad_kernel_matches_twin(dev, size, image_term, cap_weight):
    """The adjoint kernel against its twin: dd and dw bit-equal, dpinv
    within 1e-6 of its largest entry, two launches bit-equal; sizes whose
    bricks of 32 x 4 x 8 voxels are ragged in x, y and z."""
    vol, depth, gd, gw = _adjoint_inputs(dev, size, seed=size[0])
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    dd, dp = _assert_adjoint_equals_twin(vol, depth, cam, gd, gw,
                                         cap_weight=cap_weight,
                                         image_term=image_term)
    updated = dd != gd
    assert updated.any() and float(dp.abs().max()) > 0
    if cap_weight:
        assert (updated & (vol.weight == 14.0)).any()  # the tie


def test_pose_grad_kernel_on_a_zero_depth_frame_is_a_copy(dev):
    """A frame with no depth > 0 culls every brick: dd and dw are gbar_d
    and gbar_w bit for bit, and the pose_inv cotangent is exactly 0."""
    vol, _depth, gd, gw = _adjoint_inputs(dev, (70, 37, 13), seed=3)
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    for empty in (torch.zeros((H, W)), torch.full((H, W), float("nan"))):
        dd, dw, dp = integrate.pose_grad_cuda(vol, empty.to(dev), cam, gd, gw)
        torch.cuda.synchronize()
        assert torch.equal(dd.view(torch.int32), gd.view(torch.int32))
        assert torch.equal(dw.view(torch.int32), gw.view(torch.int32))
        assert torch.equal(dp.view(torch.int32),
                           torch.zeros_like(dp).view(torch.int32))


@pytest.mark.parametrize("image_term", [False, True])
@pytest.mark.parametrize("size", [(64, 48, 40), (70, 37, 13)])
def test_pose_grad_kernel_sums_bricks_in_the_model_order(dev, size,
                                                         image_term):
    """The kernel's pose_inv cotangent equals, bit for bit, the column sums
    of ``pose_grad_partials`` (the kernel's per-brick reduction order in
    plain PyTorch) taken by the same ``torch.sum`` on the card: the
    partials do not depend on the order in which blocks take bricks."""
    vol, depth, gd, gw = _adjoint_inputs(dev, size, seed=11)
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    _dd, _dw, dp = integrate.pose_grad_cuda(vol, depth, cam, gd, gw,
                                            image_term=image_term)
    partials = integrate.pose_grad_partials(vol, depth, cam, gd,
                                            image_term=image_term)
    sums = partials.sum(dim=0).to(torch.float32).reshape(3, 4)
    torch.cuda.synchronize()
    assert float(sums.abs().max()) > 0
    assert torch.equal(dp[:3].view(torch.int32), sums.view(torch.int32))


def test_pose_grad_kernel_gates_at_slivers(dev):
    """Voxels on the camera plane (Z == 0), behind it, at exact half-pixel
    projections, and NaN depth pixels: the adjoint gates exactly like the
    forward kernel and equals its twin."""
    vol = make_volume((20, 18, 22), 200.0, offset=(0.0, 0.0, 0.0), device=dev)
    zc = float(vol.axis_centres()[0][6])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (95.0, 100.0, zc)  # on the centres x = 95 and z plane 6
    cam = Camera.from_intrinsics(40.0, 40.0, 20.5, 15.5, pose=pose,
                                 device=dev)
    rng = np.random.default_rng(5)
    depth = rng.uniform(10.0, 120.0, (32, 41)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = np.nan
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    depth = torch.from_numpy(depth).to(dev)
    vol = vol.replace(
        tsdf=torch.from_numpy(rng.normal(size=vol.tsdf.shape)
                              .astype(np.float32)).to(dev),
        weight=torch.from_numpy(rng.integers(0, 4, vol.tsdf.shape)
                                .astype(np.float32)).to(dev))
    g = torch.from_numpy(rng.normal(size=vol.tsdf.shape)
                         .astype(np.float32)).to(dev)
    fused = integrate.integrate_cuda(
        vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone()),
        depth, cam)
    updated = fused.weight != vol.weight
    dd, _dp = _assert_adjoint_equals_twin(vol, depth, cam, g, g)
    assert updated.any() and not updated.all()
    assert torch.equal(dd != g, updated)
    # a NaN camera point at every voxel: nothing is updated
    nan_cam = dataclasses.replace(cam, pose_inv=torch.full_like(cam.pose_inv,
                                                                float("nan")))
    dd, dp = _assert_adjoint_equals_twin(vol, depth, nan_cam, g, g)
    assert torch.equal(dd, g) and float(dp.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z0,n", [(0, 24), (8, 16), (12, 13), (16, 24)])
def test_pose_grad_slab_kernel_matches_twin(dev, z0, n, dtype):
    """The adjoint's slab instance on planes z0 .. z0 + n - 1 of a
    40-plane volume (a ``SlabVolume``; its box starts 600 mm lower than
    ``_adjoint_inputs``' so that the frame updates planes 0-25, those in
    its band 19-25, and every slab holds pose terms, the last one ending
    the volume), float32 and bf16: dd, dw and each
    brick's row of partials bit-equal with the twin on the same slab
    (``integrate_pose_grad``, ``pose_grad_partials``), one launch of the
    slab instance and none of the whole-volume one; against the
    whole-volume kernel, the same planes of dd and dw and, where z0 starts
    a brick, the same bricks' rows of partials."""
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad

    storage = getattr(torch, dtype)
    size, offset = (64, 48, 40), (-1000.0, -800.0, -600.0)
    vol, depth, gd, gw = _adjoint_inputs(dev, size, seed=13)
    vol = vol.replace(offset=torch.tensor(offset, device=dev))
    vol, gd, gw = vol.astype(storage), gd.to(storage), gw.to(storage)
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    planes = slice(z0, z0 + n)
    slab = make_volume(size, 2000.0, offset=offset,
                       dtype=storage, device=dev, slab=(z0, n)).replace(
        tsdf=vol.tsdf[planes].contiguous(), weight=vol.weight[planes].contiguous())
    sgd, sgw = gd[planes].contiguous(), gw[planes].contiguous()
    kern = integrate.instance(integrate.KERNEL_POSE_GRAD_SLAB, slab)
    whole_kern = integrate.instance(integrate.KERNEL_POSE_GRAD, vol)
    before = kern.launches, whole_kern.launches
    dd, dw, parts = integrate._pose_grad_kernel(slab, depth, cam, sgd, sgw,
                                                False, True)
    assert (kern.launches, whole_kern.launches) == (before[0] + 1, before[1])
    rd, rw, _ = integrate_pose_grad(slab, depth, cam, sgd, sgw)
    model = integrate.pose_grad_partials(slab, depth, cam, sgd)
    wd, ww, whole_parts = integrate._pose_grad_kernel(vol, depth, cam, gd, gw,
                                                      False, True)
    torch.cuda.synchronize()
    assert _bits_equal(dd, rd) and _bits_equal(dw, rw)
    assert torch.equal(parts.view(torch.int64), model.view(torch.int64))
    assert _bits_equal(dd, wd[planes]) and _bits_equal(dw, ww[planes])
    if z0 % integrate.BRICK[0] == 0:
        per_z = parts.shape[0] // -(-n // integrate.BRICK[0])
        first = z0 // integrate.BRICK[0] * per_z
        rows = whole_parts[first:first + parts.shape[0]]
        assert torch.equal(parts.view(torch.int64), rows.view(torch.int64))
    assert (dd != sgd).any() and float(parts.abs().max()) > 0
    # the wrapper sums the same partials
    _, _, dp = integrate.pose_grad_cuda(slab, depth, cam, sgd, sgw)
    want = parts.sum(dim=0).to(torch.float32).reshape(3, 4)
    assert torch.equal(dp[:3].view(torch.int32), want.view(torch.int32))


def test_integrate_pose_on_the_card_matches_the_cpu(dev):
    """integrate_pose end to end on CUDA tensors (integrate kernel forward,
    adjoint kernel backward) against the same on CPU tensors (the twins):
    weights equal on >= 99.9 % of voxels and the twist gradient within
    1e-3 of its largest component (the two devices' sin, cos and LU
    inverse may round the pose differently, and a voxel at a half-pixel
    sliver may then read the neighbouring pixel)."""
    from tsdf_tpu_torch.kernels.integrate import integrate_pose

    vol, depth, gd, _gw = _adjoint_inputs(dev, (48, 40, 44), seed=7)
    cam = _camera(dev, [100.0, -50.0, -500.0], [0.0, 0.0, 1200.0])
    delta = np.array([0.004, -0.003, 0.002, 12.0, -9.0, 8.0], np.float32)
    grads, outs = [], []
    for d in (dev, torch.device("cpu")):
        v = vol.replace(**{f: getattr(vol, f).to(d) for f in (
            "tsdf", "weight", "physical_size", "offset",
            "truncation_distance", "max_weight", "global_rotation",
            "global_translation")})
        c = Camera.from_numpy(*(t.cpu().numpy() for t in (
            cam.k, cam.pose, cam.k_inv, cam.pose_inv)), device=d)
        x = torch.tensor(delta, device=d, requires_grad=True)
        before = integrate.KERNEL_POSE_GRAD.launches
        out, miss = integrate_pose(v, depth.to(d), c, x)
        loss = (gd.to(d) * out.tsdf).sum() + (0.1 * out.weight).sum()
        (g,) = torch.autograd.grad(loss, x)
        assert integrate.KERNEL_POSE_GRAD.launches == before + (d.type == "cuda")
        assert int(miss) == 0
        grads.append(g.cpu())
        outs.append(out.weight.detach().cpu())
    assert (outs[0] == outs[1]).float().mean() >= 0.999
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-3 * float(grads[1].abs().max()))


def test_raycast_kernel_max_steps(dev):
    """max_steps reaches the kernel: with few samples fewer rays hit, and
    the hits equal the twin's at the same max_steps, bit for bit."""
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = fixtures.wall_tsdf(vol, 1500.0)
    cam = _camera(dev, [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    from tsdf_tpu_torch.ops.raycast import raycast_vertices

    hits = []
    for steps in (8, 256):
        vk = raycast.raycast_vertices_cuda(vol, cam, W, H, max_steps=steps)
        vp = raycast_vertices(vol, cam, W, H, max_steps=steps)
        hits.append(_assert_same_render(vk, vp))
    assert hits[0] < hits[1]


def test_raycast_diff_on_the_card_matches_the_cpu(dev):
    """raycast_diff with the kernel march against the plain march on the
    CPU: hits and vertices as the raycast gate, pose gradients within 1 %
    of the largest."""
    from tsdf_tpu_torch.ops.raycast_diff import depth_image_diff
    from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    vol = vol.replace(tsdf=torch.minimum(wall.tsdf, s1.tsdf).contiguous())
    cam = _camera(dev, [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    res = []
    for d in (dev, torch.device("cpu")):
        v = vol.replace(**{f: getattr(vol, f).to(d) for f in (
            "tsdf", "weight", "physical_size", "offset",
            "truncation_distance", "max_weight")})
        c = Camera.from_numpy(*(t.cpu().numpy() for t in (
            cam.k, cam.pose, cam.k_inv, cam.pose_inv)), device=d)
        x = torch.zeros(6, device=d, requires_grad=True)
        c = c.set_pose(matmul_small(se3_exp(x), c.pose))
        before = raycast.KERNEL.launches
        depth, hit = depth_image_diff(v, c, W, H, max_steps=256)
        assert raycast.KERNEL.launches == before + (d.type == "cuda")
        (g,) = torch.autograd.grad(torch.where(hit, depth, 0.0).sum() / 1e3,
                                   x)
        res.append((depth.detach().cpu(), hit.cpu(), g.cpu()))
    (dk, hk, gk), (dp, hp, gp) = res
    assert (hk == hp).float().mean() >= 0.999
    both = hk & hp
    assert float((dk[both] - dp[both]).abs().median()) < 0.5
    assert torch.isfinite(gk).all()
    torch.testing.assert_close(gk, gp, rtol=0,
                               atol=1e-2 * float(gp.abs().max()))


def test_gather_probe_kernel_matches_twin(dev):
    """The gather-roofline probe: out equal to its twin, rows no multiple
    of the 64-row chunk, indices past both ends of the row."""
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.normal(size=(1100, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-10, 140, (1100, 128))
                           .astype(np.int32))
    before = gather.KERNEL_PROBE.launches
    got = gather.gather_probe_cuda(tab.to(dev), idx.to(dev)).cpu()
    assert gather.KERNEL_PROBE.launches == before + 1
    want = gather.gather_probe_plain(tab, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows,g", [(7, 3), (64, 1), (130, 0), (32768, 64)])
def test_gather_probe_kernel_chunks(dev, rows, g):
    """The probe on fewer rows than one chunk, exactly one, a ragged last
    chunk with no gather at all, and the smoke's 32768 rows: bit-equal."""
    rng = np.random.default_rng(rows)
    tab = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-10, 140, (rows, 128))
                           .astype(np.int32))
    got = gather.gather_probe_cuda(tab.to(dev), idx.to(dev), g).cpu()
    want = gather.gather_probe_plain(tab, idx, g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the redesigned lane gather and rigid integrate ---------------------------


def _word_table(rng, rows, width, dtype):
    """Random 32-bit words: NaN payloads, infinities and int32 extremes
    among them, so a float round trip or a sign extension would show."""
    words = rng.integers(-(2**31), 2**31 - 1, (rows, width), dtype=np.int64)
    words.flat[::7] = 0x7FC00001  # a quiet NaN with a payload
    words.flat[1::11] = -(2**31)
    words.flat[2::13] = 2**31 - 1
    words.flat[3::17] = 0x7F800000  # +inf
    t = torch.from_numpy(words.astype(np.int32))
    return t if dtype == torch.int32 else t.view(torch.float32)


def _assert_lane_gather(dev, table, idx, want_launch):
    """The kernel on the card against ``take_or_zero`` on the CPU, bit for
    bit, with one counted launch (none for an empty output)."""
    launch = gather.lane_gather_launch(idx.shape[1], table.shape[1],
                                       table.stride(0))[0]
    assert launch == want_launch
    before = gather.KERNEL.launches
    got = gather.lane_gather_op(table, idx)
    empty = got.numel() == 0
    assert gather.KERNEL.launches == before + (0 if empty else 1)
    want = gather.take_or_zero(table.cpu(), idx.cpu())
    assert got.dtype == table.dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("cols", [1, 3, 4, 5, 24, 48, 72, 73])
@pytest.mark.parametrize(
    "kind,width,want",
    [
        ("rows", 36, "rows"),
        ("rows", 24, "rows"),
        ("rows", 100, "direct"),
        ("broadcast", 256, "broadcast"),
        ("broadcast", gather.BROADCAST_SHARED_BYTES // 4, "broadcast"),
        ("broadcast", gather.BROADCAST_SHARED_BYTES // 4 + 1, "direct"),
    ],
)
def test_lane_gather_launches_match_twin(dev, kind, width, want, cols, dtype):
    """Every launch on every column count, at a row count that is no
    multiple of any tile; indices below 0, inside, and at and past W."""
    rng = np.random.default_rng(cols * 1000 + width)
    rows = 301
    if kind == "rows":
        table = _word_table(rng, rows, width, dtype).to(dev)
    else:
        table = _word_table(rng, 1, width, dtype).to(dev).expand(rows, width)
    idx = torch.from_numpy(
        rng.integers(-3, width + 3, (rows, cols)).astype(np.int32))
    idx[0, 0], idx[-1, -1] = width, -1
    idx[1 % rows, cols // 2] = width - 1
    _assert_lane_gather(dev, table, idx.to(dev), want)


@pytest.mark.parametrize(
    "kind,width,want",
    [("rows", 36, "rows"), ("broadcast", 6144, "broadcast"),
     ("broadcast", 640 * 48, "direct")],
)
@pytest.mark.parametrize("cols", [4, 72, 73])
def test_lane_gather_unaligned_idx_and_empty(dev, kind, width, want, cols):
    """An ``idx`` view 4 bytes past a 16-byte boundary takes the scalar
    path of every launch; an empty output launches nothing."""
    rng = np.random.default_rng(width + cols)
    rows = 2 * 113 + 3
    table = _word_table(rng, rows if kind == "rows" else 1, width, torch.float32)
    table = table.to(dev)
    if kind == "broadcast":
        table = table.expand(rows, width)
    flat = torch.from_numpy(
        rng.integers(-5, width + 5, rows * cols + 1).astype(np.int32)).to(dev)
    idx = flat[1:].view(rows, cols)
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    _assert_lane_gather(dev, table, idx, want)
    _assert_lane_gather(dev, table[:0], idx[:0], want)
    _assert_lane_gather(dev, table, idx[:, :0].contiguous(), want)


def _frame_depth(seed, holes=0.05):
    rng = np.random.default_rng(seed)
    d = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32)
    d = d + (d > 0) * rng.uniform(0, 5, d.shape).astype(np.float32)
    d[rng.uniform(size=d.shape) < holes] = 0.0
    return d


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize(
    "size,at,target,roll",
    [
        ((33, 50, 21), [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0], 0.0),
        ((64, 48, 40), [100.0, -50.0, 900.0], [400.0, 200.0, 2000.0], 0.0),
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 1.2),
        ((45, 130, 3), [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0], 0.0),
        ((64, 48, 40), [0.0, 0.0, -500.0], [0.0, 0.0, -2000.0], 0.0),
    ],
    ids=["odd", "inside", "roll", "thin", "away"],
)
def test_brick_integrate_matches_twin(dev, size, at, target, roll, cap_weight):
    """The brick kernel against the twin over three frames from moving
    poses (the later ones blend into weighted voxels; max_weight 2 so the
    cap bites): tsdf and weight equal bit for bit. Odd shapes with ragged
    bricks, a camera inside the volume, a 1.2 rad roll, a volume three
    voxels deep, and a camera looking away, which updates nothing."""
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      max_weight=2.0, device=dev)
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone())
    for i in range(3):
        cam = _rolled(_camera(dev, np.add(at, [30.0 * i, -20.0 * i, 15.0 * i]),
                              target), roll)
        depth = torch.from_numpy(_frame_depth(i)).to(dev)
        ref = integrate_plain(ref, depth, cam, cap_weight=cap_weight)
        before = integrate.KERNEL.launches
        vol = integrate.integrate_cuda(vol, depth, cam, cap_weight=cap_weight)
        assert integrate.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(vol.weight, ref.weight)
    assert torch.equal(vol.tsdf, ref.tsdf)
    if target[2] < at[2]:
        assert float(vol.weight.sum()) == 0.0
    else:
        assert float(vol.weight.max()) >= 2.0
        assert not cap_weight or float(vol.weight.max()) == 2.0


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize(
    "size,at,target,roll",
    [
        ((33, 50, 21), [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0], 0.0),
        ((64, 48, 40), [100.0, -50.0, 900.0], [400.0, 200.0, 2000.0], 0.0),
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 1.2),
        ((64, 48, 40), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0], 0.72),
        ((45, 130, 3), [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0], 0.0),
        ((64, 48, 40), [0.0, 0.0, -500.0], [0.0, 0.0, -2000.0], 0.0),
    ],
    ids=["odd", "inside", "roll", "half-roll", "thin", "away"],
)
def test_fast_brick_integrate_matches_twin(dev, size, at, target, roll,
                                           cap_weight):
    """The depth-only fast kernel (the brick walk in the decimated
    convention) against ``ops.integrate.integrate_fast`` over three frames
    from moving poses, max_weight 2: tsdf, weight and miss counts equal,
    one counted launch a frame. A 1.2 rad roll makes every column steeper
    than |beta| = 1 (every in-image voxel a miss, nothing updated), 0.72
    rad some of them."""
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      max_weight=2.0, device=dev)
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone())
    misses = []
    for i in range(3):
        cam = _rolled(_camera(dev, np.add(at, [30.0 * i, -20.0 * i, 15.0 * i]),
                              target), roll)
        depth = torch.from_numpy(_frame_depth(i)).to(dev)
        ref, want_miss = integrate_fast_plain(ref, depth, cam,
                                              cap_weight=cap_weight)
        before = integrate.KERNEL_FAST.launches
        vol, miss = integrate.integrate_fast_cuda(vol, depth, cam,
                                                  cap_weight=cap_weight)
        assert integrate.KERNEL_FAST.launches == before + 1
        assert int(miss) == int(want_miss)
        misses.append(int(miss))
    torch.cuda.synchronize()
    assert torch.equal(vol.weight, ref.weight)
    assert torch.equal(vol.tsdf, ref.tsdf)
    if roll > 1.0:
        assert min(misses) > 0 and float(vol.weight.sum()) == 0.0
    elif roll > 0.5:
        assert min(misses) > 0 and float(vol.weight.sum()) > 0.0
    elif target[2] < at[2]:
        assert float(vol.weight.sum()) == 0.0
    else:
        assert misses == [0, 0, 0]
        assert float(vol.weight.max()) >= 2.0
        assert not cap_weight or float(vol.weight.max()) == 2.0


@pytest.mark.parametrize("roll", [0.0, 1.2])
def test_fast_brick_integrate_zero_depth_leaves_the_volume(dev, roll):
    """A frame with no depth after a real one: tsdf and weight keep every
    bit, and the miss count equals the twin's (a rolled camera's steep
    columns are counted whatever the depth)."""
    vol = make_volume((33, 50, 21), 2000.0, offset=(-1000.0, -800.0, 0.0),
                      device=dev)
    cam = _camera(dev, [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0])
    vol, _ = integrate.integrate_fast_cuda(
        vol, torch.from_numpy(_frame_depth(0)).to(dev), cam)
    tsdf, weight = vol.tsdf.clone(), vol.weight.clone()
    assert float(weight.sum()) > 0
    cam = _rolled(cam, roll)
    for empty in (torch.zeros((H, W)), torch.full((H, W), float("nan"))):
        _, want_miss = integrate_fast_plain(vol, empty.to(dev), cam)
        vol, miss = integrate.integrate_fast_cuda(vol, empty.to(dev), cam)
        assert int(miss) == int(want_miss)
        assert (int(miss) > 0) == (roll > 0)
    torch.cuda.synchronize()
    assert torch.equal(vol.tsdf, tsdf) and torch.equal(vol.weight, weight)


def test_brick_integrate_zero_depth_leaves_the_volume(dev):
    """A frame with no depth > 0 (zeros, NaN, negative) culls every brick:
    tsdf and weight keep every bit, after a real frame filled them."""
    vol = make_volume((33, 50, 21), 2000.0, offset=(-1000.0, -800.0, 0.0),
                      device=dev)
    cam = _camera(dev, [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0])
    vol = integrate.integrate_cuda(
        vol, torch.from_numpy(_frame_depth(0)).to(dev), cam)
    tsdf, weight = vol.tsdf.clone(), vol.weight.clone()
    assert float(weight.sum()) > 0
    for empty in (torch.zeros((H, W)), torch.full((H, W), float("nan")),
                  torch.full((H, W), -5.0)):
        vol = integrate.integrate_cuda(vol, empty.to(dev), cam)
        assert bool(integrate.brick_cull(vol, empty.to(dev), cam).all())
    torch.cuda.synchronize()
    assert torch.equal(vol.tsdf, tsdf) and torch.equal(vol.weight, weight)


# -- the package-level API on the card ----------------------------------------


def _api_frames(dev, n=2):
    rng = np.random.default_rng(13)
    out = []
    for i in range(n):
        d = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32)
        d = d + (d > 0) * rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 17 * i, axis=1)
        out.append((torch.from_numpy(d).to(dev),
                    torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
                    _camera(dev, [40.0 * i - 60.0, 25.0 * i, -500.0],
                            [0.0, 0.0, 1000.0])))
    return out


def _volumes_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("kind", ["depth", "rgb", "deformed"])
def test_root_integrate_is_its_kernel(dev, kind):
    """The root ``integrate`` launches the kernel its route names, once a
    frame, and equals that wrapper's result bit for bit."""
    import tsdf_tpu_torch
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    def fresh():
        vol = make_volume((48, 40, 36), 2000.0, offset=(-1000.0, -800.0, 0.0),
                          with_color=kind == "rgb",
                          with_deformation=kind == "deformed", device=dev)
        if kind == "deformed":
            vol = vol.replace(deform=vol.deform + torch.tensor(
                [18.0, -9.0, 6.0], device=dev))
        return vol

    frames = _api_frames(dev)
    name = {"depth": "integrate", "rgb": "integrate_color",
            "deformed": "integrate_warped"}[kind]
    root, direct = fresh(), fresh()
    reset_launch_counts()
    for depth, rgb, cam in frames:
        assert tsdf_tpu_torch.integrate(
            root, depth, cam, rgb=rgb if kind == "rgb" else None) is root
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts[name] == len(frames)
    assert sum(counts.values()) == len(frames)
    for depth, rgb, cam in frames:
        if kind == "rgb":
            integrate.integrate_color_cuda(direct, depth, rgb, cam, mode="exact")
        elif kind == "deformed":
            integrate.integrate_warped_cuda(direct, depth, cam)
        else:
            integrate.integrate_cuda(direct, depth, cam)
    _volumes_equal(root, direct)


def test_root_raycast_is_its_kernel(dev):
    import tsdf_tpu_torch
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = fixtures.sphere_tsdf(vol, 400.0)
    cam = _camera(dev, [150.0, -100.0, -600.0], [0.0, 0.0, 1000.0])
    reset_launch_counts()
    v, n = tsdf_tpu_torch.raycast(vol, cam, W, H)
    d = tsdf_tpu_torch.render_to_depth_image(vol, cam, W, H)
    torch.cuda.synchronize()
    assert launch_counts()["raycast"] == 2
    wv, wn = raycast.raycast_cuda(vol, cam, W, H)
    assert torch.equal(torch.isnan(v), torch.isnan(wv))
    assert torch.equal(v.nan_to_num(7.0), wv.nan_to_num(7.0))
    assert torch.equal(n, wn)
    assert torch.equal(d, raycast.render_to_depth_image_cuda(vol, cam, W, H))
    assert int(torch.isfinite(v).all(-1).sum()) > 1000
    for keywords in (dict(mode="fixed"), dict(step_scale=0.5)):
        with pytest.raises(ValueError, match="fixed-step raycast kernel"):
            tsdf_tpu_torch.raycast(vol, cam, W, H, **keywords)


def test_checkpoint_and_view_on_the_card(dev, tmp_path):
    """A checkpoint of a card's volume restores onto the card bit-equal;
    the view tiles computed on the card equal the CPU's byte for byte."""
    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    vol = make_volume((40, 36, 32), 2000.0, offset=(-1000.0, -900.0, 0.0),
                      with_color=True, device=dev)
    for depth, rgb, cam in _api_frames(dev):
        integrate.integrate_color_cuda(vol, depth, rgb, cam)
    save_sharded(vol, str(tmp_path / "c"))
    like = make_volume((40, 36, 32), 2000.0, with_color=True, device=dev)
    out = load_sharded(str(tmp_path / "c"), like)
    assert out.device == dev
    _volumes_equal(out, vol)
    host = vol.replace(**{f.name: getattr(vol, f.name).cpu()
                          for f in dataclasses.fields(vol)
                          if getattr(vol, f.name) is not None})
    for (name, a), (_, b) in zip(cli.view_tiles(vol), cli.view_tiles(host)):
        assert a.is_cuda and torch.equal(a.cpu(), b), name


def test_timing_helpers_on_the_card(dev):
    from tsdf_tpu_torch.utils.profiling import median_ms, profile_step, sync

    x = torch.ones(1 << 20, device=dev)
    ms = median_ms(lambda: x.mul_(1.0), reps=5)
    assert 0.0 < ms < 10.0
    prof = profile_step(lambda: x.mul_(1.0), n=3)
    assert prof["launches"] == 1 and prof["busy_ms"] > 0
    assert prof["top"] and len(prof["top"][0]) == 3
    assert prof["host"] and len(prof["host"][0]) == 4
    assert sync(x) == float(1 << 20)


# -- bfloat16 storage: each kernel's bf16 instance against its bf16 twin -----

BF16 = torch.bfloat16


def _bits_equal(a, b):
    """Equal bit for bit (NaN included): bf16 as 16-bit words, else 32."""
    word = torch.int16 if a.dtype == BF16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(word), b.view(word))


def _bf16_depths(dev, n=3):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
        depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
            np.float32) * (depth > 0)
        depth[rng.uniform(size=depth.shape) < 0.02] = 0.0
        out.append(torch.from_numpy(depth).to(dev))
    return out


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("mode", ["exact", "fast", "color", "color_fast"])
@pytest.mark.parametrize("size", [(64, 48, 40), (33, 50, 21)])
def test_bf16_integrate_kernels_match_twins(dev, size, mode, cap_weight):
    """The brick walk's bf16 instances over three frames into a bf16
    volume (the later ones blend into weighted, coloured voxels; max_weight
    2 so the cap bites): tsdf and weight bit-equal with the bf16 twin, the
    dtype kept, colour bytes and miss counts equal; the bf16 instance is
    launched and the float32 one is not."""
    color = mode.startswith("color")
    fast = mode.endswith("fast")
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      max_weight=2.0, with_color=color, dtype=BF16, device=dev)
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                      color=None if vol.color is None else vol.color.clone())
    f32 = {"exact": integrate.KERNEL, "fast": integrate.KERNEL_FAST,
           "color": integrate.KERNEL_COLOR,
           "color_fast": integrate.KERNEL_COLOR_FAST}[mode]
    kern = integrate.instance(f32, vol)
    assert kern.symbol == f32.symbol + "_bf16"
    for i, depth in enumerate(_bf16_depths(dev)):
        cam = _camera(dev, [40.0 * i, -25.0 * i, -500.0 + 10.0 * i],
                      [0.0, 0.0, 1000.0])
        rgb = torch.from_numpy(np.roll(
            fixtures.gradient_rgb(W, H, diagonal=True), 31 * i, axis=1
        ).copy()).to(dev) if color else None
        twin = integrate_fast_plain if fast else integrate_plain
        out = twin(ref, depth, cam, cap_weight=cap_weight, rgb=rgb)
        ref, want_miss = out if fast else (out, 0)
        counts = (kern.launches, f32.launches)
        if color:
            vol, miss = integrate.integrate_color_cuda(
                vol, depth, rgb, cam, cap_weight=cap_weight,
                mode="fast" if fast else "exact")
        elif fast:
            vol, miss = integrate.integrate_fast_cuda(vol, depth, cam,
                                                      cap_weight=cap_weight)
        else:
            vol, miss = integrate.integrate_cuda(
                vol, depth, cam, cap_weight=cap_weight), 0
        assert (kern.launches, f32.launches) == (counts[0] + 1, counts[1])
        assert int(miss) == int(want_miss)
    torch.cuda.synchronize()
    assert _bits_equal(vol.tsdf, ref.tsdf) and _bits_equal(vol.weight, ref.weight)
    assert float(vol.weight.max()) == (2.0 if cap_weight else 3.0)
    if color:
        assert torch.equal(vol.color, ref.color)
        assert int((vol.color.to(torch.int32) > 0).sum()) > 100


@pytest.mark.parametrize("color", [False, True], ids=["depth", "colour"])
@pytest.mark.parametrize("size", [(64, 48, 40), (33, 50, 21)])
def test_bf16_warped_kernel_matches_twin(dev, size, color):
    vol = _warped_volume(dev, size, color).astype(BF16)
    ref = vol.replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
                      color=None if vol.color is None else vol.color.clone())
    f32 = integrate.KERNEL_WARPED_COLOR if color else integrate.KERNEL_WARPED
    kern = integrate.instance(f32, vol)
    for i, depth in enumerate(_bf16_depths(dev)):
        cam = _camera(dev, [40.0 * i, -25.0 * i, -500.0 + 10.0 * i],
                      [0.0, 0.0, 1000.0])
        rgb = torch.from_numpy(np.roll(
            fixtures.gradient_rgb(W, H, diagonal=True), 31 * i, axis=1
        ).copy()).to(dev) if color else None
        ref = integrate_plain(ref, depth, cam, rgb=rgb)
        before = kern.launches
        vol = integrate.integrate_warped_cuda(vol, depth, cam, rgb=rgb)
        assert kern.launches == before + 1
    torch.cuda.synchronize()
    assert _bits_equal(vol.tsdf, ref.tsdf) and _bits_equal(vol.weight, ref.weight)
    assert float(vol.weight.max()) == 3.0
    if color:
        assert torch.equal(vol.color, ref.color)


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("image_term", [False, True])
@pytest.mark.parametrize("size", [(64, 48, 40), (33, 50, 21), (70, 37, 13)])
def test_bf16_pose_grad_kernel_matches_twin(dev, size, image_term, cap_weight):
    """The adjoint's bf16 instance: dd and dw (bf16) bit-equal with the
    twin's, dpinv within 1e-6 of its largest entry, two launches bit-equal;
    x a multiple of 8 (the culled bricks' 16-byte copy) and not."""
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad

    vol, depth, gd, gw = _adjoint_inputs(dev, size, seed=size[0])
    vol, gd, gw = vol.astype(BF16), gd.to(BF16), gw.to(BF16)
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    kw = dict(cap_weight=cap_weight, image_term=image_term)
    before = integrate.KERNEL_POSE_GRAD_BF16.launches
    dd, dw, dp = integrate.pose_grad_cuda(vol, depth, cam, gd, gw, **kw)
    dd2, dw2, dp2 = integrate.pose_grad_cuda(vol, depth, cam, gd, gw, **kw)
    assert integrate.KERNEL_POSE_GRAD_BF16.launches == before + 2
    rd, rw, rp = integrate_pose_grad(vol, depth, cam, gd, gw, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(dd, rd) and _bits_equal(dw, rw)
    assert float((dp - rp).abs().max()) <= 1e-6 * float(rp.abs().max()) + 1e-6
    assert _bits_equal(dd, dd2) and _bits_equal(dw, dw2) and _bits_equal(dp, dp2)
    assert (dd != gd).any() and float(dp.abs().max()) > 0
    # a frame with no depth: a copy of the cotangents, bit for bit
    dd, dw, dp = integrate.pose_grad_cuda(vol, torch.zeros_like(depth), cam,
                                          gd, gw, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(dd, gd) and _bits_equal(dw, gw)
    assert not bool(dp.any())


@pytest.mark.parametrize("case", ["scene", "ragged", "inside", "fused", "nan"])
def test_bf16_raycast_kernel_matches_twin(dev, case):
    """The raycast's bf16 instance on the scenes of the float32 test, cast
    to bf16: hit masks equal, vertices bit-equal where hit; its brick table
    is the float32 table of the widened volume."""
    at, target = [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0]
    if case == "ragged":
        vol = _raycast_scene(dev, size=(45, 37, 29))
    elif case == "inside":
        vol, at = _raycast_scene(dev), [100.0, -80.0, 200.0]
    elif case == "fused":
        vol = _fused_raycast_volume(dev)
        at, target = [0.0, 2.0, -90.0], [0.0, 0.0, 300.0]
    elif case == "nan":
        vol = _raycast_scene(dev, wall=1200.0)
        tsdf = vol.tsdf.clone()
        tsdf[57, 41, 25] = float("nan")
        tsdf[48, 16, 16] = float("nan")
        vol = vol.replace(tsdf=tsdf)
    else:
        vol = _raycast_scene(dev)
    vol = vol.astype(BF16)
    cam = _camera(dev, at, target)
    before = raycast.KERNEL_BF16.launches, raycast.KERNEL.launches
    vk, nk = raycast.raycast_cuda(vol, cam, W, H)
    assert (raycast.KERNEL_BF16.launches, raycast.KERNEL.launches) == (
        before[0] + 1, before[1])
    vp, npl = raycast_plain(vol, cam, W, H)
    torch.cuda.synchronize()
    hits = _assert_same_render(vk, vp)
    assert torch.equal(nk, npl)
    assert hits > 0.2 * W * H
    table = raycast.uniform_bricks(vol.tsdf)
    assert torch.equal(table.isnan(), raycast.uniform_bricks(
        vol.tsdf.float()).isnan())


def test_bf16_integrate_pose_on_the_card_matches_the_cpu(dev):
    """integrate_pose on a bf16 volume, CUDA tensors (the bf16 kernels)
    against CPU tensors (the twins), with the float32 test's tolerances
    and reasons: weights equal on >= 99.9 % of voxels, the twist gradient
    within 1e-3 of its largest component; the fused volume stays bf16."""
    vol, depth, gd, _gw = _adjoint_inputs(dev, (48, 40, 44), seed=7)
    vol = vol.astype(BF16)
    cam = _camera(dev, [100.0, -50.0, -500.0], [0.0, 0.0, 1200.0])
    delta = np.array([0.004, -0.003, 0.002, 12.0, -9.0, 8.0], np.float32)
    grads, outs = [], []
    for d in (dev, torch.device("cpu")):
        v = vol.replace(**{f: getattr(vol, f).to(d) for f in (
            "tsdf", "weight", "physical_size", "offset",
            "truncation_distance", "max_weight", "global_rotation",
            "global_translation")})
        c = Camera.from_numpy(*(t.cpu().numpy() for t in (
            cam.k, cam.pose, cam.k_inv, cam.pose_inv)), device=d)
        x = torch.tensor(delta, device=d, requires_grad=True)
        before = integrate.KERNEL_POSE_GRAD_BF16.launches
        out, miss = integrate.integrate_pose(v, depth.to(d), c, x)
        assert out.tsdf.dtype == out.weight.dtype == BF16
        loss = ((gd.to(d) * out.tsdf.float()).sum()
                + (0.1 * out.weight.float()).sum())
        (g,) = torch.autograd.grad(loss, x)
        assert integrate.KERNEL_POSE_GRAD_BF16.launches == before + (
            d.type == "cuda")
        assert int(miss) == 0
        grads.append(g.cpu())
        outs.append(out.weight.detach().cpu())
    assert (outs[0] == outs[1]).float().mean() >= 0.999
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-3 * float(grads[1].abs().max()))


# -- z-slabs and row tiles (the mesh path's two kernel parameters) --------


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("kind", ["exact", "fast", "color", "color_fast"])
@pytest.mark.parametrize("roll", [0.0, 1.2])
def test_slab_integrate_kernels_match_twins(dev, kind, dtype, roll):
    """A z-slab (planes 4..19 of 40) through the brick walk's kernels,
    whose centres, column lines and cull start at the slab's first plane
    (``z0``): bit-equal with the twin on the same slab, and with planes
    4..19 of the whole volume fused by the same kernel, over three frames;
    the fast kernels' miss counts are the whole volume's share. A 1.2 rad
    roll makes the fast convention skip (and count) every column."""
    size = (64, 48, 40)
    kw = dict(offset=(-1000.0, -800.0, 0.0), dtype=dtype,
              with_color="color" in kind, device=dev)
    whole = make_volume(size, 2000.0, **kw)
    slab = make_volume(size, 2000.0, slab=(4, 16), **kw)
    twin = dataclasses.replace(slab, **{
        f: getattr(slab, f).to("cpu", copy=True) for f in (
            "tsdf", "weight", "color", "physical_size", "offset",
            "truncation_distance", "max_weight", "global_rotation",
            "global_translation") if getattr(slab, f) is not None})
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H)).to(dev)
    mode = "fast" if "fast" in kind else "exact"
    misses = []
    for i in range(3):
        cam = _rolled(_camera(dev, [300.0 + 30.0 * i, 200.0, -700.0],
                              [0.0, 0.0, 1000.0]), roll)
        depth = torch.from_numpy(_frame_depth(i)).to(dev)
        camc = Camera.from_numpy(cam.k.cpu(), cam.pose.cpu(),
                                 cam.k_inv.cpu(), cam.pose_inv.cpu(),
                                 device="cpu")
        for vol, c, d, img in ((whole, cam, depth, rgb), (slab, cam, depth, rgb),
                               (twin, camc, depth.cpu(), rgb.cpu())):
            if "color" in kind:
                _, miss = integrate.integrate_color_cuda(vol, d, img, c,
                                                         mode=mode)
            elif kind == "fast":
                _, miss = integrate.integrate_fast_cuda(vol, d, c)
            else:
                integrate.integrate_cuda(vol, d, c)
                miss = torch.zeros((), dtype=torch.int32)
            misses.append(int(miss))
    torch.cuda.synchronize()
    for f in ("tsdf", "weight", "color"):
        if getattr(slab, f) is None:
            continue
        got, same = getattr(slab, f), _bits_equal
        if f == "color":
            same = torch.equal
        assert same(got.cpu(), getattr(twin, f)), f
        assert same(got, getattr(whole, f)[4:20]), f
    slab_miss, twin_miss = misses[1::3], misses[2::3]
    assert slab_miss == twin_miss
    if roll and mode == "fast":  # every column skipped and counted
        assert min(slab_miss) > 0 and all(
            m <= w for m, w in zip(slab_miss, misses[0::3]))
    else:
        assert float(slab.weight.float().max()) >= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("row0,rows", [(0, 120), (37, 30), (90, 40)])
def test_raycast_row_origin_matches_twin_and_whole_render(dev, dtype, row0,
                                                          rows):
    """A tile of rows row0 .. row0 + rows - 1 (past the image's last row
    where it is longer): each row equals the twin's tile and the same row
    of the whole render bit for bit."""
    vol = _raycast_scene(dev).astype(dtype)
    cam = _camera(dev, [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    whole = raycast.raycast_vertices_cuda(vol, cam, W, H)
    tile = raycast.raycast_vertices_cuda(vol, cam, W, rows, row0=row0)
    twin = raycast.raycast_vertices(vol, cam, W, rows, row0=row0)
    torch.cuda.synchronize()
    _assert_same_render(tile, twin)
    inside = min(rows, H - row0)
    _assert_same_render(tile[:inside], whole[row0:row0 + inside])
    assert bool(torch.isfinite(tile[:inside]).all(-1).any())


# -- the mesh's SceneFusion class and checkpoint on one NCCL rank -----------


class _CardFrames:
    """An RGB-D source and a scene-flow provider over frames already on
    the card."""

    def __init__(self, depth, flows):
        self.depth, self.flows, self.index = depth, flows, 0
        self.observer = None

    def add_observer(self, observer):
        self.observer = observer

    def compute_scene_flow(self, depth=None, rgb=None):
        self.index += 1
        return None, None, self.flows[self.index - 1]

    def start(self):
        for _ in range(len(self.flows) + 1):
            self.observer(self.depth, None)


def _scenefusion_run(dev, dump_dir, mesh=None):
    """Four SceneFusion frames at 48^3 / 1500 mm on a sphere rendered by
    the raycast kernel from the identity pose (uniform +x flows of 4 + i
    mm), a dump every second frame: (the whole volume's tsdf, weight and
    deform on the host, the correspondence counts, the extract_mesh
    vertices, the launch counts of the run)."""
    from tsdf_tpu_torch import kernels
    from tsdf_tpu_torch.ops.marching_cubes import soup_to_numpy
    from tsdf_tpu_torch.pipelines.scenefusion import (
        SceneFusion,
        SceneFusionConfig,
    )

    scene = fixtures.sphere_tsdf(
        make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
                    device=dev), 300.0, centre=(0.0, 0.0, 750.0))
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    depth = raycast.render_to_depth_image_cuda(scene, cam, W, H).float()
    flows = []
    for i in range(3):
        f = torch.zeros((H, W, 3), device=dev)
        f[..., 0] = 4.0 + i
        flows.append(f)
    cfg = SceneFusionConfig(volume_size=(48,) * 3, physical_size_mm=1500.0,
                            offset_mm=(-750.0, -750.0, 0.0),
                            max_cubes=1 << 12, max_vertices=1 << 16)
    src = _CardFrames(depth, flows)
    kernels.reset_launch_counts()
    sf = SceneFusion(src, src, cfg, camera=cam, dump_every=2,
                     dump_dir=dump_dir, mesh=mesh, device=dev)
    src.start()
    soup = sf.extract_mesh()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    vol = sf.volume
    if mesh is not None:
        from tsdf_tpu_torch.parallel.ops import unshard_volume

        vol = unshard_volume(vol, mesh)
    return ({f: getattr(vol, f).cpu() for f in ("tsdf", "weight", "deform")},
            [int(n) for n in sf.correspondence_counts],
            soup_to_numpy(soup)[0], counts)


def _scenefusion_on_1x1(dev, dump_dir):
    from tsdf_tpu_torch.parallel import make_mesh

    return _scenefusion_run(dev, dump_dir, make_mesh(1, 1, device=dev))


def test_scenefusion_mesh_1x1_on_nccl_matches_the_single_class(dev, tmp_path):
    """``SceneFusion(mesh=)`` on a 1x1 mesh over NCCL: tsdf, weight and
    deform bit-equal with the single-card class on the same frames, the
    same correspondence counts, extract_mesh soup and dump files, and the
    same kernel launches."""
    import os

    from tsdf_tpu_torch.parallel.distributed import launch

    (got,) = launch(_scenefusion_on_1x1, 1, (str(tmp_path / "mesh"),),
                    device=str(dev))
    want = _scenefusion_run(dev, str(tmp_path / "single"))
    for f in ("tsdf", "weight", "deform"):
        assert _bits_equal(got[0][f], want[0][f]), f
    assert got[1] == want[1] and min(want[1]) > 100
    assert got[2].tobytes() == want[2].tobytes() and len(want[2]) > 300
    assert got[3] == want[3]
    assert want[3]["integrate_warped"] == 4 and want[3]["row_gather"] == 3 + 2
    names = sorted(os.listdir(tmp_path / "single"))
    assert names == sorted(os.listdir(tmp_path / "mesh")) and len(names) == 6
    for name in names:
        assert ((tmp_path / "mesh" / name).read_bytes()
                == (tmp_path / "single" / name).read_bytes()), name


def _checkpoint_on_1x1(dev, path):
    """A bf16 slab with colour and deformation on the card, fused by the
    kernel, saved on a 1x1 mesh and restored onto a slab on the card and
    onto a whole volume on the host."""
    from tsdf_tpu_torch.parallel import make_mesh
    from tsdf_tpu_torch.parallel.ops import make_sharded_volume
    from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    mesh = make_mesh(1, 1, device=dev)
    kw = dict(offset=(-1000.0, -800.0, 0.0), dtype=BF16, with_color=True)
    slab = make_sharded_volume(mesh, (64, 48, 40), 2000.0, **kw)
    rgb = torch.from_numpy(fixtures.gradient_rgb(W, H)).to(dev)
    for i in range(2):
        cam = _camera(dev, [300.0 + 30.0 * i, 200.0, -700.0],
                      [0.0, 0.0, 1000.0])
        integrate.integrate_color_cuda(
            slab, torch.from_numpy(_frame_depth(i)).to(dev), rgb, cam)
    slab = slab.replace(deform=torch.randn(
        slab.tsdf.shape + (3,), device=dev,
        generator=torch.Generator(dev).manual_seed(2)))
    save_sharded(slab, path, mesh=mesh)
    like = make_sharded_volume(mesh, (64, 48, 40), 2000.0, **kw)
    back = load_sharded(path, like.replace(deform=torch.zeros_like(slab.deform)),
                        mesh=mesh)
    host = make_volume((64, 48, 40), 2000.0, device="cpu", **kw)
    whole = load_sharded(path, host.replace(
        deform=torch.zeros(slab.deform.shape)))
    fields = ("tsdf", "weight", "color", "deform", "global_rotation",
              "offset", "truncation_distance")
    return ({f: (getattr(slab, f).cpu(), getattr(back, f).cpu(),
                 getattr(whole, f)) for f in fields},
            back.device, float(slab.weight.float().max()))


def test_checkpoint_of_a_slab_on_the_card(dev, tmp_path):
    """A CUDA slab's checkpoint restores onto the card and onto a whole
    volume on the host, every field in its dtype, bit for bit."""
    from tsdf_tpu_torch.parallel.distributed import launch

    (fields, where, wmax), = launch(_checkpoint_on_1x1, 1,
                                    (str(tmp_path / "c"),), device=str(dev))
    assert where == dev and wmax >= 1.0
    for name, (saved, back, whole) in fields.items():
        same = torch.equal if saved.dtype == torch.uint8 else _bits_equal
        assert saved.dtype == back.dtype == whole.dtype, name
        assert same(back, saved) and same(whole, saved), name
