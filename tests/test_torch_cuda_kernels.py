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
largest entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tsdf_tpu_torch import Camera, make_volume
from tsdf_tpu_torch.kernels import bilateral, gather, integrate, raycast
from tsdf_tpu_torch.ops.bilateral import bilateral_filter as bilateral_plain
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
    with pytest.raises(ValueError, match="shared memory"):
        bilateral.bilateral_filter_cuda(d, sigma_space=40.0)
    with pytest.raises(TypeError):
        bilateral.bilateral_filter_cuda(d.to(torch.float64))
    with pytest.raises(ValueError):
        bilateral.bilateral_filter_cuda(d.t()[:, ::2])
    before = bilateral.KERNEL.launches
    assert bilateral.bilateral_filter_cuda(d[:0]).shape == (0, 16)
    assert bilateral.KERNEL.launches == before


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
    if case != "wild":
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
    wide = torch.zeros((512, 1024), device=dev)
    wide_idx = torch.zeros((512, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="a block can stage"):
        gather.lane_gather_windowed_op(wide, wide_idx, window_blocks=8,
                                       block_rows=128)


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
@pytest.mark.parametrize("size", [(64, 48, 40), (33, 50, 21), (45, 130, 3)])
def test_pose_grad_kernel_matches_twin(dev, size, image_term, cap_weight):
    """The adjoint kernel against its twin: dd and dw bit-equal, dpinv
    within 1e-6 of its largest entry, two launches bit-equal; sizes whose
    x is no multiple of the warp and whose y is no multiple of the block's
    64 rows."""
    vol, depth, gd, gw = _adjoint_inputs(dev, size, seed=size[0])
    cam = _camera(dev, [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    dd, dp = _assert_adjoint_equals_twin(vol, depth, cam, gd, gw,
                                         cap_weight=cap_weight,
                                         image_term=image_term)
    updated = dd != gd
    assert updated.any() and float(dp.abs().max()) > 0
    if cap_weight:
        assert (updated & (vol.weight == 14.0)).any()  # the tie


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
    of the 512-row tile, indices past both ends of the row."""
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.normal(size=(1100, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-10, 140, (1100, 128))
                           .astype(np.int32))
    before = gather.KERNEL_PROBE.launches
    got = gather.gather_probe_cuda(tab.to(dev), idx.to(dev)).cpu()
    assert gather.KERNEL_PROBE.launches == before + 1
    want = gather.gather_probe_plain(tab, idx)
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
