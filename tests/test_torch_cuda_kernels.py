"""CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), so they skip elsewhere. On the card, run them without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: the kernels are built with --fmad=false and evaluate the
twins' expressions in the same order, so integrate (exact, colour, fast and
colour-fast, miss counts included), gather and bilateral must agree bit for
bit; raycast is held to the same gates as the twin-vs-JAX test
(hit masks >= 99.9% equal, median vertex difference < 0.5 mm).
"""

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


def test_raycast_kernel_matches_twin(dev):
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    vol = vol.replace(tsdf=torch.minimum(wall.tsdf, s1.tsdf).contiguous())
    cam = _camera(dev, [60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    vk, nk = raycast.raycast_cuda(vol, cam, W, H)
    vp, npl = raycast_plain(vol, cam, W, H)
    torch.cuda.synchronize()
    hk = torch.isfinite(vk).all(-1)
    hp = torch.isfinite(vp).all(-1)
    assert (hk == hp).float().mean() >= 0.999
    both = hk & hp
    err = (vk[both] - vp[both]).norm(dim=-1)
    assert float(err.median()) < 0.5
    assert int(both.sum()) > 0.5 * W * H


def test_depth_image_through_the_raycast_kernel(dev):
    """The ``icp`` verb's model depth: one raycast launch, then the u16
    tail the twin shares; within one count of the twin's image."""
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
    assert ((got > 0) == (want > 0)).float().mean() >= 0.999
    both = (got > 0) & (want > 0)
    assert int(both.sum()) > 1000
    assert int((got[both] - want[both]).abs().max()) <= 1


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
