"""CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), so they skip elsewhere. On the card, run them without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: the kernels are built with --fmad=false and evaluate the
twins' expressions in the same order, so integrate (exact, colour, fast,
colour-fast and warped, miss counts included), the gathers (lane, row and
windowed, its miss count included) and bilateral must agree bit for bit; raycast is held to the same gates as the twin-vs-JAX test
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
