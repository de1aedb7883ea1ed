"""CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), so they skip elsewhere. On the card, run them without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: the kernels are built with --fmad=false and evaluate the
twins' expressions in the same order, so integrate and gather must agree
bit for bit; raycast is held to the same gates as the twin-vs-JAX test
(hit masks >= 99.9% equal, median vertex difference < 0.5 mm).
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch import Camera, make_volume
from tsdf_tpu_torch.kernels import gather, integrate, raycast
from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain
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
