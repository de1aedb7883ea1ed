"""The port's bilateral filter vs the JAX package, on the CPU.

The same numpy depth image goes through ``tsdf_tpu.ops.bilateral``,
``tsdf_tpu.kernels.bilateral`` (the Pallas kernel in interpret mode) and
the port's wrapper ``bilateral_filter_cuda``, which on CPU tensors runs
the plain twin ``ops.bilateral.bilateral_filter``.

Tolerances: the tap order and the accumulation order are the same, but
``exp`` differs by ulps between XLA and PyTorch on the CPU, so float32
results are held to 1e-3 mm; uint16 results (rounded back to whole mm)
may differ by one count where a value sits on a rounding boundary, on at
most 0.1% of the pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdf_tpu.kernels.bilateral import bilateral_filter_pallas
from tsdf_tpu.ops.bilateral import bilateral_filter as jax_bilateral
from tsdf_tpu_torch.kernels import bilateral as kb
from tsdf_tpu_torch.ops.bilateral import (
    bilateral_filter,
    filter_radius,
    spatial_weights,
)

SHAPES = [(120, 160), (64, 128), (37, 91)]
F32_ATOL_MM = 1e-3
U16_MAX_OFF_BY_ONE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _depth(shape, seed=0):
    """A noisy two-plane scene with a sharp edge and 10% holes, mm."""
    rng = np.random.default_rng(seed)
    d = rng.normal(1000.0, 4.0, shape).astype(np.float32)
    d[:, shape[1] // 2:] += 700.0
    d[rng.uniform(size=shape) < 0.1] = 0.0
    return d


def _check(got, want, dtype):
    assert got.shape == want.shape
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL_MM)
    else:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= U16_MAX_OFF_BY_ONE


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_ops(shape, dtype):
    d = _depth(shape).astype(dtype)
    want = np.asarray(jax_bilateral(jnp.asarray(d)))
    before = kb.KERNEL.launches
    got = kb.bilateral_filter_cuda(torch.from_numpy(d))
    assert kb.KERNEL.launches == before  # CPU tensors run the twin
    assert got.dtype == torch.from_numpy(d).dtype
    _check(got.numpy(), want, dtype)
    assert (got.numpy()[d == 0] == 0).all()
    assert got.numpy()[d > 0].min() > 0


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_pallas_interpret(shape, dtype):
    d = _depth(shape, seed=1).astype(dtype)
    want = np.asarray(bilateral_filter_pallas(jnp.asarray(d), interpret=True))
    got = bilateral_filter(torch.from_numpy(d)).numpy()
    _check(got, want, dtype)


@pytest.mark.parametrize("sigmas", [(8.0, 1.5), (35.0, 4.2), (20.0, 0.5)])
def test_non_default_sigmas(sigmas):
    sc, ss = sigmas
    d = _depth((64, 128), seed=2)
    want = np.asarray(jax_bilateral(jnp.asarray(d), sc, ss))
    got = bilateral_filter(torch.from_numpy(d), sc, ss).numpy()
    _check(got, want, np.float32)


def test_all_holes_stays_zero():
    d = torch.zeros((37, 91), dtype=torch.float32)
    assert not bilateral_filter(d).any()
    assert not bilateral_filter(d.to(torch.uint16)).any()


def test_edge_is_preserved_and_noise_reduced():
    d = _depth((64, 128), seed=3)
    out = bilateral_filter(torch.from_numpy(d)).numpy()
    left = (d > 0) & (np.arange(128)[None, :] < 60)
    right = (d > 0) & (np.arange(128)[None, :] >= 68)
    assert abs(out[left].mean() - 1000.0) < 1.0
    assert abs(out[right].mean() - 1700.0) < 1.0
    assert out[left].std() < 0.5 * d[left].std()


def test_host_weights_and_shared_memory_budget():
    assert filter_radius(3.0) == 5 and filter_radius(0.5) == 1
    w = spatial_weights(3.0)
    assert len(w) == 121 and w[60] == 1.0
    assert w[0] == pytest.approx(np.exp(-50.0 / 9.0), rel=1e-15)
    # a tile of 32x16 pixels with a halo of 5, then 121 weights, float32
    assert kb.shared_bytes(5) == 4 * (42 * 26 + 121)
    assert kb.shared_bytes(filter_radius(3.0)) <= kb.MAX_SHARED_BYTES
    # a block opts in to 227 KB: sigma_space 40 (r = 60) fits, 80 does not
    assert kb.shared_bytes(filter_radius(40.0)) <= kb.MAX_SHARED_BYTES
    assert kb.shared_bytes(filter_radius(80.0)) > kb.MAX_SHARED_BYTES


def test_wrapper_refuses_bad_input():
    with pytest.raises(TypeError):
        kb.bilateral_filter_cuda(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        kb.bilateral_filter_cuda(torch.zeros((4, 4), device="meta"))


def _special(shape, seed):
    """The noisy scene with NaN, +inf, -inf and negative depths scattered
    over it, each on 0.3% of the pixels."""
    d = _depth(shape, seed)
    rng = np.random.default_rng(seed + 100)
    for v in (np.nan, np.inf, -np.inf, -250.0):
        d[rng.uniform(size=shape) < 0.003] = v
    return d


@pytest.mark.parametrize("reference", ["ops", "pallas_interpret"])
@pytest.mark.parametrize("seed", [4, 5])
def test_nan_inf_and_negative_depths_match_jax(reference, seed):
    """A NaN or infinite tap makes its window's sum NaN (tap * 0), a
    negative one adds nothing; the port leaves NaN where JAX does."""
    d = _special((48, 80), seed)
    if reference == "ops":
        want = np.asarray(jax_bilateral(jnp.asarray(d)))
    else:
        want = np.asarray(
            bilateral_filter_pallas(jnp.asarray(d), interpret=True))
    got = kb.bilateral_filter_cuda(torch.from_numpy(d)).numpy()
    assert np.isnan(want).any() and np.isnan(want).mean() < 0.9
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(
        got, want, rtol=0, atol=F32_ATOL_MM, equal_nan=True)


@pytest.mark.parametrize("sigma_space", [6.0, 12.0])
def test_radii_outside_the_compiled_set(sigma_space):
    """r = 9 and r = 18 run the kernel's runtime-radius instance."""
    radius = filter_radius(sigma_space)
    assert kb.launch_plan(radius, 48, 64).instance == 0
    d = _depth((48, 64), seed=radius)
    want = np.asarray(jax_bilateral(jnp.asarray(d), 20.0, sigma_space))
    got = kb.bilateral_filter_cuda(torch.from_numpy(d), 20.0, sigma_space)
    _check(got.numpy(), want, np.float32)


@pytest.mark.parametrize("shape", [(1, 700), (481, 641), (3, 3)])
def test_ragged_shapes(shape):
    d = _depth(shape, seed=shape[1])
    want = np.asarray(jax_bilateral(jnp.asarray(d)))
    got = kb.bilateral_filter_cuda(torch.from_numpy(d)).numpy()
    _check(got, want, np.float32)


@pytest.mark.parametrize(
    "radius,h,w",
    [(5, 480, 640), (3, 480, 640), (5, 481, 641), (9, 1, 700), (60, 3, 3),
     (2, 17, 33)],
)
def test_launch_plan_covers_the_image(radius, h, w):
    plan = kb.launch_plan(radius, h, w)
    assert plan.instance == (radius if radius in kb.COMPILED_RADII else 0)
    # a range constant of 0 (sigma_colour infinite) runs the runtime radius
    assert kb.launch_plan(radius, h, w, range_c=0.0).instance == 0
    assert plan.block == (kb.TILE_W, kb.TILE_H) and plan.rows == kb.ROWS
    gx, gy = plan.grid
    tall = kb.TILE_H * kb.ROWS
    assert gx * kb.TILE_W >= w > (gx - 1) * kb.TILE_W
    assert gy * tall >= h > (gy - 1) * tall
    assert plan.shared_bytes == kb.shared_bytes(radius) <= kb.MAX_SHARED_BYTES


@pytest.mark.parametrize("sigma_space", [3.0, 1.7, 0.5])
def test_weight_block_is_the_spatial_weights_dy_outer(sigma_space):
    radius = filter_radius(sigma_space)
    side = 2 * radius + 1
    block = kb.weight_block(sigma_space, torch.device("cpu")).numpy()
    assert block.dtype == np.float32
    np.testing.assert_array_equal(
        block, np.asarray(spatial_weights(sigma_space), np.float32))
    dy, dx = np.divmod(np.arange(side * side), side)
    direct = np.exp(-((dx - radius) ** 2 + (dy - radius) ** 2)
                    / sigma_space ** 2)
    np.testing.assert_allclose(block, direct.astype(np.float32), rtol=1e-6)


def test_shared_memory_limit_is_where_the_plan_refuses():
    """Every radius up to the largest that fits plans; the next raises."""
    largest = max(r for r in range(1, 200)
                  if kb.shared_bytes(r) <= kb.MAX_SHARED_BYTES)
    assert filter_radius(40.0) <= largest < filter_radius(80.0)
    for r in range(1, largest + 1):
        assert kb.launch_plan(r, 480, 640).shared_bytes <= kb.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        kb.launch_plan(largest + 1, 480, 640)
    with pytest.raises(ValueError, match="shared memory"):
        kb.launch_plan(filter_radius(80.0), 480, 640)
