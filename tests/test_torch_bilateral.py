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
    # tile 32x8 with a halo of 5, then 121 weights, float32
    assert kb.shared_bytes(5) == 4 * (42 * 18 + 121)
    assert kb.shared_bytes(filter_radius(3.0)) <= kb.MAX_SHARED_BYTES
    assert kb.shared_bytes(filter_radius(40.0)) > kb.MAX_SHARED_BYTES


def test_wrapper_refuses_bad_input():
    with pytest.raises(TypeError):
        kb.bilateral_filter_cuda(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        kb.bilateral_filter_cuda(torch.zeros((4, 4), device="meta"))
