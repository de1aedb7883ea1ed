"""The row gather and the windowed lane gather of tsdf_tpu_torch vs the JAX
package, on the CPU (CPU tensors run the kernels' plain twins; the JAX
Pallas kernels run in interpret mode, as in tests/test_scatter.py).

Gathers move values and add nothing, so every comparison is exact: equal
bytes for the row gather, equal values AND an equal miss count for the
windowed gather. The miss count depends on how ``idx`` is cut into tiles,
so it also checks that the twin reproduces the JAX kernel's partition
(rows padded to a multiple of 8, the tile height halved until it divides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdf_tpu.kernels import gather as jgather
from tsdf_tpu_torch import kernels
from tsdf_tpu_torch.kernels import gather as tgather

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, n, w, dtype):
    if dtype == np.float32:
        return rng.standard_normal((n, w)).astype(np.float32)
    hi = 255 if dtype == np.uint8 else 1 << 27
    return rng.integers(0, hi, (n, w)).astype(dtype)


# -- row gather -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8],
                         ids=["f32", "i32", "u8"])
@pytest.mark.parametrize("n,w,j", [(37, 4, 301), (50, 3, 64), (20, 130, 17)],
                         ids=["w4", "w3", "w130"])
def test_row_gather_twin_matches_pallas(dtype, n, w, j):
    """Rows of 4 (the [depth, flow] lookup), 3 (the deformation field) and
    130 words (not a multiple of 128), with indices below 0 and beyond the
    table, which both sides clamp."""
    rng = np.random.default_rng(n * w + j)
    table = _table(rng, n, w, dtype)
    idx = rng.integers(-5, n + 5, j).astype(np.int32)
    assert (idx < 0).any() and (idx >= n).any()
    want = np.asarray(jgather.row_gather_op(
        jnp.asarray(table), jnp.asarray(idx), interpret=True))
    kernels.reset_launch_counts()
    got = tgather.row_gather_op(torch.from_numpy(table), torch.from_numpy(idx))
    assert kernels.launch_counts()["row_gather"] == 0  # no kernel on the CPU
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[np.clip(idx, 0, n - 1)])


def test_row_gather_empty_and_bad_inputs():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = tgather.row_gather_op(table, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 3) and out.dtype == torch.float32
    idx = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        tgather.row_gather_op(table, idx.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tgather.row_gather_op(table.t(), idx)
    with pytest.raises(ValueError):
        tgather.row_gather_op(table, idx[None])
    with pytest.raises(ValueError, match="no rows"):
        tgather.row_gather_op(table[:0], idx)
    with pytest.raises(ValueError, match="idx is on"):
        tgather.row_gather_op(table, idx.to("meta"))


# -- windowed lane gather -----------------------------------------------------


def _narrow(s, c, w):
    """tests/test_scatter.py:144-147: each tile spans under 128 columns."""
    return (((np.arange(c)[None, :] % 100)
             + (np.arange(s)[:, None] // 64) * 128).astype(np.int32) % w)


def _windowed_both(tab, idx, **kw):
    out_j, miss_j = jgather.lane_gather_windowed_op(
        jnp.asarray(tab), jnp.asarray(idx), interpret=True, **kw)
    out_t, miss_t = tgather.lane_gather_windowed_op(
        torch.from_numpy(tab), torch.from_numpy(idx), **kw)
    assert miss_t.dtype == torch.int32 and miss_t.dim() == 0
    return np.asarray(out_j), int(miss_j), out_t.numpy(), int(miss_t)


@pytest.mark.parametrize("s", [96, 93, 7], ids=["rows96", "rows93", "rows7"])
def test_windowed_twin_matches_pallas_narrow(s):
    """Coherent indices: no miss, and the result is the full gather's."""
    rng = np.random.default_rng(3)
    w, c = 512, 200
    tab = rng.standard_normal((s, w)).astype(np.float32)
    idx = _narrow(s, c, w)
    out_j, miss_j, out_t, miss_t = _windowed_both(tab, idx)
    assert miss_j == miss_t == 0
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(
        out_t, tgather.take_or_zero(torch.from_numpy(tab),
                                    torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize(
    "s,c,w,kw",
    [
        (96, 200, 512, {}),
        (93, 200, 512, {}),  # rows not a multiple of 8: bs halves to 8
        (50, 130, 640, {"window_blocks": 1, "block_rows": 16}),
        (24, 300, 256, {"window_blocks": 4}),  # window wider than the table
        (40, 64, 1024, {"block_rows": 48}),  # 48 -> 24 -> 12 -> 6 -> 3 -> 1
    ],
    ids=["96", "93", "w640-wb1", "wb-clamped", "odd-block-rows"],
)
def test_windowed_twin_matches_pallas_wild(s, c, w, kw):
    """Wild indices, some out of range: the windows miss, and the twin
    counts exactly the misses the JAX kernel counts, tile for tile."""
    rng = np.random.default_rng(s + c)
    tab = rng.standard_normal((s, w)).astype(np.float32)
    idx = rng.integers(-10, w + 10, (s, c)).astype(np.int32)
    out_j, miss_j, out_t, miss_t = _windowed_both(tab, idx, **kw)
    assert miss_t == miss_j
    if w > 128 * kw.get("window_blocks", 2):
        assert miss_t > 0
    np.testing.assert_array_equal(out_t, out_j)


def test_window_tiling_is_the_jax_rule():
    assert tgather.window_tiling(96, 512, 2, 64) == (32, 2)
    assert tgather.window_tiling(93, 512, 2, 64) == (32, 2)  # padded to 96
    assert tgather.window_tiling(7, 512, 2, 64) == (8, 2)
    assert tgather.window_tiling(4096, 2048, 2, 64) == (64, 2)
    assert tgather.window_tiling(40, 256, 4, 48) == (1, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        tgather.window_tiling(8, 130, 2, 64)


@pytest.mark.parametrize("case", ["narrow", "wild", "all_out_of_range"])
@pytest.mark.parametrize("fn", ["checked", "fast"])
def test_checked_and_fast_equal_the_full_gather(fn, case):
    """``lane_gather_checked`` and ``lane_gather_fast`` equal
    ``take_or_zero`` (and the JAX ``lane_gather_checked``) on every input,
    whether or not the windows miss."""
    rng = np.random.default_rng(11)
    s, w, c = 93, 512, 200
    tab = rng.standard_normal((s, w)).astype(np.float32)
    tab[0, 0] = np.nan  # a NaN at the clamped position must not leak
    if case == "narrow":
        idx = _narrow(s, c, w)
    elif case == "wild":
        idx = rng.integers(-10, w + 10, (s, c)).astype(np.int32)
    else:
        idx = np.where(rng.uniform(size=(s, c)) < 0.5, -3, w + 4).astype(np.int32)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    want = tgather.take_or_zero(t, i)
    kernels.reset_launch_counts()
    got = (tgather.lane_gather_checked if fn == "checked"
           else tgather.lane_gather_fast)(t, i)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_out = jgather.lane_gather_checked(
        jnp.asarray(tab), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))


def test_windowed_int32_table_and_bad_inputs():
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.integers(0, 1 << 30, (8, 256)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 100, (8, 40)).astype(np.int32))
    out, miss = tgather.lane_gather_windowed_op(tab, idx)
    assert out.dtype == torch.int32 and int(miss) == 0
    assert torch.equal(out, tgather.take_or_zero(tab, idx))
    empty, miss = tgather.lane_gather_windowed_op(
        tab, torch.zeros((8, 0), dtype=torch.int32))
    assert empty.shape == (8, 0) and int(miss) == 0
    with pytest.raises(ValueError, match="multiple of 128"):
        tgather.lane_gather_windowed_op(tab[:, :130].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        tgather.lane_gather_windowed_op(tab[:1].expand(8, 256), idx)
    with pytest.raises(TypeError):
        tgather.lane_gather_windowed_op(tab.to(torch.float64), idx)
    with pytest.raises(ValueError, match="rows"):
        tgather.lane_gather_windowed_op(tab, idx[:4].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        tgather.lane_gather_fast(tab[:, :130].contiguous(), idx)
