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
from tsdf_tpu_torch import Camera, kernels, make_volume
from tsdf_tpu_torch.kernels import gather as tgather
from tsdf_tpu_torch.ops import deform
from tsdf_tpu_torch.ops.marching_cubes import extract_surface, soup_to_numpy
from tsdf_tpu_torch.pipelines import scenefusion as tsf
from tsdf_tpu_torch.utils import fixtures

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


def _rows_both(table, idx):
    """The JAX kernel (interpret mode) and the port's wrapper on the same
    rows; both as int32 words, so equal means equal bytes."""
    want = np.asarray(jgather.row_gather_op(
        jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = tgather.row_gather_op(torch.as_tensor(table), torch.as_tensor(idx))
    return got.numpy().view(np.int32), want.view(np.int32)


def _f32_rows(rng, n, w):
    """Random float32 rows with a -0.0 and a NaN, whose bytes a gather
    that went through arithmetic would not keep."""
    table = rng.standard_normal((n, w)).astype(np.float32)
    table[0, 0] = -0.0
    table[1, -1] = np.nan
    return table


@pytest.mark.parametrize("w", [3, 4], ids=["w3", "w4"])
@pytest.mark.parametrize("j", [1, 2, 3, 4, 5, 7, 8, 9, 4097])
def test_row_gather_twin_matches_pallas_at_group_tails(w, j):
    """J around the CUDA kernel's groups at its two compiled widths: pairs
    of 12-byte rows (an odd J leaves a row to its tail) and 128 16-byte
    rows a warp (a ragged last group is masked)."""
    rng = np.random.default_rng(10 * j + w)
    n = 61
    table = _f32_rows(rng, n, w)
    idx = rng.integers(-3, n + 3, j).astype(np.int32)
    got, want = _rows_both(table, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, table[np.clip(idx, 0, n - 1)].view(np.int32))


@pytest.mark.parametrize("w", [3, 4], ids=["w3", "w4"])
def test_row_gather_twin_matches_pallas_at_extreme_indices(w):
    """Indices at INT32_MIN, -1, N-1, N and INT32_MAX clamp to the first
    and the last row (no overflow in the clamp)."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    n = 17
    table = _f32_rows(np.random.default_rng(w), n, w)
    idx = np.array([lo, -1, n - 1, n, hi, 0, lo + 1, hi - 1, 5], np.int32)
    got, want = _rows_both(table, idx)
    np.testing.assert_array_equal(got, want)
    rows = [0, 0, n - 1, n - 1, n - 1, 0, 0, n - 1, 5]
    np.testing.assert_array_equal(got, table[rows].view(np.int32))


def _small_sphere(radius, with_field=False):
    """32^3 over 1500 mm with a sphere at z = 750 mm."""
    vol = make_volume((32, 32, 32), 1500.0, offset=(-750.0, -750.0, 0.0),
                      with_deformation=True, device=CPU)
    vol = fixtures.sphere_tsdf(vol, radius, centre=(0.0, 0.0, 750.0))
    if with_field:
        rng = np.random.default_rng(5)
        field = vol.deform + torch.from_numpy(rng.uniform(
            -20.0, 20.0, tuple(vol.deform.shape)).astype(np.float32))
        vol = vol.replace(deform=field)
    return vol


def test_row_gather_twin_matches_pallas_on_the_correspondence_lookup(
        monkeypatch):
    """The call ``_slot_correspondence`` makes in a SceneFusion frame
    (32^3, 64x48), recorded: a (H*W, 4) [depth, flow] table and one index
    per slot of the masked layout, every dead slot reading pixel 0."""
    h, w, max_cubes = 48, 64, 2048
    cam = (Camera.from_intrinsics(59.11, 59.01, 33.1, 23.46, device=CPU)
           .move_to([0.0, 0.0, -200.0]).look_at([0.0, 0.0, 750.0]))
    depth = torch.from_numpy(
        fixtures.sphere_depth_map(w, h, 20.0, 800.0, 1200.0).astype(np.float32))
    flow = torch.from_numpy(np.random.default_rng(3).uniform(
        -5.0, 5.0, (h, w, 3)).astype(np.float32))
    calls = []
    real = tsf.row_gather_op
    monkeypatch.setattr(tsf, "row_gather_op",
                        lambda t, i: calls.append((t, i)) or real(t, i))
    _, _, overflowed = tsf.scenefusion_step(
        _small_sphere(300.0), depth, flow, cam, max_cubes=max_cubes)
    assert not bool(overflowed) and len(calls) == 1
    table, idx = calls[0]
    assert table.shape == (h * w, 4) and idx.shape == (max_cubes * 24,)
    live = int((idx > 0).sum())
    assert live > 100 and int((idx == 0).sum()) > idx.numel() // 2
    got, want = _rows_both(table.numpy(), idx.numpy())
    np.testing.assert_array_equal(got, want)


def test_row_gather_twin_matches_pallas_on_the_deform_points_taps(
        monkeypatch):
    """The 8 taps of ``deform_points`` on the mesh of a small volume,
    recorded: the (N^3, 3) deformation field and 8 indices a vertex."""
    vol = _small_sphere(200.0, with_field=True)
    verts, _ = soup_to_numpy(extract_surface(vol, max_cubes=1 << 12,
                                             max_vertices=1 << 16))
    assert len(verts) > 1000
    calls = []
    real = deform.row_gather_op
    monkeypatch.setattr(deform, "row_gather_op",
                        lambda t, i: calls.append((t, i)) or real(t, i))
    deform.deform_points(vol, verts)
    assert len(calls) == 1
    table, idx = calls[0]
    assert table.shape == (32**3, 3) and idx.shape == (8 * len(verts),)
    got, want = _rows_both(table.numpy(), idx.numpy())
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("rows,g", [(1000, 64), (512, 5), (7, 0)])
def test_gather_probe_twin(rows, g):
    """The probe's twin (what csrc/probe_gather.cu computes) against the
    body of tools/probe_gather_roofline.py:_kern written in numpy: g
    in-row gathers at clip(idx + i, 0, 127), summed in order of i; the
    wrapper on CPU tensors is the twin."""
    rng = np.random.default_rng(rows)
    tab = rng.normal(size=(rows, 128)).astype(np.float32)
    idx = rng.integers(-10, 140, (rows, 128)).astype(np.int32)
    want = np.zeros_like(tab)
    for i in range(g):
        want = want + np.take_along_axis(tab, np.clip(idx + i, 0, 127), axis=1)
    t, ix = torch.from_numpy(tab), torch.from_numpy(idx)
    got = tgather.gather_probe_plain(t, ix, g)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tgather.gather_probe_cuda(t, ix, g), got)
    with pytest.raises(ValueError, match="columns"):
        tgather.gather_probe_cuda(t[:, :64].contiguous(),
                                  ix[:, :64].contiguous(), g)


# -- the direct-form windowed kernel's tilings; the probe's wavefronts ---------


@pytest.mark.parametrize("case", ["narrow", "wild", "out_of_range"])
@pytest.mark.parametrize(
    "s,c,w,kw",
    [
        # a window of 128 rows by 1024 words: more than a block could stage
        (256, 130, 1024, {"window_blocks": 8, "block_rows": 128}),
        # tiles of 256 rows, whose indices the kernel reads twice
        (256, 257, 512, {"block_rows": 256}),
    ],
    ids=["bs128-wb8-c130", "bs256-c257"],
)
def test_windowed_twin_matches_pallas_tall_tiles(s, c, w, kw, case):
    """Tilings the staging kernel refused or never ran, at column counts
    no multiple of 4 or of 128: out and the miss count equal the JAX
    kernel's."""
    rng = np.random.default_rng(s + c + w)
    tab = rng.standard_normal((s, w)).astype(np.float32)
    if case == "narrow":
        idx = _narrow(s, c, w)
    elif case == "wild":
        idx = rng.integers(-10, w + 10, (s, c)).astype(np.int32)
    else:
        idx = np.where(rng.uniform(size=(s, c)) < 0.5, -3, w + 4).astype(np.int32)
    out_j, miss_j, out_t, miss_t = _windowed_both(tab, idx, **kw)
    assert miss_t == miss_j
    if case == "out_of_range":
        assert miss_t == 0 and not out_t.any()  # no index reads the table
    elif kw.get("window_blocks") == 8:
        assert miss_t == 0  # the window is the whole table
    else:
        # a 256-row tile of either index set spans more than 256 columns
        assert miss_t > 0
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("case", ["narrow", "wild"])
@pytest.mark.parametrize(
    "kw", [{"window_blocks": 8, "block_rows": 128}, {"block_rows": 256}],
    ids=["bs128-wb8", "bs256"],
)
def test_checked_equals_the_full_gather_at_tall_tiles(kw, case):
    """``lane_gather_checked`` at the tilings the staging kernel refused or
    never ran equals ``take_or_zero`` and the JAX ``lane_gather_checked``,
    whether the windows miss or not."""
    rng = np.random.default_rng(17)
    s, w, c = 256, 1024, 130
    tab = rng.standard_normal((s, w)).astype(np.float32)
    if case == "narrow":
        idx = _narrow(s, c, w)
    else:
        idx = rng.integers(-10, w + 10, (s, c)).astype(np.int32)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    got = tgather.lane_gather_checked(t, i, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  tgather.take_or_zero(t, i).numpy())
    jax_out = jgather.lane_gather_checked(
        jnp.asarray(tab), jnp.asarray(idx), interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))


def test_probe_wavefronts_on_constructed_warps():
    """At g = 1: all lanes of a warp on one word is one wavefront (a
    broadcast); lanes on columns 0, 32, 64 and 96 (four words of bank 0)
    take four; indices that clip to column 127 share its word."""
    one_word = torch.full((1, 128), 5, dtype=torch.int32)
    assert tgather.probe_wavefronts(one_word, 1) == 4  # four warps, one each
    bank0 = torch.tensor([[0, 32, 64, 96] * 32], dtype=torch.int32)
    assert tgather.probe_wavefronts(bank0, 1) == 16
    clipped = torch.tensor([[127, 200, 1000, 2**30] * 32], dtype=torch.int32)
    assert tgather.probe_wavefronts(clipped, 1) == 4
    distinct = torch.arange(128, dtype=torch.int32)[None]  # 32 banks, a word each
    assert tgather.probe_wavefronts(distinct, 1) == 4
    assert tgather.probe_wavefronts(distinct, 0) == 0


@pytest.mark.parametrize("g", [1, 5, 64])
def test_probe_wavefronts_match_a_brute_force_count(g):
    rng = np.random.default_rng(64 + g)
    idx = rng.integers(-10, 140, (64, 128)).astype(np.int32)
    want = 0
    for r in range(64):
        for w0 in range(0, 128, 32):
            for i in range(g):
                cols = np.clip(idx[r, w0:w0 + 32] + i, 0, 127)
                banks = {}
                for col in set(cols.tolist()):
                    banks[col % 32] = banks.get(col % 32, 0) + 1
                want += max(banks.values())
    assert tgather.probe_wavefronts(torch.from_numpy(idx), g) == want
