"""Which of ``csrc/gather.cu``'s three launches the lane gather takes
(``kernels.gather.lane_gather_launch``), on the shapes its callers give
it: the marching-cubes lookups of a dense 512^3 and of a masked 255^3
extraction, and the ICP association's lookup on the three pyramid levels
of a 640x480 frame. The choice is a plain function of the shapes and
strides, so it is held here, off the card; the launches themselves are
held bit for bit against ``take_or_zero`` by the cuda-marked tests.
Exact comparisons throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.ops.marching_cubes import extract_surface as jax_extract
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import TSDFVolume
from tsdf_tpu_torch.kernels import gather
from tsdf_tpu_torch.kernels.gather import (
    BROADCAST_SHARED_BYTES,
    ROWS_MAX_WIDTH,
    ROWS_TILE_WORDS,
    lane_gather_launch,
)
from tsdf_tpu_torch.ops import marching_cubes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "what,cols,width,row_stride,want",
    [
        # one dense 512^3 extraction (n_occ cubes, 2^21 slots)
        ("vertex counts", 1, 256, 0, ("broadcast", 0)),
        ("triangle table", 24, 256 * 24, 0, ("broadcast", 0)),
        ("slot vertices", 72, 36, 36, ("rows", 112)),
        ("slot voxels", 48, 24, 24, ("rows", 168)),
        # the ICP association over the model depth, levels 0-2
        ("ICP level 0", 3 * 640, 640 * 480, 0, ("direct", 2)),
        ("ICP level 1", 3 * 320, 320 * 240, 0, ("direct", 3)),
        ("ICP level 2", 3 * 160, 160 * 120, 0, ("direct", 5)),
    ],
)
def test_launch_on_the_callers_shapes(what, cols, width, row_stride, want):
    assert lane_gather_launch(cols, width, row_stride) == want


@pytest.mark.parametrize(
    "cols,width,row_stride,want",
    [
        # a broadcast table at the shared-memory limit, and one word over
        (5, BROADCAST_SHARED_BYTES // 4, 0, "broadcast"),
        (5, BROADCAST_SHARED_BYTES // 4 + 1, 0, "direct"),
        # narrow rows up to ROWS_MAX_WIDTH words, and one word over
        (3, ROWS_MAX_WIDTH, ROWS_MAX_WIDTH, "rows"),
        (3, ROWS_MAX_WIDTH + 1, ROWS_MAX_WIDTH + 1, "direct"),
        (73, 1, 1, "rows"),
        # a narrow table that is neither broadcast nor contiguous is not
        # taken (the wrapper refuses it before choosing)
        (4, 36, 40, "direct"),
    ],
)
def test_launch_edges(cols, width, row_stride, want):
    launch, tile_rows = lane_gather_launch(cols, width, row_stride)
    assert launch == want
    if launch == "rows":
        # a tile stages at most ROWS_TILE_WORDS words, in rows a multiple
        # of 4, so every tile starts 16-byte aligned
        assert tile_rows % 4 == 0 and tile_rows * width <= ROWS_TILE_WORDS
    if launch == "direct":
        assert tile_rows >= 1 and (tile_rows - 1) * cols < gather.DIRECT_TILE_OUTPUTS


def test_launch_refuses_a_tile_too_long_for_32_bits():
    with pytest.raises(ValueError, match="columns"):
        lane_gather_launch(2**31, 1 << 20, 1 << 20)


def _recorded(monkeypatch, module):
    calls = []
    inner = gather.lane_gather_op

    def wrapper(table, idx):
        calls.append((tuple(table.shape), table.stride(0), tuple(idx.shape)))
        return inner(table, idx)

    monkeypatch.setattr(module, "lane_gather_op", wrapper)
    return calls


@pytest.mark.parametrize("layout", ["dense", "masked"])
def test_launch_of_each_recorded_extraction_call(monkeypatch, layout):
    """The four lookups an extraction makes, recorded at a small size: the
    two table lookups broadcast from shared memory, the two slot lookups
    in staged row tiles; the soup equals the JAX package's."""
    jvol = jax_fixtures.sphere_tsdf(
        tsdf_tpu.make_volume((20, 18, 16), 400.0), 110.0)
    vol = TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=torch.device("cpu"),
    )
    calls = _recorded(monkeypatch, marching_cubes)
    soup = marching_cubes.extract_surface(
        vol, max_cubes=4096, max_vertices=1 << 15, layout=layout)
    launches = [lane_gather_launch(c[1], t[1], s)[0] for t, s, c in calls]
    assert launches == ["broadcast", "broadcast", "rows", "rows"]
    assert [t[1] for t, _, _ in calls] == [256, 256 * 24, 36, 24]
    assert [c[1] for _, _, c in calls] == [1, 24, 72, 48]
    jsoup = jax_extract(jvol, max_cubes=4096, max_vertices=1 << 15)
    assert int(soup.n_vertices) == int(jsoup.n_vertices) > 0


def test_launch_of_the_icp_lookup(monkeypatch):
    """``lookup_flat`` sends the model depth as one broadcast row: too
    large for shared memory at 640x480, read in place; the lookup equals
    direct 2-D indexing."""
    rng = np.random.default_rng(4)
    h, w = 480, 640
    img = torch.from_numpy(rng.uniform(1.0, 9.0, (h, w)).astype(np.float32))
    lin = torch.from_numpy(rng.integers(-w, h * w + w, (h, w)).astype(np.int32))
    idx = torch.cat([lin, lin + 1, lin + w], dim=1)
    calls = _recorded(monkeypatch, gather)
    out = gather.lookup_flat(img, idx)
    assert calls == [((h, h * w), 0, (h, 3 * w))]
    assert lane_gather_launch(3 * w, h * w, 0) == ("direct", 2)
    ok = (idx >= 0) & (idx < h * w)
    assert torch.equal(out[ok], img.flatten()[idx[ok].long()])
    assert not out[~ok].any()
