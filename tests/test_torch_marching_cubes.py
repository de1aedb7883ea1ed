"""Marching cubes and the lane gather in tsdf_tpu_torch vs the JAX package.

Tolerances:
  * ``extract_surface`` vs JAX ``extract_surface(on_cpu=True)``: equal
    ``n_vertices`` and ``overflowed``; vertices in the same order within
    1e-4 mm (float32 edge interpolation, same formula); ``vertex_voxels``
    equal;
  * lane gather twin vs ``_take_or_zero`` and ``lane_gather_op``
    (interpret mode): bit-equal, out-of-range and negative indices
    included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.gather import _take_or_zero, lane_gather_op as jax_lane
from tsdf_tpu.ops.marching_cubes import extract_surface as jax_extract
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import TSDFVolume
from tsdf_tpu_torch.kernels.gather import KERNEL, lane_gather_op, take_or_zero
from tsdf_tpu_torch.ops.marching_cubes import extract_surface, soup_to_numpy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(jvol):
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


def _scene(kind):
    if kind == "sphere":
        vol = tsdf_tpu.make_volume((32,) * 3, 1000.0,
                                   offset=(-500.0, -500.0, -500.0))
        return jax_fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 0.0))
    vol = tsdf_tpu.make_volume((40, 36, 30), 2000.0,
                               offset=(-1000.0, -900.0, 0.0))
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = jax_fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    return vol.replace(tsdf=jnp.minimum(jnp.minimum(wall.tsdf, s1.tsdf),
                                        s2.tsdf))


@pytest.mark.parametrize(
    "kind,max_cubes,max_vertices",
    [
        ("sphere", 1 << 14, 1 << 16),
        ("scene", 1 << 14, 1 << 16),
        ("sphere", 1000, 1 << 16),  # cube buffer overflows
        ("sphere", 1 << 14, 3000),  # vertex buffer overflows
    ],
)
def test_extract_surface_matches_jax(kind, max_cubes, max_vertices):
    jvol = _scene(kind)
    js = jax_extract(jvol, max_cubes=max_cubes, max_vertices=max_vertices,
                     on_cpu=True)
    ts = extract_surface(_to_port(jvol), max_cubes=max_cubes,
                         max_vertices=max_vertices)
    n = int(js.n_vertices)
    assert int(ts.n_vertices) == n
    assert bool(ts.overflowed) == bool(js.overflowed)
    assert n > 1000
    np.testing.assert_allclose(ts.vertices[:n].numpy(),
                               np.asarray(js.vertices)[:n], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ts.vertex_voxels[:n].numpy(),
                                  np.asarray(js.vertex_voxels)[:n])
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    verts, tris = soup_to_numpy(ts)
    assert len(verts) == n // 3 * 3 and tris.shape == (n // 3, 3)


def test_lane_gather_twin_matches_jax():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(24, 150)).astype(np.float32)
    table[1, 0] = np.nan  # must not leak into out-of-range slots
    table[2, 3] = np.inf
    idx = rng.integers(-20, 170, (24, 200)).astype(np.int32)
    idx[1, :5] = -1
    idx[2, :5] = 150
    want_take = np.asarray(_take_or_zero(jnp.asarray(table), jnp.asarray(idx)))
    want_pallas = np.asarray(jax_lane(jnp.asarray(table), jnp.asarray(idx),
                                      interpret=True))
    before = KERNEL.launches
    got = lane_gather_op(torch.from_numpy(table), torch.from_numpy(idx))
    assert KERNEL.launches == before  # CPU tensors: the plain twin
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want_take.view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want_pallas.view(np.int32))


def test_lane_gather_int_and_broadcast_tables():
    rng = np.random.default_rng(3)
    row = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, 256,
                                        dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-4, 260, (50, 7)).astype(np.int32))
    got = lane_gather_op(row[None, :].expand(50, 256), idx)
    want = take_or_zero(row[None, :].expand(50, 256).contiguous(), idx)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    i = idx.numpy()
    ref = np.where((i >= 0) & (i < 256), row.numpy()[np.clip(i, 0, 255)], 0)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bad", ["f64", "idx_i64", "rows", "strided", "1d"])
def test_lane_gather_rejects_bad_inputs(bad):
    table = torch.zeros(4, 8)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    if bad == "f64":
        table = table.double()
    elif bad == "idx_i64":
        idx = idx.long()
    elif bad == "rows":
        idx = idx[:3]
    elif bad == "strided":
        table = torch.zeros(8, 4).t()
    elif bad == "1d":
        table = table[0]
    with pytest.raises((TypeError, ValueError)):
        lane_gather_op(table, idx)
