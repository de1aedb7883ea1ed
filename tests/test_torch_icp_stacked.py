"""The port's stacked ICP forms (``vertex_map``, ``normal_map``,
``icp_step_banded``) vs the JAX package's, on the CPU.

Inputs: random depth for the maps, and the two-view scene of
tests/test_icp.py (a wall and two spheres rendered from nearby poses) for
the normal equations, as in tests/test_torch_icp.py, whose tolerances
these are:
  * the maps: the same float32 formulas, rtol 1e-6 / 1e-5, NaN in the
    same places;
  * one step's A, b, residual: float32 sums in another order, and a
    projected pixel on a rounding boundary may pick the neighbouring model
    pixel: 1e-4 of the largest entry, inliers within 0.1 %.
Within the port the stacked forms equal the planar ones bit for bit, and
a row shard with its ``row_offset`` counts exactly the inliers of the
rows it covers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdf_tpu.tracking import icp as jicp
from tsdf_tpu_torch import tracking
from tsdf_tpu_torch.tracking import icp
from tsdf_tpu_torch.utils.se3 import se3_exp

from test_torch_icp import (  # noqa: F401  (the module fixture views)
    INTR,
    POSES,
    H,
    W,
    _check_step,
    _random_depth,
    _step_inputs,
    _t,
    views,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_exports_match_jax():
    import tsdf_tpu.tracking

    assert set(tsdf_tpu.tracking.__all__) <= set(tracking.__all__)
    for name in ("vertex_map", "normal_map", "icp_step_banded"):
        assert getattr(tracking, name) is getattr(icp, name)


def test_maps_shapes():
    d = torch.full((H, W), 1000.0)
    pyr = icp.depth_pyramid(d)
    assert [tuple(p.shape) for p in pyr] == [(H, W), (H // 2, W // 2), (H // 4, W // 4)]
    vm = icp.vertex_map(pyr[1], *icp.level_intrinsics(*INTR, 1))
    nm = icp.normal_map(vm)
    assert tuple(vm.shape) == (H // 2, W // 2, 3)
    assert nm.shape == vm.shape


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("shape", [(12, 16), (13, 17), (60, 80)])
def test_stacked_maps_match_jax(shape, with_nan):
    d = _random_depth(shape, seed=23, with_nan=with_nan)
    intr = (591.1, 590.1, 331.0, 234.6)
    jv = jicp.vertex_map(jnp.asarray(d), *intr)
    jn = np.asarray(jicp.normal_map(jv))
    jv = np.asarray(jv)
    tv = icp.vertex_map(_t(d), *intr)
    tn = icp.normal_map(tv)
    planes = icp.vertex_map_planes(_t(d), *intr)
    assert torch.equal(tv.nan_to_num(-1.0), torch.stack(planes, -1).nan_to_num(-1.0))
    assert torch.equal(
        tn.nan_to_num(-1.0),
        torch.stack(icp.normal_map_planes(*planes), -1).nan_to_num(-1.0))
    tv, tn = tv.numpy(), tn.numpy()
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0, equal_nan=True)
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=2e-5, equal_nan=True)


def _stacked(pc, intr):
    vm = icp.vertex_map(_t(pc), *intr)
    return vm, icp.normal_map(vm)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("lvl,band", [(0, 32), (0, 3), (2, 8)])
def test_icp_step_banded_matches_jax(views, lvl, band, pose):
    d_prev, d_curr = views["rotation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, lvl)
    t_pose = se3_exp(_t(POSES[pose])).numpy()
    rot, trans = t_pose[:3, :3], t_pose[:3, 3]
    jvm = jicp.vertex_map(jnp.asarray(pc), *intr)
    want = jicp.icp_step_banded(
        jnp.asarray(rot), jnp.asarray(trans), jvm, jicp.normal_map(jvm),
        jnp.asarray(pp), *intr, band=band)
    vm, nm = _stacked(pc, intr)
    got = icp.icp_step_banded(_t(rot), _t(trans), vm, nm, _t(pp), *intr,
                              band=band)
    _check_step(got, want)
    planar = icp.icp_step_banded_planes(
        _t(rot), _t(trans), vm.unbind(-1), nm.unbind(-1), _t(pp), *intr,
        band=band)
    assert all(torch.equal(a, b) for a, b in zip(got, planar))


@pytest.mark.parametrize("split", [0.5, 0.3])
def test_row_shards_with_row_offset_match_jax(views, split):
    """The current maps cut into a top and a bottom row shard against the
    whole model image: each shard, with its first row as ``row_offset``,
    against JAX's; the shards' inliers add up to the whole frame's."""
    d_prev, d_curr = views["translation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, 0)
    t_pose = se3_exp(_t(POSES["near"])).numpy()
    rot, trans = t_pose[:3, :3], t_pose[:3, 3]
    vm, nm = _stacked(pc, intr)
    jvm = jicp.vertex_map(jnp.asarray(pc), *intr)
    jnm = jicp.normal_map(jvm)
    cut = int(H * split)
    whole = icp.icp_step_banded(_t(rot), _t(trans), vm, nm, _t(pp), *intr,
                                band=8)
    inliers = 0.0
    for lo, hi in ((0, cut), (cut, H)):
        got = icp.icp_step_banded(
            _t(rot), _t(trans), vm[lo:hi], nm[lo:hi], _t(pp), *intr,
            band=8, row_offset=lo)
        want = jicp.icp_step_banded(
            jnp.asarray(rot), jnp.asarray(trans), jvm[lo:hi], jnm[lo:hi],
            jnp.asarray(pp), *intr, band=8, row_offset=lo)
        _check_step(got, want)
        as_tensor = icp.icp_step_banded(
            _t(rot), _t(trans), vm[lo:hi], nm[lo:hi], _t(pp), *intr,
            band=8, row_offset=torch.tensor(lo))
        assert all(torch.equal(a, b) for a, b in zip(got, as_tensor))
        inliers += float(got[3])
    assert inliers == float(whole[3])
    # without its offset the bottom shard measures the band against the
    # wrong rows and keeps almost nothing
    wrong = icp.icp_step_banded(_t(rot), _t(trans), vm[cut:], nm[cut:],
                                _t(pp), *intr, band=8)
    assert float(wrong[3]) < 0.1 * float(whole[3])


def test_adaptive_has_no_effect(views):
    d_prev, d_curr = views["rotation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, 1)
    vm, nm = _stacked(pc, intr)
    rot, trans = torch.eye(3), torch.zeros(3)
    a = icp.icp_step_banded(rot, trans, vm, nm, _t(pp), *intr, adaptive=True)
    b = icp.icp_step_banded(rot, trans, vm, nm, _t(pp), *intr, adaptive=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    jvm = jicp.vertex_map(jnp.asarray(pc), *intr)
    want = jicp.icp_step_banded(
        jnp.eye(3), jnp.zeros(3), jvm, jicp.normal_map(jvm), jnp.asarray(pp),
        *intr, adaptive=False)
    _check_step(a, want)
