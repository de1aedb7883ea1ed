"""The port's ICP tracker vs the JAX package, on the CPU.

Inputs are numpy arrays handed to both: random depth for the pyramid and
the maps, and the two-view scene of tests/test_icp.py (a wall and two
spheres rendered from nearby poses) for the normal equations and the
full coarse-to-fine solve.

Tolerances, each with its reason:
  * ``pyr_down``: ``floor(num / den)`` flips where XLA and PyTorch round
    the quotient to either side of an integer: equal on >= 99.9% of the
    pixels, the rest differ by exactly 1;
  * vertex and normal maps: same float32 formulas, rtol 1e-6 / 1e-5, NaN
    in the same places;
  * one step's A, b, residual: float32 sums over ~10^4 pixels in another
    order, and a projected pixel on a rounding boundary may pick the
    neighbouring model pixel: rtol 1e-4 of the largest entry, inliers
    within 0.1%;
  * the full solve: 19 Gauss-Newton steps of a 6x6 float32 solve amplify
    those differences: translation within 0.02 mm, rotation within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdf_tpu import Camera as JaxCamera, make_volume as jax_make_volume
from tsdf_tpu.ops.raycast import render_to_depth_image as jax_render_depth
from tsdf_tpu.tracking import icp as jicp
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch.kernels import gather
from tsdf_tpu_torch.tracking import icp
from tsdf_tpu_torch.utils.se3 import se3_exp

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4
INTR = (FX, FY, CX, CY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_depth(shape, seed, with_nan=False):
    rng = np.random.default_rng(seed)
    d = rng.uniform(400.0, 4000.0, size=shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[:, shape[1] // 2:] += 500.0
    d[0, 0] = 25000.0  # beyond the cutoff
    if with_nan:
        d[rng.uniform(size=shape) < 0.05] = np.nan
    return d


def _scene():
    vol = jax_make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = jax_fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    tsdf = jnp.minimum(jnp.minimum(wall.tsdf, s1.tsdf), s2.tsdf)
    return vol.replace(tsdf=tsdf, weight=jnp.ones_like(vol.weight))


def _delta(kind):
    if kind == "translation":
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = [15.0, -10.0, 8.0]
        return d
    a = 0.02
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 5.0], [0, 1, 0, 0.0], [-s, 0, c, -5.0],
                     [0, 0, 0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def views():
    """{kind: (d_prev, d_curr)} float32 numpy depth of the two-view scene."""
    scene = _scene()
    cam_prev = (JaxCamera.from_intrinsics(*INTR).move_to([0.0, 0.0, -400.0])
                .look_at([0.0, 0.0, 1000.0]))
    d_prev = np.asarray(jax_render_depth(scene, cam_prev, width=W, height=H),
                        np.float32)
    out = {}
    for kind in ("translation", "rotation"):
        cam = cam_prev.set_pose(cam_prev.pose @ jnp.asarray(_delta(kind)))
        out[kind] = (d_prev, np.asarray(
            jax_render_depth(scene, cam, width=W, height=H), np.float32))
    return out


# -- pyramid and maps -------------------------------------------------------


@pytest.mark.parametrize("shape", [(120, 160), (16, 24), (15, 23), (17, 22), (8, 9)])
def test_pyr_down_matches_jax(shape):
    d = _random_depth(shape, seed=7)
    want = np.asarray(jicp.pyr_down(jnp.asarray(d)))
    got = icp.pyr_down(_t(d)).numpy()
    assert got.shape == want.shape == (shape[0] // 2, shape[1] // 2)
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= 0.999
    assert set(np.unique(diff)) <= {0.0, 1.0}


def test_depth_pyramid_and_level_intrinsics():
    d = _random_depth((H, W), seed=3)
    pyr = icp.depth_pyramid(_t(d))
    assert [tuple(p.shape) for p in pyr] == [(H, W), (H // 2, W // 2), (H // 4, W // 4)]
    assert all(p.dtype == torch.float32 for p in pyr)
    assert icp.level_intrinsics(*INTR, 2) == jicp.level_intrinsics(*INTR, 2)
    assert icp.DIST_THRESH_MM == jicp.DIST_THRESH_MM
    assert icp.ANGLE_THRESH == jicp.ANGLE_THRESH
    assert icp.SIGMA_COLOR == jicp.SIGMA_COLOR
    assert icp.DEPTH_CUTOFF_MM == jicp.DEPTH_CUTOFF_MM


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("shape", [(12, 16), (13, 17), (60, 80)])
def test_vertex_and_normal_maps_match_jax(shape, with_nan):
    d = _random_depth(shape, seed=11, with_nan=with_nan)
    intr = (591.1, 590.1, 331.0, 234.6)
    jv = jicp.vertex_map(jnp.asarray(d), *intr)
    jn = np.asarray(jicp.normal_map(jv))
    jv = np.asarray(jv)
    planes = icp.vertex_map_planes(_t(d), *intr)
    tv = torch.stack(planes, dim=-1).numpy()
    tn = torch.stack(icp.normal_map_planes(*planes), dim=-1).numpy()
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
    assert np.isnan(tv).any() and np.isnan(tn[-1]).all() and np.isnan(tn[:, -1]).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0, equal_nan=True)
    # a near-degenerate cross product normalizes to an arbitrary
    # direction: compare where the unnormalized normal is well above its
    # rounding error
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=2e-5, equal_nan=True)
    assert all(p.shape == shape and p.dtype == torch.float32 for p in planes)


# -- one Gauss-Newton step ----------------------------------------------------


def _step_inputs(d_prev, d_curr, lvl):
    intr = jicp.level_intrinsics(*INTR, lvl)
    pc = np.asarray(jicp.depth_pyramid(jnp.asarray(d_curr), 3)[lvl])
    pp = np.asarray(jicp.depth_pyramid(jnp.asarray(d_prev), 3)[lvl])
    return intr, pc, pp


def _check_step(got, want):
    ga, gb, gr, gi = (np.asarray(x, np.float64) for x in got)
    wa, wb, wr, wi = (np.asarray(x, np.float64) for x in want)
    assert wi > 500
    assert abs(gi - wi) <= 1e-3 * wi
    np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-4 * np.abs(wa).max())
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4 * np.abs(wb).max())
    assert gr == pytest.approx(wr, rel=1e-4)
    np.testing.assert_array_equal(ga, ga.T)


POSES = {
    "identity": np.zeros(6, np.float32),
    "near": np.array([0.002, -0.004, 0.001, 9.0, -6.0, 5.0], np.float32),
}


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("lvl", [0, 2])
def test_icp_step_matches_jax(views, lvl, pose):
    d_prev, d_curr = views["translation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, lvl)
    t_pose = se3_exp(_t(POSES[pose])).numpy()
    jvc = jicp.vertex_map(jnp.asarray(pc), *intr)
    jvp = jicp.vertex_map(jnp.asarray(pp), *intr)
    want = jicp.icp_step(
        jnp.asarray(t_pose[:3, :3]), jnp.asarray(t_pose[:3, 3]),
        jvc, jicp.normal_map(jvc), jvp, jicp.normal_map(jvp), *intr)
    tvc = icp.vertex_map_planes(_t(pc), *intr)
    tvp = icp.vertex_map_planes(_t(pp), *intr)
    got = icp.icp_step(
        _t(t_pose[:3, :3]), _t(t_pose[:3, 3]),
        tvc, icp.normal_map_planes(*tvc), tvp, icp.normal_map_planes(*tvp),
        *intr)
    _check_step(got, want)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("lvl,band", [(0, 32), (0, 3), (2, 8)])
def test_icp_step_banded_planes_matches_jax(views, lvl, band, pose):
    d_prev, d_curr = views["rotation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, lvl)
    t_pose = se3_exp(_t(POSES[pose])).numpy()
    jvc = jicp.vertex_map_planes(jnp.asarray(pc), *intr)
    want = jicp.icp_step_banded_planes(
        jnp.asarray(t_pose[:3, :3]), jnp.asarray(t_pose[:3, 3]),
        jvc, jicp.normal_map_planes(*jvc), jnp.asarray(pp), *intr, band=band)
    tvc = icp.vertex_map_planes(_t(pc), *intr)
    tnc = icp.normal_map_planes(*tvc)
    got = icp.icp_step_banded_planes(
        _t(t_pose[:3, :3]), _t(t_pose[:3, 3]), tvc, tnc, _t(pp), *intr,
        band=band)
    _check_step(got, want)


def test_band_drops_displaced_rows(views):
    """A narrow band keeps fewer correspondences than a wide one under a
    vertical shift, and a wide band equals the exact association's
    count up to the one-pixel border the normal stencil needs."""
    d_prev, d_curr = views["translation"]
    intr, pc, pp = _step_inputs(d_prev, d_curr, 0)
    tvc = icp.vertex_map_planes(_t(pc), *intr)
    tnc = icp.normal_map_planes(*tvc)
    pose = se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 60.0, 0.0]))
    counts = [
        float(icp.icp_step_banded_planes(
            pose[:3, :3], pose[:3, 3], tvc, tnc, _t(pp), *intr, band=b,
            dist_thresh=1e9, angle_thresh=10.0)[3])
        for b in (2, 200)
    ]
    assert counts[0] == 0 and counts[1] > 1000


def test_lookup_flat_equals_direct_2d_indexing():
    rng = np.random.default_rng(5)
    img = rng.uniform(1.0, 9.0, (H, W)).astype(np.float32)
    py = rng.integers(-3, H + 3, (H, W)).astype(np.int32)
    px = rng.integers(-3, W + 3, (H, W)).astype(np.int32)
    inside = (py >= 0) & (py < H - 1) & (px >= 0) & (px < W - 1)
    lin = np.where(inside, py * W + px, -1).astype(np.int32)
    before = gather.KERNEL.launches
    got = gather.lookup_flat(
        _t(img), torch.cat([_t(lin), _t(lin) + 1, _t(lin) + W], dim=1)
    ).numpy()
    assert gather.KERNEL.launches == before  # CPU tensors run the twin
    pyc, pxc = np.clip(py, 0, H - 2), np.clip(px, 0, W - 2)
    for k, (oy, ox) in enumerate(((0, 0), (0, 1), (1, 0))):
        want = np.where(inside, img[pyc + oy, pxc + ox], 0.0)
        np.testing.assert_array_equal(
            np.where(inside, got[:, k * W:(k + 1) * W], 0.0), want)
    assert (got[:, :W][~inside] == 0).all()


# -- the full solve ------------------------------------------------------------


def _rot_angle(a, b):
    r = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    return np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))


@pytest.mark.parametrize("band", [None, 32])
@pytest.mark.parametrize("kind", ["translation", "rotation"])
def test_get_incremental_transformation_matches_jax(views, kind, band):
    d_prev, d_curr = views[kind]
    want = jicp.get_incremental_transformation(
        jnp.asarray(d_curr), jnp.asarray(d_prev), *INTR, band=band)
    got = icp.get_incremental_transformation(
        _t(d_curr), _t(d_prev), *INTR, band=band)
    gp, wp = got.pose.numpy(), np.asarray(want.pose)
    assert np.linalg.norm(gp[:3, 3] - wp[:3, 3]) < 0.02
    np.testing.assert_allclose(gp[:3, :3], wp[:3, :3], rtol=0, atol=1e-5)
    assert abs(float(got.inliers) - float(want.inliers)) <= 1e-3 * float(want.inliers)
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-3)
    # and it recovers the motion, as tests/test_icp.py asks of the JAX one
    gt = _delta(kind)
    assert np.linalg.norm(gp[:3, 3] - gt[:3, 3]) < 4.0
    assert np.rad2deg(_rot_angle(gp, gt)) < 0.3
    assert float(got.inliers) > 1000


def test_identity_stays_identity(views):
    d_prev, _ = views["translation"]
    res = icp.get_incremental_transformation(_t(d_prev), _t(d_prev), *INTR, band=32)
    p = res.pose.numpy()
    assert np.linalg.norm(p[:3, 3]) < 1.0 and np.rad2deg(_rot_angle(p, np.eye(4))) < 0.05
    assert float(res.error) < 5.0


def test_conv_eps_zero_equals_the_fixed_schedule(views):
    """conv_eps=0 runs every scheduled iteration: equal, bit for bit, to
    a hand-unrolled 10/5/4 loop over the same step and update."""
    d_prev, d_curr = views["translation"]
    res = icp.get_incremental_transformation(
        _t(d_curr), _t(d_prev), *INTR, conv_eps=0.0)
    pyr_c = icp.depth_pyramid(_t(d_curr))
    pyr_p = icp.depth_pyramid(_t(d_prev))
    pose = torch.eye(4)
    steps = 0
    for lvl in (2, 1, 0):
        intr = icp.level_intrinsics(*INTR, lvl)
        vc = icp.vertex_map_planes(pyr_c[lvl], *intr)
        vp = icp.vertex_map_planes(pyr_p[lvl], *intr)
        nc, np_ = icp.normal_map_planes(*vc), icp.normal_map_planes(*vp)
        for _ in range((10, 5, 4)[lvl]):
            A, b, _r, _i = icp.icp_step(pose[:3, :3], pose[:3, 3], vc, nc, vp,
                                        np_, *intr)
            pose, _score = icp.gn_pose_update(A, b, pose)
            steps += 1
    assert steps == 19
    assert torch.equal(res.pose, pose)


@pytest.mark.parametrize("band", [None, 32])
def test_conv_eps_early_exit_matches_jax(views, band, monkeypatch):
    d_prev, d_curr = views["translation"]
    calls = []
    real = icp.gn_pose_update
    monkeypatch.setattr(
        icp, "gn_pose_update", lambda *a: calls.append(1) or real(*a))
    fast = icp.get_incremental_transformation(
        _t(d_curr), _t(d_prev), *INTR, band=band, conv_eps=0.05)
    n_fast = len(calls)
    full = icp.get_incremental_transformation(
        _t(d_curr), _t(d_prev), *INTR, band=band)
    assert len(calls) - n_fast == 19 and 3 <= n_fast < 19
    want = jicp.get_incremental_transformation(
        jnp.asarray(d_curr), jnp.asarray(d_prev), *INTR, band=band,
        conv_eps=0.05)
    fp, wp = fast.pose.numpy(), np.asarray(want.pose)
    assert np.linalg.norm(fp[:3, 3] - wp[:3, 3]) < 0.02
    np.testing.assert_allclose(fp[:3, :3], wp[:3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(fp[:3, 3], full.pose.numpy()[:3, 3], atol=0.3)


def test_gn_pose_update_damping_and_non_finite():
    pose = se3_exp(torch.tensor([0.1, 0.0, -0.2, 5.0, 6.0, 7.0]))
    new, score = icp.gn_pose_update(torch.zeros(6, 6), torch.zeros(6), pose)
    assert torch.equal(new, pose) and float(score) == 0.0
    bad_b = torch.full((6,), float("nan"))
    new, score = icp.gn_pose_update(torch.eye(6), bad_b, pose)
    assert torch.equal(new, pose) and float(score) == 0.0
    # Sophus ordering: the first three entries of the solution translate
    new, score = icp.gn_pose_update(
        torch.eye(6), torch.tensor([1.0, 2.0, 3.0, 0.0, 0.0, 0.0]), torch.eye(4))
    np.testing.assert_allclose(new[:3, 3].numpy(), [1.0, 2.0, 3.0], rtol=1e-5)
    assert float(score) == pytest.approx(np.sqrt(14.0), rel=1e-5)


def test_zero_depth_gives_no_inliers_and_identity():
    z = torch.zeros((H, W))
    for band in (None, 32):
        res = icp.get_incremental_transformation(z, z, *INTR, band=band)
        assert torch.equal(res.pose, torch.eye(4))
        assert float(res.inliers) == 0.0 and float(res.error) == 0.0
