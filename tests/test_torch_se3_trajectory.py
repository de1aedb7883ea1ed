"""The port's SE(3) helpers and trajectory metrics vs the JAX package.

Tolerances: ``se3_exp``/``so3_exp``/``euler_to_matrix`` evaluate the same
float32 formulas (sin, cos, a 3x3 product), so they agree within 1e-6
absolute on rotations and 1e-6 relative on translations; ``ate``/``rpe``
are the same float64 numpy code and agree to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdf_tpu.utils import se3 as jax_se3
from tsdf_tpu.utils import trajectory as jax_traj
from tsdf_tpu_torch.utils import se3, trajectory

TWISTS = [
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    [1e-6, -2e-6, 5e-7, 3.0, -2.0, 1.0],
    [3e-5, 4e-5, 0.0, 0.1, 0.2, 0.3],
    [0.01, -0.02, 0.015, 12.0, -7.0, 4.0],
    [0.4, 0.3, -0.2, 100.0, 50.0, -25.0],
    [1.5, -2.0, 0.7, -300.0, 10.0, 80.0],
    [3.0, 0.5, -0.1, 5.0, 5.0, 5.0],
]


@pytest.mark.parametrize("xi", TWISTS)
def test_se3_exp_matches_jax(xi):
    xi = np.asarray(xi, np.float32)
    want = np.asarray(jax_se3.se3_exp(jnp.asarray(xi)))
    got = se3.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3], [0.0, 0.0, 0.0, 1.0])
    r = got[:3, :3].astype(np.float64)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("xi", TWISTS)
def test_so3_exp_and_hat_match_jax(xi):
    om = np.asarray(xi[:3], np.float32)
    np.testing.assert_allclose(
        se3.so3_exp(torch.from_numpy(om)).numpy(),
        np.asarray(jax_se3.so3_exp(jnp.asarray(om))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        se3.hat(torch.from_numpy(om)).numpy(),
        np.asarray(jax_se3.hat(jnp.asarray(om))))


def test_hat_batched_and_matmul_small():
    rng = np.random.default_rng(0)
    om = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        se3.hat(torch.from_numpy(om)).numpy(),
        np.asarray(jax_se3.hat(jnp.asarray(om))))
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        se3.matmul_small(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        a.astype(np.float64) @ b.astype(np.float64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "angles", [[0.0, 0.0, 0.0], [0.1, -0.2, 0.3], [1.2, 0.7, -2.5]]
)
def test_euler_to_matrix_matches_jax(angles):
    a = np.asarray(angles, np.float32)
    np.testing.assert_allclose(
        se3.euler_to_matrix(torch.from_numpy(a)).numpy(),
        np.asarray(jax_se3.euler_to_matrix(jnp.asarray(a))),
        rtol=0, atol=1e-6)


def _trajectories(n=40, seed=0):
    rng = np.random.default_rng(seed)
    gt, est = [], []
    for i in range(n):
        xi = np.concatenate([0.01 * rng.normal(size=3) + [0, 0.02 * i, 0],
                             [10.0 * i, 3.0 * np.sin(i / 5), 2.0 * i]])
        g = se3.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()
        noise = np.concatenate([1e-3 * rng.normal(size=3),
                                1.5 * rng.normal(size=3)])
        e = g @ se3.se3_exp(torch.from_numpy(noise.astype(np.float32))).numpy()
        gt.append(g)
        est.append(e)
    return est, gt


@pytest.mark.parametrize("align", [True, False])
def test_ate_matches_jax_package(align):
    est, gt = _trajectories()
    a, b = trajectory.ate(est, gt, align=align), jax_traj.ate(est, gt, align=align)
    for key in ("rmse", "mean", "median", "max"):
        assert a[key] == pytest.approx(b[key], abs=1e-9)
    np.testing.assert_allclose(a["errors"], b["errors"], rtol=0, atol=1e-9)
    assert 0.5 < a["rmse"] < 10.0


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_matches_jax_package(delta):
    est, gt = _trajectories(seed=1)
    a, b = trajectory.rpe(est, gt, delta), jax_traj.rpe(est, gt, delta)
    for key in ("trans_rmse", "rot_rmse"):
        assert a[key] == pytest.approx(b[key], abs=1e-9)
    np.testing.assert_allclose(a["trans_errors"], b["trans_errors"], atol=1e-9)


def test_align_rigid_recovers_a_known_motion():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(30, 3)) * 100.0
    rot = se3.so3_exp(torch.tensor([0.3, -0.2, 0.5])).numpy().astype(np.float64)
    moved = 1.7 * pts @ rot.T + [5.0, -3.0, 9.0]
    s, r, t = trajectory.align_rigid(pts, moved, with_scale=True)
    sj, rj, tj = jax_traj.align_rigid(pts, moved, with_scale=True)
    # rot comes from float32: orthonormal to ~1e-7
    assert s == pytest.approx(1.7, rel=1e-6) and s == pytest.approx(sj, abs=1e-12)
    np.testing.assert_allclose(r, rot, atol=1e-6)
    np.testing.assert_allclose(t, tj, atol=1e-9)
    est = [np.eye(4) for _ in pts]
    gt = [np.eye(4) for _ in pts]
    for e, g, p, m in zip(est, gt, pts, pts @ rot.T + [5.0, -3.0, 9.0]):
        e[:3, 3], g[:3, 3] = p, m
    assert trajectory.ate(est, gt)["rmse"] < 1e-4
