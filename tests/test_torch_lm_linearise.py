"""The Levenberg-Marquardt linearisation's plain twin
(``ops/lm_linearise.py``, what ``pipelines/pose_recovery.py:lm_step`` runs
on CPU tensors; on CUDA tensors the kernel ``csrc/lm_linearise.cu``) held
to six forward-mode dual passes through ``banded_residuals``, on the CPU at
64^3 / 80x60.

Each case draws a wall and two spheres from its seed and a twist of the
start pose: xi = 0 (se3_exp's Taylor branch), theta^2 just above the
branch's 1e-8, config 4's 25 mm / 13.7 mrad, and a wide view of a wall at
the volume's far z face whose hits reach its x and y faces (the
sampler's border rules). With the twin's own frozen slope given to the
dual passes, the residuals and the band's mask are equal; each column of
the Jacobian is within 1e-5 of its largest entry (or of its natural size,
where the scene leaves it near 0); the sums of the normal
equations and the damped step's proposal within 1e-5 (the same float32
expressions differentiated by hand and by forward mode round apart by a
few ulps).
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from tsdf_tpu_torch import Camera, make_volume
from tsdf_tpu_torch.kernels.lm import lm_linearise
from tsdf_tpu_torch.ops import lm_linearise as twin
from tsdf_tpu_torch.ops.raycast_diff import depth_image_diff, march
from tsdf_tpu_torch.ops.raycast_diff import slope as reverse_slope
from tsdf_tpu_torch.ops.trilinear import trilinear_sample, trilinear_sample_and_grad
from tsdf_tpu_torch.pipelines.pose_recovery import BAND_MM, banded_residuals, lm_step
from tsdf_tpu_torch.utils import fixtures, profiling
from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

W, H = 80, 60
FX, FY, CX, CY = 73.9, 73.8, 39.5, 29.5
SIZE, PHYSICAL, OFFSET = 64, 2400.0, (-1200.0, -1200.0, 0.0)
STEPS = 512
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twisted(cam, xi):
    return cam.set_pose(matmul_small(se3_exp(xi), cam.pose))


def _scene(seed, faces=False):
    """(volume, true camera): a wall and two spheres drawn from the seed,
    seen from in front of the volume; with ``faces`` a wall at the far z
    face seen wider than the volume."""
    rng = np.random.default_rng(seed)
    vol = make_volume((SIZE,) * 3, PHYSICAL, offset=OFFSET, device="cpu")
    tsdf = fixtures.wall_tsdf(vol, 2360.0 if faces else float(rng.uniform(1800, 2000))).tsdf
    if not faces:
        for _ in range(2):
            centre = (rng.uniform(-350, 350), rng.uniform(-250, 250), rng.uniform(1100, 1500))
            sphere = fixtures.sphere_tsdf(vol, float(rng.uniform(150, 260)), centre=centre)
            tsdf = torch.minimum(tsdf, sphere.tsdf)
    vol = vol.replace(tsdf=tsdf.contiguous(), weight=torch.ones_like(vol.weight))
    at = [float(rng.uniform(-100, 100)), float(rng.uniform(-80, 80)),
          -700.0 if faces else float(rng.uniform(150, 300))]
    cam = (Camera.from_intrinsics(FX, FY, CX, CY, device="cpu")
           .move_to(at).look_at([at[0] * 0.5, at[1] * 0.5, 1500.0]))
    return vol, cam


def _xi(twist, seed):
    rng = np.random.default_rng(seed + 1000)
    w, v = rng.normal(size=3), rng.normal(size=3)
    w, v = w / np.linalg.norm(w), v / np.linalg.norm(v)
    if twist == "zero":
        return torch.zeros(6)
    if twist == "taylor_edge":  # theta^2 = 1.2e-8
        return torch.tensor(np.concatenate([w * np.sqrt(1.2e-8), v * 4.0]), dtype=torch.float32)
    # config 4's offset; the faces case moves as far
    return torch.tensor(np.concatenate([w * 13.7e-3, v * 25.0]), dtype=torch.float32)


def _problem(seed, twist):
    """(volume, start camera, twisted camera, xi, t0, hit, target): the
    target is the true view's corrected render, the start the true pose
    moved by a twist, linearised at ``xi``."""
    vol, cam_true = _scene(seed, faces=twist == "faces")
    with torch.no_grad():
        target, _ = depth_image_diff(vol, cam_true, W, H, max_steps=STEPS)
    cam0 = _twisted(cam_true, _xi("config4", seed + 7))
    xi = _xi(twist, seed)
    cam = _twisted(cam0, xi)
    t0, hit = march(vol, cam, W, H, max_steps=STEPS)
    return vol, cam0, cam, xi, t0, hit, target.detach()


def _dual_passes(vol, cam0, xi, t0, hit, target, fp):
    """(r, mask, (H*W, 6) J): six dual passes through banded_residuals."""
    cols = []
    tangents = torch.eye(6)
    with fwAD.dual_level():
        for j in range(6):
            x = fwAD.make_dual(xi, tangents[j])
            rj, m = banded_residuals(vol, _twisted(cam0, x), target, t0, hit, fp=fp)
            r, dr = fwAD.unpack_dual(rj)
            cols.append(dr.reshape(-1))
    return r.reshape(-1), m.reshape(-1), torch.stack(cols, dim=-1)


def _solve(jtj, jtr, lam=1e-2):
    a = jtj + lam * torch.diag(torch.diag(jtj))
    return torch.linalg.solve(a, -jtr)


@pytest.mark.parametrize("twist", ["zero", "taylor_edge", "config4", "faces"])
@pytest.mark.parametrize("seed", [1, 2])
def test_twin_matches_the_dual_passes(seed, twist):
    vol, cam0, cam, xi, t0, hit, target = _problem(seed, twist)
    sums, rows = lm_linearise(vol, cam0, cam, xi, t0, hit, target, BAND_MM, rows=True)
    fp = twin.slope(vol, cam, t0, W, H)
    r, m, jac = _dual_passes(vol, cam0, xi, t0, hit, target, fp)
    assert int(m.sum()) > 0.3 * W * H
    assert torch.equal(rows[:, 0], r) and torch.equal(rows[:, 7] > 0, m)
    for j in range(6):
        err = (rows[:, 1 + j] - jac[:, j]).abs().max()
        # a wall seen head-on leaves a column near 0; then its rounding is
        # held to the column's natural size: the longest ray for a
        # rotation (mm a radian), 1 for a translation (mm a mm)
        natural = float(t0.max()) if j < 3 else 1.0
        assert err <= TOL * max(float(jac[:, j].abs().max()), natural), (j, float(err))

    j64, r64 = jac.double(), r.double()
    jtj, jtr = j64.T @ j64, j64.T @ r64
    scale = torch.sqrt(torch.diag(jtj))
    got_jtj, got_jtr, got_rr, got_n = twin.normal_equations(sums)
    assert ((got_jtj - jtj).abs() <= TOL * scale[:, None] * scale[None, :]).all()
    rr = float((r64 * r64).sum())
    assert ((got_jtr - jtr).abs() <= TOL * scale * rr ** 0.5).all()
    assert abs(float(got_rr) - rr) <= TOL * rr and float(got_n) == int(m.sum())
    dx, got_dx = _solve(jtj, jtr), _solve(got_jtj, got_jtr)
    assert float((got_dx - dx).norm()) <= TOL * float(dx.norm())

    if twist == "faces":
        # inliers whose point lies in the first or last half voxel of x or
        # y: the lower corner clamped to 0 (u < 0) or the upper taps
        # clamped to the last voxel
        pts = cam.position + t0[:, None] * twin._sampled(vol, cam, t0, W, H)[2] - vol.space_min
        vs = float(vol.voxel_size[0])
        edge = ((pts[:, :2] < vs / 2) | (pts[:, :2] > PHYSICAL - vs / 2)).any(-1)
        assert int((edge & m).sum()) >= 10


@pytest.mark.parametrize("seed", [3, 4])
def test_the_slope_is_the_reverse_mode_slope(seed):
    vol, _cam0, cam, _xi_, t0, hit, _target = _problem(seed, "config4")
    fp = twin.slope(vol, cam, t0, W, H)
    ref = reverse_slope(vol, cam, t0, W, H)
    torch.testing.assert_close(fp[hit], ref[hit], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("where", ["inside", "first_half_voxel", "last_half_voxel",
                                   "below_zero", "past_the_far_face"])
def test_trilinear_gradient_is_the_forward_mode_gradient(where):
    # the wall at the far z face: points in its band, near that face
    vol, _cam = _scene(5, faces=True)
    rng = np.random.default_rng(6)
    vs, trunc = float(vol.voxel_size[0]), float(vol.truncation_distance)
    pts = torch.tensor(rng.uniform([0, 0, 2360 - trunc], [PHYSICAL, PHYSICAL, PHYSICAL],
                                   size=(512, 3)), dtype=torch.float32)
    lo, hi = {"inside": (None, None), "first_half_voxel": (0.0, vs / 2),
              "last_half_voxel": (PHYSICAL - vs / 2, PHYSICAL - 1e-3),
              "below_zero": (-60.0, -1e-3),
              "past_the_far_face": (PHYSICAL, PHYSICAL + 60.0)}[where]
    if lo is not None:  # one coordinate of each point in the region
        axis = torch.tensor(rng.integers(0, 3, size=512))
        value = torch.tensor(rng.uniform(lo, hi, size=512), dtype=torch.float32)
        pts[torch.arange(512), axis] = value
    f, grad = trilinear_sample_and_grad(vol.tsdf, pts, vol.voxel_size)
    assert torch.equal(f, trilinear_sample(vol.tsdf, pts, vol.voxel_size))
    with fwAD.dual_level():
        for a in range(3):
            tangent = torch.zeros_like(pts)
            tangent[:, a] = 1.0
            out = trilinear_sample(vol.tsdf, fwAD.make_dual(pts, tangent), vol.voxel_size)
            ref = fwAD.unpack_dual(out).tangent
            # where the taps' differences are 0 the forward mode rounds to a
            # few 1e-7: held to the tsdf's unit slope (mm a mm)
            torch.testing.assert_close(grad[:, a], ref, rtol=1e-5, atol=1e-5)
    if where in ("below_zero", "past_the_far_face"):
        held = (pts < 0) | (pts >= PHYSICAL)
        assert held.any() and (grad[held] == 0).all()


def test_lm_step_on_the_cpu_takes_the_twin():
    vol, cam0, _cam, xi, _t0, _hit, target = _problem(8, "config4")
    with profiling.counting() as counts:
        xi_new, rms = lm_step(vol, cam0, target, xi, 1e-2, STEPS)
    totals = counts.totals()
    assert "lm.linearised" not in totals and totals["lm.inliers"] > 0.3 * W * H
    assert torch.isfinite(xi_new).all() and float(rms) > 0
