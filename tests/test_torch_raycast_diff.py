"""Differentiable raycasting in tsdf_tpu_torch: gradient checks, pose
recovery, and agreement with the JAX package.

The port's ``ops.raycast_diff`` (march with no gradient, then the
differentiable Newton correction) is held to the JAX suite's own checks
(tests/test_raycast_diff.py: the finite-difference pose gradient, the
taps-only tsdf gradient, descent recovery) and against
``tsdf_tpu.ops.raycast_diff`` on the same volume and camera with
``max_steps=256``.

Tolerances against JAX:
  * hit masks equal on >= 99.9 % of rays, vertices within 0.5 mm median
    and 1e-2 mm at the 99th percentile where both hit (the marches step in
    another float32 order; the Newton correction pulls both onto the same
    zero crossing: 2.8e-4 mm at the 99th percentile here);
  * the masked-depth pose gradient within 1e-4 of its largest component
    (5e-6 here);
  * the tsdf gradient: nonzero on the same voxels (>= 99.9 % of the
    union), and within 1e-3 of the largest magnitude (4.8e-5 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import tsdf_tpu
from tsdf_tpu.ops.raycast_diff import depth_image_diff as jax_depth_image_diff
from tsdf_tpu.ops.raycast_diff import raycast_diff as jax_raycast_diff
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu.utils.se3 import se3_exp as jax_se3_exp
from tsdf_tpu_torch import Camera, TSDFVolume
from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
from tsdf_tpu_torch.ops.raycast import raycast_vertices
from tsdf_tpu_torch.ops.raycast_diff import (
    correct,
    depth_image_diff,
    march,
    raycast_diff,
    vertices_to_depth,
)
from tsdf_tpu_torch.pipelines.pose_recovery import (
    banded_residuals,
    lm_step,
    recover_pose_lm,
)
from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

CPU = torch.device("cpu")
W, H = 80, 60
FX, FY, CX, CY = 591.1 / 8, 590.1 / 8, 331.0 / 8, 234.6 / 8
STEPS = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene():
    vol = tsdf_tpu.make_volume((48, 48, 48), 2000.0,
                               offset=(-1000.0, -1000.0, 0.0))
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    return vol.replace(tsdf=jnp.minimum(wall.tsdf, s1.tsdf),
                       weight=jnp.ones_like(vol.weight))


def _jax_camera():
    return (tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY)
            .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))


def _scene():
    jvol = _jax_scene()
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


def _camera():
    jcam = _jax_camera()
    return Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")),
        device=CPU,
    )


def _twisted(cam, xi):
    return cam.set_pose(matmul_small(se3_exp(xi), cam.pose))


def _eroded_mask(hit, depth=None, max_jump=30.0):
    """5x5 erosion of silhouettes and occlusion boundaries: the loss is
    only smooth where neighbouring rays hit the same surface patch."""
    h = np.asarray(hit).copy()
    if depth is not None:
        d = np.asarray(depth)
        lo = d.copy()
        hi = d.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                r = np.roll(np.roll(d, dy, 0), dx, 1)
                lo = np.minimum(lo, r)
                hi = np.maximum(hi, r)
        h &= (hi - lo) < max_jump
    out = h.copy()
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            out &= np.roll(np.roll(h, dy, 0), dx, 1)
    out[0:2, :] = out[-2:, :] = False
    out[:, 0:2] = out[:, -2:] = False
    return out


def _masked_depth_grad(vol, cam, mask):
    xi = torch.zeros(6, requires_grad=True)
    depth, _hit = depth_image_diff(vol, _twisted(cam, xi), W, H,
                                   max_steps=STEPS)
    loss = torch.where(torch.from_numpy(mask), depth, 0.0).sum() / 1e3
    (g,) = torch.autograd.grad(loss, xi)
    return g.numpy()


def test_pose_gradient_matches_finite_difference():
    vol, cam = _scene(), _camera()
    d0, hit0 = depth_image_diff(vol, cam, W, H, max_steps=STEPS)
    mask = _eroded_mask(hit0.numpy(), d0.detach().numpy())

    def loss_f64(xi):
        # sum the f32 depth image in f64: float32 summation noise swamps
        # small finite differences
        depth, _hit = depth_image_diff(vol, _twisted(cam, xi), W, H,
                                       max_steps=STEPS)
        return depth.detach().numpy().astype(np.float64)[mask].sum() / 1e3

    g = _masked_depth_grad(vol, cam, mask)
    assert np.isfinite(g).all()
    for i in range(6):
        eps = 1e-4 if i < 3 else 0.03
        e = torch.zeros(6)
        e[i] = eps
        fd = (loss_f64(e) - loss_f64(-e)) / (2 * eps)
        # 10 % relative, with an absolute floor well below the dominant
        # components' scale (~180) for near-zero gradients like roll
        assert abs(fd - g[i]) < max(0.1 * max(abs(fd), abs(g[i])), 0.5), (
            i, fd, g[i])


def _tsdf_grad(vol, cam):
    t = vol.tsdf.clone().requires_grad_(True)
    depth, _hit = depth_image_diff(vol.replace(tsdf=t), cam, W, H,
                                   max_steps=STEPS)
    (g,) = torch.autograd.grad(depth.sum(), t)
    return g.numpy()


def test_tsdf_gradient_is_scattered_to_taps():
    vol, cam = _scene(), _camera()
    g = _tsdf_grad(vol, cam)
    assert np.isfinite(g).all()
    assert (g != 0).sum() > 100  # gradient lands on voxels near the surface
    # and only near the surface, but for trilinear-neighbourhood effects
    far = (vol.tsdf.abs() >= vol.truncation_distance).numpy()
    assert (g[far] != 0).mean() < 0.05


def test_pose_recovery_by_gradient_descent():
    vol, cam_true = _scene(), _camera()
    target, _ = depth_image_diff(vol, cam_true, W, H, max_steps=STEPS)
    target = target.detach()
    xi_perturb = torch.tensor([0.01, -0.008, 0.005, 20.0, -15.0, 10.0])
    cam0 = _twisted(cam_true, xi_perturb)

    def loss(xi):
        depth, hit = depth_image_diff(vol, _twisted(cam0, xi), W, H,
                                      max_steps=STEPS)
        m = hit & (target > 0)
        return torch.where(m, (depth - target) ** 2, 0.0).sum() / m.sum()

    xi = torch.zeros(6)
    l0 = float(loss(xi))
    # diagonal-preconditioned descent: rotations vs translations scale
    lr = torch.tensor([1e-8] * 3 + [1e-2] * 3)
    for _ in range(150):
        x = xi.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        xi = xi - lr * g
    l1 = float(loss(xi))
    assert l1 < 0.2 * l0, (l0, l1)
    t_rec = matmul_small(se3_exp(xi), cam0.pose)
    terr0 = float((cam0.pose - cam_true.pose)[:3, 3].norm())
    terr1 = float((t_rec - cam_true.pose)[:3, 3].norm())
    assert terr1 < 0.5 * terr0, (terr0, terr1)


def test_vertices_and_hits_match_jax():
    vol, cam = _scene(), _camera()
    verts, hit = raycast_diff(vol, cam, W, H, max_steps=STEPS)
    jverts, jhit = jax_raycast_diff(_jax_scene(), _jax_camera(), W, H,
                                    max_steps=STEPS)
    hit, jhit = hit.numpy(), np.asarray(jhit)
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    assert both.sum() > 0.5 * hit.size
    err = np.linalg.norm(verts.detach().numpy()[both]
                         - np.asarray(jverts)[both], axis=-1)
    assert np.median(err) < 0.5 and np.percentile(err, 99) < 1e-2, (
        np.median(err), np.percentile(err, 99))
    assert np.isnan(verts.detach().numpy()[~hit]).all()


def test_pose_gradient_matches_jax():
    vol, cam = _scene(), _camera()
    d0, hit0 = depth_image_diff(vol, cam, W, H, max_steps=STEPS)
    mask = _eroded_mask(hit0.numpy(), d0.detach().numpy())
    g = _masked_depth_grad(vol, cam, mask)
    jvol, jcam = _jax_scene(), _jax_camera()

    def jloss(xi):
        c = jcam.set_pose(jax_se3_exp(xi) @ jcam.pose)
        depth, _hit = jax_depth_image_diff(jvol, c, W, H, max_steps=STEPS)
        return jnp.sum(jnp.where(jnp.asarray(mask), depth, 0.0)) / 1e3

    gj = np.asarray(jax.grad(jloss)(jnp.zeros(6, jnp.float32)))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, gj, rtol=0, atol=1e-4 * np.abs(gj).max())


def test_tsdf_gradient_matches_jax():
    vol, cam = _scene(), _camera()
    g = _tsdf_grad(vol, cam)
    jvol, jcam = _jax_scene(), _jax_camera()

    def jloss(tsdf):
        depth, _hit = jax_depth_image_diff(jvol.replace(tsdf=tsdf), jcam, W,
                                           H, max_steps=STEPS)
        return jnp.sum(depth)

    gj = np.asarray(jax.grad(jloss)(jvol.tsdf))
    nz, jnz = g != 0, gj != 0
    assert (nz & jnz).sum() >= 0.999 * (nz | jnz).sum()
    np.testing.assert_allclose(g, gj, rtol=0, atol=1e-3 * np.abs(gj).max())


def test_march_is_the_raycast_and_correct_keeps_its_hits():
    """march == the plain raycast's hits; on CPU tensors the kernel
    wrapper with max_steps is the twin; correct moves a hit by less than a
    voxel."""
    vol, cam = _scene(), _camera()
    t0, hit = march(vol, cam, W, H, max_steps=STEPS)
    ref = raycast_vertices(vol, cam, W, H, max_steps=STEPS)
    assert torch.equal(
        raycast_vertices_cuda(vol, cam, W, H, max_steps=STEPS).isnan(),
        ref.isnan())
    assert torch.equal(hit, torch.isfinite(ref).all(-1).reshape(-1))
    assert torch.equal(t0[~hit], torch.zeros_like(t0[~hit]))
    verts, hit_img = correct(vol, cam, t0, hit, W, H)
    moved = (verts - ref).norm(dim=-1)[hit_img]
    assert float(moved.max()) < float(vol.voxel_size[0])
    with pytest.raises(ValueError, match="max_steps"):
        raycast_vertices_cuda(vol, cam, W, H, max_steps=-1)


def test_forward_mode_jacobian_matches_reverse_mode():
    """The Jacobian the LM step takes (six forward-mode dual passes
    through the correction, one march outside) agrees with reverse mode
    through the whole raycast_diff: J^T 1 == grad of the residuals' sum."""
    vol, cam_true = _scene(), _camera()
    target, _ = depth_image_diff(vol, cam_true, W, H, max_steps=STEPS)
    target = target.detach()
    cam0 = _twisted(cam_true, torch.tensor([0.01, -0.008, 0.005, 15.0,
                                            -12.0, 16.0]))
    xi = torch.zeros(6)
    t0, hit = march(vol, _twisted(cam0, xi), W, H, max_steps=STEPS)
    cols = []
    with fwAD.dual_level():
        for j in range(6):
            x = fwAD.make_dual(xi, torch.eye(6)[j])
            rj, _ = banded_residuals(vol, _twisted(cam0, x), target, t0, hit)
            cols.append(fwAD.unpack_dual(rj).tangent.reshape(-1))
    jac = torch.stack(cols, -1)
    x = xi.clone().requires_grad_(True)
    r, m = banded_residuals(vol, _twisted(cam0, x), target, t0, hit)
    assert int(m.sum()) > 1000
    (g,) = torch.autograd.grad(r.sum(), x)
    torch.testing.assert_close(jac.sum(0), g, rtol=1e-4, atol=1e-3)


def test_lm_recovers_the_pose():
    """tools/run_config4.py at 48^3 / 80x60: Levenberg-Marquardt on the
    banded depth residuals recovers a 25 mm / 0.8 degree offset to under
    1 mm."""
    vol, cam_true = _scene(), _camera()
    target, _ = depth_image_diff(vol, cam_true, W, H, max_steps=STEPS)
    target = target.detach()
    cam0 = _twisted(cam_true, torch.tensor([0.01, -0.008, 0.005, 15.0,
                                            -12.0, 16.0]))

    def terr(xi):
        pose = matmul_small(se3_exp(xi), cam0.pose)
        return float((pose - cam_true.pose)[:3, 3].norm())

    assert terr(torch.zeros(6)) > 20.0
    xi, history = recover_pose_lm(vol, cam0, target, iters=30,
                                  max_steps=STEPS,
                                  stop=lambda x: terr(x) < 1.0)
    assert terr(xi) < 1.0, (terr(xi), history)
    assert len(history) < 30
    # a step taken at lam -> 0 is Gauss-Newton: rms falls on the way
    assert history[-1]["rms"] < history[0]["rms"]
    _xi1, rms = lm_step(vol, cam0, target, xi, 1e-2, max_steps=STEPS)
    assert float(rms) < history[0]["rms"]


def test_nan_misses_do_not_leak_into_gradients():
    """A camera that sees the volume's edge: misses are NaN vertices but
    the gradients of the masked depth stay finite."""
    vol, cam = _scene(), _camera()
    cam = cam.move_to([700.0, 0.0, -400.0])
    xi = torch.zeros(6, requires_grad=True)
    t = vol.tsdf.clone().requires_grad_(True)
    verts, hit = raycast_diff(vol.replace(tsdf=t), _twisted(cam, xi), W, H,
                              max_steps=STEPS)
    assert (~hit).any() and hit.any()
    depth = vertices_to_depth(verts, hit, _twisted(cam, xi))
    gx, gt = torch.autograd.grad(depth.sum(), (xi, t))
    assert torch.isfinite(gx).all() and torch.isfinite(gt).all()
