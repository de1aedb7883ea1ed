"""The linearisation of a Levenberg-Marquardt step on the depth residuals
of a differentiable render, in plain PyTorch: the twin of the CUDA kernel
``csrc/lm_linearise.cu`` (``kernels/lm.py``).

At the twist xi of the pose P = se3_exp(xi) @ P0, with the march's t0 and
hits at P, each ray's Newton-corrected hit

    t* = t0 - f(p0) / f',   p0 = c + t0 d,   f' = grad f(p0) . d (frozen)

gives the residual r = z(c + t* d) - target, z the camera depth through
P^-1 as ``Camera.world_to_camera`` writes it, kept inside the band. Its
derivative in xi_j is the chain rule written out, with the pose's
tangents dP_j and d(P^-1)_j:

    dd   = (dR K^-1 p - d (d . dR K^-1 p)) / |R K^-1 p|
    dt*  = -grad f . (dc + t0 dd) / f'
    dv   = dc + dt* d + t* dd
    dz   = (d num - z d den) / den

the same Gauss-Newton linearisation as the six forward-mode dual passes
through ``ops.raycast_diff.correct`` (``banded_residuals``), in one pass.
The sums of the normal equations follow in float64.

The residuals and the band's mask are the dual passes' primal bit for bit
(the same operators in the same order); the derivative rounds otherwise.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..camera import Camera
from ..utils.se3 import matmul_small, se3_exp
from ..volume import TSDFVolume
from .raycast import _mat3_rows, pixel_rays
from .raycast_diff import vertices_to_depth
from .trilinear import trilinear_sample_and_grad

_F32, _F64 = torch.float32, torch.float64
# the sums: J^T J (6 x 6, row-major), J^T r (6), sum of r^2, inliers
SUMS = 44


def normal_equations(sums: torch.Tensor):
    """(J^T J (6, 6), J^T r (6,), sum of r^2, inliers), views of the
    (SUMS,) float64 sums of :func:`linearise` or the kernel."""
    return sums[:36].reshape(6, 6), sums[36:42], sums[42], sums[43]


def pose_tangents(camera: Camera, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dP, dP^-1), each (6, 4, 4) f32: the tangents along each twist axis
    of the pose se3_exp(xi) @ camera.pose and of its LU inverse, by
    forward-mode AD through the expressions ``Camera.set_pose`` evaluates
    (so the tangents of the dual passes)."""
    tangents = torch.eye(6, dtype=_F32, device=xi.device)
    dp, dpi = [], []
    with fwAD.dual_level():
        for j in range(6):
            x = fwAD.make_dual(xi.detach(), tangents[j])
            cam = camera.set_pose(matmul_small(se3_exp(x), camera.pose))
            dp.append(fwAD.unpack_dual(cam.pose).tangent)
            dpi.append(fwAD.unpack_dual(cam.pose_inv).tangent)
    return torch.stack(dp), torch.stack(dpi)


def _sampled(vol: TSDFVolume, cam: Camera, t0: torch.Tensor, width: int, height: int):
    """Each ray's camera-space ray K^-1 p (three (H*W,)), |R K^-1 p|, unit
    direction (H*W, 3) (``ray_directions``' bits), f(p0), grad f(p0) and
    the frozen slope, |f'| >= 1e-6 with its sign kept."""
    d_cam = [c.reshape(-1) for c in pixel_rays(cam, width, height)]
    raw = _mat3_rows(cam.rotation, *d_cam)
    norm = torch.sqrt(raw[0] * raw[0] + raw[1] * raw[1] + raw[2] * raw[2])
    dirs = torch.stack([c / norm for c in raw], dim=-1)
    pts = cam.position[None, :] + t0[:, None] * dirs - vol.space_min[None, :]
    f, grad = trilinear_sample_and_grad(vol.tsdf, pts, vol.voxel_size)
    fp = grad[:, 0] * dirs[:, 0] + grad[:, 1] * dirs[:, 1] + grad[:, 2] * dirs[:, 2]
    fp = torch.where(fp.abs() < 1e-6, torch.where(fp < 0, -1e-6, 1e-6), fp)
    return d_cam, norm, dirs, f, grad, fp


def slope(vol: TSDFVolume, cam: Camera, t0: torch.Tensor, width: int = 640,
          height: int = 480) -> torch.Tensor:
    """f'(t0) = grad f(p0) . d along each ray, clamped away from 0 as
    ``ops.raycast_diff.slope`` (which takes it by reverse mode): the
    frozen slope of the linearisation."""
    return _sampled(vol, cam, t0.detach(), width, height)[-1]


def linearise(
    vol: TSDFVolume,
    camera: Camera,
    cam: Camera,
    xi: torch.Tensor,
    t0: torch.Tensor,
    hit: torch.Tensor,
    target: torch.Tensor,
    band_mm: float,
    rows: bool = False,
):
    """The normal equations of the banded depth residuals at the twist
    ``xi`` of ``camera``'s pose: (SUMS,) float64 sums, J^T J row-major,
    J^T r, the sum of r^2 and the band's inlier count.

    ``cam`` is ``camera`` at the twisted pose (the march's camera), ``t0``
    and ``hit`` the march's flat (H*W,) results, ``target`` the (H, W) f32
    target depth. With ``rows``, also (H*W, 8) f32 per ray: r, the six
    entries of J and the mask (1.0 inside the band), r and J 0 outside.
    """
    h, w = target.shape
    dpose, dpose_inv = pose_tangents(camera, xi)
    origin = cam.position
    t0 = t0.detach()
    d_cam, norm, dirs, f, grad, fp = _sampled(vol, cam, t0, w, h)
    d = [dirs[:, i] for i in range(3)]
    g = [grad[:, i] for i in range(3)]

    # the correction and its residuals, as banded_residuals evaluates them
    t_star = t0 - f / fp
    verts = origin[None, :] + t_star[:, None] * dirs
    verts = torch.where(hit[:, None], verts, float("nan"))
    depth = vertices_to_depth(verts.reshape(h, w, 3), hit.reshape(h, w), cam).reshape(-1)
    tgt = target.reshape(-1)
    m = hit & (tgt > 0) & ((depth - tgt).abs() < band_mm)
    r = torch.where(m, depth - tgt, 0.0)

    # the six tangents at once, (6, H*W) each
    v = [torch.where(hit, verts[:, i], 0.0) for i in range(3)]
    pi = cam.pose_inv
    num = pi[2, 0] * v[0] + pi[2, 1] * v[1] + pi[2, 2] * v[2] + pi[2, 3]
    den = pi[3, 0] * v[0] + pi[3, 1] * v[1] + pi[3, 2] * v[2] + pi[3, 3]
    z = num / den
    dr, dc, dpi = dpose[:, :3, :3, None], dpose[:, :3, 3, None], dpose_inv[..., None]
    ddr = [dr[:, i, 0] * d_cam[0] + dr[:, i, 1] * d_cam[1] + dr[:, i, 2] * d_cam[2]
           for i in range(3)]
    dn = d[0] * ddr[0] + d[1] * ddr[1] + d[2] * ddr[2]
    dd = [(ddr[i] - d[i] * dn) / norm for i in range(3)]
    dp = [dc[:, i] + t0 * dd[i] for i in range(3)]
    dt = -(g[0] * dp[0] + g[1] * dp[1] + g[2] * dp[2]) / fp
    dv = [dc[:, i] + dt * d[i] + t_star * dd[i] for i in range(3)]
    dnum = (dpi[:, 2, 0] * v[0] + dpi[:, 2, 1] * v[1] + dpi[:, 2, 2] * v[2] + dpi[:, 2, 3]
            + (pi[2, 0] * dv[0] + pi[2, 1] * dv[1] + pi[2, 2] * dv[2]))
    dden = (dpi[:, 3, 0] * v[0] + dpi[:, 3, 1] * v[1] + dpi[:, 3, 2] * v[2] + dpi[:, 3, 3]
            + (pi[3, 0] * dv[0] + pi[3, 1] * dv[1] + pi[3, 2] * dv[2]))
    jac = torch.where(m, (dnum - z * dden) / den, 0.0).T

    j64, r64 = jac.to(_F64), r.to(_F64)
    sums = torch.cat([(j64.T @ j64).reshape(-1), j64.T @ r64,
                      (r64 * r64).sum().reshape(1), m.sum().to(_F64).reshape(1)])
    if rows:
        return sums, torch.cat([r[:, None], jac, m[:, None].to(_F32)], dim=1)
    return sums
