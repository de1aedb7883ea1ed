"""Plain reference of config 4's Levenberg-Marquardt step (the formulation
of ``tools/run_config4.py``): pose refinement of a depth frame against a
fused model through a differentiable render.

At the twist xi of the pose exp(xi) P0 the model is sphere-traced once
(the render of ``tracking.render_depth``, returning each ray's distance
t0 from the camera centre and whether it hit). The Newton correction
t* = t0 - f(t0) / f'(t0), with f(t) the model's trilinear tsdf along the
ray and f' frozen, carries the implicit derivative of the hit to the pose;
the residual is the corrected hit's camera z less the target's depth,
kept where the ray hit, the target has depth and the residual is within
the band. The step solves (J^T J + lam diag(J^T J)) dx = -J^T r.

Its own route throughout: the camera z is taken from the rigid inverse;
the (H*W, 6) Jacobian by reverse-mode autograd, each ray given its own
copy of the pose's 12 entries (one backward pass gives every ray's row),
chained with the pose's derivative in the twist, also by reverse mode;
the normal equations, the solve and the rms in float64. Every product and
sum of the render and the correction is its own elementwise float32
operation.

Imports nothing but torch: it takes no part of the program under test.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .fusion import Grid
from .tracking import matmul, se3_exp, trilinear

_F32 = torch.float32
_F64 = torch.float64


@contextlib.contextmanager
def _no_tf32():
    """Both TF32 flags off while a step runs, so that a float32 product
    on the card is a float32 product; the caller's flags come back."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@dataclasses.dataclass
class Step:
    """One step's outcome: rms of the residuals at xi, the proposed twist
    (float64), the band's inlier count; and, for the tests, the Jacobian
    and the residuals."""

    rms: float
    xi_new: torch.Tensor
    inliers: int
    jac: torch.Tensor
    residuals: torch.Tensor


def camera_rays(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H*W, 3) camera-space directions K^-1 (u, v, 1) of the pixels."""
    dev = k.device
    k_inv = torch.linalg.inv_ex(k).inverse
    xs = torch.arange(w, dtype=_F32, device=dev)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=_F32, device=dev)[:, None].expand(h, w)
    d = [k_inv[i, 0] * xs + k_inv[i, 1] * ys + k_inv[i, 2] for i in range(3)]
    return torch.stack(d, dim=-1).reshape(-1, 3)


def directions(rot: torch.Tensor, d_cam: torch.Tensor) -> torch.Tensor:
    """Unit world directions of camera rays: normalize(R d). ``rot`` is
    (3, 3) or one (N, 3, 3) per ray."""
    d = [rot[..., i, 0] * d_cam[:, 0] + rot[..., i, 1] * d_cam[:, 1]
         + rot[..., i, 2] * d_cam[:, 2] for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return torch.stack([c / norm for c in d], dim=-1)


def march(grid: Grid, origin: torch.Tensor, dirs: torch.Tensor, max_steps: int):
    """Sphere-trace the rays (origin (3,), unit dirs (N, 3)) through the
    model: (t0, hit), t0 the distance from the origin to the hit (0 on a
    miss). The loop of ``tracking.render_depth``."""
    origin = origin[None, :]
    lo = grid.offset[None, :]
    hi = (grid.offset + grid.physical)[None, :]
    safe = torch.where(dirs == 0.0, torch.full_like(dirs, 1e-20), dirs)
    t1 = (lo - origin) / safe
    t2 = (hi - origin) / safe
    inside = (origin >= lo) & (origin <= hi)
    par_miss = ((dirs == 0.0) & ~inside).any(dim=-1)
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    meets = (near <= far) & (far >= 0.0) & ~par_miss
    near = torch.clamp(near, min=0.0)
    start = origin + near[:, None] * dirs - lo
    max_t = far - near

    trunc = grid.trunc
    min_step = trunc * 0.05
    max_step = trunc * 0.9
    zeros = torch.zeros_like(dirs[:, 0])
    t = zeros
    hit_t = zeros
    prev = zeros + trunc
    prev_step = zeros + min_step
    marching = meets.clone()
    hit_any = torch.zeros_like(meets)
    count = 0
    while count < max_steps and bool(marching.any()):
        for _ in range(min(16, max_steps - count)):
            pts = start + t[:, None] * dirs
            val = trilinear(grid.tsdf, pts, grid.voxel_size)
            frac = prev / (prev - val)
            refined = t - prev_step + frac * prev_step
            hit = marching & (val <= 0.0)
            new_hit_t = torch.where(val < 0.0, refined, t)
            back = marching & (val > 0.0) & (prev < 0.0)
            step = torch.clamp(0.75 * val, min_step, max_step)
            new_t = t + step
            escaped = marching & ~hit & ~back & (new_t >= max_t)
            t = torch.where(marching & ~hit, new_t, t)
            hit_t = torch.where(hit, new_hit_t, hit_t)
            prev = torch.where(marching, val, prev)
            prev_step = torch.where(marching, step, prev_step)
            hit_any = hit_any | hit
            marching = marching & ~hit & ~back & ~escaped
            count += 1
    verts = start + hit_t[:, None] * dirs + lo
    hit = hit_any & torch.isfinite(verts).all(dim=-1)
    rel = torch.where(hit[:, None], verts, 0.0) - origin
    dist = torch.sqrt(rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
                      + rel[:, 2] * rel[:, 2])
    return torch.where(hit, dist, 0.0), hit


def _along(grid: Grid, origin, dirs, t):
    """f(t): the model's trilinear tsdf at origin + t dirs, each ray."""
    pts = origin + t[:, None] * dirs - grid.offset[None, :]
    return trilinear(grid.tsdf, pts, grid.voxel_size)


def slope(grid: Grid, origin, dirs, t0) -> torch.Tensor:
    """f'(t0) by autograd along each ray, |f'| >= 1e-6 with its sign."""
    with torch.enable_grad():
        t = t0.detach().clone().requires_grad_(True)
        (fp,) = torch.autograd.grad(_along(grid, origin, dirs, t).sum(), t)
    return torch.where(fp.abs() < 1e-6, torch.where(fp < 0, -1e-6, 1e-6), fp)


def corrected_depth(grid: Grid, rot, origin, d_cam, t0, fp) -> torch.Tensor:
    """The camera z of each ray's Newton-corrected hit: R[:, 2] . (v - o)
    with v = o + t* d, t* = t0 - f(t0) / f'. ``rot`` and ``origin`` may
    be one copy a ray ((N, 3, 3), (N, 3))."""
    origin = origin.expand(d_cam.shape[0], 3)
    dirs = directions(rot, d_cam)
    t_star = t0 - _along(grid, origin, dirs, t0) / fp
    rel = t_star[:, None] * dirs
    rot = rot.expand(d_cam.shape[0], 3, 3)
    return (rot[:, 0, 2] * rel[:, 0] + rot[:, 1, 2] * rel[:, 1]
            + rot[:, 2, 2] * rel[:, 2])


def pose_of(pose0: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """exp(xi) P0, float32."""
    return matmul(se3_exp(xi.to(_F32)), pose0.to(_F32))


def _entries(pose0, xi):
    p = pose_of(pose0, xi)
    return torch.cat([p[0:3, 0:3].reshape(9), p[0:3, 3]])


def pose_jacobian(pose0: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """(12, 6) derivative of the pose's entries (R row-major, then t) in
    the twist, by reverse mode: one backward pass an entry."""
    x = xi.detach().to(_F32).clone().requires_grad_(True)
    with torch.enable_grad():
        e = _entries(pose0, x)
        rows = [torch.autograd.grad(e[i], x, retain_graph=i < 11)[0]
                for i in range(12)]
    return torch.stack(rows)


def step(grid: Grid, target: torch.Tensor, pose0: torch.Tensor,
         xi: torch.Tensor, lam: float, k: torch.Tensor, band_mm: float,
         max_steps: int) -> Step:
    """One Levenberg-Marquardt step at xi, from the model ``grid``, with
    TF32 off."""
    with _no_tf32():
        return _step(grid, target, pose0, xi, lam, k, band_mm, max_steps)


def _step(grid, target, pose0, xi, lam, k, band_mm, max_steps) -> Step:
    h, w = target.shape
    n = h * w
    xi = xi.detach().to(_F32)
    with torch.no_grad():
        pose = pose_of(pose0, xi)
        rot, origin = pose[0:3, 0:3], pose[0:3, 3]
        d_cam = camera_rays(k, h, w)
        dirs = directions(rot, d_cam)
        t0, hit = march(grid, origin, dirs, max_steps)
        fp = slope(grid, origin, dirs, t0)
    tgt = target.to(_F32).reshape(-1)
    with torch.enable_grad():
        rots = rot.expand(n, 3, 3).clone().requires_grad_(True)
        origins = origin.expand(n, 3).clone().requires_grad_(True)
        depth = corrected_depth(grid, rots, origins, d_cam, t0, fp)
        mask = hit & (tgt > 0) & ((depth.detach() - tgt).abs() < band_mm)
        r = torch.where(mask, depth - tgt, 0.0)
        g_rot, g_origin = torch.autograd.grad(r.sum(), [rots, origins])
    per_ray = torch.cat([g_rot.reshape(n, 9), g_origin], dim=1).to(_F64)
    jac = per_ray @ pose_jacobian(pose0, xi).to(_F64)
    rd = r.detach().to(_F64)
    jtj = jac.T @ jac
    jtr = jac.T @ rd
    a = jtj + lam * torch.diag(torch.diag(jtj))
    dx = torch.linalg.solve(a, -jtr)
    inliers = int(mask.sum())
    rms = float(torch.sqrt((rd * rd).sum() / max(inliers, 1)))
    return Step(rms=rms, xi_new=xi.to(_F64) + dx, inliers=inliers, jac=jac,
                residuals=rd)


def residuals_at(grid: Grid, target, pose0, xi, k, t0, hit, fp, mask):
    """The residuals at the twist xi with the march, slope and mask of
    another twist held: the function whose derivative ``step`` takes
    (for a finite-difference check)."""
    h, w = target.shape
    pose = pose_of(pose0, xi)
    depth = corrected_depth(grid, pose[0:3, 0:3], pose[0:3, 3],
                            camera_rays(k, h, w), t0, fp)
    return torch.where(mask, depth - target.to(_F32).reshape(-1), 0.0)
