"""Plain reference of pose refinement through fusion (the formulation of
``tools/run_config4b.py``): a depth frame fused into an empty volume at
the pose exp(delta) T is compared with a target fused at the true pose T,
by the mean of the squared tsdf difference over the voxels both updated;
delta takes normalised steps along minus the gradient, and the best
iterate wins.

The fusion's depth lookup is a rounded pixel, whose derivative autograd
cannot see; the image-space term is put back by a surrogate whose value
is the looked-up depth and whose derivative is the depth frame's central
difference times the projection's: d sdf = Gx d px + Gy d py - d Z. The
gradient is then autograd's, through the 4x4 inverse and the exponential
map, summed over blocks of planes in float64.

Imports nothing but torch: it takes no part of the program under test.
"""

from __future__ import annotations

import torch

from . import fusion
from .tracking import matmul, se3_exp

_F32 = torch.float32


def image_gradients(depth: torch.Tensor):
    """(Gx, Gy): central differences in mm per pixel, 0 where the pixel or
    either neighbour has no depth."""
    d = depth.to(_F32)
    valid = d > 0
    pad = torch.nn.functional.pad
    left = pad(d, (1, 0))[:, :-1]
    right = pad(d, (0, 1))[:, 1:]
    up = pad(d, (0, 0, 1, 0))[:-1, :]
    down = pad(d, (0, 0, 0, 1))[1:, :]
    vl = pad(valid, (1, 0))[:, :-1]
    vr = pad(valid, (0, 1))[:, 1:]
    vu = pad(valid, (0, 0, 1, 0))[:-1, :]
    vd = pad(valid, (0, 0, 0, 1))[1:, :]
    gx = torch.where(valid & vl & vr, (right - left) * 0.5, 0.0)
    gy = torch.where(valid & vu & vd, (down - up) * 0.5, 0.0)
    return gx, gy


def _observe(grid, depth, gx, gy, pose_inv, k, z0, z1):
    """(update gate, clamped sdf with the surrogate image term) of planes
    z0..z1, differentiable in pose_inv."""
    h, w = depth.shape
    cz, cy, cx = grid.axis_centres(z0, z1)
    cx, cy, cz = cx[None, None, :], cy[None, :, None], cz[:, None, None]
    cam, lin, inside = fusion.project(cx, cy, cz, pose_inv, k, h, w)
    z = cam[2]
    # the continuous pixel, kept finite where the voxel is not updated so
    # that no infinite derivative meets a zero one there
    zs = torch.where(z > 0, z, 1.0)
    pxc = (k[0, 0] * cam[0] + k[0, 2] * zs) / zs
    pyc = (k[1, 1] * cam[1] + k[1, 2] * zs) / zs
    surface = depth.reshape(-1)[lin]
    sur = (surface + gx.reshape(-1)[lin] * (pxc - pxc.detach())
           + gy.reshape(-1)[lin] * (pyc - pyc.detach()))
    sdf = sur - z
    update = (inside & (z > 0) & (surface > 0)
              & (sdf.detach() >= -grid.trunc))
    return update, torch.minimum(sdf, grid.trunc)


class Problem:
    """One recovery: the frame, its true pose, and the reference's own
    target (the frame fused at the true pose into an empty volume)."""

    def __init__(self, grid: fusion.Grid, depth, pose, k):
        self.grid, self.depth, self.pose, self.k = grid, depth.to(_F32), pose, k
        self.gx, self.gy = image_gradients(self.depth)
        self.target = []
        with torch.no_grad():
            pose_inv = fusion.inverse(pose)
            for z0, z1 in self.blocks():
                upd, obs = _observe(grid, self.depth, self.gx, self.gy,
                                    pose_inv, k, z0, z1)
                self.target.append((upd, obs.detach()))

    def blocks(self):
        sz = self.grid.shape[0]
        b = fusion.BLOCK_PLANES
        return [(z0, min(sz, z0 + b)) for z0 in range(0, sz, b)]

    def loss_and_grad(self, delta: torch.Tensor):
        """(loss, d loss / d delta), both float64."""
        total = torch.zeros((), dtype=torch.float64, device=delta.device)
        grad = torch.zeros(6, dtype=torch.float64, device=delta.device)
        count = 0
        for (z0, z1), (t_upd, t_obs) in zip(self.blocks(), self.target):
            d = delta.detach().clone().requires_grad_(True)
            pose_inv = fusion.inverse(matmul(se3_exp(d), self.pose))
            upd, obs = _observe(self.grid, self.depth, self.gx, self.gy,
                                pose_inv, self.k, z0, z1)
            m = upd & t_upd
            diff = torch.where(m, obs - t_obs, 0.0)
            s = (diff * diff).to(torch.float64).sum()
            (g,) = torch.autograd.grad(s, d)
            total += s.detach()
            grad += g.to(torch.float64)
            count += int(m.sum())
        n = max(count, 1)
        return total / n, grad / n


def descend(problem: Problem, delta0: torch.Tensor, steps: int,
            rot_step: float, trans_step: float):
    """Normalised steps from delta0: the rotation moves ``rot_step`` rad
    and the translation ``trans_step`` mm along minus the gradient.
    Returns (best loss, best delta, [(loss, |v| mm, |w| mrad) a step],
    [delta before each step and the last])."""
    delta = delta0.to(_F32).clone()
    best = (float("inf"), delta)
    history, deltas = [], []
    for _ in range(steps):
        deltas.append(delta)
        loss, g = problem.loss_and_grad(delta)
        lv = float(loss)
        if lv < best[0]:
            best = (lv, delta)
        g = g.to(_F32)
        gw, gv = g[:3], g[3:]
        step = torch.cat([rot_step * gw / (torch.linalg.vector_norm(gw) + 1e-12),
                          trans_step * gv / (torch.linalg.vector_norm(gv) + 1e-12)])
        delta = delta - step
        history.append((lv, float(torch.linalg.vector_norm(delta[3:])),
                        float(torch.linalg.vector_norm(delta[:3])) * 1e3))
    deltas.append(delta)
    lv = float(problem.loss_and_grad(delta)[0])
    if lv < best[0]:
        best = (lv, delta)
    return best[0], best[1], history, deltas


def counts(problem: Problem, delta: torch.Tensor) -> tuple[int, int]:
    """(updated, updated in the band sdf < trunc) at exp(delta) T: the
    pose adjoint's work for this step."""
    updated = band = 0
    with torch.no_grad():
        pose_inv = twisted_inverse(problem, delta)
        for z0, z1 in problem.blocks():
            upd, obs = _observe(problem.grid, problem.depth, problem.gx,
                                problem.gy, pose_inv, problem.k, z0, z1)
            updated += int(upd.sum())
            band += int((upd & (obs < problem.grid.trunc)).sum())
    return updated, band


def twisted_inverse(problem: Problem, delta: torch.Tensor) -> torch.Tensor:
    """pose_inv of exp(delta) T."""
    return fusion.inverse(matmul(se3_exp(delta.to(_F32)), problem.pose))
