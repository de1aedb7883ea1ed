"""Synthetic depth streams, made on the device from a seed.

Frozen copies, rewritten for batches of frames on the device, so that a
later change to the program cannot move the yardstick:

* ``look_at`` is ``chip_smoke.py:look_at_pose`` (columns [left, up,
  forward, position], +Y up);
* ``analytic_depth`` is ``chip_smoke.py:analytic_depth`` (camera-z depth
  of the nearest ray hit), extended from a wall and spheres to planes,
  spheres and axis-aligned boxes;
* ``kinect_noise`` is ``tsdf_tpu_torch/utils/fixtures.py:kinect_noise``
  over a (B, H, W) batch.

A scene is a dict of the configuration file: ``planes`` [[axis, value]],
``spheres`` [[x, y, z, r]], ``boxes`` [[x0, y0, z0, x1, y1, z1]] in mm.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32
_AXES = {"x": 0, "y": 1, "z": 2}


def look_at(position: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) float64 camera->world poses from (B, 3) positions and
    targets."""
    forward = target - position
    forward = forward / forward.norm(dim=-1, keepdim=True)
    up0 = torch.zeros_like(forward)
    up0[:, 1] = 1.0
    left = torch.linalg.cross(up0, forward)
    left = left / left.norm(dim=-1, keepdim=True)
    up = torch.linalg.cross(forward, left)
    pose = torch.eye(4, dtype=position.dtype, device=position.device)
    pose = pose.repeat(position.shape[0], 1, 1)
    pose[:, :3, 0], pose[:, :3, 1] = left, up
    pose[:, :3, 2], pose[:, :3, 3] = forward, position
    return pose


def trajectory(traj: dict, frames: int, seed: int, device) -> torch.Tensor:
    """(frames, 4, 4) float64 poses of a closed periodic trajectory of
    ``traj["period"]`` frames. The seed picks the starting frame and the
    direction: every seed replays the same poses, in another order.

    Position and look-at target are sums of sines of the phase
    theta = 2 pi k / period: ``position`` and ``target`` are [centre,
    [amplitude, harmonic, phase] per axis]."""
    period = int(traj["period"])
    start = seed % period
    direction = 1 if (seed // period) % 2 == 0 else -1
    k = start + direction * torch.arange(frames, dtype=torch.float64,
                                         device=device)
    theta = 2.0 * math.pi * k / period

    def curve(spec):
        centre, waves = spec
        axes = []
        for c, (amp, harmonic, phase) in zip(centre, waves):
            axes.append(c + amp * torch.sin(harmonic * theta + phase))
        return torch.stack(axes, dim=-1)

    return look_at(curve(traj["position"]), curve(traj["target"]))


def ray_directions(cam: dict, device) -> torch.Tensor:
    """(H, W, 3) float64 camera-space directions with z = 1."""
    h, w = cam["height"], cam["width"]
    v = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    u = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    x = ((u - cam["cx"]) / cam["fx"]).expand(h, w)
    y = ((v - cam["cy"]) / cam["fy"]).expand(h, w)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def analytic_depth(poses: torch.Tensor, scene: dict, cam: dict) -> torch.Tensor:
    """(B, H, W) float32 camera-z depth in mm of the nearest hit of each
    pixel's ray with the scene's planes, spheres and boxes (0 = no hit)."""
    d_cam = ray_directions(cam, poses.device)
    # world direction with camera z = 1, so the ray parameter is depth
    d = torch.einsum("bij,hwj->bhwi", poses[:, :3, :3], d_cam)
    o = poses[:, None, None, :3, 3]
    inf = torch.full(d.shape[:-1], float("inf"), dtype=d.dtype, device=d.device)
    t = inf
    for axis, value in scene.get("planes", []):
        a = _AXES[axis]
        tp = (value - o[..., a]) / d[..., a]
        t = torch.where(tp > 0, torch.minimum(t, tp), t)
    for x, y, z, r in scene.get("spheres", []):
        oc = o - torch.tensor([x, y, z], dtype=d.dtype, device=d.device)
        a = (d * d).sum(-1)
        b = 2.0 * (d * oc).sum(-1)
        c = (oc * oc).sum(-1) - r * r
        disc = b * b - 4.0 * a * c
        ts = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
        t = torch.where((disc > 0) & (ts > 0), torch.minimum(t, ts), t)
    for box in scene.get("boxes", []):
        lo = torch.tensor(box[:3], dtype=d.dtype, device=d.device)
        hi = torch.tensor(box[3:], dtype=d.dtype, device=d.device)
        t1 = (lo - o) / d
        t2 = (hi - o) / d
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0)
        t = torch.where(hit, torch.minimum(t, near), t)
    return torch.where(torch.isfinite(t), t, 0.0).to(_F32)


def kinect_noise(depth: torch.Tensor, generator: torch.Generator,
                 noise: dict) -> torch.Tensor:
    """Kinect-like corruption of clean (B, H, W) depth frames in mm, in
    sensor order: depth-dependent Gaussian noise (sigma_z = sigma_scale *
    z^2), IR shadows (the ``shadow_px`` pixels on the -x side of a jump
    over ``edge_thresh_mm`` read 0), salt dropouts (``dropout_frac``), the
    TUM u16 x5 round trip (0.2 mm steps). Returns float32 (0 = invalid)."""
    pad = torch.nn.functional.pad
    d = depth.to(_F32)
    zero = torch.zeros_like(d)
    valid = d > 0
    normal = torch.randn(d.shape, generator=generator, device=d.device)
    d = torch.where(valid, d + noise["sigma_scale"] * d * d * normal, zero)

    jump = (pad(d[..., 1:], (0, 1)) - d).abs()
    edge = (jump > noise["edge_thresh_mm"]) & valid
    shadow = torch.zeros_like(edge)
    for s in range(1, int(noise["shadow_px"]) + 1):
        shadow = shadow | pad(edge[..., s:], (0, s))
    d = torch.where(shadow, zero, d)

    uniform = torch.rand(d.shape, generator=generator, device=d.device)
    d = torch.where(uniform < noise["dropout_frac"], zero, d)
    return torch.clamp(torch.round(d * 5.0), 0, 65535) * 0.2


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def depth_stream(config: dict, poses: torch.Tensor, seed: int,
                 batch: int = 64) -> torch.Tensor:
    """(B, H, W) float32 noisy frames of the configuration's scene seen
    from ``poses`` (B, 4, 4), made in batches on the poses' device."""
    g = make_generator(seed, poses.device)
    out = []
    for i in range(0, poses.shape[0], batch):
        clean = analytic_depth(poses[i:i + batch], config["scene"],
                               config["camera"])
        out.append(kinect_noise(clean, g, config["noise"]))
    return torch.cat(out)
