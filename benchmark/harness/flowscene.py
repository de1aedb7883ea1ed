"""A moving scene with its exact scene flow, made on the device.

A static wall and spheres that move on periodic paths, one sphere's
radius pulsing, seen from a camera at the identity pose. Each pixel's flow
is the 3-D motion, from the previous frame to this one, of the surface
point it sees: a sphere's point moves with its centre and scales with
its radius; the wall and the pixels with no depth have none.
"""

from __future__ import annotations

import math

import torch

from . import scene

_F32 = torch.float32


def spheres_at(spheres: list, phase: torch.Tensor):
    """(F, S, 3) centres and (F, S) radii of the spheres at the phases
    (F,) in radians."""
    centres, radii = [], []
    for s in spheres:
        c = [base + amp * torch.sin(h * phase + ph)
             for base, (amp, h, ph) in zip(s["centre"], s["path"])]
        centres.append(torch.stack(c, dim=-1))
        radii.append(s["radius"] + s["pulse"] * torch.sin(phase))
    return torch.stack(centres, dim=1), torch.stack(radii, dim=1)


def make_cycle(config: dict, seed: int, device):
    """One period of (P, H, W) float32 noisy depth frames and (P, H, W, 3)
    float32 flows in mm. The seed picks the starting frame, the direction
    and the noise."""
    sc, cam = config["scene"], config["camera"]
    period = int(sc["period"])
    start = seed % period
    direction = 1 if (seed // period) % 2 == 0 else -1
    k = start + direction * torch.arange(period + 1, dtype=torch.float64,
                                         device=device) - direction
    phase = 2.0 * math.pi * k / period  # frame i at k[i + 1], its past at k[i]
    centres, radii = spheres_at(sc["spheres"], phase)
    d = scene.ray_directions(cam, device)  # (H, W, 3), z = 1
    g = scene.make_generator(seed, device)
    depths, flows = [], []
    for i in range(period):
        c, r = centres[i + 1], radii[i + 1]
        t = torch.full(d.shape[:-1], sc["wall_z"], dtype=d.dtype, device=device)
        which = torch.full(t.shape, -1, dtype=torch.int64, device=device)
        for s in range(c.shape[0]):
            a = (d * d).sum(-1)
            b = -2.0 * (d * c[s]).sum(-1)
            cc = (c[s] * c[s]).sum() - r[s] * r[s]
            disc = b * b - 4.0 * a * cc
            ts = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
            near = (disc > 0) & (ts > 0) & (ts < t)
            t = torch.where(near, ts, t)
            which = torch.where(near, s, which)
        p = t[..., None] * d
        flow = torch.zeros_like(p)
        for s in range(c.shape[0]):
            past = centres[i, s] + (radii[i, s] / r[s]) * (p - c[s])
            flow = torch.where((which == s)[..., None], p - past, flow)
        noisy = scene.kinect_noise(t.to(_F32)[None], g, config["noise"])[0]
        depths.append(noisy)
        flows.append(torch.where((noisy > 0)[..., None], flow, 0.0).to(_F32))
    return torch.stack(depths), torch.stack(flows)
