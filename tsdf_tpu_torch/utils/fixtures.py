"""Synthetic analytic scenes for the tests and the chip smoke.

Port of ``tsdf_tpu/utils/fixtures.py``: exact clamped signed distance
fields (as tensors on the volume's device) and analytic depth maps (as
numpy arrays), so a test can bound SDF error and check raycast hits
against closed-form surfaces.
"""

from __future__ import annotations

import numpy as np
import torch

from ..volume import TSDFVolume


def sphere_tsdf(vol: TSDFVolume, radius: float, centre=None) -> TSDFVolume:
    """Exact clamped signed distance to a sphere, weights = 1."""
    if centre is None:
        centre = vol.offset + vol.physical_size / 2.0
    centre = torch.as_tensor(centre, dtype=torch.float32, device=vol.device)
    zc, yc, xc = vol.axis_centres()
    d2 = (
        ((zc - centre[2]) ** 2)[:, None, None]
        + ((yc - centre[1]) ** 2)[None, :, None]
        + ((xc - centre[0]) ** 2)[None, None, :]
    )
    dist = torch.sqrt(d2) - radius
    trunc = vol.truncation_distance
    dist = torch.clamp(dist, -trunc, trunc)
    return vol.replace(tsdf=dist, weight=torch.ones_like(vol.weight))


def wall_tsdf(vol: TSDFVolume, depth: float) -> TSDFVolume:
    """Clamped signed distance to the plane z = depth, weights = 1."""
    zc, _yc, _xc = vol.axis_centres()
    sz, sy, sx = vol.tsdf.shape
    trunc = vol.truncation_distance
    dist = torch.clamp(depth - zc, -trunc, trunc)
    dist = dist[:, None, None].expand(sz, sy, sx).contiguous()
    return vol.replace(tsdf=dist, weight=torch.ones_like(vol.weight))


def sphere_depth_map(
    width: int,
    height: int,
    radius: float,
    min_depth: float,
    max_depth: float,
) -> np.ndarray:
    """u16 (H, W) depth map of an orthographic sphere bump."""
    min_depth, max_depth = sorted((min_depth, max_depth))
    cx, cy = width / 2.0, height / 2.0
    ys, xs = np.mgrid[0:height, 0:width]
    dx2 = (cx - xs) ** 2
    dy2 = (cy - ys) ** 2
    r2 = radius * radius
    inside = dx2 + dy2 < r2
    dz = np.sqrt(np.maximum(r2 - (dx2 + dy2), 0.0))
    depth_centre = min_depth + (max_depth - min_depth) / 2.0
    depth = np.where(
        inside,
        np.clip(depth_centre - dz, min_depth, max_depth),
        0.0,
    )
    return depth.astype(np.uint16)


def wall_depth_map(
    width: int,
    height: int,
    max_depth: float,
    min_depth: float,
    wall_depth: float,
) -> np.ndarray:
    """u16 (H, W): background at max_depth with a centred wall rectangle."""
    ys, xs = np.mgrid[0:height, 0:width]
    wall = (
        (xs > (width // 5) * 2)
        & (xs < (width // 5) * 3)
        & (ys > (height // 5) * 2)
        & (ys < (height // 5) * 3)
    )
    depth = np.where(wall, wall_depth, max_depth)
    return np.clip(depth, min_depth, max_depth).astype(np.uint16)


def gradient_rgb(width: int, height: int, diagonal: bool = False) -> np.ndarray:
    """u8 (H, W, 3) colour frame of smooth gradients: red grows down the
    rows, green along the columns. Blue is a constant 96, or with
    ``diagonal`` grows along the diagonal (integer arithmetic, so the
    frame is the same on every platform)."""
    ys = np.arange(height)[:, None]
    xs = np.arange(width)[None, :]
    if diagonal:
        chans = [
            np.broadcast_to(ys * 255 // height, (height, width)),
            np.broadcast_to(xs * 255 // width, (height, width)),
            (ys + xs) * 255 // (height + width),
        ]
    else:
        ys, xs = ys.astype(np.float32), xs.astype(np.float32)
        chans = [
            np.broadcast_to(255.0 * ys / (height - 1.0), (height, width)),
            np.broadcast_to(255.0 * xs / (width - 1.0), (height, width)),
            np.full((height, width), 96.0),
        ]
    return np.stack(chans, axis=-1).astype(np.uint8)


def kinect_noise(
    depth: torch.Tensor,
    generator: torch.Generator,
    sigma_scale: float = 1.425e-6,
    edge_thresh_mm: float = 50.0,
    shadow_px: int = 4,
    dropout_frac: float = 0.002,
) -> torch.Tensor:
    """Kinect-like corruption of a clean (H, W) depth frame in mm.

    In sensor order:
      1. depth-dependent Gaussian noise, sigma_z = sigma_scale * z^2 mm
         (about 3 mm at 1.5 m);
      2. IR shadow dropouts: the ``shadow_px`` pixels on the -x side of a
         depth discontinuity larger than ``edge_thresh_mm`` report 0;
      3. salt dropouts: ``dropout_frac`` random invalid pixels;
      4. the TUM u16 x5000 round trip (0.2 mm quantization, 13.1 m cap).

    The random draws come from ``generator``, which must live on the
    depth's device. Returns the corrupted float32 frame (0 = invalid).
    """
    pad = torch.nn.functional.pad
    d = depth.to(torch.float32)
    zero = torch.zeros_like(d)
    valid = d > 0
    normal = torch.randn(d.shape, generator=generator, device=d.device)
    d = torch.where(valid, d + sigma_scale * d * d * normal, zero)

    jump = (pad(d[:, 1:], (0, 1)) - d).abs()
    edge = (jump > edge_thresh_mm) & valid
    shadow = torch.zeros_like(edge)
    for s in range(1, shadow_px + 1):
        shadow = shadow | pad(edge[:, s:], (0, s))
    d = torch.where(shadow, zero, d)

    uniform = torch.rand(d.shape, generator=generator, device=d.device)
    d = torch.where(uniform < dropout_frac, zero, d)

    return torch.clamp(torch.round(d * 5.0), 0, 65535) * 0.2
