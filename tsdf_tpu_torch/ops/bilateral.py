"""Bilateral depth filtering as a dense stencil, in plain PyTorch.

Port of ``tsdf_tpu/ops/bilateral.py`` and the plain twin of the CUDA
kernel in ``kernels/bilateral.py``: a (2r+1)^2 window of shifted adds,
r = ceil(1.5 * sigma_space), spatial weight
exp(-(dx^2+dy^2)/sigma_space^2), range weight the Gaussian
exp(-dv^2 / (2 sigma_colour^2)).

Zero depth means "no data": such pixels contribute nothing and stay
zero, so the filter never bleeds values across holes.

The taps run dy outer, dx inner and accumulate in that order; the
spatial weight is a Python float from ``math.exp`` and the range
constant ``0.5 / sigma_colour^2`` is folded on the host. The kernel
keeps exactly this order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import math

import torch


def filter_radius(sigma_space: float) -> int:
    return math.ceil(sigma_space * 1.5)


def spatial_weights(sigma_space: float) -> list[float]:
    """The (2r+1)^2 spatial weights, dy outer and dx inner, computed in
    double on the host."""
    radius = filter_radius(sigma_space)
    inv_ss2 = 1.0 / (sigma_space * sigma_space)
    taps = range(-radius, radius + 1)
    return [math.exp(-(dx * dx + dy * dy) * inv_ss2) for dy in taps for dx in taps]


def range_constant(sigma_colour: float) -> float:
    """0.5 / sigma_colour^2, the factor of -dv^2 in the range weight."""
    return 0.5 * (1.0 / (sigma_colour * sigma_colour))


def bilateral_filter(
    depth: torch.Tensor,
    sigma_colour: float = 20.0,
    sigma_space: float = 3.0,
) -> torch.Tensor:
    """Filter a (H, W) depth image in mm (zero = no data); returns the
    same dtype. Integer input is filtered in float32 and rounded back
    (half to even)."""
    orig_dtype = depth.dtype
    d = depth.to(torch.float32)
    h, w = d.shape
    radius = filter_radius(sigma_space)
    weights = spatial_weights(sigma_space)
    c = range_constant(sigma_colour)

    valid = d > 0
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    padded = torch.nn.functional.pad(d, (radius,) * 4)
    zero = torch.zeros_like(d)
    i = 0
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            w_s = weights[i]
            i += 1
            tap = padded[dy : dy + h, dx : dx + w]
            dv = tap - d
            w_c = torch.exp(-(dv * dv) * c)
            wgt = torch.where(tap > 0, w_s * w_c, zero)
            num = num + tap * wgt
            den = den + wgt
    out = torch.where(valid, num / torch.clamp(den, min=1e-12), zero)
    if not orig_dtype.is_floating_point:
        out = torch.round(out)
    return out.to(orig_dtype)
