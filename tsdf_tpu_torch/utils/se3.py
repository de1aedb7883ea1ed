"""SE(3) Lie-group helpers in plain PyTorch.

Port of ``tsdf_tpu/utils/se3.py``: the exponential map written by hand,
with Taylor fallbacks at theta -> 0, for the ICP pose update.

Twist convention: xi = (omega, v) with omega the rotation part (rad) and
v the translation part (mm), Sophus' (so3, translation) tangent ordering.

Every function stays on the device of its argument and reads no value
back to the host, so the tracker's Gauss-Newton loop runs without a
sync.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def hat(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    o = torch.as_tensor(omega, dtype=_F32)
    zeros = torch.zeros_like(o[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -o[..., 2], o[..., 1]], dim=-1),
            torch.stack([o[..., 2], zeros, -o[..., 0]], dim=-1),
            torch.stack([-o[..., 1], o[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _abc(theta2: torch.Tensor):
    """Rodrigues coefficients a = sin(t)/t, b = (1 - cos t)/t^2,
    c = (1 - a)/t^2, with their Taylor series below theta^2 = 1e-8."""
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2
    )
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / safe_t2)
    return a, b, c


def matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small matrices as broadcast multiply + sum: true float32
    whatever the global TF32 flag says."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with small-angle Taylor fallback. (3,) -> (3, 3)."""
    omega = torch.as_tensor(omega, dtype=_F32)
    theta2 = (omega * omega).sum()
    k = hat(omega)
    a, b, _ = _abc(theta2)
    eye = torch.eye(3, dtype=_F32, device=omega.device)
    return eye + a * k + b * matmul_small(k, k)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(6,) twist (omega, v) -> (4, 4) homogeneous transform.

    T = [exp(omega^), V v; 0 1] with V the left Jacobian of SO(3).
    """
    xi = torch.as_tensor(xi, dtype=_F32)
    omega, v = xi[0:3], xi[3:6]
    theta2 = (omega * omega).sum()
    k = hat(omega)
    kk = matmul_small(k, k)
    a, b, c = _abc(theta2)
    eye = torch.eye(3, dtype=_F32, device=xi.device)
    r = eye + a * k + b * kk
    vmat = eye + b * k + c * kk
    t = torch.eye(4, dtype=_F32, device=xi.device)
    t[0:3, 0:3] = r
    t[0:3, 3] = (vmat * v[None, :]).sum(dim=-1)
    return t


def euler_to_matrix(rotation: torch.Tensor) -> torch.Tensor:
    """(3,) Euler angles (rad) -> (3, 3) rotation matrix, angle 1 about
    x, 2 about y, 3 about z:

        [ c2*c3           -c2*s3            s2    ]
        [ c1*s3+s1*s2*c3   c1*c3-s1*s2*s3  -s1*c2 ]
        [ s1*s3-c1*s2*c3   s1*c3+c1*s2*s3   c1*c2 ]
    """
    rotation = torch.as_tensor(rotation, dtype=_F32)
    c1, c2, c3 = torch.cos(rotation).unbind()
    s1, s2, s3 = torch.sin(rotation).unbind()
    return torch.stack(
        [
            torch.stack([c2 * c3, -c2 * s3, s2]),
            torch.stack(
                [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2]
            ),
            torch.stack(
                [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2]
            ),
        ]
    )
