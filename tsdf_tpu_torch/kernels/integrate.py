"""TSDF integration: the CUDA kernels ``csrc/integrate.cu``,
``csrc/integrate_color.cu``, ``csrc/integrate_fast.cu`` and
``csrc/integrate_warped.cu`` and their wrappers.

``integrate_cuda`` replaces
``tsdf_tpu/kernels/integrate.py:integrate_pallas`` (modes "exact" and
"line"): one thread per voxel reads its pixel directly, the
``ops/integrate.py`` contract, so no voxel is skipped and there is no miss
count to return. ``integrate_fast_cuda`` replaces its mode "fast" (the
decimated line convention, ``ops.integrate.integrate_fast``) and
``integrate_color_cuda`` replaces ``integrate_color_pallas`` in all three
modes; both return ``(vol, miss)`` like the JAX functions, with the miss
count left on the device. These three are the rigid path and refuse a
volume with a deformation field, as the JAX functions do.

``integrate_warped_cuda`` replaces ``integrate_warped_pallas``: the same
update at the deformed centres ``vol.deform``. One thread per voxel reads
its own centre and its own pixel, so no voxel is skipped: there is no miss
count and no miss mask to return, and nothing to top up.
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from ..ops.integrate import check_frame, check_rigid
from ..ops.integrate import integrate as integrate_plain
from ..ops.integrate import integrate_fast as integrate_fast_plain
from ..volume import TSDFVolume
from ._build import Kernel, check_same_device, check_tensor, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "tsdf_integrate",
    # tsdf, weight, depth, params, sx, sy, sz, width, height, cap, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
KERNEL_COLOR = Kernel(
    "tsdf_integrate_color",
    # tsdf, weight, color, depth, rgb, params, sx, sy, sz, width, height,
    # cap, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
KERNEL_FAST = Kernel(
    "tsdf_integrate_fast",
    # tsdf, weight, depth, lines, miss, params, sx, sy, sz, width, height,
    # cap, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
KERNEL_COLOR_FAST = Kernel(
    "tsdf_integrate_color_fast",
    # tsdf, weight, color, depth, rgb, lines, miss, params, sx, sy, sz,
    # width, height, cap, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
KERNEL_WARPED = Kernel(
    "tsdf_integrate_warped",
    # tsdf, weight, deform, depth, params, sx, sy, sz, width, height, cap,
    # stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
KERNEL_WARPED_COLOR = Kernel(
    "tsdf_integrate_warped_color",
    # tsdf, weight, color, deform, depth, rgb, params, sx, sy, sz, width,
    # height, cap, stream
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)

MODES = ("exact", "line", "fast")


def kernel_params(vol: TSDFVolume, camera: Camera) -> torch.Tensor:
    """The kernel's 24 f32 parameters, assembled on the volume's device:
    pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3), voxel size (3),
    truncation distance, max weight."""
    k = camera.k
    return torch.cat(
        [
            camera.pose_inv[0:3, :].reshape(-1),
            torch.stack([k[0, 0], k[1, 1], k[0, 2], k[1, 2]]),
            vol.offset,
            vol.voxel_size,
            vol.truncation_distance.reshape(1),
            vol.max_weight.reshape(1),
        ]
    ).contiguous()


def _check_frame(vol: TSDFVolume, depth, camera: Camera, rgb=None):
    """Raise on what the kernels do not take; returns the volume's device."""
    dev = vol.tsdf.device
    check_same_device(
        dev, weight=vol.weight, depth=depth, pose_inv=camera.pose_inv
    )
    shape = tuple(vol.tsdf.shape)
    check_tensor("tsdf", vol.tsdf, torch.float32, ndim=3)
    check_tensor("weight", vol.weight, torch.float32, shape=shape)
    check_tensor("depth", depth, torch.float32, ndim=2)
    if rgb is not None and not isinstance(rgb, torch.Tensor):
        raise TypeError(f"rgb: expected a tensor, got {type(rgb).__name__}")
    check_frame(vol, depth, rgb)
    if rgb is not None:
        check_same_device(dev, color=vol.color, rgb=rgb)
        check_tensor("color", vol.color, torch.uint8, shape=shape + (3,))
        check_tensor("rgb", rgb, torch.uint8, shape=tuple(depth.shape) + (3,))
    return dev


def _copy_back(vol: TSDFVolume, out: TSDFVolume) -> TSDFVolume:
    """The CPU path: write the twin's result into ``vol``'s own tensors."""
    vol.tsdf.copy_(out.tsdf)
    vol.weight.copy_(out.weight)
    if vol.color is not None and out.color is not vol.color:
        vol.color.copy_(out.color)
    return vol


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(
            f"mode must be 'exact', 'line' or 'fast', got {mode!r}"
        )


def integrate_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
) -> TSDFVolume:
    """Fuse one depth frame into ``vol``, updating ``vol.tsdf`` and
    ``vol.weight`` IN PLACE (at 512^3 a functional update would copy
    1 GiB per frame); returns ``vol``.

    On CUDA tensors this launches the kernel; on CPU tensors it runs the
    plain twin ``ops.integrate.integrate`` and copies its result back.

    Args:
      vol: float32 volume, tsdf/weight contiguous (Z, Y, X).
      depth: (H, W) float32 depth in mm, contiguous; 0 means no data.
      camera: the frame's camera, on the volume's device.
      cap_weight: clamp the accumulated weight at vol.max_weight.
    """
    check_rigid(vol, "integrate_cuda")
    dev = _check_frame(vol, depth, camera)
    if dev.type == "cpu":
        return _copy_back(
            vol, integrate_plain(vol, depth, camera, cap_weight=cap_weight)
        )

    params = kernel_params(vol, camera)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    with torch.cuda.device(dev):
        KERNEL(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), depth.data_ptr(),
            params.data_ptr(), sx, sy, sz, w, h, int(bool(cap_weight)),
            stream_handle(dev),
        )
    return vol


def _fast_scratch(vol: TSDFVolume):
    """The fast kernels' scratch on the volume's device: the (alpha, beta)
    line of every voxel column, and the zeroed miss count."""
    sz, _sy, sx = vol.tsdf.shape
    dev = vol.tsdf.device
    lines = torch.empty((sz, sx, 2), dtype=torch.float32, device=dev)
    miss = torch.zeros(1, dtype=torch.int32, device=dev)
    return lines, miss


def integrate_fast_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
) -> tuple[TSDFVolume, torch.Tensor]:
    """Fuse one depth frame under the decimated line convention
    (``ops.integrate.integrate_fast``), updating ``vol`` IN PLACE.

    Returns (vol, miss): ``miss`` is a 0-d int32 tensor on the volume's
    device, the in-image voxels skipped because their column's image line
    is steeper than |beta| = 1 (extreme camera roll). It is not read here:
    a caller sums a run's counts and reads them once.

    On CUDA tensors this launches the kernel; on CPU tensors it runs the
    plain twin. Arguments as ``integrate_cuda``.
    """
    check_rigid(vol, "integrate_fast_cuda")
    dev = _check_frame(vol, depth, camera)
    if dev.type == "cpu":
        out, miss = integrate_fast_plain(
            vol, depth, camera, cap_weight=cap_weight
        )
        return _copy_back(vol, out), miss

    params = kernel_params(vol, camera)
    lines, miss = _fast_scratch(vol)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    with torch.cuda.device(dev):
        KERNEL_FAST(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), depth.data_ptr(),
            lines.data_ptr(), miss.data_ptr(), params.data_ptr(),
            sx, sy, sz, w, h, int(bool(cap_weight)), stream_handle(dev),
        )
    return vol, miss[0]


def integrate_color_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    rgb: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
    mode: str = "line",
) -> tuple[TSDFVolume, torch.Tensor]:
    """Fuse one depth + colour frame, updating ``vol.tsdf``, ``vol.weight``
    and ``vol.color`` IN PLACE.

    Modes "exact" and "line" are the ``ops.integrate.integrate(rgb=)``
    contract (every voxel reads its own pixel; the miss count is 0); mode
    "fast" samples depth and rgb under the decimated line convention
    (``ops.integrate.integrate_fast``).

    Returns (vol, miss) with ``miss`` a 0-d int32 tensor on the volume's
    device, as ``integrate_fast_cuda``.

    Args:
      vol: float32 volume with a (Z, Y, X, 3) uint8 colour field.
      depth: (H, W) float32 depth in mm, contiguous; 0 means no data.
      rgb: (H, W, 3) uint8 colour frame, contiguous, on the volume's device.
      camera: the frame's camera, on the volume's device.
      cap_weight: clamp the accumulated weight at vol.max_weight; the
        colour rate then uses the clamped weight.
    """
    _check_mode(mode)
    check_rigid(vol, "integrate_color_cuda")
    dev = _check_frame(vol, depth, camera, rgb=rgb)
    fast = mode == "fast"
    if dev.type == "cpu":
        if fast:
            out, miss = integrate_fast_plain(
                vol, depth, camera, cap_weight=cap_weight, rgb=rgb
            )
        else:
            out = integrate_plain(
                vol, depth, camera, cap_weight=cap_weight, rgb=rgb
            )
            miss = torch.zeros((), dtype=torch.int32)
        return _copy_back(vol, out), miss

    params = kernel_params(vol, camera)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    volume = (vol.tsdf.data_ptr(), vol.weight.data_ptr(), vol.color.data_ptr())
    images = (depth.data_ptr(), rgb.data_ptr())
    tail = (sx, sy, sz, w, h, int(bool(cap_weight)), stream_handle(dev))
    with torch.cuda.device(dev):
        if fast:
            lines, miss = _fast_scratch(vol)
            KERNEL_COLOR_FAST(
                *volume, *images, lines.data_ptr(), miss.data_ptr(),
                params.data_ptr(), *tail,
            )
            return vol, miss[0]
        KERNEL_COLOR(*volume, *images, params.data_ptr(), *tail)
    return vol, torch.zeros((), dtype=torch.int32, device=dev)


def integrate_warped_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
    rgb: torch.Tensor | None = None,
) -> TSDFVolume:
    """Fuse one depth frame into a DEFORMED volume, at the centres
    ``vol.deform``, updating ``vol.tsdf`` and ``vol.weight`` (and
    ``vol.color`` with ``rgb``) IN PLACE; returns ``vol``.

    The contract is ``ops.integrate.integrate`` on a volume with a
    deformation field. Every voxel projects its own centre and reads its
    own pixel, so nothing is skipped: unlike the JAX
    ``integrate_warped_pallas`` there is no miss count and no miss mask.
    A centre that is NaN or infinite, or lands on Z == 0, is not updated.

    On CUDA tensors this launches the kernel; on CPU tensors it runs the
    plain twin and copies its result back.

    Args:
      vol: float32 volume with a contiguous (Z, Y, X, 3) float32
        ``deform`` (a strided view raises: it is not copied silently).
      depth: (H, W) float32 depth in mm, contiguous; 0 means no data.
      camera: the frame's camera, on the volume's device.
      cap_weight: clamp the accumulated weight at vol.max_weight.
      rgb: optional (H, W, 3) uint8 colour frame; needs ``vol.color``.
    """
    if vol.deform is None:
        raise ValueError(
            "integrate_warped_cuda needs vol.deform; use integrate_cuda "
            "for rigid volumes"
        )
    dev = _check_frame(vol, depth, camera, rgb=rgb)
    check_same_device(dev, deform=vol.deform)
    check_tensor(
        "deform", vol.deform, torch.float32, shape=(*vol.tsdf.shape, 3)
    )
    if dev.type == "cpu":
        return _copy_back(
            vol,
            integrate_plain(vol, depth, camera, cap_weight=cap_weight, rgb=rgb),
        )

    params = kernel_params(vol, camera)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    tail = (
        params.data_ptr(), sx, sy, sz, w, h, int(bool(cap_weight)),
        stream_handle(dev),
    )
    with torch.cuda.device(dev):
        if rgb is None:
            KERNEL_WARPED(
                vol.tsdf.data_ptr(), vol.weight.data_ptr(),
                vol.deform.data_ptr(), depth.data_ptr(), *tail,
            )
        else:
            KERNEL_WARPED_COLOR(
                vol.tsdf.data_ptr(), vol.weight.data_ptr(),
                vol.color.data_ptr(), vol.deform.data_ptr(),
                depth.data_ptr(), rgb.data_ptr(), *tail,
            )
    return vol
