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

``pose_grad_cuda`` (``csrc/integrate_pose_grad.cu``) replaces
``_pose_grad_pallas``: the adjoint of the exact rigid integrate, the
volume cotangents and the pose_inv cotangent. ``integrate_pose`` is the
differentiable fusion built on it, a ``torch.autograd.Function`` whose
forward is ``integrate_cuda`` (or ``integrate_fast_cuda``) and whose
backward is one ``pose_grad_cuda`` launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..camera import Camera
from ..ops.integrate import check_frame, check_rigid
from ..ops.integrate import integrate as integrate_plain
from ..ops.integrate import integrate_fast as integrate_fast_plain
from ..ops.integrate_diff import depth_image_gradients, integrate_pose_grad
from ..utils.se3 import matmul_small, se3_exp
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

KERNEL_POSE_GRAD = Kernel(
    "tsdf_integrate_pose_grad",
    # tsdf, weight, gbar_d, gbar_w, depth, gx, gy, dd, dw, partials,
    # n_blocks, params, sx, sy, sz, width, height, cap, image_term, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
     _I, _I, _I, _I, _I, _I, _I, _P],
)
# the pose-adjoint kernel's block tile (x, y) and its number of sums
POSE_GRAD_TILE = (32, 64)
POSE_GRAD_SUMS = 12

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


def pose_grad_cuda(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    gbar_d: torch.Tensor,
    gbar_w: torch.Tensor,
    cap_weight: bool = False,
    image_term: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint of the exact rigid integrate: (dd, dw, dpinv), the
    cotangents of tsdf_in and weight_in and the (4, 4) cotangent of
    ``camera.pose_inv`` (rows R_wc | t_wc, bottom row zero).

    On CUDA tensors this launches the kernel (the depth gradient images
    are plain torch on the card, as they are plain XLA in the JAX
    package) and sums its (blocks, 12) float64 partials in one fixed-order
    ``torch.sum``; on CPU tensors it runs the plain twin
    ``ops.integrate_diff.integrate_pose_grad``. Arguments as the twin's;
    ``vol`` is the volume the frame was fused into.
    """
    check_rigid(vol, "pose_grad_cuda")
    dev = _check_frame(vol, depth, camera)
    shape = tuple(vol.tsdf.shape)
    check_same_device(dev, gbar_d=gbar_d, gbar_w=gbar_w)
    check_tensor("gbar_d", gbar_d, torch.float32, shape=shape)
    check_tensor("gbar_w", gbar_w, torch.float32, shape=shape)
    if dev.type == "cpu":
        return integrate_pose_grad(
            vol, depth, camera, gbar_d, gbar_w, cap_weight=cap_weight,
            image_term=image_term,
        )

    gx, gy = depth_image_gradients(depth)
    params = kernel_params(vol, camera)
    sz, sy, sx = shape
    h, w = depth.shape
    tx, ty = POSE_GRAD_TILE
    n_blocks = -(-sx // tx) * -(-sy // ty) * sz
    partials = torch.empty(
        (n_blocks, POSE_GRAD_SUMS), dtype=torch.float64, device=dev
    )
    dd = torch.empty_like(vol.tsdf)
    dw = torch.empty_like(vol.weight)
    with torch.cuda.device(dev):
        KERNEL_POSE_GRAD(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), gbar_d.data_ptr(),
            gbar_w.data_ptr(), depth.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), dd.data_ptr(), dw.data_ptr(), partials.data_ptr(),
            n_blocks, params.data_ptr(), sx, sy, sz, w, h,
            int(bool(cap_weight)), int(bool(image_term)), stream_handle(dev),
        )
    sums = partials.sum(dim=0).to(torch.float32)
    dpinv = torch.cat(
        [sums.reshape(3, 4), torch.zeros((1, 4), dtype=torch.float32,
                                         device=dev)]
    )
    return dd, dw, dpinv


class _IntegrateCore(torch.autograd.Function):
    """Fusion as a function of (tsdf_in, weight_in, pose_inv). The other
    arguments are observed data: depth, the intrinsics and the volume's
    geometry get no gradient through the fusion (the volume's other fields
    are not outputs of this Function; ``integrate_pose`` passes them
    through, so their cotangents flow by themselves)."""

    @staticmethod
    def forward(ctx, tsdf, weight, pose_inv, vol, depth, camera,
                cap_weight, image_term, fast):
        cam = dataclasses.replace(camera, pose_inv=pose_inv)
        # a functional op: the kernel updates in place, so it runs on
        # copies, and the backward keeps the inputs (1 GiB at 512^3)
        out = vol.replace(tsdf=tsdf.clone(), weight=weight.clone())
        if fast:
            out, miss = integrate_fast_cuda(out, depth, cam, cap_weight)
        else:
            out = integrate_cuda(out, depth, cam, cap_weight)
            miss = torch.zeros((), dtype=torch.int32, device=tsdf.device)
        ctx.save_for_backward(tsdf, weight, pose_inv)
        ctx.vol, ctx.depth, ctx.camera = vol, depth, camera
        ctx.cap_weight, ctx.image_term = cap_weight, image_term
        ctx.mark_non_differentiable(miss)
        return out.tsdf, out.weight, miss

    @staticmethod
    def backward(ctx, g_tsdf, g_weight, _g_miss):
        tsdf, weight, pose_inv = ctx.saved_tensors
        # a loss that never reads an output gives it no cotangent: zero
        g_tsdf = torch.zeros_like(tsdf) if g_tsdf is None else g_tsdf
        g_weight = torch.zeros_like(weight) if g_weight is None else g_weight
        dd, dw, dpinv = pose_grad_cuda(
            ctx.vol.replace(tsdf=tsdf, weight=weight), ctx.depth,
            dataclasses.replace(ctx.camera, pose_inv=pose_inv),
            g_tsdf.contiguous(), g_weight.contiguous(),
            cap_weight=ctx.cap_weight, image_term=ctx.image_term,
        )
        return dd, dw, dpinv, None, None, None, None, None, None


def integrate_pose(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    delta,
    cap_weight: bool = False,
    image_term: bool = True,
    mode: str = "exact",
) -> tuple[TSDFVolume, torch.Tensor]:
    """Differentiable fusion with respect to the pose (and the volume).

    Fuses ``depth`` at the pose ``se3_exp(delta) @ camera.pose`` into a
    COPY of ``vol`` (the caller's tensors are not touched) and returns
    (fused volume, miss count, a 0-d int32 tensor with no gradient).
    Backward: one launch of the pose-adjoint kernel (``pose_grad_cuda``),
    which includes the image-space term autograd cannot see through the
    rounded depth lookup (with ``image_term``) and emits the raw cotangent
    of the pose_inv MATRIX; autograd chains it through the 4x4 inverse and
    ``se3_exp``, so the gradient is exact at any ``delta``, not only at 0.
    The tsdf and weight cotangents are exact, the 0.5 subgradient at the
    weight cap's tie included, so fusion steps chain. ``depth`` and the
    intrinsics are observed data and get no gradient.

    Modes: "exact" and "line" both run the exact kernel (on the card every
    voxel reads its own pixel; the miss count is 0), and the adjoint gates
    exactly like that forward. "fast" does what the JAX function does: the
    forward is the decimated line convention (``integrate_fast_cuda``,
    whose miss count is returned) while the backward is still the exact
    adjoint, so its gradient is that of the exact fusion at the same pose.

    On CUDA tensors the forward and the backward are the kernels; on CPU
    tensors they are the plain twins. A deformed volume raises.

    Args:
      vol: rigid float32 volume; tsdf and weight may require grad.
      depth: (H, W) depth in mm; 0 means no data.
      camera: the frame's camera before the twist.
      delta: (6,) twist (omega, v), a tensor (it may require grad) or an
        array.
      cap_weight: clamp the accumulated weight at vol.max_weight.
      image_term: include the image-space term in the pose gradient.
      mode: "exact", "line" or "fast".
    """
    _check_mode(mode)
    check_rigid(vol, "integrate_pose")
    dev = vol.tsdf.device
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    depth = depth.to(torch.float32).contiguous()
    cam = camera.set_pose(matmul_small(se3_exp(delta), camera.pose))
    new_tsdf, new_weight, miss = _IntegrateCore.apply(
        vol.tsdf, vol.weight, cam.pose_inv, vol, depth, cam, cap_weight,
        image_term, mode == "fast",
    )
    return vol.replace(tsdf=new_tsdf, weight=new_weight), miss
