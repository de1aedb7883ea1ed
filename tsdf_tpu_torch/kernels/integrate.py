"""TSDF integration: the CUDA kernels ``csrc/integrate.cu``,
``csrc/integrate_color.cu``, ``csrc/integrate_fast.cu`` and
``csrc/integrate_warped.cu`` and their wrappers.

``integrate_cuda`` replaces
``tsdf_tpu/kernels/integrate.py:integrate_pallas`` (modes "exact" and
"line"): each voxel reads its pixel directly, the ``ops/integrate.py``
contract, so no voxel is skipped and there is no miss count to return. Its
kernel walks bricks of voxels and skips a brick that no voxel of it can
update; ``brick_cull`` is that test in plain PyTorch.
``integrate_fast_cuda`` replaces its mode "fast" (the
decimated line convention, ``ops.integrate.integrate_fast``) and
``integrate_color_cuda`` replaces ``integrate_color_pallas`` in all three
modes; both return ``(vol, miss)`` like the JAX functions, with the miss
count left on the device. These three are the rigid path and refuse a
volume with a deformation field, as the JAX functions do. The fast and
the colour kernels walk the same bricks as ``integrate_cuda``'s
(``brick_cull`` with ``fast`` is the test in the decimated convention).

``integrate_warped_cuda`` replaces ``integrate_warped_pallas``: the same
update at the deformed centres ``vol.deform``. One thread per voxel reads
its own centre and its own pixel, so no voxel is skipped: there is no miss
count and no miss mask to return, and nothing to top up.

``pose_grad_cuda`` (``csrc/integrate_pose_grad.cu``) replaces
``_pose_grad_pallas``: the adjoint of the exact rigid integrate, the
volume cotangents and the pose_inv cotangent. Its kernel walks the same
bricks: a culled brick is a copy of the cotangents, and each live brick
sums its pose terms into its own row of partials (``pose_grad_partials``
is that order in plain PyTorch). ``integrate_pose`` is the
differentiable fusion built on it, a ``torch.autograd.Function`` whose
forward is ``integrate_cuda`` (or ``integrate_fast_cuda``) and whose
backward is one ``pose_grad_cuda`` launch.

Every kernel has two instances, one for each storage dtype of the volume's
tsdf and weight: float32, and bfloat16 (``TSDFVolume.astype``), which
reads and writes half the volume's bytes; ``instance`` picks the one a
launch takes, and each counts its own launches. Both compute in float32,
as their twins do. Another dtype, or a weight of another dtype than the
tsdf, raises TypeError.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..camera import Camera
from ..ops.integrate import check_frame, check_rigid
from ..ops.integrate import integrate as integrate_plain
from ..ops.integrate import fit_column_lines
from ..ops.integrate import integrate_fast as integrate_fast_plain
from ..ops.integrate_diff import integrate_pose_grad, pose_grad_terms
from ..utils.se3 import matmul_small, se3_exp
from ..volume import TSDFVolume
from ._build import (
    Kernel,
    check_same_device,
    check_tensor,
    storage_dtype,
    stream_handle,
)

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
    # tsdf, weight, gbar_d, gbar_w, depth, dd, dw, partials, n_bricks,
    # params, sx, sy, sz, width, height, cap, image_term, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
     _I, _I, _I, _I, _I, _I, _I, _P],
)
# the pose adjoint's sums a brick: the rows R_wc | t_wc of dL/dpose_inv
POSE_GRAD_SUMS = 12


def _bf16(kernel: Kernel) -> Kernel:
    """The bfloat16-storage instance of ``kernel``: the same arguments, its
    own entry point and launch count."""
    return Kernel(kernel.symbol + "_bf16", kernel.argtypes)


KERNEL_BF16 = _bf16(KERNEL)
KERNEL_COLOR_BF16 = _bf16(KERNEL_COLOR)
KERNEL_FAST_BF16 = _bf16(KERNEL_FAST)
KERNEL_COLOR_FAST_BF16 = _bf16(KERNEL_COLOR_FAST)
KERNEL_WARPED_BF16 = _bf16(KERNEL_WARPED)
KERNEL_WARPED_COLOR_BF16 = _bf16(KERNEL_WARPED_COLOR)
KERNEL_POSE_GRAD_BF16 = _bf16(KERNEL_POSE_GRAD)
# the instance a launch takes, by the volume's storage dtype
_INSTANCES = {
    k: {torch.float32: k, torch.bfloat16: b}
    for k, b in (
        (KERNEL, KERNEL_BF16), (KERNEL_COLOR, KERNEL_COLOR_BF16),
        (KERNEL_FAST, KERNEL_FAST_BF16),
        (KERNEL_COLOR_FAST, KERNEL_COLOR_FAST_BF16),
        (KERNEL_WARPED, KERNEL_WARPED_BF16),
        (KERNEL_WARPED_COLOR, KERNEL_WARPED_COLOR_BF16),
        (KERNEL_POSE_GRAD, KERNEL_POSE_GRAD_BF16),
    )
}


def instance(kernel: Kernel, vol: TSDFVolume) -> Kernel:
    """``kernel``'s instance for ``vol``'s storage: the float32 one or its
    bfloat16 twin (``storage_dtype`` has checked the dtype)."""
    return _INSTANCES[kernel][vol.tsdf.dtype]

MODES = ("exact", "line", "fast")


# csrc/integrate_bricks.cuh's brick, (z, y, x) voxels: a block of 32 x 4
# threads, each walking 8 voxels in z
BRICK = (8, 4, 32)
# its cull keeps every brick within this many pixels of the image; in the
# fast convention, whose sampled column lies up to 3.5 pixels from the
# voxel's projection, this many on either side in x
CULL_MARGIN_PX = 2.0
FAST_CULL_MARGIN_PX = 5.0
# the words of the brick walk's scratch before its list of live bricks:
# the frame's largest depth, the count of live bricks, the steep-column flag
_INTEGRATE_SCRATCH_HEAD = 3


def brick_grid(shape) -> tuple[int, int, int]:
    """The (z, y, x) count of ``BRICK``-sized bricks that cover a volume of
    ``shape`` (Z, Y, X), the last of each axis ragged."""
    return tuple(-(-n // b) for n, b in zip(shape, BRICK))


def kernel_params(
    vol: TSDFVolume, camera: Camera, scratch: int = 0
) -> torch.Tensor:
    """The kernels' 24 f32 parameters, assembled on the volume's device:
    pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3), voxel size (3),
    truncation distance, max weight; then ``scratch`` zeroed words a
    kernel may write into (``_brick_params`` sizes the scratch of the
    brick walk)."""
    k = camera.k
    parts = [
        camera.pose_inv[0:3, :].reshape(-1),
        torch.stack([k[0, 0], k[1, 1], k[0, 2], k[1, 2]]),
        vol.offset,
        vol.voxel_size,
        vol.truncation_distance.reshape(1),
        vol.max_weight.reshape(1),
    ]
    if scratch:
        parts.append(torch.zeros(scratch, dtype=torch.float32,
                                 device=vol.tsdf.device))
    return torch.cat(parts).contiguous()


def brick_cull(vol: TSDFVolume, depth: torch.Tensor, camera: Camera,
               fast: bool = False):
    """Which bricks of ``BRICK`` voxels the brick walk of
    ``csrc/integrate_bricks.cuh`` skips for this frame: a
    ``brick_grid(vol.tsdf.shape)`` bool tensor, True where no voxel of the
    brick can pass the gates of ``ops.integrate.integrate`` or, with
    ``fast``, be updated or counted as a miss by
    ``ops.integrate.integrate_fast``.

    The kernel's test, in float32 and in its order: at the 8 corners of
    the brick's box of voxel centres widened by one voxel each way, the
    camera point (X, Y, Z), u = fx X + cx Z and v = fy Y + cy Z; the brick
    is culled when all 8 corners are outside one plane -- Z <= 0,
    u + mu Z < 0, (W - 1 + mu) Z - u < 0, v + m Z < 0, (H - 1 + m) Z - v < 0
    or Z > max depth + truncation, m = ``CULL_MARGIN_PX``, mu = m or, with
    ``fast``, ``FAST_CULL_MARGIN_PX`` -- or when the frame has no depth > 0.
    All six are affine in the voxel index, so a plane negative at the
    corners is negative on the box. With ``fast``, a voxel column steeper
    than |beta| = 1 (``ops.integrate.fit_column_lines``) keeps every brick:
    its voxels count as misses wherever they lie.
    """
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    dev = vol.tsdf.device
    vs, off = vol.voxel_size, vol.offset
    m = CULL_MARGIN_PX
    mu = FAST_CULL_MARGIN_PX if fast else m

    def ends(n, b, axis):
        """The low and high corner coordinate of every brick on an axis."""
        first = torch.arange(0, n, b, device=dev).to(torch.float32)
        return [(c + 0.5) * vs[axis] + off[axis]
                for c in (first - 1, first + b)]

    bz, by, bx = BRICK
    xs, ys, zs = ends(sx, bx, 0), ends(sy, by, 1), ends(sz, bz, 2)
    depth = depth.to(torch.float32)
    dmax = torch.where(depth > 0, depth, 0.0).max()
    far = dmax + vol.truncation_distance
    pi, k = camera.pose_inv, camera.k
    culled = None
    for wz in zs:
        for wy in ys:
            for wx in xs:
                x, y, z = wx[None, None, :], wy[None, :, None], wz[:, None, None]
                cx, cy, cz = (
                    pi[i, 0] * x + pi[i, 1] * y + pi[i, 2] * z + pi[i, 3]
                    for i in range(3)
                )
                u = k[0, 0] * cx + k[0, 2] * cz
                v = k[1, 1] * cy + k[1, 2] * cz
                outside = torch.stack([
                    cz <= 0,
                    u + mu * cz < 0,
                    float(w - 1 + mu) * cz - u < 0,
                    v + m * cz < 0,
                    float(h - 1 + m) * cz - v < 0,
                    cz > far,
                ])
                culled = outside if culled is None else culled & outside
    culled = culled.any(0) | ~(dmax > 0)
    if fast:
        _alpha, beta = fit_column_lines(vol, camera)
        culled = culled & ~(~(beta.abs() <= 1.0)).any()
    return culled


def pose_grad_partials(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    gbar_d: torch.Tensor,
    image_term: bool = True,
) -> torch.Tensor:
    """The pose-adjoint kernel's partial sums in plain PyTorch: a (bricks,
    12) float64 tensor whose row b holds brick b's sums of the 12 terms of
    ``ops.integrate_diff.pose_grad_terms`` (bricks of ``BRICK`` voxels,
    b = (bz * nby + by) * nbx + bx), and whose column sums are the rows
    R_wc | t_wc of the pose_inv cotangent.

    Each row is added up in the kernel's order, so that it does not depend
    on the order in which the kernel's blocks take the bricks: a thread's
    strip of 8 voxels in z from 0.0, the 32 strips along x by the warp's
    tree (lane i adds lane i + 16, then i + 8, ...), the 4 warps
    along y from 0.0. A term outside the volume or off the gates is 0 and
    changes no sum, so a brick the cull skips (its row written as zero by
    the kernel) holds zero here too.
    """
    sz, sy, sx = vol.tsdf.shape
    nb = brick_grid(vol.tsdf.shape)
    bz, by, bx = BRICK
    cols = []
    for term in pose_grad_terms(vol, depth, camera, gbar_d, image_term):
        t = torch.zeros((nb[0] * bz, nb[1] * by, nb[2] * bx),
                        dtype=torch.float64, device=vol.tsdf.device)
        t[:sz, :sy, :sx] = term.to(torch.float64)
        t = t.reshape(nb[0], bz, nb[1], by, nb[2], bx)
        acc = torch.zeros_like(t[:, 0])
        for k in range(bz):  # each thread's strip
            acc = acc + t[:, k]
        h = bx // 2
        while h:  # the tree over the warp's x
            acc = acc[..., :h] + acc[..., h:2 * h]
            h //= 2
        acc = acc[..., 0]
        row = torch.zeros_like(acc[:, :, 0])
        for r in range(by):  # the block's warps
            row = row + acc[:, :, r]
        cols.append(row.reshape(-1))
    return torch.stack(cols, dim=1)


def _brick_params(vol: TSDFVolume, camera: Camera) -> torch.Tensor:
    """``kernel_params`` with the brick walk's zeroed scratch after them:
    the largest depth, the count of live bricks, the steep-column flag and
    the list of live bricks."""
    nb = brick_grid(vol.tsdf.shape)
    return kernel_params(
        vol, camera, scratch=_INTEGRATE_SCRATCH_HEAD + nb[0] * nb[1] * nb[2])


def _check_frame(vol: TSDFVolume, depth, camera: Camera, rgb=None):
    """Raise on what the kernels do not take; returns the volume's device."""
    dev = vol.tsdf.device
    check_same_device(
        dev, weight=vol.weight, depth=depth, pose_inv=camera.pose_inv
    )
    shape = tuple(vol.tsdf.shape)
    dtype = storage_dtype(vol.tsdf, vol.weight)
    check_tensor("tsdf", vol.tsdf, dtype, ndim=3)
    check_tensor("weight", vol.weight, dtype, shape=shape)
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

    On CUDA tensors this launches the kernel (one counted launch: a
    pre-pass reduces the frame's largest depth, a second lists the bricks
    ``brick_cull`` keeps, and the brick kernel walks that list); on CPU
    tensors it runs the plain twin ``ops.integrate.integrate`` and copies
    its result back.

    Args:
      vol: volume with float32 or bfloat16 tsdf/weight (both the same),
        contiguous (Z, Y, X); a bfloat16 volume launches the kernel's bf16
        instance.
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

    params = _brick_params(vol, camera)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    with torch.cuda.device(dev):
        instance(KERNEL, vol)(
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

    The kernel walks the bricks ``brick_cull(..., fast=True)`` keeps (all
    of them when a column is steeper than |beta| = 1), as the colour-fast
    kernel does.
    """
    check_rigid(vol, "integrate_fast_cuda")
    dev = _check_frame(vol, depth, camera)
    if dev.type == "cpu":
        out, miss = integrate_fast_plain(
            vol, depth, camera, cap_weight=cap_weight
        )
        return _copy_back(vol, out), miss

    params = _brick_params(vol, camera)
    lines, miss = _fast_scratch(vol)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    with torch.cuda.device(dev):
        instance(KERNEL_FAST, vol)(
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
      vol: float32 or bfloat16 volume with a (Z, Y, X, 3) uint8 colour
        field.
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

    params = _brick_params(vol, camera)
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    volume = (vol.tsdf.data_ptr(), vol.weight.data_ptr(), vol.color.data_ptr())
    images = (depth.data_ptr(), rgb.data_ptr())
    tail = (sx, sy, sz, w, h, int(bool(cap_weight)), stream_handle(dev))
    with torch.cuda.device(dev):
        if fast:
            lines, miss = _fast_scratch(vol)
            instance(KERNEL_COLOR_FAST, vol)(
                *volume, *images, lines.data_ptr(), miss.data_ptr(),
                params.data_ptr(), *tail,
            )
            return vol, miss[0]
        instance(KERNEL_COLOR, vol)(
            *volume, *images, params.data_ptr(), *tail)
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
      vol: float32 or bfloat16 volume with a contiguous (Z, Y, X, 3)
        float32 ``deform`` (a strided view raises: it is not copied
        silently).
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
            instance(KERNEL_WARPED, vol)(
                vol.tsdf.data_ptr(), vol.weight.data_ptr(),
                vol.deform.data_ptr(), depth.data_ptr(), *tail,
            )
        else:
            instance(KERNEL_WARPED_COLOR, vol)(
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

    On CUDA tensors this launches the kernel (which takes the depth
    gradients of ``ops.integrate_diff.depth_image_gradients`` at the pixels
    it needs, where the JAX package computes the images in plain XLA) and
    sums its (bricks, 12) float64 partials, one row a brick
    (``pose_grad_partials``), in one fixed-order ``torch.sum``; on CPU
    tensors it runs the plain twin
    ``ops.integrate_diff.integrate_pose_grad``. Arguments as the twin's;
    ``vol`` is the volume the frame was fused into. The cotangents gbar_d
    and gbar_w are of the volume's dtype, and so are dd and dw: a bfloat16
    volume launches the bf16 instance, which reads them into float32 and
    rounds dd and dw once, as the JAX backward does.
    """
    check_rigid(vol, "pose_grad_cuda")
    dev = _check_frame(vol, depth, camera)
    shape = tuple(vol.tsdf.shape)
    check_same_device(dev, gbar_d=gbar_d, gbar_w=gbar_w)
    check_tensor("gbar_d", gbar_d, vol.tsdf.dtype, shape=shape)
    check_tensor("gbar_w", gbar_w, vol.tsdf.dtype, shape=shape)
    if dev.type == "cpu":
        return integrate_pose_grad(
            vol, depth, camera, gbar_d, gbar_w, cap_weight=cap_weight,
            image_term=image_term,
        )

    params = _brick_params(vol, camera)
    sz, sy, sx = shape
    h, w = depth.shape
    nb = brick_grid(shape)
    n_bricks = nb[0] * nb[1] * nb[2]
    partials = torch.empty(
        (n_bricks, POSE_GRAD_SUMS), dtype=torch.float64, device=dev
    )
    dd = torch.empty_like(vol.tsdf)
    dw = torch.empty_like(vol.weight)
    with torch.cuda.device(dev):
        instance(KERNEL_POSE_GRAD, vol)(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), gbar_d.data_ptr(),
            gbar_w.data_ptr(), depth.data_ptr(), dd.data_ptr(), dw.data_ptr(),
            partials.data_ptr(), n_bricks, params.data_ptr(), sx, sy, sz, w, h,
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
        # autograd gives the outputs' cotangents in their dtype, the
        # volume's; dd and dw come back in it
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
      vol: rigid float32 or bfloat16 volume; tsdf and weight may require
        grad (their gradients come back in the volume's dtype).
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
