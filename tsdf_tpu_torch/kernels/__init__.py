"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel on CUDA tensors and runs the plain
PyTorch twin only on CPU tensors; each keeps a launch count on its
``KERNEL`` object.
"""

from __future__ import annotations

from . import bilateral, gather, integrate, lm, raycast

KERNELS = {
    "integrate": integrate.KERNEL,
    "integrate_color": integrate.KERNEL_COLOR,
    "integrate_fast": integrate.KERNEL_FAST,
    "integrate_color_fast": integrate.KERNEL_COLOR_FAST,
    "raycast": raycast.KERNEL,
    "integrate_warped": integrate.KERNEL_WARPED,
    "integrate_warped_color": integrate.KERNEL_WARPED_COLOR,
    "integrate_pose_grad": integrate.KERNEL_POSE_GRAD,
    "integrate_pose_grad_slab": integrate.KERNEL_POSE_GRAD_SLAB,
    "lane_gather": gather.KERNEL,
    "row_gather": gather.KERNEL_ROWS,
    "lane_gather_windowed": gather.KERNEL_WINDOWED,
    "lane_gather_if_missed": gather.KERNEL_IF_MISSED,
    "bilateral": bilateral.KERNEL,
    "gather_probe": gather.KERNEL_PROBE,
    "lm_linearise": lm.KERNEL,
    # the bfloat16-storage instances of the kernels that read the volume
    "integrate_bf16": integrate.KERNEL_BF16,
    "integrate_color_bf16": integrate.KERNEL_COLOR_BF16,
    "integrate_fast_bf16": integrate.KERNEL_FAST_BF16,
    "integrate_color_fast_bf16": integrate.KERNEL_COLOR_FAST_BF16,
    "raycast_bf16": raycast.KERNEL_BF16,
    "integrate_warped_bf16": integrate.KERNEL_WARPED_BF16,
    "integrate_warped_color_bf16": integrate.KERNEL_WARPED_COLOR_BF16,
    "integrate_pose_grad_bf16": integrate.KERNEL_POSE_GRAD_BF16,
    "integrate_pose_grad_slab_bf16": integrate.KERNEL_POSE_GRAD_SLAB_BF16,
    "lm_linearise_bf16": lm.KERNEL_BF16,
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
