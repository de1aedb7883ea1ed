"""Camera pose recovery by gradient steps through the volume.

The two differentiable paths of the port, as the JAX package's runners
drive them:

* through fusion (``tools/run_config4b.py``): a depth frame fused at the
  pose ``se3_exp(delta) @ camera.pose`` is compared with a target volume
  fused at the true pose (the masked mean squared tsdf difference over the
  voxels both updated), and ``delta`` takes normalised gradient steps
  through ``kernels.integrate.integrate_pose``: the integrate kernel
  forward, the pose-adjoint kernel backward;
* through the raycast (``tools/run_config4.py``): Levenberg-Marquardt on
  the depth residuals of a differentiable render against a target depth
  image. Each step marches once at the current pose (the raycast kernel,
  no gradient), then linearises the Newton correction
  (``ops.raycast_diff.correct``) in one pass: every ray's residual and
  row of the (H*W, 6) Jacobian, summed into the normal equations
  (``kernels.lm.lm_linearise``, the kernel ``csrc/lm_linearise.cu``). The
  tangents flow only through the correction in any case; six forward-mode
  dual passes through ``banded_residuals`` take the same Jacobian.

Both follow their tensors' device: on CUDA tensors every kernel runs, on
CPU tensors the plain twins.
"""

from __future__ import annotations

import time

import torch

from ..camera import Camera
from ..kernels.integrate import integrate_pose
from ..kernels.lm import lm_linearise
from ..ops.lm_linearise import normal_equations
from ..ops.raycast import REFERENCE_MAX_STEPS
from ..ops.raycast_diff import correct, march, vertices_to_depth
from ..utils.profiling import count, count_tensor, trace
from ..utils.se3 import matmul_small, se3_exp
from ..volume import TSDFVolume

_F32 = torch.float32
# the descent through fusion: a step moves the rotation by ROT_STEP rad and
# the translation by TRANS_STEP mm (tools/run_config4b.py)
ROT_STEP, TRANS_STEP = 2e-3, 3.0
# Levenberg-Marquardt: residuals beyond BAND_MM are silhouette and
# disocclusion pixels, whose jump the local linearisation does not
# describe; the damping starts at LAM0 (tools/run_config4.py)
BAND_MM = 100.0
LAM0 = 1e-2


def _twisted(camera: Camera, xi: torch.Tensor) -> Camera:
    return camera.set_pose(matmul_small(se3_exp(xi), camera.pose))


# -- through fusion ----------------------------------------------------------


def fusion_loss_and_grad(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    target: TSDFVolume,
    delta: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d delta) on the device: the mean of
    (fused tsdf - target tsdf)^2 over the voxels both volumes updated.
    The fusion is the exact one (the JAX runner's "line" mode runs the
    same kernel here). Spans ``pose.forward`` (the fusion and its
    clones), ``pose.loss`` and ``pose.backward`` (the loss's backward and
    the adjoint kernel)."""
    with trace("pose.forward"):
        d = delta.detach().clone().requires_grad_(True)
        out, _miss = integrate_pose(vol, depth, camera, d)
    with trace("pose.loss"):
        m = (target.weight > 0) & (out.weight > 0)
        n = torch.clamp(m.sum().to(_F32), min=1.0)
        # in float32 whatever the volumes' storage
        diff = out.tsdf.to(_F32) - target.tsdf.to(_F32)
        loss = torch.where(m, diff ** 2, 0.0).sum() / n
    with trace("pose.backward"):
        (g,) = torch.autograd.grad(loss, d)
    return loss.detach(), g


def descend_through_fusion(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    target: TSDFVolume,
    delta0,
    steps: int = 14,
) -> tuple[torch.Tensor, float, list[dict]]:
    """Normalised gradient steps on the twist from ``delta0``: each step
    moves the rotation by ROT_STEP rad and the translation by TRANS_STEP
    mm along minus the gradient's direction (the gradient
    supplies the direction; fixed-size steps walk the discretely masked
    landscape), and the best iterate wins.

    Returns (best delta, its loss, one record a step: loss, |v| and |w|
    after the step, host seconds of the step including its one sync).

    Spans: ``pose.step`` (its index; the last evaluation, after the
    steps, is ``steps``) around each evaluation, and inside it, after
    ``fusion_loss_and_grad``'s, ``pose.update``: the host reads and the
    normalised step. Counter ``pose.steps``: the evaluations.
    """
    delta = torch.as_tensor(delta0, dtype=_F32, device=vol.device).clone()
    best = (float("inf"), delta)
    history = []
    for index in range(steps):
        with trace("pose.step", index):
            count("pose.steps")
            t0 = time.perf_counter()
            loss, g = fusion_loss_and_grad(vol, depth, camera, target, delta)
            with trace("pose.update"):
                lv = float(loss)
                seconds = time.perf_counter() - t0
                if lv < best[0]:
                    best = (lv, delta)
                gw, gv = g[:3], g[3:]
                step = torch.cat([
                    ROT_STEP * gw / (torch.linalg.vector_norm(gw) + 1e-12),
                    TRANS_STEP * gv / (torch.linalg.vector_norm(gv) + 1e-12),
                ])
                delta = delta - step
                history.append(dict(
                    loss=lv, v_mm=float(torch.linalg.vector_norm(delta[3:])),
                    w_mrad=float(torch.linalg.vector_norm(delta[:3])) * 1e3,
                    seconds=seconds,
                ))
    with trace("pose.step", steps):
        count("pose.steps")
        loss = fusion_loss_and_grad(vol, depth, camera, target, delta)[0]
        with trace("pose.update"):
            lv = float(loss)
    if lv < best[0]:
        best = (lv, delta)
    return best[1], best[0], history


# -- through the raycast -----------------------------------------------------


def banded_residuals(
    vol: TSDFVolume,
    camera: Camera,
    target: torch.Tensor,
    t0: torch.Tensor,
    hit: torch.Tensor,
    fp: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) depth residuals of the corrected render against ``target``,
    and their mask: hits with target depth whose residual is inside
    BAND_MM. ``fp`` as in ``ops.raycast_diff.correct``."""
    h, w = target.shape
    verts, hit_img = correct(vol, camera, t0, hit, w, h, fp=fp)
    depth = vertices_to_depth(verts, hit_img, camera)
    m = hit_img & (target > 0) & ((depth - target).abs() < BAND_MM)
    return torch.where(m, depth - target, 0.0), m


def lm_step(
    vol: TSDFVolume,
    camera: Camera,
    target: torch.Tensor,
    xi: torch.Tensor,
    lam: float,
    max_steps: int = REFERENCE_MAX_STEPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Levenberg-Marquardt step on the twist ``xi`` of
    ``se3_exp(xi) @ camera.pose``: (new xi, rms of the residuals at
    ``xi``), both on the device.

    One march at the current pose; then, in one pass, every ray's
    residual of the Newton correction with its slope f'(t0) frozen and
    its row of the (H*W, 6) Jacobian, summed into J^T J, J^T r, the sum of
    r^2 and the band's inliers (``kernels.lm.lm_linearise``: the kernel on
    CUDA tensors, its plain twin on CPU tensors; the Jacobian of six
    forward-mode dual passes through ``banded_residuals``); then
    (J^T J + lam diag(J^T J)) dx = -J^T r, solved in float64 without a
    host sync.

    Spans ``lm.march`` (the pose, the raycast-kernel march, t0 and the
    hits), ``lm.jacobian`` (the slope, the residuals, the Jacobian and the
    sums) and ``lm.solve`` (the damped solve, the rms). Counters
    ``lm.inliers`` (the band's mask, summed, by reference) and
    ``lm.linearised`` (the steps the kernel took, from the wrapper).
    """
    xi = xi.detach()
    h, w = target.shape
    with trace("lm.march"):
        cam = _twisted(camera, xi)
        t0, hit = march(vol, cam, w, h, max_steps=max_steps)
    with trace("lm.jacobian"):
        sums = lm_linearise(vol, camera, cam, xi, t0, hit, target, BAND_MM)
    with trace("lm.solve"):
        jtj, jtr, rr, inliers = normal_equations(sums)
        a = jtj + lam * torch.diag(torch.diag(jtj))
        dx = torch.linalg.solve_ex(a, -jtr[:, None]).result[:, 0]
        count_tensor("lm.inliers", inliers.to(torch.int64))
        rms = torch.sqrt(rr / torch.clamp(inliers, min=1.0))
    return xi + dx.to(_F32), rms.to(_F32)


def recover_pose_lm(
    vol: TSDFVolume,
    camera: Camera,
    target: torch.Tensor,
    iters: int = 80,
    max_steps: int = REFERENCE_MAX_STEPS,
    stop=None,
) -> tuple[torch.Tensor, list[dict]]:
    """Levenberg-Marquardt from xi = 0, lam = LAM0, with the host-side
    trust adaptation of ``tools/run_config4.py``: a step whose rms is
    within 1.2x of the best so far is taken and lam halves (floor 1e-4),
    otherwise lam grows 8x (cap 1e2). ``stop(xi)``, if given, ends the loop when it returns
    True (the runner stops at a translation error under 1 mm).

    Returns (xi, one record an iteration: rms, lam after it, whether the
    step was taken, host seconds including its one sync, and as device
    tensors read by no one here: ``xi`` the twist the step linearised at,
    ``xi_new`` the twist it proposed).

    Spans: ``lm.step`` (its index) around each iteration, holding
    ``lm_step``'s and then ``lm.update``: the rms read (the step's one
    host sync) and the trust rule. Counters ``lm.steps`` and
    ``lm.accepted``.
    """
    xi = torch.zeros(6, dtype=_F32, device=vol.device)
    lam = LAM0
    best_rms = float("inf")
    history = []
    for index in range(iters):
        with trace("lm.step", index):
            count("lm.steps")
            t0 = time.perf_counter()
            xi_at = xi
            xi_new, rms = lm_step(vol, camera, target, xi, lam, max_steps)
            with trace("lm.update"):
                rms = float(rms)
                seconds = time.perf_counter() - t0
                accept = rms <= best_rms * 1.2
                count("lm.accepted", int(accept))
                if accept:
                    xi = xi_new
                    best_rms = min(best_rms, rms)
                    lam = max(lam * 0.5, 1e-4)
                else:
                    lam = min(lam * 8.0, 1e2)
                history.append(dict(rms=rms, lam=lam, accepted=accept,
                                    seconds=seconds, xi=xi_at, xi_new=xi_new))
        if stop is not None and stop(xi):
            break
    return xi, history
