"""Trajectory-error metrics: ATE / RPE for tracked-fusion evaluation.

The port's own copy of ``tsdf_tpu/utils/trajectory.py``: the standard TUM
RGB-D benchmark metrics (Sturm et al., IROS'12), absolute trajectory
error after rigid (Horn/Umeyama) alignment and relative pose error over a
fixed frame delta. Pure numpy: an offline evaluation path, not device
code.

Conventions match the rest of the framework: poses are 4x4 camera->world
matrices in mm.
"""

from __future__ import annotations

import numpy as np


def align_rigid(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment est -> gt.

    Umeyama's closed form (the TUM benchmark's ``align`` routine).

    Args:
      est, gt: (N, 3) point sets (trajectory positions), N >= 3 for a
        well-determined rotation (N >= 1 works, returning a translation).
      with_scale: also estimate a global scale (monocular trails); off
        for depth-based tracking.

    Returns:
      (s, R, t): scale float, (3, 3) rotation, (3,) translation with
      ``aligned = s * est @ R.T + t``.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    assert est.shape == gt.shape and est.shape[-1] == 3, (
        est.shape, gt.shape,
    )
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1.0
    rot = u @ s_mat @ vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        scale = float((d * np.diag(s_mat)).sum() / var_e) if var_e else 1.0
    else:
        scale = 1.0
    trans = mu_g - scale * rot @ mu_e
    return scale, rot, trans


def ate(
    est_poses,
    gt_poses,
    align: bool = True,
    with_scale: bool = False,
) -> dict:
    """Absolute trajectory error between pose lists.

    Args:
      est_poses, gt_poses: sequences of (4, 4) camera->world poses (mm).
      align: rigidly align the estimate first (the standard metric; the
        free gauge of a SLAM trajectory is not an error).

    Returns:
      dict with rmse/mean/median/max translational error (mm) and the
      per-frame error array.
    """
    pe = np.asarray([np.asarray(p)[:3, 3] for p in est_poses], np.float64)
    pg = np.asarray([np.asarray(p)[:3, 3] for p in gt_poses], np.float64)
    assert pe.shape == pg.shape, (pe.shape, pg.shape)
    if align and len(pe) >= 3:
        s, r, t = align_rigid(pe, pg, with_scale=with_scale)
        pe = s * pe @ r.T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "errors": err,
    }


def rpe(est_poses, gt_poses, delta: int = 1) -> dict:
    """Relative pose error over a frame delta (drift per step).

    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}); reports translational
    RMSE (mm) and rotational RMSE (radians).
    """
    est = [np.asarray(p, np.float64) for p in est_poses]
    gt = [np.asarray(p, np.float64) for p in gt_poses]
    assert len(est) == len(gt) and len(est) > delta, (len(est), delta)
    terr, rerr = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.arccos(c))
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt((terr**2).mean())),
        "rot_rmse": float(np.sqrt((rerr**2).mean())),
        "trans_errors": terr,
        "rot_errors": rerr,
    }
