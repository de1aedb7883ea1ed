"""The check that decides ``correct``, on tiny cells on the CPU: a sound
run passes; the control (the program with its bfloat16 storage) and
each fault the cell can have, planted underneath the timed path, fail.

The CPU runs the program's plain twins; the cuda-marked test runs the
control at the cells' own sizes on the card."""

import pytest
import torch

from bench_tiny import run_tiny

CELLS = ["kinfu512.tracked", "sfusion255.flow", "kinfu512.posegrad"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = run_tiny(workload, trace=1)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["metrics"] and result["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result = run_tiny(workload, control="bfloat16", seconds=2.0)
    assert not result["correct"], result["checks"]


def _scale_tsdf(fn):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs)
        vol = out[0] if isinstance(out, tuple) else out
        vol.tsdf.mul_(1.01)
        return out
    return altered


def _faults():
    from tsdf_tpu_torch.pipelines import kinfu, pose_recovery, scenefusion

    def unchanged_integrate(vol, *args, **kwargs):
        return vol

    def icp_on_half(fn):
        def half(depth_curr, *args, **kwargs):
            depth_curr = depth_curr.clone()
            depth_curr[depth_curr.shape[0] // 2:] = 0.0
            return fn(depth_curr, *args, **kwargs)
        return half

    def icp_shifted(fn):
        def shifted(*args, **kwargs):
            res = fn(*args, **kwargs)
            pose = res.pose.clone()
            pose[0, 3] += 1.0
            return res._replace(pose=pose)
        return shifted

    def no_update(vol, soup, *args, **kwargs):
        return vol, scenefusion.deformation_sums(
            soup, *args, n_vox=vol.tsdf.numel())[1]

    def half_the_surface(fn):
        def half(*args, **kwargs):
            soup = fn(*args, **kwargs)
            valid = soup.valid.clone()
            valid[1::2] = False
            return soup._replace(valid=valid)
        return half

    def zero_gradient(fn):
        def zero(*args, **kwargs):
            loss, g = fn(*args, **kwargs)
            return loss, torch.zeros_like(g)
        return zero

    def flipped_gradient(fn):
        def flipped(*args, **kwargs):
            loss, g = fn(*args, **kwargs)
            g = g.clone()
            g[3] = -g[3]
            return loss, g
        return flipped

    def half_the_voxels(fn):
        def half(*args, **kwargs):
            out, miss = fn(*args, **kwargs)
            keep = torch.ones_like(out.weight)
            keep[::2] = 0.0
            return out.replace(weight=out.weight * keep), miss
        return half

    def best_moved(fn):
        def moved(*args, **kwargs):
            best, best_loss, history = fn(*args, **kwargs)
            best = best.clone()
            best[3] += 1.0
            return best, best_loss, history
        return moved

    def start_as_best(fn):
        def start(vol, depth, camera, target, delta0, steps=14):
            _best, _loss, history = fn(vol, depth, camera, target, delta0, steps=steps)
            loss, _g = pose_recovery.fusion_loss_and_grad(vol, depth, camera, target, delta0)
            return delta0.clone(), float(loss), history
        return start

    return {
        "kinfu512.tracked": {
            "state unchanged": (kinfu, "integrate_cuda", lambda f: unchanged_integrate),
            "half the image": (kinfu, "get_incremental_transformation", icp_on_half),
            "answer altered": (kinfu, "get_incremental_transformation", icp_shifted),
        },
        "sfusion255.flow": {
            "state unchanged": (scenefusion, "update_deformation", lambda f: no_update),
            "half the surface": (scenefusion, "extract_surface", half_the_surface),
            "answer altered": (scenefusion, "integrate_warped_cuda", _scale_tsdf),
        },
        "kinfu512.posegrad": {
            "state unchanged": (pose_recovery, "fusion_loss_and_grad", zero_gradient),
            "half the voxels": (pose_recovery, "integrate_pose", half_the_voxels),
            "answer altered": (pose_recovery, "fusion_loss_and_grad", flipped_gradient),
            "best twist altered": (pose_recovery, "descend_through_fusion", best_moved),
            "best not the least": (pose_recovery, "descend_through_fusion", start_as_best),
        },
    }


FAULTS = [(w, f) for w in CELLS for f in ("state unchanged", "half", "answer altered")]
FAULTS += [("kinfu512.posegrad", f) for f in ("best twist altered", "best not the least")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    faults = _faults()[workload]
    key = next(k for k in faults if k.startswith(fault))
    module, name, plant = faults[key]
    monkeypatch.setattr(module, name, plant(getattr(module, name)))
    result = run_tiny(workload)
    assert not result["correct"], (key, result["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size_on_the_card(workload):
    """The control on the card at the cell's own size (about a minute a
    cell): it must come out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import argparse

    import run

    args = argparse.Namespace(workload=workload, seed=2**31 + 101, seconds=10.0,
                              trace=0, control="bfloat16")
    assert not run.run(args)["correct"]

