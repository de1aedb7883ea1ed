"""The brick design of the pose-adjoint kernel (``csrc/integrate_pose_grad.cu``)
on the CPU, held on its plain twins.

The kernel walks the bricks of ``csrc/integrate_bricks.cuh``: a brick the
exact cull skips (``kernels.integrate.brick_cull``) is a copy, dd = gbar_d
and dw = gbar_w, with nothing summed; a live brick computes the adjoint and
writes its 12 pose sums to its own row of partials, added up in a fixed
order (``kernels.integrate.pose_grad_partials`` is that order in plain
PyTorch), and the wrapper sums the rows.

  * The cull is conservative for the adjoint: every voxel whose dd or dw
    the twin ``ops.integrate_diff.integrate_pose_grad`` moves off gbar lies
    in a kept brick. No tolerance: one such voxel fails.
  * The partials do not depend on the order of the bricks: the model gives
    the same bits twice, a culled brick's row is exactly zero, and the
    column sums equal the twin's pose_inv cotangent within 1e-6 of its
    largest entry plus 1e-6 (float64 sums of the same float32 terms in
    another order). Against the JAX ``_pose_grad_pallas`` (interpret mode)
    within 1e-5 of its largest entry, the gate tests/
    test_torch_integrate_pose_diff.py states for the twin (float32 block
    sums in JAX).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.integrate import _pose_grad_pallas, integrate_pallas
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.kernels.integrate import (
    BRICK,
    brick_cull,
    brick_grid,
    pose_grad_partials,
)
from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rolled(cam, angle):
    """``cam`` rolled about its optical axis by ``angle``."""
    c, s = float(np.cos(angle)), float(np.sin(angle))
    roll = torch.tensor([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1.0]])
    return cam.set_pose(cam.pose @ roll)


def _inputs(size, at, target, roll, seed):
    """A weighted, filled volume (weights 10..14, so w + 1 == max_weight 15
    is the cap's tie on some voxels), a noisy sphere frame with NaN and
    zero pixels, one cotangent for both outputs."""
    rng = np.random.default_rng(seed)
    vol = make_volume(size, 2000.0, offset=(-1000.0, -800.0, 0.0),
                      device=CPU)
    shape = vol.tsdf.shape
    vol = vol.replace(
        tsdf=torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10),
        weight=torch.from_numpy(rng.integers(10, 15, shape)
                                .astype(np.float32)))
    depth = fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
    depth = depth.astype(np.float32) + rng.uniform(0, 5, depth.shape).astype(
        np.float32) * (depth > 0)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    depth[rng.uniform(size=depth.shape) < 0.05] = np.nan
    cam = (Camera.from_intrinsics(*INTR, device=CPU).move_to(at)
           .look_at(target))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return vol, torch.from_numpy(depth), _rolled(cam, roll), g


def _bricks_of(mask):
    """The (z, y, x) brick index of every True voxel of ``mask``."""
    z, y, x = np.nonzero(mask)
    bz, by, bx = BRICK
    return z // bz, y // by, x // bx


CASES = {
    "oblique": ((64, 48, 40), [400.0, -250.0, -600.0],
                [-100.0, 150.0, 1200.0], 0.0),
    # ragged bricks on every axis: x no multiple of 32, y of 4, z of 8
    "ragged": ((33, 50, 21), [300.0, 200.0, -700.0], [0.0, 0.0, 1000.0], 0.3),
    "ragged-inside": ((21, 33, 50), [-200.0, 100.0, 500.0],
                      [100.0, -50.0, 1800.0], -0.4),
    "rolled": ((64, 48, 40), [400.0, -250.0, -600.0],
               [-100.0, 150.0, 1200.0], 1.2),
}


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_cull_keeps_every_voxel_the_adjoint_moves(case, cap_weight):
    size, at, target, roll = CASES[case]
    vol, depth, cam, g = _inputs(size, at, target, roll, seed=len(case))
    dd, dw, _dp = integrate_pose_grad(vol, depth, cam, g, g,
                                      cap_weight=cap_weight)
    moved = ((dd != g) | (dw != g)).numpy()
    culled = brick_cull(vol, depth, cam).numpy()
    assert culled.shape == brick_grid(vol.tsdf.shape)
    lost = culled[_bricks_of(moved)]
    assert not lost.any(), f"{int(lost.sum())} moved voxels are culled"
    assert moved.sum() > 100  # the frame exercises the test
    assert 0.0 < culled.mean() < 1.0
    if cap_weight:  # the tie's half slope is in play
        assert (moved & (vol.weight.numpy() == 14.0)).any()


@pytest.mark.parametrize("image_term", [False, True])
@pytest.mark.parametrize("case", ["oblique", "ragged"])
def test_partials_are_deterministic_and_sum_to_the_twin(case, image_term):
    size, at, target, roll = CASES[case]
    vol, depth, cam, g = _inputs(size, at, target, roll, seed=3)
    partials = pose_grad_partials(vol, depth, cam, g, image_term=image_term)
    again = pose_grad_partials(vol, depth, cam, g, image_term=image_term)
    nb = brick_grid(vol.tsdf.shape)
    assert partials.shape == (nb[0] * nb[1] * nb[2], 12)
    assert partials.dtype == torch.float64
    assert torch.equal(partials.view(torch.int64), again.view(torch.int64))
    culled = brick_cull(vol, depth, cam).reshape(-1)
    assert culled.any() and not culled.all()
    assert torch.equal(partials[culled].view(torch.int64),
                       torch.zeros_like(partials[culled]).view(torch.int64))
    _dd, _dw, dp = integrate_pose_grad(vol, depth, cam, g, g,
                                       image_term=image_term)
    sums = partials.sum(0).to(torch.float32).reshape(3, 4)
    tol = 1e-6 * float(dp.abs().max()) + 1e-6
    assert float(dp.abs().max()) > 0
    assert float((sums - dp[:3]).abs().max()) <= tol
    assert float(dp[3].abs().max()) == 0.0


def _to_port(jvol):
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


@pytest.mark.parametrize("image_term", [False, True])
def test_partials_match_pose_grad_pallas(image_term):
    """The model's column sums against ``_pose_grad_pallas`` (interpret
    mode, mode "exact") on the JAX suite's fixture (48^3 over 1500 mm,
    weights 10..15, gbar from default_rng(1)), where the JAX forward skips
    no voxel."""
    jvol = tsdf_tpu.make_volume((48,) * 3, 1500.0,
                                offset=(-750.0, -750.0, 0.0))
    rng = np.random.default_rng(1)
    gbar = rng.normal(size=jvol.tsdf.shape).astype(np.float32)
    weight = rng.integers(10, 16, jvol.tsdf.shape).astype(np.float32)
    jvol = jvol.replace(weight=jnp.asarray(weight))
    jcam = (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([40.0, -30.0, -300.0]).look_at([0.0, 0.0, 750.0]))
    depth = np.asarray(fixtures.sphere_depth_map(W, H, 300.0, 600.0, 1200.0),
                       np.float32)
    _out, miss = integrate_pallas(jvol, depth, jcam, interpret=True,
                                  mode="exact")
    assert int(miss) == 0
    _jdd, _jdw, jdp = _pose_grad_pallas(
        jvol, depth, jcam, gbar, gbar, nk=3, cap_weight=False,
        image_term=image_term, interpret=True, mode="exact")
    cam = Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")), device=CPU)
    partials = pose_grad_partials(_to_port(jvol), torch.from_numpy(depth),
                                  cam, torch.from_numpy(gbar),
                                  image_term=image_term)
    jdp = np.asarray(jdp)
    sums = partials.sum(0).to(torch.float32).reshape(3, 4).numpy()
    assert np.abs(jdp).max() > 0
    np.testing.assert_allclose(sums, jdp[:3], rtol=0,
                               atol=1e-5 * np.abs(jdp).max())
