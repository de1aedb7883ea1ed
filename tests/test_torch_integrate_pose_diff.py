"""Differentiable fusion in tsdf_tpu_torch vs the JAX package.

The port's ``integrate_pose`` (a ``torch.autograd.Function``: the exact
integrate forward, the pose-adjoint backward) and its plain adjoint twin
``ops.integrate_diff.integrate_pose_grad`` are held against
``tsdf_tpu.kernels.integrate.integrate_pose`` / ``_pose_grad_pallas`` (in
interpret mode), ``tsdf_tpu.ops.integrate_diff.pose_gradient_lax`` and
``jax.grad`` of the lax ``integrate``, on the same numpy inputs: the JAX
suite's fixtures (48^3 over 1500 mm, 160x120, weight 2, gbar from
``default_rng(1)``).

Tolerances, as the JAX suite states them for its own kernel:
  * twist gradients: rtol 2e-4 / atol 2e-3 against ``pose_gradient_lax``
    (the sums run over ~10^5 float32 terms in another order);
  * at a nonzero twist: rtol / atol 1e-3 against ``jax.grad`` of the lax
    integrate (the inverse and ``se3_exp`` chain in float32);
  * volume cotangents: rtol 1e-4 (atol 1e-5 tsdf, 1e-4 weight);
  * twin against ``_pose_grad_pallas``: dd equal; dw within 1e-4 (the two
    packages round the camera-space Z, and so min(sdf, trunc), in another
    order on ~0.6 % of voxels: up to 2.1e-5 apart); the pose_inv cotangent
    within 1e-5 of its largest entry (float32 block sums in JAX, float64
    sums here).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.integrate import _pose_grad_pallas, integrate_pallas
from tsdf_tpu.kernels.integrate import integrate_pose as jax_integrate_pose
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.ops.integrate_diff import (
    depth_image_gradients as jax_depth_image_gradients,
)
from tsdf_tpu.ops.integrate_diff import pose_gradient_lax as jax_pgl
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu.utils.se3 import se3_exp as jax_se3_exp
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.kernels.integrate import integrate_pose, pose_grad_cuda
from tsdf_tpu_torch.ops.integrate import (
    integrate,
    integrate_fast,
    project_voxels,
)
from tsdf_tpu_torch.ops.integrate_diff import (
    depth_image_gradients,
    integrate_pose_grad,
    pose_gradient_lax,
)
from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)
DELTA_NONZERO = np.array([0.05, -0.04, 0.06, 12.0, -9.0, 8.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(jvol):
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


def _cam_to_port(jcam):
    return Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")),
        device=CPU,
    )


@functools.lru_cache(maxsize=None)
def _jax_setup(at=(40.0, -30.0, -300.0)):
    """The JAX suite's fixture (``_setup``; ``_setup_line_agreeing`` with
    the camera at (41, -33, -300))."""
    vol = tsdf_tpu.make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0))
    vol = vol.replace(weight=jnp.full_like(vol.weight, 2.0))
    cam = (
        tsdf_tpu.Camera.from_intrinsics(*INTR)
        .move_to(list(at))
        .look_at([0.0, 0.0, 750.0])
    )
    depth = jax_fixtures.sphere_depth_map(W, H, 300.0, 600.0, 1200.0)
    depth = np.asarray(depth, np.float32)
    gbar = np.random.default_rng(1).normal(size=vol.tsdf.shape)
    return vol, cam, depth, gbar.astype(np.float32)


def _setup(line_agreeing=False):
    """(jax vol, jax cam, port vol, port cam, depth numpy, port depth,
    gbar numpy, port gbar)."""
    at = (41.0, -33.0, -300.0) if line_agreeing else (40.0, -30.0, -300.0)
    vol, cam, depth, gbar = _jax_setup(at)
    return (vol, cam, _to_port(vol), _cam_to_port(cam), depth,
            torch.from_numpy(depth), gbar, torch.from_numpy(gbar))


def _twist_grad(tvol, tcam, tdepth, loss_of_out, delta=None, **kw):
    d = torch.zeros(6) if delta is None else torch.as_tensor(delta)
    d = d.clone().requires_grad_(True)
    out, miss = integrate_pose(tvol, tdepth, tcam, d, **kw)
    assert int(miss) == 0
    (g,) = torch.autograd.grad(loss_of_out(out), d)
    return g.numpy()


@functools.lru_cache(maxsize=None)
def _jax_pose_grads(image_term, mode="exact", line_agreeing=False):
    """jax.grad of <gbar, new_tsdf> through the JAX integrate_pose
    (interpret mode) at delta = 0, and pose_gradient_lax."""
    at = (41.0, -33.0, -300.0) if line_agreeing else (40.0, -30.0, -300.0)
    vol, cam, depth, gbar = _jax_setup(at)

    def loss(delta):
        out, _miss = jax_integrate_pose(
            vol, depth, cam, delta, image_term=image_term, interpret=True,
            mode=mode,
        )
        return jnp.sum(gbar * out.tsdf)

    g_k = np.asarray(jax.grad(loss)(jnp.zeros(6)))
    g_l = np.asarray(jax_pgl(vol, depth, cam, gbar, image_term=image_term))
    return g_k, g_l


def test_depth_image_gradients_match_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(500, 900, (37, 53)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    gx, gy = depth_image_gradients(torch.from_numpy(d))
    jgx, jgy = jax_depth_image_gradients(jnp.asarray(d))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))


@pytest.mark.parametrize("image_term", [False, True])
def test_pose_gradient_lax_matches_jax(image_term):
    _v, _c, tvol, tcam, _d, tdepth, _g, tgbar = _setup()
    g = pose_gradient_lax(tvol, tdepth, tcam, tgbar, image_term=image_term)
    _g_k, g_l = _jax_pose_grads(image_term)
    np.testing.assert_allclose(g.numpy(), g_l, rtol=2e-4, atol=2e-3)


def test_analytic_matches_ad_without_image_term():
    """image_term=False == autograd through the plain integrate (blind to
    the image term: round() has zero gradient), and jax.grad of the lax
    integrate."""
    vol, cam, tvol, tcam, depth, tdepth, gbar, tgbar = _setup()
    d = torch.zeros(6, requires_grad=True)
    c = tcam.set_pose(matmul_small(se3_exp(d), tcam.pose))
    (g_ad,) = torch.autograd.grad((tgbar * integrate(tvol, tdepth, c).tsdf)
                                  .sum(), d)
    g_an = pose_gradient_lax(tvol, tdepth, tcam, tgbar, image_term=False)
    np.testing.assert_allclose(g_an.numpy(), g_ad.numpy(), rtol=1e-4,
                               atol=1e-4)

    def loss(delta):
        c = cam.set_pose(jax_se3_exp(delta) @ cam.pose)
        return jnp.sum(gbar * jax_integrate(vol, depth, c).tsdf)

    g_jax = np.asarray(jax.grad(loss)(jnp.zeros(6)))
    np.testing.assert_allclose(g_ad.numpy(), g_jax, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("image_term", [False, True])
def test_kernel_adjoint_matches_lax(image_term):
    """The port's autograd through integrate_pose == pose_gradient_lax
    (port and JAX) and jax.grad through the JAX integrate_pose."""
    _v, _c, tvol, tcam, _d, tdepth, _g, tgbar = _setup()
    g = _twist_grad(tvol, tdepth=tdepth, tcam=tcam,
                    loss_of_out=lambda out: (tgbar * out.tsdf).sum(),
                    image_term=image_term)
    g_k, g_l = _jax_pose_grads(image_term)
    g_port_lax = pose_gradient_lax(tvol, tdepth, tcam, tgbar,
                                   image_term=image_term).numpy()
    np.testing.assert_allclose(g, g_l, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(g, g_k, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(g, g_port_lax, rtol=2e-4, atol=2e-3)


def _random_state(vol):
    rng = np.random.default_rng(2)
    weight = rng.uniform(0.0, 5.0, size=vol.weight.shape).astype(np.float32)
    tsdf = (rng.normal(size=vol.tsdf.shape) * 10.0).astype(np.float32)
    return tsdf, weight


def test_volume_cotangents_match_ad():
    """d loss/d (tsdf_in, weight_in) through integrate_pose == jax.grad of
    the lax integrate and autograd through the plain integrate."""
    vol, cam, tvol, tcam, depth, tdepth, gbar, tgbar = _setup()
    tsdf, weight = _random_state(vol)

    def loss_lax(t, w):
        out = jax_integrate(vol.replace(tsdf=t, weight=w), depth, cam)
        return jnp.sum(gbar * out.tsdf) + jnp.sum(0.3 * out.weight)

    gt_l, gw_l = jax.grad(loss_lax, argnums=(0, 1))(
        jnp.asarray(tsdf), jnp.asarray(weight))

    def port_grads(fuse):
        t = torch.from_numpy(tsdf).requires_grad_(True)
        w = torch.from_numpy(weight).requires_grad_(True)
        out = fuse(tvol.replace(tsdf=t, weight=w))
        loss = (tgbar * out.tsdf).sum() + (0.3 * out.weight).sum()
        return [g.numpy() for g in torch.autograd.grad(loss, (t, w))]

    gt_k, gw_k = port_grads(
        lambda v: integrate_pose(v, tdepth, tcam, torch.zeros(6))[0])
    gt_p, gw_p = port_grads(lambda v: integrate(v, tdepth, tcam))
    for gt, gw in ((gt_l, gw_l), (gt_p, gw_p)):
        np.testing.assert_allclose(gt_k, np.asarray(gt), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw_k, np.asarray(gw), rtol=1e-4, atol=1e-4)


def test_pose_recovery_descent():
    """Fusing at a perturbed pose vs a target fused at truth: a gradient
    step on the twist reduces the loss."""
    _v, _c, tvol, tcam, _d, tdepth, _g, _tg = _setup()
    tvol = tvol.replace(weight=torch.zeros_like(tvol.weight))
    target, _ = integrate_pose(tvol, tdepth, tcam, torch.zeros(6))

    def loss(delta):
        out, _ = integrate_pose(tvol, tdepth, tcam, delta)
        m = (target.weight > 0) & (out.weight > 0)
        return torch.where(m, (out.tsdf - target.tsdf) ** 2, 0.0).sum()

    delta = torch.tensor([0.004, -0.003, 0.002, 8.0, -6.0, 5.0],
                         requires_grad=True)
    l0 = loss(delta)
    (g,) = torch.autograd.grad(l0, delta)
    step = torch.cat([1e-2 / (g[:3].norm() + 1e-9) * g[:3],
                      4.0 / (g[3:].norm() + 1e-9) * g[3:]])
    l1 = loss((delta - step).detach())
    l0, l1 = float(l0.detach()), float(l1)
    assert l1 < l0, (l0, l1)


def test_gradient_exact_at_nonzero_delta():
    """The gradient through integrate_pose is exact at a nonzero twist
    (the pose_inv cotangent chains through the inverse and se3_exp):
    against jax.grad of the lax integrate and of the JAX integrate_pose,
    and autograd through the plain integrate."""
    vol, cam, tvol, tcam, depth, tdepth, gbar, tgbar = _setup()

    def loss_lax(delta):
        c = cam.set_pose(jax_se3_exp(delta) @ cam.pose)
        return jnp.sum(gbar * jax_integrate(vol, depth, c).tsdf)

    def loss_pose(delta):
        out, _ = jax_integrate_pose(vol, depth, cam, delta, image_term=False,
                                    interpret=True)
        return jnp.sum(gbar * out.tsdf)

    g_true = np.asarray(jax.grad(loss_lax)(jnp.asarray(DELTA_NONZERO)))
    g_jax_k = np.asarray(jax.grad(loss_pose)(jnp.asarray(DELTA_NONZERO)))
    g = _twist_grad(tvol, tcam=tcam, tdepth=tdepth,
                    loss_of_out=lambda out: (tgbar * out.tsdf).sum(),
                    delta=DELTA_NONZERO, image_term=False)
    d = torch.tensor(DELTA_NONZERO, requires_grad=True)
    c = tcam.set_pose(matmul_small(se3_exp(d), tcam.pose))
    (g_ad,) = torch.autograd.grad(
        (tgbar * integrate(tvol, tdepth, c).tsdf).sum(), d)
    np.testing.assert_allclose(g, g_true, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(g, g_jax_k, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(g, g_ad.numpy(), rtol=1e-3, atol=1e-3)


def test_weight_cotangent_at_cap_tie():
    """cap_weight=True: the weight cotangent at the w+1 == max_weight tie
    is 0.5 exactly where jax.grad of the lax integrate gives 0.5."""
    vol, cam, tvol, tcam, depth, tdepth, _g, _tg = _setup()
    w0 = np.full(vol.weight.shape, float(vol.max_weight) - 1.0, np.float32)

    def loss_lax(w):
        out = jax_integrate(vol.replace(weight=w), depth, cam, cap_weight=True)
        return jnp.sum(out.weight)

    g_l = np.asarray(jax.grad(loss_lax)(jnp.asarray(w0)))
    w = torch.from_numpy(w0).requires_grad_(True)
    out, _ = integrate_pose(tvol.replace(weight=w), tdepth, tcam,
                            torch.zeros(6), cap_weight=True)
    (g_k,) = torch.autograd.grad(out.weight.sum(), w)
    g_k = g_k.numpy()
    np.testing.assert_allclose(g_k, g_l, atol=1e-6)
    tie = g_l == 0.5
    assert tie.any()  # the tie is actually exercised
    assert (g_k[tie] == 0.5).all()


def test_passthrough_cotangents_flow():
    """Fields the fusion returns unchanged pass their cotangent through:
    a loss reading out.truncation_distance gets the identity gradient."""
    _v, _c, tvol, tcam, _d, tdepth, _g, _tg = _setup()
    trunc = tvol.truncation_distance.clone().requires_grad_(True)
    out, _ = integrate_pose(tvol.replace(truncation_distance=trunc), tdepth,
                            tcam, torch.zeros(6))
    (g,) = torch.autograd.grad(2.0 * out.truncation_distance, trunc)
    assert float(g) == 2.0


def test_line_mode_forward_matches_exact_on_agreeing_pose():
    """On the pose where JAX's line and exact conventions agree, the
    port's line and exact forwards are one kernel, and they match JAX's
    under the integrate gate (tests/test_torch_integrate.py)."""
    vol, cam, tvol, tcam, depth, tdepth, _g, _tg = _setup(line_agreeing=True)
    ol, _ = integrate_pose(tvol, tdepth, tcam, torch.zeros(6), mode="line")
    oe, _ = integrate_pose(tvol, tdepth, tcam, torch.zeros(6), mode="exact")
    assert torch.equal(ol.tsdf, oe.tsdf) and torch.equal(ol.weight, oe.weight)
    jl, ml = integrate_pallas(vol, depth, cam, interpret=True, mode="line")
    assert int(ml) == 0
    same = ol.weight.detach().numpy() == np.asarray(jl.weight)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(ol.tsdf.detach().numpy()[same],
                               np.asarray(jl.tsdf)[same], rtol=0, atol=5e-3)


@pytest.mark.parametrize("image_term", [False, True])
def test_line_mode_adjoint_matches_lax(image_term):
    _v, _c, tvol, tcam, _d, tdepth, _g, tgbar = _setup(line_agreeing=True)
    g = _twist_grad(tvol, tcam=tcam, tdepth=tdepth,
                    loss_of_out=lambda out: (tgbar * out.tsdf).sum(),
                    image_term=image_term, mode="line")
    g_k, g_l = _jax_pose_grads(image_term, mode="line", line_agreeing=True)
    np.testing.assert_allclose(g, g_l, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(g, g_k, rtol=2e-4, atol=2e-3)


def test_line_mode_volume_cotangents_match_exact():
    """The line and exact adjoints give the same volume cotangents on the
    agreeing pose, and match the JAX line-mode adjoint."""
    vol, cam, tvol, tcam, depth, tdepth, gbar, tgbar = _setup(
        line_agreeing=True)
    _tsdf, weight = _random_state(vol)
    jvol = vol.replace(weight=jnp.asarray(weight))

    def jloss(v):
        out, _miss = jax_integrate_pose(v, depth, cam, jnp.zeros(6),
                                        interpret=True, mode="line")
        return jnp.sum(gbar * out.tsdf) + jnp.sum(0.3 * gbar * out.weight)

    gj = jax.grad(jloss)(jvol)
    grads = {}
    for mode in ("exact", "line"):
        t = tvol.tsdf.clone().requires_grad_(True)
        w = torch.from_numpy(weight).requires_grad_(True)
        out, _ = integrate_pose(tvol.replace(tsdf=t, weight=w), tdepth, tcam,
                                torch.zeros(6), mode=mode)
        loss = (tgbar * out.tsdf).sum() + (0.3 * tgbar * out.weight).sum()
        grads[mode] = [g.numpy() for g in torch.autograd.grad(loss, (t, w))]
    for a, b in zip(grads["line"], grads["exact"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(grads["line"][0], np.asarray(gj.tsdf),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grads["line"][1], np.asarray(gj.weight),
                               rtol=1e-4, atol=1e-4)


def test_fast_mode_forward_is_fast_and_backward_is_exact_adjoint():
    """mode="fast" as in JAX: the forward is the decimated line
    convention with its miss count, the backward the exact adjoint."""
    _v, _c, tvol, tcam, _d, tdepth, _g, tgbar = _setup()
    d = torch.zeros(6, requires_grad=True)
    out, miss = integrate_pose(tvol, tdepth, tcam, d, mode="fast")
    ref, ref_miss = integrate_fast(tvol, tdepth, tcam)
    assert torch.equal(out.tsdf.detach(), ref.tsdf)
    assert torch.equal(out.weight.detach(), ref.weight)
    assert int(miss) == int(ref_miss)
    (g,) = torch.autograd.grad((tgbar * out.tsdf).sum(), d)
    g_exact = _twist_grad(tvol, tcam=tcam, tdepth=tdepth,
                          loss_of_out=lambda o: (tgbar * o.tsdf).sum())
    np.testing.assert_array_equal(g.numpy(), g_exact)


def test_integrate_pose_leaves_inputs_untouched_and_refuses_deformed():
    _v, _c, tvol, tcam, _d, tdepth, _g, _tg = _setup()
    before = (tvol.tsdf.clone(), tvol.weight.clone())
    out, _ = integrate_pose(tvol, tdepth, tcam, np.zeros(6, np.float32))
    assert torch.equal(tvol.tsdf, before[0])
    assert torch.equal(tvol.weight, before[1])
    assert not torch.equal(out.weight, tvol.weight)
    with pytest.raises(ValueError, match="rigid"):
        integrate_pose(tvol.with_identity_deformation(), tdepth, tcam,
                       torch.zeros(6))
    with pytest.raises(ValueError, match="mode"):
        integrate_pose(tvol, tdepth, tcam, torch.zeros(6), mode="nearest")


@pytest.mark.parametrize("cap_weight", [False, True])
@pytest.mark.parametrize("image_term", [False, True])
def test_twin_matches_pose_grad_pallas(image_term, cap_weight):
    """The plain twin of the adjoint kernel against _pose_grad_pallas
    (interpret mode, mode "exact") on a fixture where the JAX forward
    skips no voxel (miss 0) and some updated voxels sit at the cap's tie."""
    vol, cam, tvol, tcam, depth, tdepth, gbar, tgbar = _setup()
    _tsdf, weight = _random_state(vol)
    weight = np.round(weight) + 10.0  # 10..15: w+1 == 15 is the tie
    jvol = vol.replace(weight=jnp.asarray(weight))
    _out, miss = integrate_pallas(jvol, depth, cam, interpret=True,
                                  cap_weight=cap_weight, mode="exact")
    assert int(miss) == 0
    gw = np.random.default_rng(3).normal(size=weight.shape).astype(np.float32)
    jdd, jdw, jdp = _pose_grad_pallas(
        jvol, depth, cam, gbar, gw, nk=3, cap_weight=cap_weight,
        image_term=image_term, interpret=True, mode="exact")
    tv = tvol.replace(weight=torch.from_numpy(weight))
    dd, dw, dp = integrate_pose_grad(tv, tdepth, tcam, tgbar,
                                     torch.from_numpy(gw),
                                     cap_weight=cap_weight,
                                     image_term=image_term)
    np.testing.assert_array_equal(dd.numpy(), np.asarray(jdd))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-4)
    jdp = np.asarray(jdp)
    np.testing.assert_allclose(dp.numpy(), jdp, rtol=0,
                               atol=1e-5 * np.abs(jdp).max())
    # the wrapper on CPU tensors is the twin
    for a, b in zip(pose_grad_cuda(tv, tdepth, tcam, tgbar,
                                   torch.from_numpy(gw),
                                   cap_weight=cap_weight,
                                   image_term=image_term),
                    (dd, dw, dp)):
        assert torch.equal(a, b)
    # updated voxels at the tie (w = 14, w + 1 == max_weight) exist
    assert ((dd != tgbar) & (tv.weight == 14.0)).any()


def _sliver_fixture():
    """A volume and camera with voxels on the camera plane (Z == 0),
    behind it, at exact half-pixel projections, and NaN depth pixels."""
    vol = make_volume((20, 18, 22), 200.0, offset=(0.0, 0.0, 0.0), device=CPU)
    # voxel size 10 x 11.11 x 9.09 mm: centres at x = 5, 15, ...; the camera
    # sits on the centre x = 95 and on the z plane of voxel 6
    zc = float(vol.axis_centres()[0][6])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (95.0, 100.0, zc)
    cam = Camera.from_intrinsics(40.0, 40.0, 20.5, 15.5, pose=pose,
                                 device=CPU)
    rng = np.random.default_rng(5)
    depth = rng.uniform(10.0, 120.0, (32, 41)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = np.nan
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    weight = rng.integers(0, 4, vol.weight.shape).astype(np.float32)
    tsdf = rng.normal(size=vol.tsdf.shape).astype(np.float32) * 10
    vol = vol.replace(tsdf=torch.from_numpy(tsdf),
                      weight=torch.from_numpy(weight))
    return vol, cam, torch.from_numpy(depth)


def test_twin_gates_equal_the_forward_gates():
    """The adjoint updates exactly the voxels the forward updates, on a
    fixture with Z == 0 voxels, voxels behind the camera, half-pixel
    projections and NaN depth: dd = gbar * w/(w+1) there, gbar elsewhere;
    and nothing where every camera point is NaN."""
    vol, cam, depth = _sliver_fixture()
    fused = integrate(vol, depth, cam)
    updated = fused.weight != vol.weight
    _centre, (_x, _y, z), _lin, _inside = project_voxels(vol, cam,
                                                        *depth.shape)
    z = z.expand(vol.tsdf.shape)
    assert (z == 0).any() and (z < 0).any() and updated.any()
    assert (~updated & (z > 0)).any()
    gbar = torch.from_numpy(
        np.random.default_rng(6).normal(size=vol.tsdf.shape)
        .astype(np.float32))
    dd, dw, dp = integrate_pose_grad(vol, depth, cam, gbar, gbar)
    assert torch.equal(updated, dd != gbar)
    assert torch.equal(dd[~updated], gbar[~updated])
    assert torch.isfinite(dp).all()
    # a NaN camera point at every voxel: nothing is updated
    nan_cam = dataclasses.replace(cam, pose_inv=torch.full_like(cam.pose_inv,
                                                                float("nan")))
    dd, dw, dp = integrate_pose_grad(vol, depth, nan_cam, gbar, gbar)
    assert torch.equal(dd, gbar) and torch.equal(dw, gbar)
    assert float(dp.abs().max()) == 0.0


def test_descend_through_fusion_recovers_translation():
    """tools/run_config4b.py at 48^3 / 160x120: normalised steps through
    integrate_pose from a 17 mm / 5.4 mrad perturbation keep a best
    iterate with a lower loss and a smaller translation residual."""
    from tsdf_tpu_torch.pipelines.pose_recovery import (
        descend_through_fusion,
        fusion_loss_and_grad,
    )

    _v, _c, tvol, tcam, _d, tdepth, _g, _tg = _setup()
    tvol = tvol.replace(weight=torch.zeros_like(tvol.weight))
    with torch.no_grad():
        target, _ = integrate_pose(tvol, tdepth, tcam, torch.zeros(6),
                                   mode="line")
    delta0 = torch.tensor([0.004, -0.003, 0.002, 12.0, -9.0, 8.0])
    loss0, _g0 = fusion_loss_and_grad(tvol, tdepth, tcam, target, delta0)
    best, best_loss, history = descend_through_fusion(
        tvol, tdepth, tcam, target, delta0, steps=8)
    assert len(history) == 8 and history[0]["loss"] == float(loss0)
    assert best_loss < float(loss0)
    assert float(best[3:].norm()) < float(delta0[3:].norm())
