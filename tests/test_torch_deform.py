"""The deformation field in tsdf_tpu_torch vs the JAX package, on the CPU
(CPU tensors run the kernels' plain twins): the volume's field, the
integration at the deformed centres, and ``deform_points``.

Tolerances:
  * the deformed exact twin vs ``tsdf_tpu.ops.integrate.integrate``: the
    rigid twin's gate (tests/test_torch_integrate.py): weights equal on
    >= 99.9% of the voxels, tsdf within 5e-3 mm where they agree (the JAX
    side projects with a 3x3 matmul, so a voxel at a half-pixel sliver may
    round to the neighbouring pixel); colour within one level on >= 99.9%
    of the bytes;
  * vs ``integrate_warped_pallas(interpret=True)`` where its miss count is
    0: tsdf 1e-3, weight 1e-5 on >= 99.9% of the voxels (the kernel's own
    gate in tests/test_scenefusion.py:258-263, which holds everywhere on
    that fixture; here a sliver voxel may take the neighbouring pixel);
  * ``trilinear_weights_and_indices``: indices equal, weights within
    1e-6; ``deform_points``: 1e-3 mm (a sum of 8 products of mm-scale
    values, rounded in another order), the JAX tests' own tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.integrate import integrate_warped_pallas
from tsdf_tpu.ops.deform import deform_points as jax_deform_points
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.ops.trilinear import (
    trilinear_weights_and_indices as jax_weights_and_indices,
)
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, kernels, make_volume
from tsdf_tpu_torch.kernels import integrate as kint
from tsdf_tpu_torch.ops.deform import deform_points
from tsdf_tpu_torch.ops.integrate import integrate, integrate_fast
from tsdf_tpu_torch.ops.trilinear import trilinear_weights_and_indices
from tsdf_tpu_torch.pipelines.kinfu import (
    FusionConfig,
    fuse_frames,
    track_and_fuse_frames,
)
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


def _warp_field(rng, jvol, amplitude):
    """A smooth non-uniform field plus a little noise: what a few
    deformation updates leave."""
    c = np.asarray(jvol.voxel_centres())
    bump = np.exp(-((c[..., 0] / 500.0) ** 2 + ((c[..., 2] - 900.0) / 400.0) ** 2))
    d = c.copy()
    d[..., 0] += amplitude * bump
    d[..., 1] -= 0.4 * amplitude * bump
    d += rng.uniform(-0.5, 0.5, d.shape)
    return d.astype(np.float32)


def _jax_cam(i=0):
    return (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([30.0 * i, -20.0 * i, -500.0 + 10.0 * i])
            .look_at([0.0, 0.0, 1000.0]))


def _noisy_depth(rng):
    d = jax_fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32)
    d = d + (d > 0) * rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.02] = 0.0
    return d


def _assert_gate(tsdf, weight, jvol, min_agree=0.999):
    wj = np.asarray(jvol.weight)
    same = weight == wj
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_allclose(tsdf[same], np.asarray(jvol.tsdf)[same],
                               rtol=0, atol=5e-3)


# -- the volume's field -----------------------------------------------------------


def test_volume_deformation_field():
    plain = make_volume((6, 5, 4), 600.0, device=CPU)
    assert plain.deform is None and plain.deform_rot is None
    assert torch.equal(plain.deformed_centres(), plain.voxel_centres())
    vol = make_volume((6, 5, 4), 600.0, with_deformation=True, device=CPU)
    jvol = tsdf_tpu.make_volume((6, 5, 4), 600.0, with_deformation=True)
    assert vol.deform.shape == tuple(jvol.deform.shape) == (4, 5, 6, 3)
    assert vol.deform.is_contiguous() and vol.deformed_centres() is vol.deform
    # voxel centres: XLA on the CPU may round (i + 0.5) * v + o differently
    # by an ulp or two (ROADMAP Queue 3)
    np.testing.assert_allclose(vol.deform.numpy(), np.asarray(jvol.deform),
                               rtol=3e-7, atol=1e-4)
    assert float(vol.deform_rot.abs().sum()) == 0.0
    again = plain.with_identity_deformation()
    assert again.tsdf is plain.tsdf and torch.equal(again.deform, vol.deform)
    both = make_volume((6, 5, 4), 600.0, with_deformation=True,
                       with_color=True, device=CPU)
    assert both.deform is not None and both.color is not None
    moved = vol.replace(deform=vol.deform + 7.0, weight=vol.weight + 1.0)
    cleared = moved.clear()
    assert torch.equal(cleared.deform, vol.deform) and cleared.deform.is_contiguous()
    assert float(cleared.weight.sum()) == 0.0
    assert float((moved.deform - vol.deform).min()) == 7.0  # clear() copies


# -- integration at the deformed centres ------------------------------------------


@pytest.mark.parametrize("cap_weight", [False, True], ids=["nocap", "cap"])
@pytest.mark.parametrize("size", [(48, 48, 48), (40, 32, 36)],
                         ids=["48", "40x32x36"])
def test_deformed_twin_matches_jax_over_frames(size, cap_weight):
    """Three noisy frames from moving poses into a volume warped by a
    non-uniform field; the later frames blend into weighted voxels."""
    rng = np.random.default_rng(0)
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                                max_weight=2.0, with_deformation=True)
    jvol = jvol.replace(deform=jnp.asarray(_warp_field(rng, jvol, 60.0)))
    tvol = _to_port(jvol)
    for i in range(3):
        jcam = _jax_cam(i)
        depth = _noisy_depth(rng)
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam,
                             cap_weight=cap_weight)
        tvol = integrate(tvol, torch.from_numpy(depth), _cam_to_port(jcam),
                         cap_weight=cap_weight)
    assert float(tvol.weight.max()) == (2.0 if cap_weight else 3.0)
    assert float(tvol.weight.sum()) > 1000
    _assert_gate(tvol.tsdf.numpy(), tvol.weight.numpy(), jvol)
    # the warp matters: the rigid integration of the same frames differs
    rigid = _to_port(jvol).replace(deform=None).clear()
    rigid = integrate(rigid, torch.from_numpy(depth), _cam_to_port(jcam))
    assert not torch.equal(rigid.weight > 0, tvol.weight > 0)


def test_deformed_colour_twin_matches_jax():
    """``rgb=`` into a deformed volume, which the JAX package has as plain
    XLA only (ops/integrate.py): the colour gate of test_torch_color.py."""
    rng = np.random.default_rng(1)
    jvol = tsdf_tpu.make_volume((40, 32, 36), 2000.0,
                                offset=(-1000.0, -1000.0, 0.0), max_weight=2.0,
                                with_deformation=True, with_color=True)
    jvol = jvol.replace(deform=jnp.asarray(_warp_field(rng, jvol, 40.0)))
    tvol = _to_port(jvol)
    for i in range(3):
        jcam = _jax_cam(i)
        depth = np.where(
            jax_fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0) > 0,
            1200.0, 1700.0).astype(np.float32)
        depth += rng.uniform(-4.0, 4.0, depth.shape).astype(np.float32)
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 31 * i, axis=1)
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam,
                             rgb=jnp.asarray(rgb))
        tvol = integrate(tvol, torch.from_numpy(depth), _cam_to_port(jcam),
                         rgb=torch.from_numpy(rgb.copy()))
    assert int((tvol.color > 0).any(-1).sum()) > 1000
    _assert_gate(tvol.tsdf.numpy(), tvol.weight.numpy(), jvol)
    d = np.abs(np.asarray(jvol.color).astype(int) - tvol.color.numpy().astype(int))
    assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (80.0, 0.0, 0.0),
                                   (-12.0, 25.0, 6.0)],
                         ids=["identity", "x80", "oblique"])
def test_deformed_twin_vs_warped_pallas(shift):
    """Against the JAX Pallas kernel in interpret mode on the 48^3 sphere
    of tests/test_scenefusion.py, warped uniformly (a uniform warp of any
    size is inside its window: miss 0)."""
    jvol = tsdf_tpu.make_volume((48, 48, 48), 1500.0,
                                offset=(-750.0, -750.0, 0.0),
                                with_deformation=True)
    jvol = jvol.replace(deform=jvol.deform + jnp.asarray(shift, jnp.float32))
    jcam = (tsdf_tpu.Camera.from_intrinsics(591.1 / 4, 590.1 / 4, 331.0 / 4,
                                            234.6 / 4)
            .move_to([0.0, 0.0, -200.0]).look_at([0.0, 0.0, 750.0]))
    depth = jax_fixtures.sphere_depth_map(W, H, 30.0, 500.0, 1100.0)
    depth = depth.astype(np.float32)
    tvol = _to_port(jvol)
    for _ in range(2):  # the second frame blends into weighted voxels
        jvol, miss = integrate_warped_pallas(jvol, jnp.asarray(depth), jcam,
                                             nk=5, interpret=True)
        assert int(miss) == 0
        tvol = integrate(tvol, torch.from_numpy(depth), _cam_to_port(jcam))
    assert float(tvol.weight.max()) == 2.0
    ok = (np.abs(tvol.tsdf.numpy() - np.asarray(jvol.tsdf)) <= 1e-3) & (
        np.abs(tvol.weight.numpy() - np.asarray(jvol.weight)) <= 1e-5)
    assert ok.mean() >= 0.999, ok.mean()


def test_non_finite_centres_are_never_updated():
    """What the twin decides for a NaN or infinite centre and for a centre
    on the camera plane (Z == 0): no update, no exception."""
    vol = make_volume((8, 8, 8), 800.0, offset=(-400.0, -400.0, 200.0),
                      with_deformation=True, device=CPU)
    cam = Camera.from_intrinsics(100.0, 100.0, 32.0, 24.0, device=CPU)
    depth = torch.full((48, 64), 600.0)
    deform = vol.deform.clone()
    deform[0, 0, 0] = float("nan")
    deform[0, 0, 1, 2] = float("inf")
    deform[0, 0, 2, 0] = float("-inf")
    deform[0, 0, 3, 2] = 0.0  # on the camera plane
    deform[0, 0, 4] = torch.tensor([0.0, 0.0, 0.0])  # at the camera centre
    out = integrate(vol.replace(deform=deform), depth, cam)
    assert float(out.weight[0, 0, :5].sum()) == 0.0
    assert float(out.weight.sum()) > 50
    assert bool(torch.isfinite(out.tsdf).all())
    clean = integrate(vol, depth, cam)
    keep = torch.ones_like(clean.weight, dtype=torch.bool)
    keep[0, 0, :5] = False
    assert torch.equal(out.weight[keep], clean.weight[keep])


def _small(color=False):
    jvol = tsdf_tpu.make_volume((16, 16, 16), 1000.0,
                                offset=(-500.0, -500.0, 0.0), with_color=color,
                                with_deformation=True)
    jvol = jvol.replace(deform=jvol.deform + jnp.asarray([30.0, -10.0, 5.0]))
    jcam = tsdf_tpu.Camera.from_intrinsics(59.11, 59.01, 33.1, 23.46).move_to(
        [0.0, 0.0, -300.0]).look_at([0.0, 0.0, 500.0])
    depth = jax_fixtures.sphere_depth_map(64, 48, 12.0, 400.0, 800.0)
    return jvol, jcam, depth.astype(np.float32)


@pytest.mark.parametrize("color", [False, True], ids=["depth", "colour"])
def test_warped_wrapper_runs_twin_in_place_on_cpu(color):
    jvol, jcam, depth = _small(color)
    vol, cam = _to_port(jvol), _cam_to_port(jcam)
    rgb = torch.from_numpy(fixtures.gradient_rgb(64, 48)) if color else None
    want = integrate(vol, torch.from_numpy(depth), cam, rgb=rgb)
    ptr = vol.tsdf.data_ptr()
    kernels.reset_launch_counts()
    out = kint.integrate_warped_cuda(vol, torch.from_numpy(depth), cam, rgb=rgb)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert out is vol and vol.tsdf.data_ptr() == ptr
    assert torch.equal(vol.tsdf, want.tsdf) and torch.equal(vol.weight, want.weight)
    assert float(vol.weight.sum()) > 0
    if color:
        assert torch.equal(vol.color, want.color) and int(vol.color.sum()) > 0
    jout = jax_integrate(jvol, jnp.asarray(depth), jcam,
                         rgb=None if rgb is None else jnp.asarray(rgb.numpy()))
    _assert_gate(vol.tsdf.numpy(), vol.weight.numpy(), jout)


@pytest.mark.parametrize(
    "bad,error,match",
    [
        ("rigid", ValueError, "needs vol.deform"),
        ("deform_strided", ValueError, "contiguous"),
        ("deform_shape", ValueError, "deform: shape"),
        ("deform_f64", TypeError, "deform"),
        ("deform_meta", ValueError, "deform is on"),
        ("depth_int32", TypeError, "depth"),
        ("rgb_no_colour_field", ValueError, "no colour field"),
    ],
)
def test_warped_wrapper_rejects_bad_inputs(bad, error, match):
    jvol, jcam, depth = _small()
    vol, cam = _to_port(jvol), _cam_to_port(jcam)
    depth = torch.from_numpy(depth)
    rgb = None
    if bad == "rigid":
        vol = vol.replace(deform=None)
    elif bad == "deform_strided":
        # a view with the right shape and the wrong strides, as slicing a
        # larger field gives: refused, not copied silently
        big = torch.zeros((16, 16, 16, 4))
        vol = vol.replace(deform=big[..., :3])
    elif bad == "deform_shape":
        vol = vol.replace(deform=vol.deform[:-1].contiguous())
    elif bad == "deform_f64":
        vol = vol.replace(deform=vol.deform.double())
    elif bad == "deform_meta":
        vol = vol.replace(deform=vol.deform.to("meta"))
    elif bad == "depth_int32":
        depth = depth.to(torch.int32)
    elif bad == "rgb_no_colour_field":
        rgb = torch.from_numpy(fixtures.gradient_rgb(64, 48))
    with pytest.raises(error, match=match):
        kint.integrate_warped_cuda(vol, depth, cam, rgb=rgb)
    assert float(vol.weight.sum()) == 0.0


def test_rigid_paths_refuse_and_pipelines_route_deformed_volumes():
    """The rigid wrappers and the fast convention refuse a deformed volume
    with the JAX ``integrate_pallas`` reason; ``fuse_frames`` sends it to
    the warped integrate; the tracked loop refuses it as in JAX."""
    jvol, jcam, depth = _small()
    vol, cam = _to_port(jvol), _cam_to_port(jcam)
    depth = torch.from_numpy(depth)
    for fn in (kint.integrate_cuda, kint.integrate_fast_cuda, integrate_fast):
        with pytest.raises(ValueError, match="rigid path"):
            fn(vol, depth, cam)
    want = integrate(vol, depth, cam)
    cfg = FusionConfig(volume_size=(16,) * 3, physical_size_mm=1000.0,
                       width=64, height=48)
    out, _ = fuse_frames(_to_port(jvol), cam, [(depth, cam.pose)], cfg)
    assert torch.equal(out.tsdf, want.tsdf) and float(out.weight.sum()) > 0
    with pytest.raises(ValueError, match="rigid path"):
        fuse_frames(_to_port(jvol), cam, [(depth, cam.pose)],
                    dataclasses.replace(cfg, integrate_mode="fast"))
    with pytest.raises(ValueError, match="deformation-enabled"):
        track_and_fuse_frames(_to_port(jvol), cam, [depth], cfg)


# -- deform_points ----------------------------------------------------------------


def test_trilinear_weights_and_indices_match_jax():
    rng = np.random.default_rng(2)
    shape = (9, 11, 13)
    vs = np.array([100.0, 90.0, 110.0], np.float32)
    hi = np.array([13, 11, 9], np.float32) * vs
    # inside, on both faces, past the far face and below zero
    pts = (rng.uniform(-0.05, 1.05, (400, 3)) * hi).astype(np.float32)
    pts[:3] = [[0.0, 0.0, 0.0], hi, hi - vs / 2]
    lin_j, wts_j = jax_weights_and_indices(shape, jnp.asarray(pts), jnp.asarray(vs))
    lin_t, wts_t = trilinear_weights_and_indices(
        shape, torch.from_numpy(pts), torch.from_numpy(vs))
    assert lin_t.dtype == torch.int32 and lin_t.shape == (400, 8)
    np.testing.assert_array_equal(lin_t.numpy(), np.asarray(lin_j))
    np.testing.assert_allclose(wts_t.numpy(), np.asarray(wts_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wts_t.sum(-1).numpy(), 1.0, atol=1e-5)


def _deform_vols(**changes):
    jvol = tsdf_tpu.make_volume((16, 16, 16), 1600.0, offset=(0.0, 0.0, 0.0),
                                with_deformation=True)
    jvol = jvol.replace(**{k: jnp.asarray(v) for k, v in changes.items()})
    return jvol, _to_port(jvol)


@pytest.mark.parametrize("case", ["identity", "translation", "global", "field"])
def test_deform_points_matches_jax(case):
    """The tests/test_deform.py cases, and a random smooth field at random
    points (some outside the volume), through both packages."""
    rng = np.random.default_rng(4)
    pts = np.array([[800.0, 800.0, 800.0], [123.0, 456.0, 789.0],
                    [800.0, 400.0, 200.0]], np.float32)
    if case == "identity":
        jvol, tvol = _deform_vols()
    elif case == "translation":
        jvol, tvol = _deform_vols()
        shift = np.array([10.0, -20.0, 5.0], np.float32)
        jvol = jvol.replace(deform=jvol.deform + shift)
        tvol = tvol.replace(deform=tvol.deform + torch.from_numpy(shift))
    elif case == "global":
        jvol, tvol = _deform_vols(
            global_rotation=np.array([0.1, -0.2, 0.3], np.float32),
            global_translation=np.array([5.0, 6.0, 7.0], np.float32))
    else:
        jvol, _ = _deform_vols()
        field = np.asarray(jvol.deform) + rng.uniform(
            -30.0, 30.0, jvol.deform.shape).astype(np.float32)
        jvol, tvol = _deform_vols(deform=field)
        pts = rng.uniform(-100.0, 1700.0, (300, 3)).astype(np.float32)
    want, want_valid = jax_deform_points(jvol, jnp.asarray(pts))
    kernels.reset_launch_counts()
    got, valid = deform_points(tvol, pts)
    assert kernels.launch_counts()["row_gather"] == 0  # no kernel on the CPU
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    if case == "identity":
        assert bool(valid.all())
        np.testing.assert_allclose(got.numpy(), pts, atol=1e-3)
    if case == "translation":
        np.testing.assert_allclose(got.numpy(), pts + shift, atol=1e-3)
    if case == "field":
        assert 0 < int(valid.sum()) < len(pts)
        np.testing.assert_array_equal(got.numpy()[~valid.numpy()],
                                      pts[~valid.numpy()])


def test_deform_points_shapes_and_errors():
    _, tvol = _deform_vols()
    out, valid = deform_points(tvol, np.zeros((2, 5, 3), np.float32) + 800.0)
    assert out.shape == (2, 5, 3) and valid.shape == (2, 5)
    out, valid = deform_points(tvol, torch.tensor([[-100.0, 0.0, 0.0]]))
    assert not bool(valid[0]) and out.tolist() == [[-100.0, 0.0, 0.0]]
    empty, valid = deform_points(tvol, np.zeros((0, 3), np.float32))
    assert empty.shape == (0, 3) and valid.shape == (0,)
    with pytest.raises(ValueError, match="no deformation field"):
        deform_points(tvol.replace(deform=None), np.zeros((1, 3), np.float32))
