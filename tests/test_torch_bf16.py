"""bfloat16 volume storage in tsdf_tpu_torch vs the JAX package.

The port's twins on a bf16 volume run beside the JAX functions on the same
bf16 volume (32^3, 64x48 frames, inputs made from a numpy seed): the JAX
side's ``astype(jnp.bfloat16)`` volume, the port's
``TSDFVolume.astype(torch.bfloat16)`` one, each reading the storage into
float32, computing in float32 and rounding once when it stores.

Tolerances:
  * weights equal at every voxel, and the dtype stays bf16;
  * tsdf equal, or 1 bf16 ulp apart where the float32 values the two
    packages round differ: XLA on the CPU rounds some float32 expressions
    differently from PyTorch's op-by-op order (ROADMAP Queue 3, "CPU
    rounding"), and a difference of a float32 ulp can land on the other
    side of a bf16 rounding boundary. 1 ulp of bf16 is 2^-7 of the value's
    binade (0.0078 relative);
  * colour bytes within 1 level on >= 99.9 % of voxels (test_torch_color.py's
    gate);
  * the raycast and marching cubes: their float32 suites' gates, applied to
    the bf16 volumes;
  * gradients: the float32 suite's (test_torch_integrate_pose_diff.py:
    rtol 2e-4 / atol 2e-3 on the twist); dd equal; dw within 1 bf16 ulp
    plus that suite's 1e-4 (the two packages round the camera-space Z, and
    so min(sdf, trunc), in another order on a few voxels: up to 2.1e-5
    apart in float32, which is 2 bf16 ulps of a dw near 1e-3);
  * marching-cubes vertices within 2 float32 ulps (the CPU-rounding
    caveat's bound for mesh vertices);
  * the port in bf16 against the port in f32 (JAX tests/test_integrate.py:
    181-205): weights equal, tsdf within 2^-7 of its largest magnitude.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.io.tsdf_file import save_tsdf as jax_save_tsdf
from tsdf_tpu.kernels.integrate import integrate_color_pallas, integrate_pallas
from tsdf_tpu.kernels.integrate import integrate_pose as jax_integrate_pose
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.ops.marching_cubes import extract_surface as jax_extract
from tsdf_tpu.ops.raycast import raycast as jax_raycast
from tsdf_tpu.ops.raycast_diff import raycast_diff as jax_raycast_diff
from tsdf_tpu.ops.raycast import render_to_depth_image as jax_render_depth
from tsdf_tpu.ops.trilinear import trilinear_sample as jax_trilinear
from tsdf_tpu.pipelines import scenefusion as jsf
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.io.tsdf_file import load_tsdf, save_tsdf
from tsdf_tpu_torch.kernels.integrate import (
    integrate_color_cuda,
    integrate_cuda,
    integrate_fast_cuda,
    integrate_pose,
    integrate_warped_cuda,
    pose_grad_cuda,
)
from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda, uniform_bricks
from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad
from tsdf_tpu_torch.ops.marching_cubes import extract_surface
from tsdf_tpu_torch.ops.raycast_diff import raycast_diff
from tsdf_tpu_torch.ops.trilinear import trilinear_sample
from tsdf_tpu_torch.pipelines import scenefusion as tsf
from tsdf_tpu_torch.pipelines.kinfu import (
    FusionConfig,
    fuse_frames,
    track_and_fuse_frames,
)
from tsdf_tpu_torch.utils import fixtures
from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

CPU = torch.device("cpu")
BF16 = torch.bfloat16
W, H = 64, 48
SIZE = (32, 32, 32)
# a 64x48 camera: the default depth camera's field of view
INTR = (59.11, 59.01, 31.5, 23.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _to_port(jvol) -> TSDFVolume:
    """The port's copy of a JAX volume, in the JAX volume's storage dtype."""
    vol = TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else _f32(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )
    return vol.astype(BF16) if jvol.tsdf.dtype == jnp.bfloat16 else vol


def _cam_to_port(jcam) -> Camera:
    return Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")),
        device=CPU,
    )


def _jax_cam(i=0):
    return (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([20.0 * i, -15.0 * i, -500.0 + 10.0 * i])
            .look_at([0.0, 0.0, 1000.0]))


def _depth(rng):
    """A sphere over a far plane with noise and dropouts (64x48)."""
    d = jax_fixtures.sphere_depth_map(W, H, 20.0, 800.0, 1200.0)
    d = np.where(d > 0, d, 1500.0).astype(np.float32)
    d = d + rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.02] = 0.0
    return d


def _jax_volume(**kw):
    return tsdf_tpu.make_volume(SIZE, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                                **kw).astype(jnp.bfloat16)


def _ulp(a, b) -> np.ndarray:
    """One bf16 ulp at the larger magnitude of a and b."""
    scale = np.maximum(np.abs(_f32(a)), np.abs(_f32(b)))
    return np.exp2(np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)


def _ulps(a, b) -> np.ndarray:
    """|a - b| in bf16 ulps of the larger magnitude (a, b bf16-valued)."""
    return np.abs(_f32(a) - _f32(b)) / _ulp(a, b)


def _assert_storage(tvol, jvol):
    """The gate of this suite: bf16 kept, weights equal, tsdf within 1 ulp
    (and equal almost everywhere)."""
    assert tvol.tsdf.dtype == tvol.weight.dtype == BF16
    assert jvol.tsdf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(tvol.weight), _f32(jvol.weight))
    u = _ulps(tvol.tsdf, jvol.tsdf)
    assert u.max() <= 1.0, u.max()
    assert (u == 0).mean() >= 0.999, (u == 0).mean()


# -- the volume ----------------------------------------------------------------


def test_make_volume_and_astype_mirror_jax():
    jvol = _jax_volume(with_color=True, with_deformation=True)
    tvol = make_volume(SIZE, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                       with_color=True, with_deformation=True, dtype=BF16,
                       device=CPU)
    assert tvol.tsdf.dtype == tvol.weight.dtype == BF16
    # astype recasts tsdf and weight only, as JAX volume.py:190-198 does
    for name in ("tsdf", "weight", "color", "deform", "physical_size",
                 "truncation_distance", "max_weight"):
        t, j = getattr(tvol, name), getattr(jvol, name)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        np.testing.assert_array_equal(_f32(t), _f32(j))
    back = tvol.astype(torch.float32)
    assert back.tsdf.dtype == back.weight.dtype == torch.float32
    assert back.color is tvol.color and back.deform is tvol.deform
    cleared = tvol.clear()
    assert cleared.tsdf.dtype == BF16
    assert cleared.to_numpy()["tsdf"].dtype == np.float32


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_storage_dtypes_raise(dtype):
    with pytest.raises(TypeError):
        make_volume((8, 8, 8), 100.0, dtype=dtype, device=CPU)
    vol = make_volume((8, 8, 8), 100.0, device=CPU).astype(dtype)
    cam = Camera.default_depth_camera(device=CPU)
    depth = torch.full((H, W), 500.0)
    with pytest.raises(TypeError):
        integrate_cuda(vol, depth, cam)
    with pytest.raises(TypeError):
        raycast_vertices_cuda(vol, cam, W, H)
    # tsdf and weight of different storage: refused, nothing is cast
    mixed = make_volume((8, 8, 8), 100.0, device=CPU)
    mixed = mixed.replace(tsdf=mixed.tsdf.to(BF16))
    with pytest.raises(TypeError):
        integrate_cuda(mixed, depth, cam)


def test_bf16_weights_count_frames_exactly_to_256():
    vol = make_volume((8, 8, 8), 200.0, offset=(-100.0, -100.0, 0.0),
                      max_weight=300.0, dtype=BF16, device=CPU)
    cam = Camera.from_intrinsics(*INTR, device=CPU).move_to([0.0, 0.0, -400.0])
    depth = torch.full((H, W), 450.0)
    for _ in range(256):
        vol = integrate_cuda(vol, depth, cam)
    assert float(vol.weight.max()) == 256.0
    # 257 is not a bf16: the 257th frame rounds the weight back to 256
    vol = integrate_cuda(vol, depth, cam)
    assert float(vol.weight.max()) == 256.0


# -- the integrates --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "line", "fast", "color", "color_fast"])
def test_integrate_bf16_matches_jax(mode):
    """Three frames from moving poses into a bf16 volume: the later frames
    blend into weighted voxels. exact and colour: the lax integrate; line:
    the port's exact kernel contract against the same (JAX's line mode is a
    resampling that differs at half-pixel slivers, test_torch_integrate.py);
    fast and colour-fast: ``integrate_(color_)pallas(mode="fast")`` in
    interpret mode."""
    rng = np.random.default_rng(0)
    color = mode.startswith("color")
    jvol = _jax_volume(with_color=color)
    tvol = _to_port(jvol)
    for i in range(3):
        jcam, depth = _jax_cam(i), _depth(rng)
        tcam, tdepth = _cam_to_port(jcam), torch.from_numpy(depth)
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 7 * i, axis=1)
        trgb = torch.from_numpy(np.ascontiguousarray(rgb))
        if mode in ("exact", "line"):
            jvol = jax_integrate(jvol, jnp.asarray(depth), jcam)
            tvol = integrate_cuda(tvol, tdepth, tcam)
        elif mode == "fast":
            jvol, jmiss = integrate_pallas(jvol, jnp.asarray(depth), jcam,
                                           mode="fast", interpret=True)
            tvol, tmiss = integrate_fast_cuda(tvol, tdepth, tcam)
            assert int(tmiss) == int(jmiss) == 0
        elif mode == "color":
            jvol = jax_integrate(jvol, jnp.asarray(depth), jcam,
                                 rgb=jnp.asarray(rgb))
            tvol, _ = integrate_color_cuda(tvol, tdepth, trgb, tcam,
                                           mode="exact")
        else:
            jvol, jmiss = integrate_color_pallas(
                jvol, jnp.asarray(depth), jnp.asarray(rgb), jcam,
                mode="fast", interpret=True)
            tvol, tmiss = integrate_color_cuda(tvol, tdepth, trgb, tcam,
                                               mode="fast")
            assert int(tmiss) == int(jmiss) == 0
    assert float(tvol.weight.max()) == 3.0
    assert float((tvol.weight > 0).float().mean()) > 0.05
    _assert_storage(tvol, jvol)
    if color:
        d = np.abs(np.asarray(jvol.color).astype(int)
                   - tvol.color.numpy().astype(int))
        assert int((tvol.color > 0).any(-1).sum()) > 500
        assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


def test_integrate_bf16_computes_in_f32():
    """The twin upcasts before d * w + obs: a bf16 product would round the
    running mean at 8 bits before the division."""
    vol = make_volume((8, 8, 8), 200.0, offset=(-100.0, -100.0, 0.0),
                      dtype=BF16, device=CPU)
    vol = vol.replace(tsdf=torch.full_like(vol.tsdf, 3.0078125),
                      weight=torch.full_like(vol.weight, 7.0))
    cam = Camera.from_intrinsics(*INTR, device=CPU).move_to([0.0, 0.0, -400.0])
    depth = torch.full((H, W), 450.0)
    out = integrate_cuda(vol.replace(tsdf=vol.tsdf.clone(),
                                     weight=vol.weight.clone()), depth, cam)
    ref = integrate_cuda(vol.astype(torch.float32), depth, cam)
    np.testing.assert_array_equal(_f32(out.tsdf), _f32(ref.tsdf.to(BF16)))
    np.testing.assert_array_equal(_f32(out.weight), _f32(ref.weight))


def test_warped_bf16_matches_jax_after_two_updates():
    """A deformed bf16 volume: two frames at the deformed centres."""
    rng = np.random.default_rng(3)
    jvol = tsdf_tpu.make_volume(SIZE, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                                with_deformation=True).astype(jnp.bfloat16)
    c = np.asarray(jvol.voxel_centres())
    bump = np.exp(-((c[..., 0] / 500.0) ** 2
                    + ((c[..., 2] - 900.0) / 400.0) ** 2))
    d = c.copy()
    d[..., 0] += 60.0 * bump
    d[..., 1] -= 24.0 * bump
    d += rng.uniform(-0.5, 0.5, d.shape)
    jvol = jvol.replace(deform=jnp.asarray(d.astype(np.float32)))
    tvol = _to_port(jvol)
    for i in range(2):
        jcam, depth = _jax_cam(i), _depth(rng)
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam)
        tvol = integrate_warped_cuda(tvol, torch.from_numpy(depth),
                                     _cam_to_port(jcam))
    assert float(tvol.weight.max()) == 2.0
    _assert_storage(tvol, jvol)


# -- the pose adjoint ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pose_setup():
    """A bf16 volume that already holds two frames, the third frame, and a
    seeded cotangent."""
    rng = np.random.default_rng(5)
    jvol = _jax_volume()
    for i in range(2):
        jvol = jax_integrate(jvol, jnp.asarray(_depth(rng)), _jax_cam(i))
    jcam, depth = _jax_cam(2), _depth(rng)
    gbar = rng.normal(size=SIZE).astype(np.float32)
    return jvol, jcam, depth, gbar


def test_pose_gradient_bf16_matches_jax():
    """jax.grad of <gbar, new tsdf> through the JAX integrate_pose
    (interpret mode) on a bf16 volume, against autograd through the port's
    on the same bf16 volume, at delta = 0 and at a nonzero twist."""
    jvol, jcam, depth, gbar = _pose_setup()
    tvol, tcam = _to_port(jvol), _cam_to_port(jcam)
    tgbar = torch.from_numpy(gbar)
    for delta in (np.zeros(6, np.float32),
                  np.float32([0.01, -0.02, 0.015, 6.0, -4.0, 5.0])):

        def loss(dl):
            out, _ = jax_integrate_pose(jvol, depth, jcam, dl, interpret=True)
            assert out.tsdf.dtype == jnp.bfloat16
            return jnp.sum(gbar * out.tsdf.astype(jnp.float32))

        want = np.asarray(jax.grad(loss)(jnp.asarray(delta)))
        d = torch.from_numpy(delta).requires_grad_(True)
        out, _ = integrate_pose(tvol, torch.from_numpy(depth), tcam, d)
        assert out.tsdf.dtype == BF16
        (got,) = torch.autograd.grad((tgbar * out.tsdf.float()).sum(), d)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


def test_volume_cotangents_bf16_match_jax():
    """d loss / d (tsdf_in, weight_in) through integrate_pose on a bf16
    volume: bf16 like the volume, as the JAX backward casts them
    (kernels/integrate.py:1596-1597); and the adjoint twin called alone."""
    jvol, jcam, depth, gbar = _pose_setup()
    tvol, tcam = _to_port(jvol), _cam_to_port(jcam)

    def jloss(t, w):
        out, _ = jax_integrate_pose(jvol.replace(tsdf=t, weight=w), depth,
                                    jcam, jnp.zeros(6), interpret=True)
        return (jnp.sum(gbar * out.tsdf.astype(jnp.float32))
                + jnp.sum(0.3 * out.weight.astype(jnp.float32)))

    gt_j, gw_j = jax.grad(jloss, argnums=(0, 1))(jvol.tsdf, jvol.weight)
    assert gt_j.dtype == gw_j.dtype == jnp.bfloat16
    t = tvol.tsdf.clone().requires_grad_(True)
    w = tvol.weight.clone().requires_grad_(True)
    out, _ = integrate_pose(tvol.replace(tsdf=t, weight=w),
                            torch.from_numpy(depth), tcam, torch.zeros(6))
    loss = ((torch.from_numpy(gbar) * out.tsdf.float()).sum()
            + (0.3 * out.weight.float()).sum())
    gt, gw = torch.autograd.grad(loss, (t, w))
    assert gt.dtype == gw.dtype == BF16
    np.testing.assert_array_equal(_f32(gt), _f32(gt_j))
    a, b = _f32(gw), _f32(gw_j)
    assert (np.abs(a - b) <= _ulp(a, b) + 1e-4).all()
    assert (a == b).mean() >= 0.999
    # the twin alone: cotangents in the volume's dtype, dd = gbar off the
    # gates, read in f32 as the kernel reads them
    g = torch.from_numpy(gbar).to(BF16)
    dd, dw, dpinv = pose_grad_cuda(tvol, torch.from_numpy(depth), tcam, g, g)
    assert dd.dtype == dw.dtype == BF16 and dpinv.dtype == torch.float32
    dd32, dw32, dpinv32 = integrate_pose_grad(
        tvol.astype(torch.float32), torch.from_numpy(depth), tcam, g.float(),
        g.float())
    np.testing.assert_array_equal(_f32(dd), _f32(dd32.to(BF16)))
    np.testing.assert_array_equal(_f32(dw), _f32(dw32.to(BF16)))
    np.testing.assert_array_equal(dpinv.numpy(), dpinv32.numpy())
    with pytest.raises(TypeError):  # a float32 cotangent on a bf16 volume
        pose_grad_cuda(tvol, torch.from_numpy(depth), tcam, g.float(),
                       g.float())


# -- reading the volume ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scene():
    """A bf16 wall-and-sphere scene (the raycast_diff suite's, at 32^3)."""
    jvol = tsdf_tpu.make_volume(SIZE, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = jax_fixtures.wall_tsdf(jvol, 1500.0)
    ball = jax_fixtures.sphere_tsdf(jvol, 380.0, centre=(150.0, -100.0, 900.0))
    jvol = jvol.replace(tsdf=jnp.minimum(wall.tsdf, ball.tsdf),
                        weight=jnp.ones_like(jvol.weight))
    jcam = (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))
    return jvol.astype(jnp.bfloat16), jcam


def test_trilinear_bf16_matches_jax():
    rng = np.random.default_rng(6)
    values = rng.normal(size=(7, 9, 11)).astype(np.float32)
    vs = np.float32([10.0, 12.5, 8.0])
    extent = np.float32([11, 9, 7]) * vs
    pts = rng.uniform(-0.3, 1.3, (400, 3)).astype(np.float32) * extent
    jv = jnp.asarray(values).astype(jnp.bfloat16)
    want = np.asarray(jax_trilinear(jv, jnp.asarray(pts), jnp.asarray(vs)))
    tv = torch.from_numpy(values).to(BF16)
    got = trilinear_sample(tv, torch.from_numpy(pts), torch.from_numpy(vs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the same as sampling the widened volume: the cast is after the gather
    np.testing.assert_array_equal(
        got.numpy(), trilinear_sample(tv.float(), torch.from_numpy(pts),
                                      torch.from_numpy(vs)).numpy())


def test_raycast_bf16_matches_jax():
    jvol, jcam = _scene()
    vj, _nj = jax_raycast(jvol, jcam, width=W, height=H)
    vt = raycast_vertices_cuda(_to_port(jvol), _cam_to_port(jcam), W, H)
    vt, vj = vt.numpy(), np.asarray(vj)
    hit_t, hit_j = np.isfinite(vt).all(-1), np.isfinite(vj).all(-1)
    assert (hit_t == hit_j).mean() >= 0.999
    both = hit_t & hit_j
    assert both.sum() > 1000
    err = np.linalg.norm(vt[both] - vj[both], axis=-1)
    assert np.median(err) < 0.5, np.median(err)


def test_uniform_bricks_of_bf16_are_the_widened_words():
    """The raycast kernel's brick table on a bf16 volume compares 16-bit
    words; widening is exact and one to one, so it is the table of the
    widened volume, value for value."""
    jvol, _ = _scene()
    t16 = _to_port(jvol).tsdf
    t16[3:5, 10:12, 7] = float("nan")
    got = uniform_bricks(t16)
    want = uniform_bricks(t16.float())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(torch.isfinite(got).sum()) > 10


def test_raycast_diff_bf16_matches_jax():
    jvol, jcam = _scene()
    tvol, tcam = _to_port(jvol), _cam_to_port(jcam)
    verts, hit = raycast_diff(tvol, tcam, W, H)
    jverts, jhit = jax_raycast_diff(jvol, jcam, W, H)
    hit, jhit = hit.numpy(), np.asarray(jhit)
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    assert both.sum() > 0.5 * hit.size
    err = np.linalg.norm(verts.detach().numpy()[both]
                         - np.asarray(jverts)[both], axis=-1)
    assert np.median(err) < 0.5 and np.percentile(err, 99) < 1e-2, (
        np.median(err), np.percentile(err, 99))
    # the tsdf gradient reaches the bf16 grid, as a bf16 cotangent
    t = tvol.tsdf.clone().requires_grad_(True)
    v, h = raycast_diff(tvol.replace(tsdf=t), tcam, W, H)
    (g,) = torch.autograd.grad(torch.where(h, v[..., 2], 0.0).sum(), t)
    assert g.dtype == BF16 and int((g != 0).sum()) > 1000


def test_marching_cubes_bf16_matches_jax():
    jvol, _ = _scene()
    js = jax_extract(jvol, max_cubes=1 << 14, max_vertices=1 << 16,
                     on_cpu=True)
    ts = extract_surface(_to_port(jvol), max_cubes=1 << 14,
                         max_vertices=1 << 16)
    n = int(js.n_vertices)
    assert int(ts.n_vertices) == n > 500
    assert ts.vertices.dtype == torch.float32
    got, want = ts.vertices[:n].numpy(), np.asarray(js.vertices)[:n]
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    np.testing.assert_array_equal(ts.vertex_voxels[:n].numpy(),
                                  np.asarray(js.vertex_voxels)[:n])


# -- files --------------------------------------------------------------------------


def test_tsdf_file_of_a_bf16_volume_is_float32(tmp_path):
    """.tsdf is always float32 (JAX io/tsdf_file.py:49-50): the two writers
    give the same bytes for a bf16 volume, and a load gives float32."""
    rng = np.random.default_rng(7)
    jvol = _jax_volume(with_color=True)
    jvol = jax_integrate(jvol, jnp.asarray(_depth(rng)), _jax_cam(0))
    tvol = _to_port(jvol)
    save_tsdf(tvol, str(tmp_path / "port.tsdf"))
    jax_save_tsdf(jvol, str(tmp_path / "jax.tsdf"))
    assert ((tmp_path / "port.tsdf").read_bytes()
            == (tmp_path / "jax.tsdf").read_bytes())
    back = load_tsdf(str(tmp_path / "port.tsdf"), device=CPU)
    assert back.tsdf.dtype == back.weight.dtype == torch.float32
    np.testing.assert_array_equal(back.tsdf.numpy(), _f32(tvol.tsdf))
    np.testing.assert_array_equal(back.weight.numpy(), _f32(tvol.weight))


def test_checkpoint_keeps_bf16(tmp_path):
    rng = np.random.default_rng(8)
    jvol = jax_integrate(_jax_volume(), jnp.asarray(_depth(rng)), _jax_cam(0))
    tvol = _to_port(jvol)
    save_sharded(tvol, str(tmp_path / "ckpt"))
    back = load_sharded(str(tmp_path / "ckpt"), like=tvol)
    assert back.tsdf.dtype == back.weight.dtype == BF16
    assert torch.equal(back.tsdf, tvol.tsdf)
    assert torch.equal(back.weight, tvol.weight)
    with pytest.raises(ValueError, match="dtype|bfloat16|float32"):
        load_sharded(str(tmp_path / "ckpt"), like=tvol.astype(torch.float32))


# -- bf16 against f32 ---------------------------------------------------------------


def test_port_bf16_storage_close_to_f32():
    """JAX tests/test_integrate.py:181-205 on the port: compute stays f32,
    results within bf16 rounding of the f32 path; weights (small ints)
    stay exact."""
    vol32 = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0),
                        device=CPU)
    vol16 = vol32.astype(BF16)
    cam = (Camera.default_depth_camera(device=CPU)
           .move_to([0.0, 0.0, -500.0]).look_at([0.0, 0.0, 1000.0]))
    depth = torch.from_numpy(np.asarray(
        jax_fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0), np.float32))
    for _ in range(3):
        vol32 = integrate_cuda(vol32, depth, cam)
        vol16 = integrate_cuda(vol16, depth, cam)
    assert vol16.tsdf.dtype == BF16
    np.testing.assert_array_equal(_f32(vol16.weight), vol32.weight.numpy())
    d16, d32 = _f32(vol16.tsdf), vol32.tsdf.numpy()
    assert np.max(np.abs(d16 - d32)) < np.max(np.abs(d32)) * 2**-7


# -- the paths ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "color", "fast", "color_fast"])
def test_fuse_frames_keeps_the_callers_bf16_volume(mode):
    """``fuse_frames`` fuses into the caller's bf16 volume (depth, colour,
    integrate_mode="fast"): the volume stays bf16 and equals the frames
    fused one by one through the wrappers, and JAX's on the same frames."""
    rng = np.random.default_rng(9)
    color = mode.startswith("color")
    cfg = FusionConfig(volume_size=SIZE, physical_size_mm=2000.0,
                       offset_mm=(-1000.0, -1000.0, 0.0), width=W, height=H,
                       integrate_mode="fast" if "fast" in mode else "exact")
    jvol = _jax_volume(with_color=color)
    vol = _to_port(jvol)
    frames = []
    for i in range(3):
        jcam, depth = _jax_cam(i), _depth(rng)
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 7 * i, axis=1)
        frames.append((torch.from_numpy(depth), _cam_to_port(jcam).pose)
                      + ((torch.from_numpy(np.ascontiguousarray(rgb)),)
                         if color else ()))
        if "fast" in mode:
            fn = integrate_color_pallas if color else integrate_pallas
            args = (jnp.asarray(rgb),) if color else ()
            jvol, _ = fn(jvol, jnp.asarray(depth), *args, jcam, mode="fast",
                         interpret=True)
        else:
            jvol = jax_integrate(jvol, jnp.asarray(depth), jcam,
                                 rgb=jnp.asarray(rgb) if color else None)
    out, _cam = fuse_frames(vol, _cam_to_port(_jax_cam(0)), frames, cfg)
    assert out.tsdf is vol.tsdf and out.tsdf.dtype == BF16
    _assert_storage(out, jvol)


def test_tracked_loop_on_a_bf16_volume():
    """The tracked loop (bilateral, raycast of the model, ICP, integrate) on
    a bf16 volume: it stays bf16, tracks every frame, and its poses stay
    within 0.5 mm and 1 mrad of the float32 loop's."""
    jscene = tsdf_tpu.make_volume((48,) * 3, 2000.0,
                                  offset=(-1000.0, -1000.0, 0.0))
    wall = jax_fixtures.wall_tsdf(jscene, 1500.0)
    ball = jax_fixtures.sphere_tsdf(jscene, 380.0, centre=(150.0, -100.0, 900.0))
    jscene = jscene.replace(tsdf=jnp.minimum(wall.tsdf, ball.tsdf),
                            weight=jnp.ones_like(jscene.weight))
    w, h = 80, 60
    intr = (73.9, 73.8, 41.4, 29.3)
    cams = [tsdf_tpu.Camera.from_intrinsics(*intr)
            .move_to([10.0 * i, -4.0 * i, -400.0 + 2.5 * i])
            .look_at([0.0, 0.0, 1000.0]) for i in range(3)]
    depths = [torch.from_numpy(np.asarray(
        jax_render_depth(jscene, c, width=w, height=h), np.float32))
        for c in cams]
    cfg = FusionConfig(volume_size=(48,) * 3, physical_size_mm=2000.0,
                       offset_mm=(-1000.0, -1000.0, 0.0), width=w, height=h,
                       use_bilateral_filter=True)
    runs = {}
    for dtype in (torch.float32, BF16):
        vol = cfg.make_volume(device=CPU).astype(dtype)
        cam = Camera.from_intrinsics(
            *intr, pose=torch.from_numpy(np.asarray(cams[0].pose).copy()),
            device=CPU)
        vol, _cam, poses, stats = track_and_fuse_frames(vol, cam, depths, cfg)
        assert vol.tsdf.dtype == vol.weight.dtype == dtype
        assert len(poses) == 3 and int(stats[-1][1]) > 500
        runs[dtype] = [p.numpy() for p in poses]
    for a, b in zip(runs[torch.float32], runs[BF16]):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < 0.5
        assert np.abs(a[:3, :3] - b[:3, :3]).max() < 1e-3


def test_scenefusion_step_on_a_bf16_volume_matches_jax():
    """SceneFusion's frame (masked extraction, deformation update,
    integrate at the deformed centres) on a bf16 volume with its float32
    deformation field, against the JAX package's plain functions on the
    same bf16 volume."""
    jvol = tsdf_tpu.make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
                                with_deformation=True)
    jvol = jax_fixtures.sphere_tsdf(jvol, 300.0, centre=(0.0, 0.0, 750.0))
    jvol = jvol.replace(weight=jnp.ones_like(jvol.weight)).astype(jnp.bfloat16)
    jcam = (tsdf_tpu.Camera.from_intrinsics(*INTR)
            .move_to([0.0, 0.0, -200.0]).look_at([0.0, 0.0, 750.0]))
    depth = np.asarray(jax_render_depth(jvol, jcam, width=W, height=H),
                       np.float32)
    flow = np.broadcast_to(np.float32([5.0, 0.0, 0.0]), (H, W, 3)).copy()
    soup = jax_extract(jvol, max_cubes=1 << 14, max_vertices=1,
                       layout="masked", on_cpu=True)
    want, n_want = jsf.update_deformation(
        jvol, soup, jnp.asarray(depth), jcam, jnp.asarray(flow),
        threshold_mm=10.0, tpu_safe=False)
    want = jax_integrate(want, jnp.asarray(depth), jcam)
    got, n_got, over = tsf.scenefusion_step(
        _to_port(jvol), torch.from_numpy(depth), torch.from_numpy(flow),
        _cam_to_port(jcam), max_cubes=1 << 14, threshold_mm=10.0)
    assert int(n_got) == int(n_want) > 100 and not bool(over)
    assert got.deform.dtype == torch.float32
    np.testing.assert_allclose(got.deform.numpy(), np.asarray(want.deform),
                               rtol=0, atol=1e-4)
    _assert_storage(got, want)
