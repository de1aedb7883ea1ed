"""The package-level API of tsdf_tpu_torch vs tsdf_tpu's, on the CPU, on
a 32^3 scene.

CPU tensors take the kernels' wrappers, which run the plain twins there;
every root function is also held bit for bit against the twin it must
run. Against JAX, the tolerances of the tests of each twin:
  * ``integrate`` (depth, colour, a deformed volume): weights equal on
    >= 99.9 % of the voxels, tsdf within 5e-3 mm where they agree, colour
    within one level on >= 99.9 % of the bytes (tests/test_torch_integrate.py,
    tests/test_torch_color.py, tests/test_torch_deform.py);
  * ``raycast``: hit masks >= 99.9 % equal, median vertex error < 0.5 mm,
    median normal dot > 0.999; ``render_to_depth_image``: masks >= 99.9 %
    equal, median |diff| <= 1 mm (tests/test_torch_raycast.py);
  * ``trilinear_sample`` within 1e-4; ``compute_normals`` rtol 1e-5,
    atol 2e-5; ``scene_image`` and ``normals_image`` within one level on
    >= 99.9 % of the pixels (a norm or a floor rounded the other way);
  * ``voxel_for_point``: equal.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
import tsdf_tpu.ops
import tsdf_tpu_torch
import tsdf_tpu_torch.ops
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu.volume import voxel_for_point as jax_voxel_for_point
from tsdf_tpu_torch import Camera, TSDFVolume
from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain
from tsdf_tpu_torch.ops.raycast import raycast as raycast_plain
from tsdf_tpu_torch.utils import fixtures
from tsdf_tpu_torch.volume import voxel_for_point

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)
GRID = 32


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


def _jcam(i=0):
    return tsdf_tpu.Camera.from_intrinsics(*INTR).move_to(
        [40.0 * i - 60.0, 25.0 * i, -500.0]).look_at([0.0, 0.0, 1000.0])


def _frames(n=3, seed=0):
    """Seeded noisy depth frames with dropouts, and colour frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = jax_fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0)
        d = d.astype(np.float32)
        d = d + (d > 0) * rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
        d[rng.uniform(size=d.shape) < 0.02] = 0.0
        rgb = np.roll(fixtures.gradient_rgb(W, H, diagonal=True), 17 * i, axis=1)
        out.append((d, np.ascontiguousarray(rgb)))
    return out


def _scene(**kw):
    jvol = tsdf_tpu.make_volume((GRID,) * 3, 2000.0,
                                offset=(-1000.0, -1000.0, 0.0), **kw)
    wall = jax_fixtures.wall_tsdf(jvol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(jvol, 380.0, centre=(150.0, -100.0, 900.0))
    return jvol.replace(tsdf=jnp.minimum(wall.tsdf, s1.tsdf),
                        weight=jnp.ones_like(jvol.weight))


def _assert_gate(tvol, jvol, min_agree=0.999):
    wt, wj = tvol.weight.numpy(), np.asarray(jvol.weight)
    same = wt == wj
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_allclose(tvol.tsdf.numpy()[same],
                               np.asarray(jvol.tsdf)[same], rtol=0, atol=5e-3)
    if jvol.color is not None:
        d = np.abs(np.asarray(jvol.color).astype(int)
                   - tvol.color.numpy().astype(int))
        assert (d <= 1).mean() >= min_agree


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


def test_root_exports_the_jax_names():
    assert set(tsdf_tpu_torch.__all__) == set(tsdf_tpu.__all__)
    assert set(tsdf_tpu_torch.ops.__all__) == set(tsdf_tpu.ops.__all__)
    for name in tsdf_tpu.__all__:
        assert callable(getattr(tsdf_tpu_torch, name)), name
    for name in tsdf_tpu.ops.__all__:
        assert callable(getattr(tsdf_tpu_torch.ops, name)), name
    from tsdf_tpu_torch.ops.raycast import compute_normals_from_vertices

    assert tsdf_tpu_torch.compute_normals is compute_normals_from_vertices
    # the ops list is the plain functions; the root routes through the
    # kernels' wrappers
    assert tsdf_tpu_torch.ops.integrate is integrate_plain
    assert tsdf_tpu_torch.ops.raycast is raycast_plain
    assert tsdf_tpu_torch.integrate is not integrate_plain


@pytest.mark.parametrize("depth_type", ["f32 tensor", "u16 array", "cap_weight"])
def test_root_integrate_matches_jax(depth_type):
    jvol = tsdf_tpu.make_volume((GRID,) * 3, 2000.0,
                                offset=(-1000.0, -1000.0, 0.0), max_weight=2.0)
    tvol = _to_port(jvol)
    twin = _to_port(jvol)
    cap = depth_type == "cap_weight"
    reset_launch_counts()
    for i, (d, _rgb) in enumerate(_frames()):
        if depth_type == "u16 array":
            d = np.round(d).astype(np.uint16)
        jcam = _jcam(i)
        jvol = tsdf_tpu.integrate(jvol, jnp.asarray(d), jcam, cap_weight=cap)
        frame = d if depth_type == "u16 array" else torch.from_numpy(d)
        out = tsdf_tpu_torch.integrate(tvol, frame, _cam_to_port(jcam),
                                       cap_weight=cap)
        assert out is tvol  # in place
        twin = integrate_plain(twin, torch.as_tensor(d.astype(np.float32)),
                               _cam_to_port(jcam), cap_weight=cap)
    assert float(tvol.weight.sum()) > 1000
    if cap:
        assert float(tvol.weight.max()) == 2.0
    _assert_gate(tvol, jvol)
    _equal(tvol, twin)
    assert not any(launch_counts().values())  # CPU tensors launch nothing


def test_root_integrate_rgb_matches_jax():
    jvol = _scene(with_color=True)
    tvol, twin = _to_port(jvol), _to_port(jvol)
    for i, (d, rgb) in enumerate(_frames(seed=1)):
        jcam = _jcam(i)
        jvol = tsdf_tpu.integrate(jvol, jnp.asarray(d), jcam,
                                  rgb=jnp.asarray(rgb))
        tsdf_tpu_torch.integrate(tvol, torch.from_numpy(d), _cam_to_port(jcam),
                                 rgb=rgb)
        twin = integrate_plain(twin, torch.from_numpy(d), _cam_to_port(jcam),
                               rgb=torch.from_numpy(rgb))
    assert int(tvol.color.sum()) > 0
    _assert_gate(tvol, jvol)
    _equal(tvol, twin)


def test_root_integrate_deformed_volume_matches_jax():
    jvol = _scene(with_deformation=True)
    jvol = jvol.replace(deform=jvol.deform + jnp.asarray([18.0, -9.0, 6.0]))
    tvol, twin = _to_port(jvol), _to_port(jvol)
    for i, (d, _rgb) in enumerate(_frames(seed=2)):
        jcam = _jcam(i)
        jvol = tsdf_tpu.integrate(jvol, jnp.asarray(d), jcam)
        tsdf_tpu_torch.integrate(tvol, torch.from_numpy(d), _cam_to_port(jcam))
        twin = integrate_plain(twin, torch.from_numpy(d), _cam_to_port(jcam))
    _assert_gate(tvol, jvol)
    _equal(tvol, twin)


def test_root_integrate_takes_the_pipelines_dispatch(monkeypatch):
    """The root ``integrate`` has no kernel choice of its own: a depth
    frame reaches ``pipelines.kinfu``'s ``integrate_cuda``, the name the
    benchmark's planted faults patch."""
    from tsdf_tpu_torch.pipelines import kinfu

    calls = []
    real = kinfu.integrate_cuda

    def spy(vol, depth, camera, cap_weight=False):
        calls.append(cap_weight)
        return real(vol, depth, camera, cap_weight=cap_weight)

    monkeypatch.setattr(kinfu, "integrate_cuda", spy)
    jvol = _scene()
    tvol, twin = _to_port(jvol), _to_port(jvol)
    d, _rgb = _frames(n=1)[0]
    cam = _cam_to_port(_jcam())
    assert tsdf_tpu_torch.integrate(tvol, d, cam, cap_weight=True) is tvol
    assert calls == [True]
    _equal(tvol, integrate_plain(twin, torch.from_numpy(d), cam,
                                 cap_weight=True))


def _compare_verts(vt, vj):
    hit_t, hit_j = np.isfinite(vt).all(-1), np.isfinite(vj).all(-1)
    assert (hit_t == hit_j).mean() >= 0.999
    both = hit_t & hit_j
    assert both.sum() > 1000
    assert np.median(np.linalg.norm(vt[both] - vj[both], axis=-1)) < 0.5
    return both


@pytest.mark.parametrize("mode", ["sphere", "fixed"])
def test_root_raycast_matches_jax(mode):
    jvol = _scene()
    jcam = _jcam(1)
    vj, nj = tsdf_tpu.raycast(jvol, jcam, W, H, mode=mode)
    reset_launch_counts()
    vt, nt = tsdf_tpu_torch.raycast(_to_port(jvol), _cam_to_port(jcam), W, H,
                                    mode=mode)
    assert not any(launch_counts().values())
    both = _compare_verts(vt.numpy(), np.asarray(vj))
    assert np.median((nt.numpy()[both] * np.asarray(nj)[both]).sum(-1)) > 0.999
    pv, pn = raycast_plain(_to_port(jvol), _cam_to_port(jcam), W, H, mode=mode)
    assert torch.equal(vt.nan_to_num(7.0), pv.nan_to_num(7.0))
    assert torch.equal(nt, pn)


def test_root_render_to_depth_image_matches_jax():
    jvol = _scene()
    jcam = _jcam(2)
    dj = np.asarray(tsdf_tpu.render_to_depth_image(jvol, jcam, W, H))
    dt = tsdf_tpu_torch.render_to_depth_image(_to_port(jvol),
                                              _cam_to_port(jcam), W, H)
    assert dt.dtype == torch.uint16 and tuple(dt.shape) == (H, W)
    dt = dt.numpy()
    assert ((dt > 0) == (dj > 0)).mean() >= 0.999
    both = (dt > 0) & (dj > 0)
    assert both.sum() > 1000
    assert np.median(np.abs(dt[both].astype(int) - dj[both])) <= 1
    fixed = tsdf_tpu_torch.render_to_depth_image(
        _to_port(jvol), _cam_to_port(jcam), W, H, mode="fixed")
    dfj = np.asarray(tsdf_tpu.render_to_depth_image(jvol, jcam, W, H,
                                                    mode="fixed"))
    assert ((fixed.numpy() > 0) == (dfj > 0)).mean() >= 0.999


@pytest.mark.parametrize("keywords", [dict(mode="fixed"), dict(step_scale=0.5)])
def test_keywords_no_kernel_implements_raise_on_cuda(keywords):
    """A CUDA volume with a keyword the raycast kernel lacks raises before
    touching the card, naming the ROADMAP line; on the CPU it runs."""
    jvol = _scene()
    cam = _cam_to_port(_jcam(0))
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="fixed-step raycast kernel"):
        tsdf_tpu_torch.raycast(card, cam, W, H, **keywords)
    with pytest.raises(ValueError, match="fixed-step raycast kernel"):
        tsdf_tpu_torch.render_to_depth_image(card, cam, W, H, **keywords)
    vt, _ = tsdf_tpu_torch.raycast(_to_port(jvol), cam, W, H, **keywords)
    assert torch.isfinite(vt).all(-1).sum() > 1000


def test_plain_exports_match_jax():
    jvol = _scene()
    jcam = _jcam(1)
    vj, nj = tsdf_tpu.raycast(jvol, jcam, W, H)
    verts = torch.from_numpy(np.array(vj))
    np.testing.assert_allclose(
        tsdf_tpu_torch.compute_normals(verts).numpy(),
        np.asarray(tsdf_tpu.compute_normals(vj)), rtol=1e-5, atol=2e-5)
    normals = torch.from_numpy(np.array(nj))
    for got, want in (
        (tsdf_tpu_torch.scene_image(verts, normals, _cam_to_port(jcam).position),
         tsdf_tpu.scene_image(vj, nj, jcam.position)),
        (tsdf_tpu_torch.normals_image(normals), tsdf_tpu.normals_image(nj)),
    ):
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert got.dtype == torch.uint8 and d.max() <= 1
        assert (d == 0).mean() >= 0.999
    rng = np.random.default_rng(5)
    values = rng.normal(size=(9, 7, 11)).astype(np.float32)
    vs = np.float32([10.0, 12.5, 8.0])
    pts = rng.uniform(-0.2, 1.2, (300, 3)).astype(np.float32) * (
        np.float32([11, 7, 9]) * vs)
    np.testing.assert_allclose(
        tsdf_tpu_torch.trilinear_sample(torch.from_numpy(values),
                                        torch.from_numpy(pts),
                                        torch.from_numpy(vs)).numpy(),
        np.asarray(tsdf_tpu.trilinear_sample(jnp.asarray(values),
                                             jnp.asarray(pts), jnp.asarray(vs))),
        rtol=0, atol=1e-4)


def test_voxel_for_point_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-300.0, 2500.0, size=(5, 40, 3)).astype(np.float32)
    pts[0, :3] = [[0.0, 0.0, 0.0], [62.5, 125.0, -0.0], [-1e-3, 61.9, 187.5]]
    vs = np.float32([62.5, 62.5, 31.25])
    want = np.asarray(jax_voxel_for_point(jnp.asarray(pts), jnp.asarray(vs)))
    got = voxel_for_point(pts, torch.from_numpy(vs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        voxel_for_point(torch.from_numpy(pts), 62.5).numpy(),
        np.asarray(jax_voxel_for_point(jnp.asarray(pts), 62.5)))
