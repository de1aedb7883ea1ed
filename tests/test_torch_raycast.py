"""Trilinear sampling, raycasting and shading in tsdf_tpu_torch vs the
JAX package.

Tolerances:
  * trilinear: same formula, same order, float32 -> within 1e-4 mm;
  * raycast vs ``tsdf_tpu.ops.raycast``: hit masks >= 99.9% equal and
    median vertex error < 0.5 mm (rays whose direction differs in the last
    bit may step to a different sample near a silhouette);
  * vs ``raycast_pallas(interpret=True)``: the JAX slab-sweep gates of
    tests/test_raycast_pallas.py (hit masks >= 99.9%, median < 1 mm,
    p99 < 5 mm, normals' median dot > 0.999);
  * shading vs tests/goldens at tests/test_golden.py's tolerance (mean
    |diff| < 0.5 and < 0.1% of pixels off by more than 8).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.io.png import load_png
from tsdf_tpu.kernels.raycast import raycast_pallas
from tsdf_tpu.ops.raycast import raycast as jax_raycast
from tsdf_tpu.ops.trilinear import trilinear_sample as jax_trilinear
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.kernels.raycast import (
    KERNEL,
    raycast_cuda,
    render_to_depth_image_cuda,
)
from tsdf_tpu_torch.ops.raycast import raycast, render_to_depth_image
from tsdf_tpu_torch.ops.shading import normals_image, scene_image
from tsdf_tpu_torch.ops.trilinear import trilinear_sample
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
W, H = 160, 120
INTR = (147.775, 147.525, 82.75, 58.65)
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


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


def _jcam(at, target):
    return tsdf_tpu.Camera.from_intrinsics(*INTR).move_to(at).look_at(target)


def test_trilinear_matches_jax_with_border_clamps():
    rng = np.random.default_rng(0)
    values = rng.normal(size=(7, 9, 11)).astype(np.float32)
    vs = np.float32([10.0, 12.5, 8.0])
    extent = np.float32([11, 9, 7]) * vs
    # inside, past every face, negative, exactly on the far faces
    pts = rng.uniform(-0.3, 1.3, (400, 3)).astype(np.float32) * extent
    pts[:3] = extent
    pts[3:6] = 0.0
    pts[6] = extent - vs / 10.0
    want = np.asarray(jax_trilinear(jnp.asarray(values), jnp.asarray(pts),
                                    jnp.asarray(vs)))
    got = trilinear_sample(torch.from_numpy(values), torch.from_numpy(pts),
                           torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _sphere_vol():
    vol = tsdf_tpu.make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    return jax_fixtures.sphere_tsdf(vol, 400.0)


def _compare(vt, vj, min_agree=0.999, median=0.5):
    hit_t = np.isfinite(vt).all(-1)
    hit_j = np.isfinite(vj).all(-1)
    assert (hit_t == hit_j).mean() >= min_agree
    both = hit_t & hit_j
    assert both.sum() > 1000
    err = np.linalg.norm(vt[both] - vj[both], axis=-1)
    assert np.median(err) < median, np.median(err)
    return both, err


@pytest.mark.parametrize(
    "at,target,mode",
    [
        ([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0], "sphere"),
        ([0.0, 0.0, 2600.0], [0.0, 0.0, 1000.0], "sphere"),
        ([0.0, 0.0, 100.0], [0.0, 0.0, 1000.0], "sphere"),  # inside
        ([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0], "fixed"),
    ],
)
def test_raycast_matches_jax(at, target, mode):
    jvol = _sphere_vol()
    jcam = _jcam(at, target)
    vj, nj = jax_raycast(jvol, jcam, width=W, height=H, mode=mode)
    vt, nt = raycast(_to_port(jvol), _cam_to_port(jcam), W, H, mode=mode)
    both, _ = _compare(vt.numpy(), np.asarray(vj))
    dot = (nt.numpy()[both] * np.asarray(nj)[both]).sum(-1)
    assert np.median(dot) > 0.999


def test_raycast_matches_pallas_slab_sweep():
    jvol = _sphere_vol()
    jcam = _jcam([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0])
    vp, npm = raycast_pallas(jvol, jcam, width=W, height=H, interpret=True)
    vt, nt = raycast(_to_port(jvol), _cam_to_port(jcam), W, H)
    both, err = _compare(vt.numpy(), np.asarray(vp), median=1.0)
    assert np.percentile(err, 99) < 5.0
    dot = (nt.numpy()[both] * np.asarray(npm)[both]).sum(-1)
    assert np.median(dot) > 0.999


def test_render_to_depth_image_matches_jax():
    from tsdf_tpu.ops.raycast import render_to_depth_image as jax_render

    jvol = _sphere_vol()
    jcam = _jcam([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0])
    dj = np.asarray(jax_render(jvol, jcam, width=W, height=H))
    dt = render_to_depth_image(_to_port(jvol), _cam_to_port(jcam), W, H)
    assert dt.dtype == torch.uint16
    dt = dt.numpy()
    assert ((dt > 0) == (dj > 0)).mean() >= 0.999
    both = (dt > 0) & (dj > 0)
    assert np.median(np.abs(dt[both].astype(int) - dj[both])) <= 1


def test_depth_image_wrapper_on_cpu_tensors_is_the_twin():
    """``render_to_depth_image_cuda`` on CPU tensors launches nothing and
    equals ``render_to_depth_image`` bit for bit."""
    vol = _to_port(_sphere_vol())
    cam = _cam_to_port(_jcam([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0]))
    before = KERNEL.launches
    got = render_to_depth_image_cuda(vol, cam, W, H)
    assert KERNEL.launches == before
    assert got.dtype == torch.uint16 and int(got.to(torch.int32).max()) > 0
    assert torch.equal(got, render_to_depth_image(vol, cam, W, H))


def _golden_scene():
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=CPU)
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    vol = vol.replace(
        tsdf=torch.minimum(torch.minimum(wall.tsdf, s1.tsdf), s2.tsdf),
        weight=torch.ones_like(vol.weight),
    )
    cam = (Camera.from_intrinsics(*INTR, device=CPU)
           .move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))
    return vol, cam


def test_shading_matches_goldens():
    vol, cam = _golden_scene()
    before = KERNEL.launches
    verts, normals = raycast_cuda(vol, cam, W, H)
    assert KERNEL.launches == before  # CPU tensors: the plain twin
    scene = scene_image(verts, normals, cam.position).numpy()
    nimg = normals_image(normals).numpy()
    for img, name in ((scene, "scene.png"), (nimg, "normals.png")):
        golden = load_png(os.path.join(GOLDENS, name))
        assert img.shape == golden.shape and img.dtype == golden.dtype
        d = np.abs(img.astype(int) - golden.astype(int))
        assert d.mean() < 0.5 and (d > 8).mean() < 0.001, (name, d.mean())


@pytest.mark.parametrize("bad", ["tsdf_f64", "tsdf_strided", "mode",
                                 "meta_device", "size"])
def test_raycast_wrapper_rejects_bad_inputs(bad):
    vol, cam = _golden_scene()
    kwargs = {}
    width = W
    if bad == "tsdf_f64":
        vol = vol.replace(tsdf=vol.tsdf.double())
    elif bad == "tsdf_strided":
        vol = vol.replace(tsdf=vol.tsdf.transpose(0, 2))
    elif bad == "mode":
        # the kernel is the sphere trace only: the twin's fixed-step mode
        # is not an option of the wrapper
        kwargs["mode"] = "fixed"
    elif bad == "meta_device":
        cam = dataclasses.replace(cam, k_inv=cam.k_inv.to("meta"))
    elif bad == "size":
        width = 0
    with pytest.raises((TypeError, ValueError)):
        raycast_cuda(vol, cam, width, H, **kwargs)
