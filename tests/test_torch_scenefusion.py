"""Non-rigid SceneFusion in tsdf_tpu_torch vs the JAX package, on the CPU
(CPU tensors run the kernels' plain twins), on the 48^3 / 1500 mm sphere of
tests/test_scenefusion.py. The same numpy inputs go through the JAX
function and its counterpart.

Tolerances:
  * the masked marching-cubes layout vs ``_extract_arrays(layout="masked",
    tpu_safe=False)``: ``valid``, ``n_vertices``, ``overflowed`` and the
    bracketing voxels of live slots equal; vertices within 2 ulps (XLA on
    the CPU rounds the centre and interpolation expressions differently,
    ROADMAP Queue 3);
  * correspondences: the count equal (the fixtures keep every vertex off
    the 10 mm threshold by far more than rounding), the flow rows equal;
  * the deformation field: 1e-4 mm, the JAX tests' own tolerance between
    its accumulation paths (sums of a few flow rows in another order);
  * the frame step and the orchestrator: deform 1e-4; tsdf and weight
    under the integrate gate of tests/test_torch_integrate.py (weights
    equal on >= 99.9% of the voxels, tsdf within 5e-3 mm where they
    agree) against the JAX run, whose warped Pallas kernel runs in
    interpret mode.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.cli import main as jax_main
from tsdf_tpu.io import mock_kinect as jax_mock_kinect
from tsdf_tpu.io import sceneflow as jax_sceneflow
from tsdf_tpu.io.png import save_png
from tsdf_tpu.ops.marching_cubes import _extract_arrays
from tsdf_tpu.ops.marching_cubes import extract_surface as jax_extract_surface
from tsdf_tpu.ops.marching_cubes import soup_to_numpy as jax_soup_to_numpy
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.pipelines import scenefusion as jsf
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, kernels
from tsdf_tpu_torch.cli import main as torch_main
from tsdf_tpu_torch.io import mock_kinect, sceneflow
from tsdf_tpu_torch.parallel.distributed import launch
from tsdf_tpu_torch.ops.marching_cubes import (
    TriangleSoup,
    extract_surface,
    soup_to_numpy,
)
from tsdf_tpu_torch.pipelines import scenefusion as tsf

CPU = torch.device("cpu")
W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4
CAM_ARGS = ["--fx", str(FX), "--fy", str(FY), "--cx", str(CX), "--cy", str(CY),
            "--width", str(W), "--height", str(H)]
MAX_CUBES = 1 << 14
SMALL = ["-s", "48", "--physical", "1500", "--max-cubes", str(MAX_CUBES)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_ply(path):
    """(n, 3) f32 vertices and (m, 3) i32 triangles of an ASCII PLY."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines.index("end_header")
    count = {ln.split()[1]: int(ln.split()[2])
             for ln in lines[:head] if ln.startswith("element")}
    nv, nf = count["vertex"], count["face"]
    body = lines[head + 1:]
    verts = np.array([ln.split()[:3] for ln in body[:nv]], np.float32)
    tris = np.array([ln.split()[1:4] for ln in body[nv:nv + nf]], np.int32)
    return verts.reshape(-1, 3), tris.reshape(-1, 3)


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


def _soup_to_port(jsoup):
    return TriangleSoup(
        vertices=torch.from_numpy(np.array(jsoup.vertices)),
        vertex_voxels=torch.from_numpy(np.array(jsoup.vertex_voxels)),
        n_vertices=torch.tensor(int(jsoup.n_vertices), dtype=torch.int32),
        overflowed=torch.tensor(bool(jsoup.overflowed)),
        valid=torch.from_numpy(np.array(jsoup.valid)),
    )


def _jax_cam(at=(0.0, 0.0, -200.0)):
    return (tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY)
            .move_to(list(at)).look_at([0.0, 0.0, 750.0]))


_SETUP = {}


def _sphere_setup(at=(0.0, 0.0, -200.0)):
    """tests/test_scenefusion.py:97-109 (cached: the render is slow)."""
    if at not in _SETUP:
        vol = tsdf_tpu.make_volume((48, 48, 48), 1500.0,
                                   offset=(-750.0, -750.0, 0.0),
                                   with_deformation=True)
        vol = jax_fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
        cam = _jax_cam(at)
        depth = np.asarray(render_to_depth_image(vol, cam, width=W, height=H))
        _SETUP[at] = (vol, cam, depth.astype(np.float32))
    return _SETUP[at]


def _flow(vec, rng=None):
    flow = np.broadcast_to(np.asarray(vec, np.float32), (H, W, 3)).copy()
    if rng is not None:
        flow += rng.uniform(-2.0, 2.0, flow.shape).astype(np.float32)
    return flow


def _jax_masked(jvol, max_cubes=MAX_CUBES):
    return _extract_arrays(jvol.tsdf, jvol.voxel_size, jvol.offset,
                           max_cubes=max_cubes, max_vertices=1,
                           layout="masked", tpu_safe=False)


def _assert_gate(tsdf, weight, jvol, min_agree=0.999):
    wj = np.asarray(jvol.weight)
    same = weight == wj
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_allclose(tsdf[same], np.asarray(jvol.tsdf)[same],
                               rtol=0, atol=5e-3)


# -- the masked marching-cubes layout --------------------------------------------


@pytest.mark.parametrize("max_cubes", [MAX_CUBES, 700], ids=["fits", "overflow"])
def test_masked_layout_matches_jax(max_cubes):
    jvol, _, _ = _sphere_setup()
    want = _jax_masked(jvol, max_cubes)
    kernels.reset_launch_counts()
    got = extract_surface(_to_port(jvol), max_cubes=max_cubes, max_vertices=1,
                          layout="masked")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert got.vertices.shape == (max_cubes * 24, 3)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert int(got.n_vertices) == int(want.n_vertices)
    assert bool(got.overflowed) == bool(want.overflowed) == (max_cubes == 700)
    assert got.n_vertices.dtype == torch.int32 and got.overflowed.dtype == torch.bool
    np.testing.assert_array_equal(got.vertex_voxels.numpy()[valid],
                                  np.asarray(want.vertex_voxels)[valid])
    np.testing.assert_allclose(got.vertices.numpy()[valid],
                               np.asarray(want.vertices)[valid],
                               rtol=2.4e-7, atol=1e-4)
    if max_cubes == MAX_CUBES:
        assert valid.sum() == int(want.n_vertices) > 1000
    else:
        assert valid.sum() < int(want.n_vertices)


def test_soup_to_numpy_of_both_layouts():
    """A dense and a masked soup of one volume give the same mesh, equal
    to the JAX mesh; an overflowed masked soup is cut to whole triangles
    of what was captured, as in JAX."""
    jvol, _, _ = _sphere_setup()
    tvol = _to_port(jvol)
    dense = extract_surface(tvol, max_cubes=MAX_CUBES, max_vertices=1 << 16)
    masked = extract_surface(tvol, max_cubes=MAX_CUBES, layout="masked")
    dv, dt = soup_to_numpy(dense)
    mv, mt = soup_to_numpy(masked)
    np.testing.assert_array_equal(dv, mv)
    np.testing.assert_array_equal(dt, mt)
    jv, jt = jax_soup_to_numpy(_jax_masked(jvol))
    assert len(mv) == len(jv) == int(dense.n_vertices) and len(mv) % 3 == 0
    np.testing.assert_allclose(mv, jv, rtol=2.4e-7, atol=1e-4)
    np.testing.assert_array_equal(mt, jt)

    over = extract_surface(tvol, max_cubes=700, layout="masked")
    ov, ot = soup_to_numpy(over)
    jov, jot = jax_soup_to_numpy(_jax_masked(jvol, 700))
    assert len(ov) == len(jov) < int(over.n_vertices) and len(ov) % 3 == 0
    np.testing.assert_array_equal(ot, jot)
    np.testing.assert_allclose(ov, jov, rtol=2.4e-7, atol=1e-4)
    with pytest.raises(ValueError, match="layout"):
        extract_surface(tvol, layout="sparse")


# -- correspondences and the deformation update -------------------------------------


def test_correspondence_uses_camera_depth_not_world_z():
    """tests/test_scenefusion.py:352: a camera looking along world +x. The
    gate compares camera-space depth, and a vertex behind the camera never
    corresponds."""
    jcam = (tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY)
            .move_to([0.0, 0.0, 0.0]).look_at([1000.0, 0.0, 0.0]))
    depth = np.full((H, W), 1000.0, np.float32)
    flow = np.ones((H, W, 3), np.float32)
    verts = np.array([[1000.0, 0.0, 0.0], [1200.0, 0.0, 0.0],
                      [-1000.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    want_corr, want_flow = jsf._slot_correspondence(
        jnp.asarray(verts), jnp.ones(4, bool), jnp.asarray(depth), jcam,
        jnp.asarray(flow), 10.0)
    corr, fl = tsf._slot_correspondence(
        torch.from_numpy(verts), torch.ones(4, dtype=torch.bool),
        torch.from_numpy(depth), _cam_to_port(jcam), torch.from_numpy(flow),
        10.0)
    assert corr.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(corr.numpy(), np.asarray(want_corr))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(want_flow))


def test_slot_correspondence_matches_jax_on_random_vertices():
    """tests/test_scenefusion.py:384: random vertices around a noisy depth,
    some dead, under a 40 mm threshold: some correspond, some do not."""
    rng = np.random.RandomState(5)
    jcam = tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY).move_to([0.0, 0.0, 0.0])
    depth = 900.0 + 50.0 * rng.rand(H, W).astype(np.float32)
    flow = rng.randn(H, W, 3).astype(np.float32)
    verts = (rng.randn(5000, 3).astype(np.float32) * 400.0
             + np.array([0.0, 0.0, 920.0], np.float32))
    valid = rng.rand(5000) < 0.7
    want_corr, want_flow = jsf._slot_correspondence(
        jnp.asarray(verts), jnp.asarray(valid), jnp.asarray(depth), jcam,
        jnp.asarray(flow), 40.0)
    kernels.reset_launch_counts()
    corr, fl = tsf._slot_correspondence(
        torch.from_numpy(verts), torch.from_numpy(valid),
        torch.from_numpy(depth), _cam_to_port(jcam), torch.from_numpy(flow),
        40.0)
    assert kernels.launch_counts()["row_gather"] == 0  # no kernel on the CPU
    assert 50 < int(corr.sum()) < int(valid.sum())
    np.testing.assert_array_equal(corr.numpy(), np.asarray(want_corr))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(want_flow))


@pytest.mark.parametrize("layout", ["dense", "masked"])
@pytest.mark.parametrize("at", [(0.0, 0.0, -200.0), (600.0, 0.0, 150.0)],
                         ids=["frontal", "rotated"])
def test_update_deformation_matches_jax(layout, at):
    """Both soup layouts, the frontal camera and the rotated one of
    tests/test_scenefusion.py:424, a flow that varies by pixel."""
    jvol, jcam, depth = _sphere_setup(at)
    flow = _flow([25.0, -5.0, 3.0], np.random.default_rng(7))
    if layout == "dense":
        jsoup = jax_extract_surface(jvol, max_cubes=MAX_CUBES,
                                    max_vertices=1 << 16)
    else:
        jsoup = _jax_masked(jvol)
    want, n_want = jsf.update_deformation(
        jvol, jsoup, jnp.asarray(depth), jcam, jnp.asarray(flow),
        tpu_safe=False)
    tvol = _to_port(jvol)
    tsoup = extract_surface(tvol, max_cubes=MAX_CUBES, max_vertices=1 << 16,
                            layout=layout)
    got, n_got = tsf.update_deformation(
        tvol, tsoup, torch.from_numpy(depth), _cam_to_port(jcam),
        torch.from_numpy(flow))
    assert n_got.dtype == torch.int32 and n_got.dim() == 0
    assert int(n_got) == int(n_want) > 100
    assert int(n_got) < int(tsoup.valid.sum())  # the visible side only
    np.testing.assert_allclose(got.deform.numpy(), np.asarray(want.deform),
                               rtol=0, atol=1e-4)
    delta = (got.deform - tvol.deform).numpy()
    assert (np.abs(delta[..., 0]) > 1.0).sum() > 100
    assert delta[..., 0].max() <= 27.0 + 1e-3
    assert got.tsdf is tvol.tsdf  # only the field is replaced
    # the port's update on the JAX soup: the same field again
    again, n_again = tsf.update_deformation(
        tvol, _soup_to_port(jsoup), torch.from_numpy(depth),
        _cam_to_port(jcam), torch.from_numpy(flow))
    assert int(n_again) == int(n_want)
    np.testing.assert_allclose(again.deform.numpy(), np.asarray(want.deform),
                               rtol=0, atol=1e-4)


def test_update_deformation_matches_the_cube_corner_factoring():
    """The port has one ``update_deformation``; the JAX package's TPU
    factoring of the same math (``update_deformation_cubes``: slot
    contributions folded onto cube corners, per-edge correspondences) gives
    the same field."""
    jvol, jcam, depth = _sphere_setup()
    flow = _flow([25.0, -5.0, 3.0])
    jsoup, (cid, edge_idx, cube_valid, edge_verts) = _extract_arrays(
        jvol.tsdf, jvol.voxel_size, jvol.offset, max_cubes=MAX_CUBES,
        max_vertices=1, layout="masked", tpu_safe=True,
        return_cube_slots=True, return_edge_verts=True)
    want, n_want = jsf.update_deformation_cubes(
        jvol, jsoup, cid, edge_idx, cube_valid, jnp.asarray(depth), jcam,
        jnp.asarray(flow), edge_verts=edge_verts)
    tvol = _to_port(jvol)
    got, n_got = tsf.update_deformation(
        tvol, extract_surface(tvol, max_cubes=MAX_CUBES, layout="masked"),
        torch.from_numpy(depth), _cam_to_port(jcam), torch.from_numpy(flow))
    assert int(n_got) == int(n_want) > 100
    np.testing.assert_allclose(got.deform.numpy(), np.asarray(want.deform),
                               rtol=0, atol=1e-4)


def test_update_deformation_is_deterministic_across_thread_counts():
    """The promise of deterministic sums: the same bits from one thread and
    from four, run after run."""
    jvol, jcam, depth = _sphere_setup()
    tvol, cam = _to_port(jvol), _cam_to_port(jcam)
    flow = torch.from_numpy(_flow([25.0, -5.0, 3.0], np.random.default_rng(9)))
    soup = extract_surface(tvol, max_cubes=MAX_CUBES, layout="masked")
    first, _ = tsf.update_deformation(tvol, soup, torch.from_numpy(depth), cam, flow)
    assert not torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(4)
    try:
        for _ in range(3):
            again, _ = tsf.update_deformation(
                tvol, soup, torch.from_numpy(depth), cam, flow)
            assert torch.equal(again.deform, first.deform)
    finally:
        torch.set_num_threads(1)
    assert not torch.are_deterministic_algorithms_enabled()


# -- the frame step and the orchestrator --------------------------------------------


def test_frame_step_matches_sf_step_pallas():
    """extract masked -> update -> integrate at the deformed centres, vs
    the JAX fused step with ``tpu_safe=False`` (its warped Pallas kernel in
    interpret mode, miss 0)."""
    jvol, jcam, depth = _sphere_setup()
    flow = _flow([5.0, 0.0, 0.0])
    want, miss, _mask, n_want, overflow = jsf._sf_step_pallas(
        jvol, jnp.asarray(depth), jnp.asarray(flow), jcam,
        max_cubes=MAX_CUBES, nk=5, threshold_mm=10.0, tpu_safe=False)
    assert int(miss) == 0 and not bool(overflow)
    tvol = _to_port(jvol)
    got, n_got, over = tsf.scenefusion_step(
        tvol, torch.from_numpy(depth), torch.from_numpy(flow),
        _cam_to_port(jcam), max_cubes=MAX_CUBES, threshold_mm=10.0)
    assert int(n_got) == int(n_want) > 100 and not bool(over)
    assert over.dtype == torch.bool and over.dim() == 0
    np.testing.assert_allclose(got.deform.numpy(), np.asarray(want.deform),
                               rtol=0, atol=1e-4)
    assert float(got.weight.sum()) > 1000
    _assert_gate(got.tsdf.numpy(), got.weight.numpy(), want)
    _, _, over = tsf.scenefusion_step(
        _to_port(jvol), torch.from_numpy(depth), torch.from_numpy(flow),
        _cam_to_port(jcam), max_cubes=700)
    assert bool(over)


def _write_pdflow(path, h, w, flow_mm):
    ys, xs = np.mgrid[0:h, 0:w]
    fx_, fy_, fz_ = (v / 1000.0 for v in flow_mm)
    rows = np.stack([ys.ravel(), xs.ravel(), np.full(h * w, fz_),
                     np.full(h * w, fx_), np.full(h * w, fy_)], axis=1)
    np.savetxt(path, rows, fmt=["%d", "%d", "%.6f", "%.6f", "%.6f"])


def _write_sequence(root, n_frames, n_flows=None):
    """An RGBD + PD-Flow directory: the rendered sphere, every frame the
    same depth, a uniform +x flow of 4 + i mm."""
    _, _, depth = _sphere_setup()
    os.makedirs(root, exist_ok=True)
    for i in range(n_frames):
        save_png(os.path.join(root, f"depth_{i:05d}.png"), depth.astype(np.uint16))
        save_png(os.path.join(root, f"colour_{i:05d}.png"),
                 np.zeros((H, W, 3), np.uint8))
    for i in range(n_frames if n_flows is None else n_flows):
        _write_pdflow(os.path.join(root, f"sflow_{i:05d}_results01.txt"),
                      H, W, (4.0 + i, 0.0, 0.0))
    return str(root)


def _port_run(data, **kw):
    sfa = sceneflow.PDSFMockSceneFlow(data)
    assert sfa.init()
    rgbd = mock_kinect.MockKinect(data)
    rgbd.initialise()
    cfg = tsf.SceneFusionConfig(
        volume_size=(48, 48, 48), physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0), max_cubes=MAX_CUBES,
        max_vertices=1 << 16)
    sf = tsf.SceneFusion(sfa, rgbd, cfg, camera=_cam_to_port(_jax_cam()),
                         device=CPU, **kw)
    return sf, rgbd


def test_scenefusion_three_frames_through_both_packages(tmp_path):
    data = _write_sequence(tmp_path / "data", 3)
    jsfa = jax_sceneflow.PDSFMockSceneFlow(data)
    assert jsfa.init()
    jdev = jax_mock_kinect.MockKinect(data)
    jdev.initialise()
    jcfg = jsf.SceneFusionConfig(
        volume_size=(48, 48, 48), physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0), max_cubes=MAX_CUBES,
        max_cubes_fast=MAX_CUBES, max_vertices=1 << 16, prewarm_fallback=False)
    jout = jsf.SceneFusion(jsfa, jdev, jcfg, camera=_jax_cam(), dump_every=2,
                           dump_dir=str(tmp_path / "jdumps"))
    jdev.start()

    sf, rgbd = _port_run(data, dump_every=2, dump_dir=str(tmp_path / "dumps"))
    assert sf.volume.deform is not None and sf.volume.deform.is_contiguous()
    kernels.reset_launch_counts()
    rgbd.start()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert sf.frame_index == jout.frame_index == 3
    assert len(sf.correspondence_counts) == 2
    assert all(int(n) > 100 for n in sf.correspondence_counts)
    np.testing.assert_allclose(sf.volume.deform.numpy(),
                               np.asarray(jout.volume.deform), rtol=0, atol=1e-4)
    assert float(sf.volume.weight.max()) == 3.0
    _assert_gate(sf.volume.tsdf.numpy(), sf.volume.weight.numpy(), jout.volume)
    # the front cap moved by 4 mm + 5 mm in x (the first flow file is read
    # for the second frame), and nothing moved in y or z
    delta = (sf.volume.deform - sf.volume.voxel_centres()).numpy()
    assert abs(delta[..., 0].max() - 9.0) < 1e-3
    assert np.abs(delta[..., 1:]).max() < 1e-3
    assert sorted(os.listdir(tmp_path / "dumps")) == sorted(
        os.listdir(tmp_path / "jdumps")) == [
        "frame_000.tsdf", "frame_002.tsdf", "mesh_canonical_000.ply",
        "mesh_canonical_002.ply", "mesh_warped_000.ply", "mesh_warped_002.ply"]
    canon, tris = read_ply(str(tmp_path / "dumps" / "mesh_canonical_002.ply"))
    warped, wtris = read_ply(str(tmp_path / "dumps" / "mesh_warped_002.ply"))
    np.testing.assert_array_equal(tris, wtris)
    shift = warped - canon
    assert abs(shift[:, 0].max() - 9.0) < 0.5 and np.abs(shift[:, 1:]).max() < 1e-2
    soup = sf.extract_mesh()
    assert int(soup.n_vertices) == int(jout.extract_mesh().n_vertices) > 1000


def test_scenefusion_exhausted_flow_overflow_warning_and_mesh(tmp_path):
    data = _write_sequence(tmp_path / "data", 3, n_flows=1)
    sf, rgbd = _port_run(data)
    with pytest.raises(RuntimeError, match="exhausted after 1 files"):
        rgbd.start()
    assert sf.frame_index == 2

    two = _write_sequence(tmp_path / "two", 2)
    sf, rgbd = _port_run(two)
    sf.config = dataclasses.replace(sf.config, max_cubes=700)
    with pytest.warns(UserWarning, match=r"frame 1: occupied cubes exceed "
                                         r"max_cubes=700"):
        rgbd.start()

    # on a mesh (one gloo rank in this process) the class runs, and its
    # overflow warns with the same message; a mesh on another device than
    # device= is refused
    def on_a_mesh(dev):
        from tsdf_tpu_torch.parallel import make_mesh

        sf, rgbd = _port_run(two, mesh=make_mesh(1, 1, device=dev))
        sf.config = dataclasses.replace(sf.config, max_cubes=700)
        with pytest.warns(UserWarning, match=r"frame 1: occupied cubes "
                                             r"exceed max_cubes=700"):
            rgbd.start()
        return sf.frame_index, type(sf.volume).__name__

    assert launch(on_a_mesh, 1, backend="gloo", device="cpu") == [
        (2, "SlabVolume")]
    with pytest.raises(ValueError, match="not the mesh's device"):
        _port_run(data, mesh=SimpleNamespace(device=torch.device("meta")))


# -- host I/O -------------------------------------------------------------------------


def test_readers_and_mocks_match_the_jax_package(tmp_path):
    p = tmp_path / "sflow_00001_results01.txt"
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[0:4, 0:6]
    rows = np.concatenate([np.stack([ys.ravel(), xs.ravel()], 1),
                           rng.uniform(-0.05, 0.05, (24, 3))], axis=1)
    np.savetxt(p, rows, fmt=["%d", "%d", "%.7f", "%.7f", "%.7f"])
    flow = sceneflow.read_pdflow(str(p))
    assert flow.shape == (4, 6, 3) and flow.dtype == np.float32
    np.testing.assert_array_equal(flow, jax_sceneflow.read_pdflow(str(p)))
    np.testing.assert_allclose(flow[2, 3], rows[15, [3, 4, 2]] * 1000.0, atol=1e-3)

    x = tmp_path / "sflow_00000.xml"
    x.write_text("""<root>
      <Translation><data>1 2 3</data></Translation>
      <Rotation><data>0.1 0.2 0.3</data></Rotation>
      <SFx><rows>2</rows><cols>3</cols><data>1 2 3 4 5 6</data></SFx>
      <SFy><rows>2</rows><cols>3</cols><data>0 0 0 0 0 0</data></SFy>
      <SFz><rows>2</rows><cols>3</cols><data>9 9 9 9 9 9</data></SFz>
    </root>""")
    for got, want in zip(sceneflow.read_srsf_xml(str(x)),
                         jax_sceneflow.read_srsf_xml(str(x))):
        np.testing.assert_array_equal(got, want)
    assert sceneflow.read_srsf_xml(str(x))[2][1, 2].tolist() == [6.0, 0.0, 9.0]

    srsf = sceneflow.SRSFMockSceneFlow(str(tmp_path))
    pdsf = sceneflow.PDSFMockSceneFlow(str(tmp_path))
    assert srsf.init() and pdsf.init()
    assert [os.path.basename(f) for f in srsf.files] == ["sflow_00000.xml"]
    assert [os.path.basename(f) for f in pdsf.files] == [p.name]
    t, r, f = pdsf.compute_scene_flow()
    assert t.tolist() == r.tolist() == [0.0, 0.0, 0.0] and f.shape == (4, 6, 3)
    with pytest.raises(RuntimeError, match="exhausted"):
        pdsf.compute_scene_flow()

    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(2):
        save_png(frames / f"depth_{i:05d}.png", np.full((8, 8), 1000 + i, np.uint16))
        save_png(frames / f"colour_{i:05d}.png", np.full((8, 8, 3), i, np.uint8))
    got, want = [], []
    for mod, sink in ((mock_kinect, got), (jax_mock_kinect, want)):
        dev = mod.MockKinect(str(frames))
        dev.initialise()
        dev.add_observer(lambda d, c, sink=sink: sink.append((d, c)))
        dev.start()
    assert len(got) == 2 and got[1][0][0, 0] == 1001 and got[1][1].shape == (8, 8, 3)
    for (d, c), (jd, jc) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(c, jc)
    os.remove(frames / "colour_00001.png")
    dev = mock_kinect.MockKinect(str(frames))
    with pytest.raises(ValueError, match="no matching colour"):
        dev.initialise()


# -- the CLI ----------------------------------------------------------------------------


def test_cli_sfusion_on_cpu_matches_the_jax_cli(tmp_path, capsys):
    data = _write_sequence(tmp_path / "data", 3)
    mesh = str(tmp_path / "mesh.ply")
    kernels.reset_launch_counts()
    rc = torch_main(["sfusion", data, data, *SMALL, "--mesh", mesh,
                     "--device", "cpu", *CAM_ARGS])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    verts, tris = read_ply(mesh)
    assert len(verts) > 1000 and len(tris) * 3 == len(verts)
    assert out == ["processed 3 frames", f"wrote {mesh} ({len(verts)} vertices)"]

    jmesh = str(tmp_path / "jmesh.ply")
    jax_main(["sfusion", data, data, *SMALL, "--mesh", jmesh, *CAM_ARGS])
    jout = capsys.readouterr().out.splitlines()
    jverts, jtris = read_ply(jmesh)
    assert jout == ["processed 3 frames", f"wrote {jmesh} ({len(jverts)} vertices)"]
    # the meshes are of volumes equal under the integrate gate: the same
    # surface, a sliver voxel may add or drop a triangle
    assert abs(len(jverts) - len(verts)) <= 0.01 * len(verts)
    np.testing.assert_allclose(verts.mean(0), jverts.mean(0), atol=0.5)


def test_cli_sfusion_refusals(tmp_path, capsys):
    data = _write_sequence(tmp_path / "data", 2)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert torch_main(["sfusion", data, data, "--devices", "2x1",
                       "--device", "cpu"]) == 1
    assert "divisible" in capsys.readouterr().err
    assert torch_main(["sfusion", data, str(empty), "--device", "cpu"]) == 1
    assert capsys.readouterr().err == (
        f"no scene-flow files found in {empty}\n")
    assert torch_main(["sfusion", data, data, "--flow-format", "srsf",
                       "--device", "cpu"]) == 1
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            torch_main(["sfusion", data, data, *SMALL, *CAM_ARGS])
