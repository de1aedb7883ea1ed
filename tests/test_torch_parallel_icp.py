"""The port's sharded ICP (``icp_step_sharded``, the sharded pyramid) and
tracked fusion on the mesh, in four gloo ranks on the CPU, against the JAX
package on the virtual 8-device mesh at the same mesh shapes (4x1, 2x2),
and against the single-device loops.

The scenes are tests/test_parallel_icp.py's (a sphere and a wall, depth
frames rendered by JAX's slab sweep in interpret mode) and
tests/test_parallel_extra.py's (random depth); the numpy frames go to both
packages. Ranks are spawned as in tests/test_torch_parallel.py, once a
mesh shape, and import no JAX.

Tolerances, those of the JAX tests:
  * one step: A within rtol 1e-5, b within rtol 1e-5 / atol 1e-2, the
    residual within rtol 1e-5, the inliers equal;
  * the pyramid against the single device: pose within 1e-4, inliers and
    error within 1e-3 (relative); banded against exact: pose within 5e-3;
    the banded pyramid against JAX's, tests/test_torch_icp.py's gate for
    the two packages' pyramids: translation within 0.02 mm, rotation 1e-5;
  * tracked fusion: each pose's translation within 2 mm and rotation
    within 3e-3 of the single-device loop's.
The sums over the mesh add the ranks' partial sums in rank order, so
they differ from the single sums in the last bits only.
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.parallel.distributed import launch

SHAPES = {"4x1": (4, 1), "2x2": (2, 2)}
W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4
STEP_INTR = (60.0, 60.0, 32.0, 24.0)
TRACK_T = (0.0, 0.4, 0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene():
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.utils import fixtures

    vol = make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
    vol = fixtures.sphere_tsdf(vol, 600.0)
    wall = fixtures.wall_tsdf(vol, 2500.0)
    return vol.replace(tsdf=jnp.minimum(vol.tsdf, wall.tsdf),
                       weight=jnp.ones_like(vol.weight))


def _jax_cam(t):
    from tsdf_tpu import Camera

    return (Camera.from_intrinsics(FX, FY, CX, CY)
            .move_to([30.0 * t, -20.0 * t, -500.0])
            .look_at([0.0, 0.0, 1500.0]))


def _depth_of(scene, cam):
    import jax.numpy as jnp

    from tsdf_tpu.kernels.raycast import raycast_pallas

    verts, _ = raycast_pallas(scene, cam, W, H, interpret=True)
    camz = cam.world_to_camera(
        jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
    ).reshape(H, W, 3)[..., 2]
    return np.asarray(jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0),
                      np.float32)


@pytest.fixture(scope="module")
def inputs():
    """The numpy frames and cameras both packages take."""
    scene = _jax_scene()
    ts = sorted({0.0, 0.5, 1.0, *TRACK_T})
    cams = {t: _jax_cam(t) for t in ts}
    rng = np.random.RandomState(0)
    prev = 800.0 + rng.rand(48, 64).astype(np.float32) * 200.0
    curr = prev + rng.randn(48, 64).astype(np.float32) * 2.0
    return {
        "depth": {t: _depth_of(scene, c) for t, c in cams.items()},
        "pose": {t: np.asarray(c.pose) for t, c in cams.items()},
        "k": np.asarray(cams[0.0].k),
        "step": (prev, curr),
    }


def _rank_body(dev, nb, nr, inp):
    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.parallel import (
        get_incremental_transformation_sharded,
        make_mesh,
        shard_volume,
        track_and_fuse_frames_sharded,
    )
    from tsdf_tpu_torch.parallel.ops import icp_step_sharded, unshard_volume
    from tsdf_tpu_torch.tracking.icp import normal_map, vertex_map

    torch.set_num_threads(1)
    mesh = make_mesh(nb, nr, device=dev)
    out = {}

    def t(a):
        return torch.from_numpy(np.asarray(a))

    prev, curr = (t(a) for a in inp["step"])
    vp = vertex_map(prev, *STEP_INTR)
    vc = vertex_map(curr, *STEP_INTR)
    out["step"] = [v.numpy() for v in icp_step_sharded(
        torch.eye(3), torch.zeros(3), vc, normal_map(vc), vp, normal_map(vp),
        STEP_INTR, mesh)]

    intr = torch.tensor([FX, FY, CX, CY], dtype=torch.float32)
    d = inp["depth"]
    for name, curr_t, band in (("exact", 1.0, None), ("half", 0.5, None),
                               ("banded", 0.5, 32)):
        res = get_incremental_transformation_sharded(
            t(d[curr_t]), t(d[0.0]), intr, mesh, band=band)
        out[name] = [v.numpy() for v in res]

    vol = make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0),
                      device=dev)
    cam = Camera.from_numpy(inp["k"], inp["pose"][TRACK_T[0]], device=dev)
    for key, band, filtered in ((None, None, False), (32, 32, False),
                                ("filter", 32, True)):
        slab, _, poses, stats = track_and_fuse_frames_sharded(
            shard_volume(vol, mesh), cam, [t(d[s]) for s in TRACK_T], mesh,
            width=W, height=H, band=band, use_bilateral_filter=filtered)
        out[f"tracked_{key}"] = [p.numpy() for p in poses]
        whole = unshard_volume(slab, mesh)
        if whole is not None and filtered:
            out["tracked_filter_volume"] = (whole.tsdf.numpy(),
                                            whole.weight.numpy())
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module", params=list(SHAPES))
def ranks(request, inputs):
    nb, nr = SHAPES[request.param]
    out = launch(_rank_body, 4, (nb, nr, inputs), backend="gloo",
                 device="cpu")
    return request.param, out[0]


def _jax_mesh(shape):
    import jax

    from tsdf_tpu.parallel import make_mesh

    nb, nr = SHAPES[shape]
    return make_mesh(n_bricks=nb, n_rays=nr, devices=jax.devices()[:nb * nr])


_JAX = {}


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def test_icp_step_sharded_matches_single(ranks, inputs):
    import jax.numpy as jnp

    from tsdf_tpu.tracking.icp import icp_step, normal_map, vertex_map

    _shape, got = ranks

    def run():
        prev, curr = (jnp.asarray(a) for a in inputs["step"])
        vp = vertex_map(prev, *STEP_INTR)
        vc = vertex_map(curr, *STEP_INTR)
        out = icp_step(jnp.eye(3, dtype=jnp.float32),
                       jnp.zeros(3, jnp.float32), vc, normal_map(vc), vp,
                       normal_map(vp), *STEP_INTR)
        return [np.asarray(v) for v in out]

    a0, b0, r0, i0 = _jax("step", run)
    a1, b1, r1, i1 = got["step"]
    np.testing.assert_allclose(a1, a0, rtol=1e-5)
    np.testing.assert_allclose(b1, b0, rtol=1e-5, atol=1e-2)
    assert float(i1) == float(i0)
    np.testing.assert_allclose(float(r1), float(r0), rtol=1e-5)


def _hold_pyramid(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-3,
                               atol=1e-3)


def test_sharded_pyramid_matches_single_device(ranks, inputs):
    """The port's sharded pyramid against JAX's single-device pyramid and
    JAX's sharded pyramid on the same mesh shape, and against the port's
    own single-device pyramid."""
    import jax.numpy as jnp

    from tsdf_tpu.parallel import get_incremental_transformation_sharded
    from tsdf_tpu.tracking.icp import get_incremental_transformation
    from tsdf_tpu_torch.tracking import icp

    shape, got = ranks
    d = inputs["depth"]
    d0, d1 = jnp.asarray(d[0.0]), jnp.asarray(d[1.0])
    ref = _jax("pyramid", lambda: [np.asarray(v) for v in
                                   get_incremental_transformation(
                                       d1, d0, FX, FY, CX, CY)])
    _hold_pyramid(got["exact"], ref)
    sharded = _jax(("pyramid", shape), lambda: [
        np.asarray(v) for v in get_incremental_transformation_sharded(
            d1, d0, jnp.asarray([FX, FY, CX, CY], jnp.float32),
            _jax_mesh(shape))])
    _hold_pyramid(got["exact"], sharded)
    mine = icp.get_incremental_transformation(
        torch.tensor(d[1.0]), torch.tensor(d[0.0]), FX, FY, CX, CY)
    _hold_pyramid(got["exact"], [v.numpy() for v in mine])


def test_sharded_pyramid_banded_matches_exact(ranks, inputs):
    """The banded association (its lookups through the lane-gather
    wrapper, each rank's rows from their row offset) against the exact
    one, and against JAX's sharded banded pyramid."""
    import jax.numpy as jnp

    from tsdf_tpu.parallel import get_incremental_transformation_sharded

    shape, got = ranks
    np.testing.assert_allclose(got["banded"][0], got["half"][0], rtol=0,
                               atol=5e-3)
    d = inputs["depth"]
    want = _jax(("banded", shape), lambda: np.asarray(
        get_incremental_transformation_sharded(
            jnp.asarray(d[0.5]), jnp.asarray(d[0.0]),
            jnp.asarray([FX, FY, CX, CY], jnp.float32), _jax_mesh(shape),
            band=32).pose))
    # port against JAX: tests/test_torch_icp.py's gate for the pyramid
    assert np.linalg.norm(got["banded"][0][:3, 3] - want[:3, 3]) < 0.02
    np.testing.assert_allclose(got["banded"][0][:3, :3], want[:3, :3],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("band", [None, 32])
def test_tracked_fusion_on_mesh_matches_single(ranks, inputs, band):
    """``track_and_fuse_frames_sharded`` (the bricked model render, the
    sharded pyramid, exact or banded, the sharded integrate) against the
    single-device loops of both packages."""
    from tsdf_tpu import make_volume as jax_make_volume
    from tsdf_tpu.pipelines import FusionConfig as JaxConfig
    from tsdf_tpu.pipelines import track_and_fuse_frames as jax_track
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.pipelines.kinfu import (
        FusionConfig,
        track_and_fuse_frames,
    )

    _shape, got = ranks
    frames = [inputs["depth"][s] for s in TRACK_T]

    def run_jax():
        vol = jax_make_volume((64,) * 3, 3000.0,
                              offset=(-1500.0, -1500.0, 0.0))
        cfg = JaxConfig(width=W, height=H, volume_size=(64,) * 3)
        _, _, poses, _ = jax_track(vol, _jax_cam(TRACK_T[0]), frames, cfg)
        return [np.asarray(p) for p in poses]

    cpu = torch.device("cpu")
    vol = make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0),
                      device=cpu)
    cam = Camera.from_numpy(inputs["k"], inputs["pose"][TRACK_T[0]],
                            device=cpu)
    cfg = FusionConfig(width=W, height=H, volume_size=(64,) * 3,
                       icp_band=band or 0)
    _, _, mine, _ = track_and_fuse_frames(
        vol, cam, [torch.tensor(f) for f in frames], cfg)
    poses = got[f"tracked_{band}"]
    assert len(poses) == len(TRACK_T)
    for refs in (_jax("tracked", run_jax), [p.numpy() for p in mine]):
        for pm, pr in zip(poses, refs):
            np.testing.assert_allclose(pm[:3, 3], pr[:3, 3], atol=2.0)
            np.testing.assert_allclose(pm[:3, :3], pr[:3, :3], atol=3e-3)


def test_tracked_fusion_on_mesh_with_the_filter_fuses_the_raw_depth(ranks,
                                                                   inputs):
    """With the bilateral filter, the sharded loop's filtered depth feeds
    the tracker only and the raw depth is fused, as in the single-device
    loop of either package (the JAX sharded loop fuses the filtered
    depth): poses within the tracked gates of the port's single-device
    loop with the filter, and the gathered slabs bit-equal with the raw
    frames fused at the loop's own poses (the filtered frames fuse
    otherwise)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.pipelines.kinfu import (
        FusionConfig,
        fuse_frames,
        track_and_fuse_frames,
    )

    _shape, got = ranks
    frames = [torch.tensor(inputs["depth"][s]) for s in TRACK_T]
    cpu = torch.device("cpu")

    def volume():
        return make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0),
                           device=cpu)

    cam = Camera.from_numpy(inputs["k"], inputs["pose"][TRACK_T[0]],
                            device=cpu)
    cfg = FusionConfig(width=W, height=H, volume_size=(64,) * 3,
                       icp_band=32, use_bilateral_filter=True)
    _, _, mine, _ = track_and_fuse_frames(volume(), cam, frames, cfg)
    poses = got["tracked_filter"]
    assert len(poses) == len(TRACK_T)
    for pm, pr in zip(poses, [p.numpy() for p in mine]):
        np.testing.assert_allclose(pm[:3, 3], pr[:3, 3], atol=2.0)
        np.testing.assert_allclose(pm[:3, :3], pr[:3, :3], atol=3e-3)

    tsdf, weight = got["tracked_filter_volume"]
    replays = {}
    for filtered in (False, True):
        vol, _ = fuse_frames(
            volume(), cam, zip(frames, [torch.tensor(p) for p in poses]),
            FusionConfig(volume_size=(64,) * 3, use_bilateral_filter=filtered))
        replays[filtered] = (vol.tsdf.numpy(), vol.weight.numpy())
    np.testing.assert_array_equal(tsdf.view(np.int32),
                                  replays[False][0].view(np.int32))
    np.testing.assert_array_equal(weight, replays[False][1])
    assert not np.array_equal(tsdf, replays[True][0])
