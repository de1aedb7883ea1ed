"""The port's sharded SceneFusion parts (``tsdf_tpu_torch.parallel``:
``update_deformation_sharded``, ``scenefusion_frame_sharded``,
``warped_topup_sharded``) on four gloo ranks on the CPU, against the JAX
package's on the virtual 8-device mesh of tests/conftest.py at the same
mesh shapes (4x1, 2x2), and against the port's single-volume update.

The scenes, cameras and frames are those of tests/test_parallel_extra.py
(:97, :146, :247, :305), built with the JAX package's fixtures and handed
to both packages as numpy arrays. The top-up takes JAX's output slab and
its miss mask (``_integrate_warped_sharded_mask_jit``, interpret mode, on
the JAX mesh of the same shape) as numpy. Ranks are spawned as in
tests/test_torch_parallel.py, once a mesh shape, and import no JAX.

Tolerances, those of the JAX tests:
  * the deformation update against JAX's (sharded and single):
    correspondence count equal, deform within 1e-4 mm, more than 100
    surface voxels moved by more than 1 mm;
  * the SceneFusion frame against JAX's single chain: correspondence count
    equal, deform within 1e-4 mm, tsdf within 1e-3 mm, weights within 1e-5;
  * the top-up against JAX's plain integrate of the whole deformed volume:
    weights equal, tsdf within 5e-3 mm, nothing remaining; with a cap of 8
    voxels a brick, something remains (as many as in JAX).
The port's own gates: two runs of the sharded update are bit-equal, and
the update is within 1e-4 mm of the port's single-volume update with the
same correspondence count.
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.parallel.distributed import launch

SHAPES = {"4x1": (4, 1), "2x2": (2, 2)}
W, H = 160, 120
CUBES = 1 << 12
TOPUP_CAP = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam_numpy(cam) -> dict:
    return {f: np.asarray(getattr(cam, f)) for f in ("k", "pose", "k_inv", "pose_inv")}


def _sphere_scene(at):
    """tests/test_parallel_extra.py's deformed 48^3 sphere, its camera at
    ``at`` and the frame that camera renders."""
    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.utils import fixtures

    vol = make_volume((48, 48, 48), 1500.0, offset=(-750.0, -750.0, 0.0),
                      with_deformation=True)
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
           .move_to(at).look_at([0.0, 0.0, 750.0]))
    return vol, cam, render_to_depth_image(vol, cam, width=W, height=H)


def _warped_scene():
    """tests/test_parallel_extra.py:247's 32^3 volume, deformed by +-60 mm
    alternating with y (misses for the line-sweep kernel at nk=3)."""
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.utils import fixtures

    vol = make_volume((32, 32, 32), 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      with_deformation=True)
    y = jnp.arange(32, dtype=jnp.float32)[None, :, None]
    dx = 60.0 * jnp.where(y % 2 == 0, 1.0, -1.0)
    zero = jnp.zeros(vol.deform.shape[:-1])
    disp = jnp.stack([jnp.broadcast_to(dx, vol.deform.shape[:-1]), zero, zero],
                     axis=-1)
    vol = vol.replace(deform=vol.deform + disp)
    cam = (Camera.default_depth_camera().move_to([0.0, 0.0, -500.0])
           .look_at([0.0, 0.0, 1000.0]))
    depth = jnp.asarray(fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0),
                        jnp.float32)
    return vol, cam, depth


def _volume_numpy(vol) -> dict:
    return {f: np.asarray(getattr(vol, f)) for f in (
        "tsdf", "weight", "deform", "physical_size", "offset",
        "truncation_distance", "max_weight")}


def _jax_mesh(shape):
    import jax

    from tsdf_tpu.parallel import make_mesh

    nb, nr = SHAPES[shape]
    return make_mesh(n_bricks=nb, n_rays=nr, devices=jax.devices()[:nb * nr])


@pytest.fixture(scope="module")
def inputs():
    scenes = {}
    for name, at in (("update", [100.0, -50.0, -200.0]),
                     ("frame", [0.0, 0.0, -200.0])):
        vol, cam, depth = _sphere_scene(at)
        scenes[name] = {"vol": _volume_numpy(vol), "cam": _cam_numpy(cam),
                        "depth": np.asarray(depth, np.float32)}
    scenes["update"]["flow"] = np.broadcast_to(
        np.array([25.0, -5.0, 3.0], np.float32), (H, W, 3)).copy()
    scenes["frame"]["flow"] = np.broadcast_to(
        np.array([8.0, 0.0, 0.0], np.float32), (H, W, 3)).copy()
    vol, cam, depth = _warped_scene()
    scenes["topup"] = {"vol": _volume_numpy(vol), "cam": _cam_numpy(cam),
                       "depth": np.asarray(depth)}
    return scenes


def _jax_topup_inputs(shape, inputs):
    """JAX's warped integrate on its mesh of ``shape`` (interpret mode):
    its output volume, its miss mask and its miss count, as numpy."""
    from tsdf_tpu.parallel.ops import (
        _integrate_warped_sharded_mask_jit,
        shard_volume,
    )

    vol, cam, depth = _warped_scene()
    mesh = _jax_mesh(shape)
    out, miss, mask = _integrate_warped_sharded_mask_jit(
        shard_volume(vol, mesh), depth, cam, mesh=mesh, cap_weight=False,
        nk=3, interpret=True)
    return {"tsdf": np.asarray(out.tsdf), "weight": np.asarray(out.weight),
            "mask": np.asarray(mask), "miss": int(miss)}


# -- what the ranks run -------------------------------------------------------


def _rank_body(dev, nb, nr, inp, topup):
    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, TSDFVolume
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface
    from tsdf_tpu_torch.parallel import (
        make_mesh,
        scenefusion_frame_sharded,
        shard_volume,
        update_deformation_sharded,
    )
    from tsdf_tpu_torch.parallel.ops import unshard_volume, warped_topup_sharded
    from tsdf_tpu_torch.pipelines.scenefusion import update_deformation

    torch.set_num_threads(1)
    mesh = make_mesh(nb, nr, device=dev)
    first = dist.get_rank() == 0
    out = {}

    def scene(name, **replace):
        s = inp[name]
        vol = TSDFVolume.from_numpy(**{**s["vol"], **replace}, device=dev)
        cam = Camera.from_numpy(**s["cam"], device=dev)
        return vol, cam, torch.from_numpy(s["depth"]), s

    def gathered(slab):
        whole = unshard_volume(slab, mesh)
        return None if whole is None else {
            f: getattr(whole, f).numpy() for f in ("tsdf", "weight", "deform")}

    # the deformation update, twice, and the single-volume update
    vol, cam, depth, s = scene("update")
    flow = torch.from_numpy(s["flow"])
    runs = []
    for _ in range(2):
        slab, n_corr = update_deformation_sharded(
            shard_volume(vol, mesh), depth, cam, flow, mesh,
            max_cubes_per_brick=CUBES)
        runs.append((gathered(slab), int(n_corr)))
    soup = extract_surface(vol, max_cubes=1 << 14, layout="masked")
    single, n_single = update_deformation(vol, soup, depth, cam, flow)
    out["update"] = {
        "deform": None if runs[0][0] is None else runs[0][0]["deform"],
        "n_corr": runs[0][1], "again": (
            None if runs[0][0] is None
            else runs[0][1] == runs[1][1]
            and runs[0][0]["deform"].tobytes() == runs[1][0]["deform"].tobytes()),
        "single": single.deform.numpy(), "n_single": int(n_single),
    }

    # one SceneFusion frame
    vol, cam, depth, s = scene("frame")
    slab, n_corr = scenefusion_frame_sharded(
        shard_volume(vol, mesh), depth, cam, torch.from_numpy(s["flow"]), mesh,
        max_cubes_per_brick=CUBES)
    out["frame"] = {"vol": gathered(slab), "n_corr": int(n_corr)}

    # the top-up of JAX's output slab and miss mask
    vol, cam, depth, _ = scene("topup", tsdf=topup["tsdf"],
                               weight=topup["weight"])
    slab = shard_volume(vol, mesh)
    mask = torch.from_numpy(topup["mask"])[slab.z0:slab.z0 + slab.tsdf.shape[0]]
    full, remaining = warped_topup_sharded(slab, mask, depth, cam, mesh)
    _, capped = warped_topup_sharded(slab, mask, depth, cam, mesh,
                                     max_topup_per_brick=TOPUP_CAP)
    out["topup"] = {"vol": gathered(full), "remaining": int(remaining),
                    "capped": int(capped)}
    return out if first else None


@pytest.fixture(scope="module", params=list(SHAPES))
def ranks(request, inputs):
    """(shape, rank 0's results, JAX's top-up inputs) of the four ranks on
    one mesh shape."""
    shape = request.param
    nb, nr = SHAPES[shape]
    topup = _jax_topup_inputs(shape, inputs)
    out = launch(_rank_body, 4, (nb, nr, inputs, topup), backend="gloo",
                 device="cpu")
    return shape, out[0], topup


_JAX = {}


def _jax(shape, name, fn):
    """A JAX result, computed once a mesh shape."""
    if (shape, name) not in _JAX:
        _JAX[shape, name] = fn()
    return _JAX[shape, name]


def _jax_update(shape, inputs):
    """JAX's single and sharded updates of the "update" scene."""
    import jax.numpy as jnp

    from tsdf_tpu.ops.marching_cubes import extract_surface
    from tsdf_tpu.parallel.ops import shard_volume, update_deformation_sharded
    from tsdf_tpu.pipelines.scenefusion import update_deformation

    vol, cam, depth = _sphere_scene([100.0, -50.0, -200.0])
    flow = jnp.asarray(inputs["update"]["flow"])
    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    ref, n_ref = update_deformation(vol, soup, depth, cam, flow, tpu_safe=False)
    mesh = _jax_mesh(shape)
    got, n_got = update_deformation_sharded(
        shard_volume(vol, mesh), depth, cam, flow, mesh,
        max_cubes_per_brick=CUBES, tpu_safe=False)
    return [(np.asarray(ref.deform), int(n_ref)),
            (np.asarray(got.deform), int(n_got))]


# -- the deformation update ----------------------------------------------------


def test_update_deformation_sharded_matches_jax(ranks, inputs):
    """tests/test_parallel_extra.py:97 on the port, against JAX's single
    and sharded updates."""
    shape, got, _ = ranks
    u = got["update"]
    for deform, n_corr in _jax(shape, "update", lambda: _jax_update(shape, inputs)):
        assert u["n_corr"] == n_corr
        np.testing.assert_allclose(u["deform"], deform, atol=1e-4)
    moved = u["deform"] - inputs["update"]["vol"]["deform"]
    assert (np.abs(moved[..., 0]) > 1.0).sum() > 100


def test_update_deformation_sharded_is_the_single_update(ranks):
    """The port's gates: two sharded runs bit-equal; the field within
    1e-4 mm of the port's single-volume update (a voxel on a slab's first
    plane adds its neighbour's sums in another order), the same
    correspondence count."""
    _shape, got, _ = ranks
    u = got["update"]
    assert u["again"]
    assert u["n_corr"] == u["n_single"] > 0
    np.testing.assert_allclose(u["deform"], u["single"], rtol=0, atol=1e-4)


# -- the SceneFusion frame -------------------------------------------------------


def test_scenefusion_frame_sharded_matches_jax(ranks, inputs):
    """tests/test_parallel_extra.py:146 on the port: the frame (the sharded
    update, then the warped integrate of each slab) against JAX's
    single-device chain."""
    import jax.numpy as jnp

    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.marching_cubes import extract_surface
    from tsdf_tpu.pipelines.scenefusion import update_deformation

    shape, got, _ = ranks

    def run():
        vol, cam, depth = _sphere_scene([0.0, 0.0, -200.0])
        soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
        mid, n_ref = update_deformation(
            vol, soup, depth, cam, jnp.asarray(inputs["frame"]["flow"]),
            tpu_safe=False)
        ref = integrate(mid, depth, cam)
        return {f: np.asarray(getattr(ref, f))
                for f in ("tsdf", "weight", "deform")}, int(n_ref)

    want, n_ref = _jax("any", "frame", run)
    f = got["frame"]
    assert f["n_corr"] == n_ref > 0
    np.testing.assert_allclose(f["vol"]["deform"], want["deform"], atol=1e-4)
    np.testing.assert_allclose(f["vol"]["tsdf"], want["tsdf"], atol=1e-3)
    np.testing.assert_allclose(f["vol"]["weight"], want["weight"], atol=1e-5)
    assert f["vol"]["weight"].max() == 2.0  # the frame was fused


# -- the warped top-up ------------------------------------------------------------


def test_warped_topup_sharded_closes_the_fallback(ranks):
    """tests/test_parallel_extra.py:247 on the port: JAX's warped kernel
    missed voxels; the port's top-up of its output slab and mask equals
    JAX's plain integrate of the whole deformed volume."""
    from tsdf_tpu import integrate

    shape, got, topup = ranks
    assert topup["miss"] > 0

    def run():
        vol, cam, depth = _warped_scene()
        ref = integrate(vol, depth, cam)
        return np.asarray(ref.tsdf), np.asarray(ref.weight)

    tsdf, weight = _jax("any", "topup", run)
    t = got["topup"]
    assert t["remaining"] == 0
    np.testing.assert_array_equal(t["vol"]["weight"], weight)
    np.testing.assert_allclose(t["vol"]["tsdf"], tsdf, rtol=0, atol=5e-3)


def test_warped_topup_sharded_cap_reports_remaining(ranks):
    """tests/test_parallel_extra.py:305 on the port: with 8 voxels a brick
    the top-up reports what is left, as many as JAX's with the same cap."""
    from tsdf_tpu.parallel.ops import warped_topup_sharded

    shape, got, topup = ranks

    def run():
        import jax.numpy as jnp

        from tsdf_tpu.parallel.ops import shard_volume

        vol, cam, depth = _warped_scene()
        mesh = _jax_mesh(shape)
        out = shard_volume(vol.replace(tsdf=jnp.asarray(topup["tsdf"]),
                                       weight=jnp.asarray(topup["weight"])),
                           mesh)
        mask = shard_volume(vol.replace(tsdf=jnp.asarray(topup["mask"])),
                            mesh).tsdf
        _, remaining = warped_topup_sharded(out, mask, depth, cam, mesh,
                                            max_topup_per_brick=TOPUP_CAP)
        return int(remaining)

    assert got["topup"]["capped"] > 0
    assert got["topup"]["capped"] == _jax(shape, "capped", run)
