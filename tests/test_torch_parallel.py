"""The port's sharded fusion and raycasts (``tsdf_tpu_torch.parallel``) on
four gloo ranks on the CPU, against the JAX package's on the virtual
8-device mesh of tests/conftest.py, at the same mesh shapes (4x1, 2x2).

The same numpy inputs (the JAX tests' scenes, cameras and frames) go
through ``tsdf_tpu.parallel`` in this process and through the port in four
spawned ranks (``parallel.distributed.launch``, a FileStore under a
temporary directory, the launcher's group and join timeouts, so that a
deadlock fails a test instead of hanging it). Each rank runs every case
once a mesh shape; rank 0 returns what the tests compare. A rank imports
neither JAX nor tests/conftest.py: JAX is imported inside the tests.

Tolerances, those of tests/test_parallel.py and test_parallel_extra.py:
  * integrate against JAX's Pallas path: tsdf within 5e-3 mm, weights
    equal; against its lax path (and on a deformed volume): 1e-4 mm;
    colour within 1;
  * raycast_sharded against JAX's: vertices within 1e-2 mm, normals 1e-4;
  * the bricked raycast against the single-card render (JAX's slab sweep,
    and the port's own render): hit agreement > 0.999, median vertex
    distance < 0.5 mm, 99th percentile < 2 mm;
  * the halo: equal.
The port's own gates: the gathered slabs of ``integrate_sharded`` equal the
single-volume twin's tsdf, weight and colour bit for bit in every mode,
with colour, in bfloat16 and on a deformed volume, after two frames; the
rows of ``raycast_sharded`` equal the single-card render's bit for bit.
The gradient through the sharded integrate (tests/test_parallel.py:110)
is held in tests/test_torch_parallel_surface.py. The entry points take the
card unless asked for the CPU: with no card, ``make_mesh()``, ``launch`` and
``initialize`` raise.
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.parallel.distributed import launch

SHAPES = {"4x1": (4, 1), "2x2": (2, 2)}
W, H = 160, 120
INTR_SMALL = (591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4)
BRICKED_VIEWS = {
    "oblique": ([150.0, -100.0, -600.0], [0.0, 0.0, 1000.0]),
    "reverse": ([0.0, 0.0, 2600.0], [0.0, 0.0, 1000.0]),
    "-x": ([2600.0, 100.0, 1000.0], [0.0, 0.0, 1000.0]),
    "+x": ([-2600.0, 0.0, 900.0], [0.0, 0.0, 1000.0]),
    "-y": ([100.0, 2600.0, 1000.0], [0.0, 0.0, 1000.0]),
    "+y": ([0.0, -2600.0, 1100.0], [0.0, 0.0, 1000.0]),
}
# name -> (volume, frame, mode, storage) of the integrate cases
INTEGRATE_CASES = {
    "exact": ("plain", "sphere", "exact", "float32"),
    "line": ("plain", "sphere", "line", "float32"),
    "fast": ("plain", "sphere", "fast", "float32"),
    "bf16": ("plain", "sphere", "line", "bfloat16"),
    "deformed": ("deformed", "sphere", "line", "float32"),
    "color": ("color", "color", "exact", "float32"),
    "color_fast": ("color", "color", "fast", "float32"),
}
VOLUMES = {
    "plain": dict(size=(32, 32, 32), physical_size=2000.0,
                  offset=(-1000.0, -1000.0, 0.0)),
    "deformed": dict(size=(32, 32, 32), physical_size=2000.0,
                     offset=(-1000.0, -1000.0, 0.0), with_deformation=True),
    "color": dict(size=(32, 32, 32), physical_size=1500.0,
                  offset=(-750.0, -750.0, 0.0), with_color=True),
}


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


def _jax_cameras():
    from tsdf_tpu import Camera

    cams = {
        "sphere": Camera.default_depth_camera()
        .move_to([0.0, 0.0, -500.0]).look_at([0.0, 0.0, 1000.0]),
        "color": Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([50.0, -30.0, -300.0]).look_at([0.0, 0.0, 750.0]),
        "divisible": Camera.from_intrinsics(147.8, 147.5, 16.0, 12.0)
        .move_to([0.0, 0.0, -600.0]).look_at([0.0, 0.0, 1000.0]),
    }
    for name, (pos, target) in BRICKED_VIEWS.items():
        cams[name] = (Camera.from_intrinsics(*INTR_SMALL).move_to(pos)
                      .look_at(target))
    return cams


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs of both packages (built with the JAX package's
    fixtures, as its tests build them)."""
    from tsdf_tpu import make_volume
    from tsdf_tpu.utils import fixtures

    cams = _jax_cameras()
    spheres = {}
    for key, size in (("s32", (32,) * 3), ("s64", (64,) * 3),
                      ("s51", (51, 51, 48))):
        vol = make_volume(size, 2000.0, offset=(-1000, -1000, 0))
        spheres[key] = np.asarray(fixtures.sphere_tsdf(vol, 400.0).tsdf)
    return {
        "cams": {k: _cam_numpy(c) for k, c in cams.items()},
        "frames": {
            "sphere": np.asarray(
                fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0),
                np.float32),
            "color": np.asarray(
                fixtures.sphere_depth_map(160, 120, 60.0, 600.0, 1200.0),
                np.float32),
        },
        "rgb": np.random.RandomState(3).randint(
            0, 256, size=(120, 160, 3)).astype(np.uint8),
        "spheres": spheres,
    }


# -- what the ranks run -------------------------------------------------------


def _single_fuse(vol, depth, cam, mode, rgb):
    """One frame into a whole volume through the wrapper the sharded
    integrate routes the frame to (the plain twins on the CPU)."""
    from tsdf_tpu_torch.kernels import integrate as k

    if rgb is not None:
        return k.integrate_color_cuda(vol, depth, rgb, cam, mode=mode)[0]
    if vol.deform is not None:
        return k.integrate_warped_cuda(vol, depth, cam)
    if mode == "fast":
        return k.integrate_fast_cuda(vol, depth, cam)[0]
    return k.integrate_cuda(vol, depth, cam)


def _arrays(vol) -> dict:
    return {f: (None if getattr(vol, f) is None
                else getattr(vol, f).float().numpy() if f != "color"
                else getattr(vol, f).numpy())
            for f in ("tsdf", "weight", "color")}


def _rank_body(dev, nb, nr, inp):
    import dataclasses

    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.parallel import (
        integrate_sharded,
        make_mesh,
        raycast_sharded,
        raycast_sharded_bricked,
        shard_volume,
    )
    from tsdf_tpu_torch.parallel.halo import halo_exchange_z
    from tsdf_tpu_torch.parallel.mesh import all_gather
    from tsdf_tpu_torch.parallel.ops import unshard_volume

    torch.set_num_threads(1)
    mesh = make_mesh(nb, nr, device=dev)
    first = dist.get_rank() == 0
    cams = {k: Camera.from_numpy(**c, device=dev) for k, c in inp["cams"].items()}
    out = {"integrate": {}, "bricked": {}}

    for name, (vkind, frame, mode, storage) in INTEGRATE_CASES.items():
        kw = dict(VOLUMES[vkind], dtype=getattr(torch, storage))
        size = kw.pop("size")
        ps = kw.pop("physical_size")
        vol = make_volume(size, ps, device=dev, **kw)
        whole = dataclasses.replace(vol, **{
            f: getattr(vol, f).clone() for f in ("tsdf", "weight", "color")
            if getattr(vol, f) is not None})
        depth = torch.from_numpy(inp["frames"][frame])
        rgb = torch.from_numpy(inp["rgb"]) if vkind == "color" else None
        cam = cams[frame]
        slab = shard_volume(vol, mesh)
        case = {}
        for i in range(2):  # the second frame blends into the first
            slab, miss = integrate_sharded(slab, depth, cam, mesh, mode=mode,
                                           rgb=rgb, return_miss=True)
            whole = _single_fuse(whole, depth, cam, mode, rgb)
            got = unshard_volume(slab, mesh)
            if first:
                case[f"frame{i}"] = _arrays(got)
                case[f"equal{i}"] = all(
                    (a is None and b is None) or torch.equal(a, b)
                    for a, b in ((got.tsdf, whole.tsdf),
                                 (got.weight, whole.weight),
                                 (got.color, whole.color)))
                case["miss"] = int(miss)
        out["integrate"][name] = case

    # the replicated raycast, rows against the single render
    vol = make_volume((32,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = vol.replace(tsdf=torch.from_numpy(inp["spheres"]["s32"]).clone())
    slab = shard_volume(vol, mesh)
    with pytest.raises(ValueError, match="replicate_volume_ok"):
        raycast_sharded(slab, cams["sphere"], mesh, width=64, height=48)
    verts, normals = raycast_sharded(slab, cams["sphere"], mesh, width=64,
                                     height=48, replicate_volume_ok=True)
    ref = raycast_vertices_cuda(vol, cams["sphere"], 64, 48)
    out["raycast_sharded"] = {
        "verts": verts.numpy(), "normals": normals.numpy(),
        "equal": torch.equal(torch.nan_to_num(verts, 1e30),
                             torch.nan_to_num(ref, 1e30))}

    # the bricked raycast from every view
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = vol.replace(tsdf=torch.from_numpy(inp["spheres"]["s64"]).clone())
    slab = shard_volume(vol, mesh)
    for view in BRICKED_VIEWS:
        verts, _ = raycast_sharded_bricked(slab, cams[view], mesh, width=W,
                                           height=H)
        out["bricked"][view] = {
            "verts": verts.numpy(),
            "single": raycast_vertices_cuda(vol, cams[view], W, H).numpy()}
    # the replicated raycast of a view that sees the sphere
    verts, _ = raycast_sharded(slab, cams["oblique"], mesh, width=W, height=H,
                               replicate_volume_ok=True)
    out["raycast_sharded"]["oblique"] = verts.numpy()
    out["raycast_sharded"]["oblique_equal"] = torch.equal(
        torch.nan_to_num(verts, 1e30),
        torch.from_numpy(out["bricked"]["oblique"]["single"]).nan_to_num(1e30))

    # a volume whose Y and X do not divide the brick axis
    vol = make_volume((51, 51, 48), 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    vol = vol.replace(tsdf=torch.from_numpy(inp["spheres"]["s51"]).clone())
    slab = shard_volume(vol, mesh)
    try:
        raycast_sharded_bricked(slab, cams["divisible"], mesh, width=32,
                                height=24, axis_select=True)
        out["axis_select_error"] = None
    except ValueError as e:
        out["axis_select_error"] = str(e)
    verts, _ = raycast_sharded_bricked(slab, cams["divisible"], mesh,
                                       width=32, height=24)
    out["divisible"] = {
        "verts": verts.numpy(),
        "single": raycast_vertices_cuda(vol, cams["divisible"], 32, 24).numpy()}
    try:
        shard_volume(make_volume((8, 8, 33), 100.0, device=dev), mesh)
        out["indivisible_error"] = None
    except ValueError as e:
        out["indivisible_error"] = str(e)

    # the halo of a (16, 8, 8) ramp
    zl = 16 // nb
    b, _ = mesh.get_coordinate()
    x = torch.arange(16 * 8 * 8, dtype=torch.float32).reshape(16, 8, 8)
    blocks = all_gather(halo_exchange_z(x[b * zl:(b + 1) * zl].clone(), mesh),
                        mesh.get_group("b"))
    out["halo"] = [blk.numpy() for blk in blocks]
    return out if first else None


@pytest.fixture(scope="module", params=list(SHAPES))
def ranks(request, inputs):
    """(shape, rank 0's results) of the four ranks on one mesh shape."""
    nb, nr = SHAPES[request.param]
    out = launch(_rank_body, 4, (nb, nr, inputs), backend="gloo",
                 device="cpu")
    return request.param, out[0]


_JAX = {}


def _jax(shape, name, fn):
    """A JAX result, computed once a mesh shape."""
    if (shape, name) not in _JAX:
        _JAX[shape, name] = fn()
    return _JAX[shape, name]


def _jax_mesh(shape):
    import jax

    from tsdf_tpu.parallel import make_mesh

    nb, nr = SHAPES[shape]
    return make_mesh(n_bricks=nb, n_rays=nr, devices=jax.devices()[:nb * nr])


def _jax_camera(inputs, name):
    import jax.numpy as jnp

    from tsdf_tpu import Camera

    c = inputs["cams"][name]
    return Camera(k=jnp.asarray(c["k"]), k_inv=jnp.asarray(c["k_inv"]),
                  pose=jnp.asarray(c["pose"]), pose_inv=jnp.asarray(c["pose_inv"]))


def _jax_integrate(shape, inputs, vkind, **kw):
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.parallel import integrate_sharded, shard_volume

    spec = dict(VOLUMES[vkind])
    vol = make_volume(spec.pop("size"), spec.pop("physical_size"), **spec)
    frame = "color" if vkind == "color" else "sphere"
    mesh = _jax_mesh(shape)
    out = integrate_sharded(
        shard_volume(vol, mesh), jnp.asarray(inputs["frames"][frame]),
        _jax_camera(inputs, frame), mesh, return_miss=True, **kw)
    vol, miss = out if isinstance(out, tuple) else (out, 0)
    return {"tsdf": np.asarray(vol.tsdf), "weight": np.asarray(vol.weight),
            "color": None if vol.color is None else np.asarray(vol.color),
            "miss": int(miss)}


# -- integrate ----------------------------------------------------------------


def test_integrate_sharded_matches_jax(ranks, inputs):
    """JAX's default path (the line-warp Pallas kernel a brick, interpret
    mode) against the port's "line" slabs after one frame."""
    shape, got = ranks
    want = _jax(shape, "pallas", lambda: _jax_integrate(shape, inputs, "plain"))
    assert want["miss"] == 0
    g = got["integrate"]["line"]["frame0"]
    np.testing.assert_allclose(g["tsdf"], want["tsdf"], rtol=0, atol=5e-3)
    np.testing.assert_array_equal(g["weight"], want["weight"])


def test_integrate_sharded_lax_path_matches_jax(ranks, inputs):
    shape, got = ranks
    want = _jax(shape, "lax", lambda: _jax_integrate(
        shape, inputs, "plain", use_pallas=False))
    g = got["integrate"]["exact"]["frame0"]
    np.testing.assert_allclose(g["tsdf"], want["tsdf"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g["weight"], want["weight"])


def test_integrate_sharded_with_deformation_matches_jax(ranks, inputs):
    shape, got = ranks
    want = _jax(shape, "deformed", lambda: _jax_integrate(
        shape, inputs, "deformed"))
    g = got["integrate"]["deformed"]["frame0"]
    np.testing.assert_allclose(g["tsdf"], want["tsdf"], rtol=0, atol=1e-4)


def test_integrate_sharded_color_matches_jax(ranks, inputs):
    import jax.numpy as jnp

    shape, got = ranks
    want = _jax(shape, "color", lambda: _jax_integrate(
        shape, inputs, "color", rgb=jnp.asarray(inputs["rgb"]), mode="exact"))
    assert want["miss"] == 0 and got["integrate"]["color"]["miss"] == 0
    g = got["integrate"]["color"]["frame0"]
    np.testing.assert_allclose(g["tsdf"], want["tsdf"], atol=5e-3)
    np.testing.assert_array_equal(g["weight"], want["weight"])
    dc = np.abs(g["color"].astype(np.int32) - want["color"].astype(np.int32))
    assert dc.max() <= 1


@pytest.mark.parametrize("case", list(INTEGRATE_CASES))
def test_gathered_slabs_equal_the_single_volume(ranks, case):
    """The port's gate: after each of two frames, the slabs gathered from
    the mesh equal the single-volume twin's tsdf, weight and colour bit for
    bit, and the summed miss count is 0 (no column of these views is
    steeper than |beta| = 1)."""
    _shape, got = ranks
    c = got["integrate"][case]
    assert c["equal0"] and c["equal1"]
    assert c["miss"] == 0
    assert float(c["frame1"]["weight"].max()) == 2.0


# -- raycasts -------------------------------------------------------------------


def test_raycast_sharded_matches_jax(ranks, inputs):
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.parallel import raycast_sharded, shard_volume

    shape, got = ranks

    def run():
        vol = make_volume((32,) * 3, 2000.0, offset=(-1000, -1000, 0))
        vol = vol.replace(tsdf=jnp.asarray(inputs["spheres"]["s32"]))
        mesh = _jax_mesh(shape)
        v, n = raycast_sharded(shard_volume(vol, mesh),
                               _jax_camera(inputs, "sphere"), mesh, width=64,
                               height=48, replicate_volume_ok=True)
        return np.asarray(v), np.asarray(n)

    verts, normals = _jax(shape, "raycast_sharded", run)
    r = got["raycast_sharded"]
    np.testing.assert_allclose(r["verts"], verts, rtol=0, atol=1e-2)
    np.testing.assert_allclose(r["normals"], normals, rtol=0, atol=1e-4)


def test_raycast_sharded_rows_equal_the_single_render(ranks):
    """Each rank's row tile (the rows split over b x r, from the tile's
    row origin) equals the same rows of the single render bit for bit:
    JAX's view above (every ray misses the sphere) and an oblique view of
    a 64^3 sphere."""
    _shape, got = ranks
    r = got["raycast_sharded"]
    assert r["equal"] and r["oblique_equal"]
    assert np.isfinite(r["oblique"]).all(-1).sum() > 500


def _jax_single_render(inputs, view):
    """JAX's single-device slab sweep (interpret mode), once a view."""
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.kernels.raycast import raycast_pallas

    def run():
        vol = make_volume((64,) * 3, 2000.0, offset=(-1000, -1000, 0))
        vol = vol.replace(tsdf=jnp.asarray(inputs["spheres"]["s64"]))
        v, _ = raycast_pallas(vol, _jax_camera(inputs, view), W, H,
                              interpret=True)
        return np.asarray(v)

    return _jax("any", f"render_{view}", run)


def _hold_bricked(verts, ref, p99=True):
    hit_r = np.isfinite(ref).all(-1)
    hit_b = np.isfinite(verts).all(-1)
    assert hit_r.sum() > 500  # the scene is visible
    assert (hit_r == hit_b).mean() > 0.999
    both = hit_r & hit_b
    err = np.linalg.norm(ref[both] - verts[both], axis=-1)
    assert np.median(err) < 0.5
    if p99:
        assert np.percentile(err, 99) < 2.0


def test_raycast_bricked_matches_single(ranks, inputs):
    _shape, got = ranks
    b = got["bricked"]["oblique"]
    _hold_bricked(b["verts"], _jax_single_render(inputs, "oblique"))
    _hold_bricked(b["verts"], b["single"])


def test_raycast_bricked_reverse_sweep(ranks, inputs):
    _shape, got = ranks
    b = got["bricked"]["reverse"]
    _hold_bricked(b["verts"], _jax_single_render(inputs, "reverse"), p99=False)
    _hold_bricked(b["verts"], b["single"])


@pytest.mark.parametrize("view", ["-x", "+x", "-y", "+y"])
def test_raycast_bricked_axis_select(ranks, inputs, view):
    """x- and y-dominant cameras: the port's march has no sweep axis, so
    every orientation renders from the slabs alone."""
    _shape, got = ranks
    b = got["bricked"][view]
    _hold_bricked(b["verts"], _jax_single_render(inputs, view))
    _hold_bricked(b["verts"], b["single"])


def test_raycast_bricked_axis_select_divisibility(ranks):
    """Y and X that do not divide the brick axis raise with
    ``axis_select=True``, as in JAX; by default the render runs."""
    _shape, got = ranks
    assert "axis_select" in got["axis_select_error"]
    d = got["divisible"]
    assert np.isfinite(d["verts"]).all(-1).sum() > 50
    hit_r = np.isfinite(d["single"]).all(-1)
    assert (hit_r == np.isfinite(d["verts"]).all(-1)).mean() > 0.999


def test_shard_volume_refuses_an_indivisible_z(ranks):
    _shape, got = ranks
    assert "must divide the brick axis" in got["indivisible_error"]


def test_halo_exchange_matches_neighbours(ranks):
    shape, got = ranks
    nb = SHAPES[shape][0]
    zl = 16 // nb
    x = np.arange(16 * 8 * 8, dtype=np.float32).reshape(16, 8, 8)
    for b, blk in enumerate(got["halo"]):
        assert blk.shape == (zl + 2, 8, 8)
        np.testing.assert_array_equal(blk[1:-1], x[b * zl:(b + 1) * zl])
        np.testing.assert_array_equal(blk[0], x[b * zl - 1] if b > 0 else x[0])
        nxt = x[(b + 1) * zl] if b < nb - 1 else x[15]
        np.testing.assert_array_equal(blk[-1], nxt)


def test_halo_exchange_of_jax_matches(ranks):
    """The same ramp through JAX's halo exchange on the same mesh shape."""
    import jax

    from tsdf_tpu.parallel.halo import halo_exchange_z
    from tsdf_tpu.parallel.mesh import volume_sharding

    shape, got = ranks
    mesh = _jax_mesh(shape)
    x = np.arange(16 * 8 * 8, dtype=np.float32).reshape(16, 8, 8)
    out = np.asarray(halo_exchange_z(
        jax.device_put(x, volume_sharding(mesh)), mesh, halo=1))
    np.testing.assert_array_equal(np.concatenate(got["halo"]), out)


@pytest.mark.parametrize("entry", ["make_mesh", "launch", "initialize"])
def test_entry_points_take_the_card_unless_asked_for_the_cpu(entry, monkeypatch):
    """With no card visible, ``make_mesh()`` without a ``device``, ``launch``
    without one and ``initialize`` without a backend raise, before any
    process group or rank is made: the CPU is taken only when asked for
    (``device="cpu"``, ``backend="gloo"``)."""
    import torch.distributed as dist

    from tsdf_tpu_torch.parallel import distributed, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "make_mesh": lambda: make_mesh(),
        "launch": lambda: distributed.launch(print, 2),
        "initialize": lambda: distributed.initialize("localhost:1", 2, 0),
    }
    with pytest.raises(RuntimeError, match="(no CUDA card|needs a CUDA card)"):
        calls[entry]()
    assert not dist.is_initialized()


@pytest.mark.parametrize("fast", [False, True])
def test_brick_cull_of_a_slab_is_the_whole_volumes(fast):
    """``kernels.integrate.brick_cull`` on a z-slab whose first plane is a
    multiple of the brick's depth: the whole volume's verdicts for the
    slab's bricks (its centres are the whole volume's)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import BRICK, brick_cull
    from tsdf_tpu_torch.utils import fixtures

    cpu = torch.device("cpu")
    cam = (Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65, device=cpu)
           .move_to([300.0, 200.0, -700.0]).look_at([0.0, 0.0, 1000.0]))
    depth = torch.from_numpy(
        fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32))
    kw = dict(offset=(-1000.0, -800.0, 0.0), device=cpu)
    whole = brick_cull(make_volume((64, 48, 40), 2000.0, **kw), depth, cam,
                       fast=fast)
    bz = BRICK[0]
    slab = brick_cull(make_volume((64, 48, 40), 2000.0, slab=(2 * bz, 2 * bz),
                                  **kw), depth, cam, fast=fast)
    assert torch.equal(slab, whole[2:4])
    assert bool(whole.any()) and not bool(whole.all())
