"""The port's sharded surface and sharded pose gradient
(``tsdf_tpu_torch.parallel``: ``extract_surface_sharded``,
``merge_brick_soups``, ``integrate_pose_sharded``) on four gloo ranks on the
CPU, against the JAX package's on the virtual 8-device mesh of
tests/conftest.py at the same mesh shapes (4x1, 2x2), and against the
port's single-volume functions; and the pose adjoint's twin on a slab.

The scenes, cameras and frames are those of tests/test_parallel_extra.py
(:67, :199) and tests/test_parallel.py (:110), built with the JAX
package's fixtures and handed to both packages as numpy arrays. Ranks are
spawned as in tests/test_torch_parallel.py, once a mesh shape, and import
no JAX; JAX runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances, those of the JAX tests:
  * the surface against JAX's (sharded and single): the same vertex count,
    the vertex multiset equal at 3 decimals;
  * the pose gradient against JAX's (sharded and single): the loss within
    rtol 1e-4, the 6-twist gradient within rtol 1e-4 / atol 1e-4; through
    the sharded integrate (tests/test_parallel.py:110): finite, nonzero.
The port's own gates: the merged sharded soup equals the single-volume
soup bit for bit (in order, so as a sorted multiset too), with the global
voxel indices of each vertex; the fused slabs of ``integrate_pose_sharded``
(exact and fast) equal the same planes of ``integrate_pose``'s bit for bit;
its gradient is within rtol 1e-5 of the single volume's (the slabs' float64
sums are added in another order and rounded once); the slab adjoint twin's
dd, dw and per-brick partials equal the whole volume's for the same planes.
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.parallel.distributed import launch

SHAPES = {"4x1": (4, 1), "2x2": (2, 2)}
SURFACE_CAPS = dict(max_cubes_per_brick=1 << 12, max_vertices_per_brick=1 << 14)


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

    return {
        "pose": Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([40.0, -30.0, -300.0]).look_at([0.0, 0.0, 750.0]),
        "through": Camera.default_depth_camera()
        .move_to([0.0, 0.0, -500.0]).look_at([0.0, 0.0, 1000.0]),
    }


@pytest.fixture(scope="module")
def inputs():
    from tsdf_tpu import make_volume
    from tsdf_tpu.utils import fixtures

    vol = make_volume((32, 32, 32), 1000.0, offset=(-500.0, -500.0, -500.0))
    sphere = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 0.0))
    return {
        "sphere": np.asarray(sphere.tsdf),
        "cams": {k: _cam_numpy(c) for k, c in _jax_cameras().items()},
        "pose_depth": np.asarray(
            fixtures.sphere_depth_map(160, 120, 300.0, 600.0, 1200.0),
            np.float32),
        "through_depth": np.asarray(
            fixtures.sphere_depth_map(32, 24, 10.0, 800.0, 1200.0), np.float32),
        "gbar": np.random.RandomState(4).randn(32, 32, 32).astype(np.float32),
    }


# -- what the ranks run -------------------------------------------------------


def _rank_body(dev, nb, nr, inp):
    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import integrate_pose
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface
    from tsdf_tpu_torch.parallel import (
        extract_surface_sharded,
        integrate_pose_sharded,
        make_mesh,
        merge_brick_soups,
        shard_volume,
    )
    from tsdf_tpu_torch.parallel.ops import unshard_volume

    torch.set_num_threads(1)
    mesh = make_mesh(nb, nr, device=dev)
    first = dist.get_rank() == 0
    cams = {k: Camera.from_numpy(**c, device=dev) for k, c in inp["cams"].items()}
    out = {}

    # the surface of a sphere
    vol = make_volume((32,) * 3, 1000.0, offset=(-500.0, -500.0, -500.0),
                      device=dev)
    vol = vol.replace(tsdf=torch.from_numpy(inp["sphere"]).clone())
    bricks = extract_surface_sharded(shard_volume(vol, mesh), mesh,
                                     **SURFACE_CAPS)
    verts, tris = merge_brick_soups(bricks)
    single = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    n = int(single.n_vertices)
    counts = [int(c) for c in bricks[2]]
    voxels = np.concatenate([bricks[1][i, :c].numpy()
                             for i, c in enumerate(counts)])
    try:
        merge_brick_soups(extract_surface_sharded(
            shard_volume(vol, mesh), mesh, max_cubes_per_brick=1 << 12,
            max_vertices_per_brick=16))
        overflow_error = None
    except ValueError as e:
        overflow_error = str(e)
    out["surface"] = {
        "verts": verts, "tris": tris, "counts": counts,
        "shapes": [tuple(t.shape) for t in bricks],
        "overflowed": bricks[3].tolist(),
        "single": single.vertices[:n].numpy(),
        "single_voxels": single.vertex_voxels[:n].numpy(),
        "voxels": voxels, "overflow_error": overflow_error,
        # every rank of the mesh holds the same stacks
        "everywhere": all(
            torch.equal(x, t) for t in bricks[:3]
            for x in _gather_all(t, mesh)),
    }

    # the pose gradient (tests/test_parallel_extra.py:199)
    vol = make_volume((32,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
                      device=dev)
    vol = vol.replace(weight=torch.ones_like(vol.weight))
    depth = torch.from_numpy(inp["pose_depth"])
    gbar = torch.from_numpy(inp["gbar"])
    cam = cams["pose"]
    slab = shard_volume(vol, mesh)
    planes = slice(slab.z0, slab.z0 + slab.tsdf.shape[0])
    delta = torch.zeros(6, requires_grad=True)
    fused, miss = integrate_pose_sharded(slab, depth, cam, delta, mesh)
    loss = (gbar[planes] * fused.tsdf).sum()
    loss.backward()
    whole_delta = torch.zeros(6, requires_grad=True)
    whole, _ = integrate_pose(vol, depth, cam, whole_delta)
    whole_loss = (gbar * whole.tsdf).sum()
    whole_loss.backward()
    shares = [float(p) for p in _gather_b(loss.detach().reshape(1), mesh)]
    gathered = unshard_volume(fused, mesh)
    out["pose"] = {
        "loss": sum(shares), "grad": delta.grad.numpy(),
        "single_loss": float(whole_loss), "single_grad": whole_delta.grad.numpy(),
        "miss": int(miss),
        "slabs_equal": None if gathered is None else (
            torch.equal(gathered.tsdf, whole.tsdf.detach())
            and torch.equal(gathered.weight, whole.weight.detach())),
        "grads": [g.numpy() for g in _gather_all(delta.grad, mesh)],
    }
    with torch.no_grad():
        fast, fast_miss = integrate_pose_sharded(slab, depth, cam, torch.zeros(6),
                                                 mesh, mode="fast")
        whole_fast, whole_miss = integrate_pose(vol, depth, cam, torch.zeros(6),
                                                mode="fast")
    gathered = unshard_volume(fast, mesh)
    out["pose_fast"] = {
        "miss": (int(fast_miss), int(whole_miss)),
        "slabs_equal": None if gathered is None else (
            torch.equal(gathered.tsdf, whole_fast.tsdf)
            and torch.equal(gathered.weight, whole_fast.weight)),
    }
    try:
        integrate_pose_sharded(
            shard_volume(vol.with_identity_deformation(), mesh), depth, cam,
            torch.zeros(6), mesh)
        out["deformed_error"] = None
    except ValueError as e:
        out["deformed_error"] = str(e)

    # the gradient through the sharded integrate (tests/test_parallel.py:110)
    vol = make_volume((16,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=dev)
    depth = torch.from_numpy(inp["through_depth"])
    delta = torch.zeros(6, requires_grad=True)
    fused, _ = integrate_pose_sharded(shard_volume(vol, mesh), depth,
                                      cams["through"], delta, mesh)
    (fused.tsdf ** 2).sum().backward()
    whole_delta = torch.zeros(6, requires_grad=True)
    whole, _ = integrate_pose(vol, depth, cams["through"], whole_delta)
    (whole.tsdf ** 2).sum().backward()
    out["through"] = {"grad": delta.grad.numpy(),
                      "single": whole_delta.grad.numpy()}
    return out if first else None


def _gather_b(t, mesh):
    from tsdf_tpu_torch.parallel.mesh import all_gather

    return all_gather(t, mesh.get_group("b"))


def _gather_all(t, mesh):
    from tsdf_tpu_torch.parallel.mesh import AXES, all_gather

    return all_gather(t.contiguous(), mesh.get_group(AXES))


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


def _multiset(verts, decimals=None):
    v = np.ascontiguousarray(verts, np.float32)
    if decimals is not None:
        v = np.round(v, decimals)
    return np.sort(v.view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)


# -- the surface ----------------------------------------------------------------


def test_extract_surface_sharded_matches_jax(ranks, inputs):
    """tests/test_parallel_extra.py:67 on the port: the merged sharded soup
    has JAX's vertex count (its sharded and its single extraction), and
    the same vertex multiset at 3 decimals."""
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.ops.marching_cubes import extract_surface, soup_to_numpy
    from tsdf_tpu.parallel import (
        extract_surface_sharded,
        merge_brick_soups,
        shard_volume,
    )

    shape, got = ranks

    def run():
        vol = make_volume((32, 32, 32), 1000.0, offset=(-500.0, -500.0, -500.0))
        vol = vol.replace(tsdf=jnp.asarray(inputs["sphere"]))
        mesh = _jax_mesh(shape)
        sharded, _ = merge_brick_soups(extract_surface_sharded(
            shard_volume(vol, mesh), mesh, **SURFACE_CAPS))
        single, _ = soup_to_numpy(
            extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16))
        return sharded, single

    for want in _jax(shape, "surface", run):
        assert len(got["surface"]["verts"]) == len(want)
        np.testing.assert_array_equal(_multiset(got["surface"]["verts"], 3),
                                      _multiset(want, 3))


def test_extract_surface_sharded_is_the_single_soup(ranks):
    """The port's gate: the slabs' soups, merged in brick order, are the
    single-volume soup bit for bit, vertex by vertex (the slab's cubes are
    the whole volume's, in the same order, and its centres are formed from
    the whole volume's planes), with the global voxel indices of each
    vertex; so the sorted multisets are bit-equal too. The stacks have
    JAX's shapes, no brick overflowed, and every rank returns them."""
    shape, got = ranks
    s = got["surface"]
    nb = SHAPES[shape][0]
    cap = SURFACE_CAPS["max_vertices_per_brick"]
    assert s["shapes"] == [(nb, cap, 3), (nb, cap, 2), (nb,), (nb,)]
    assert s["overflowed"] == [False] * nb and s["everywhere"]
    assert len(s["single"]) > 1000 and all(c > 0 for c in s["counts"])
    assert s["verts"].view(np.int32).tobytes() == s["single"].view(np.int32).tobytes()
    np.testing.assert_array_equal(s["voxels"], s["single_voxels"])
    assert _multiset(s["verts"]).tobytes() == _multiset(s["single"]).tobytes()
    np.testing.assert_array_equal(
        s["tris"], np.arange(len(s["verts"]), dtype=np.int32).reshape(-1, 3))


def test_merge_brick_soups_raises_on_overflow(ranks):
    _shape, got = ranks
    assert "a brick overflowed" in got["surface"]["overflow_error"]


def test_merge_brick_soups_takes_numpy_and_tensors():
    """The host merge reads each brick's first ``n_vertices`` rows, from
    tensors or numpy arrays alike, and drops a trailing partial triangle."""
    from tsdf_tpu_torch.parallel import merge_brick_soups

    rng = np.random.RandomState(0)
    verts = rng.rand(3, 10, 3).astype(np.float32)
    soups = (verts, np.zeros((3, 10, 2), np.int32), np.array([3, 0, 4]),
             np.zeros(3, bool))
    want = np.concatenate([verts[0, :3], verts[2, :3]])
    for given in (soups, tuple(torch.from_numpy(a) for a in soups)):
        v, t = merge_brick_soups(given)
        np.testing.assert_array_equal(v, want)
        np.testing.assert_array_equal(t, [[0, 1, 2], [3, 4, 5]])


# -- the pose gradient ----------------------------------------------------------


def test_integrate_pose_sharded_gradient_matches_jax(ranks, inputs):
    """tests/test_parallel_extra.py:199 on the port: the loss summed over
    the slabs and the gradient on every rank against JAX's sharded and
    single value-and-grad (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.kernels.integrate import integrate_pose
    from tsdf_tpu.parallel.ops import integrate_pose_sharded, shard_volume

    shape, got = ranks

    def run():
        vol = make_volume((32, 32, 32), 1500.0, offset=(-750.0, -750.0, 0.0))
        vol = vol.replace(weight=jnp.full_like(vol.weight, 1.0))
        cam = _jax_camera(inputs, "pose")
        depth = jnp.asarray(inputs["pose_depth"])
        gbar = jnp.asarray(inputs["gbar"])
        mesh = _jax_mesh(shape)
        vs = shard_volume(vol, mesh)

        def loss_single(delta):
            out, _ = integrate_pose(vol, depth, cam, delta, interpret=True)
            return jnp.sum(gbar * out.tsdf)

        def loss_sharded(delta):
            out, _ = integrate_pose_sharded(vs, depth, cam, delta, mesh,
                                            interpret=True)
            return jnp.sum(gbar * out.tsdf)

        d0 = jnp.zeros(6)
        return [(float(v), np.asarray(g)) for v, g in (
            jax.value_and_grad(loss_single)(d0),
            jax.value_and_grad(loss_sharded)(d0))]

    p = got["pose"]
    for loss, grad in _jax(shape, "pose", run):
        np.testing.assert_allclose(p["loss"], loss, rtol=1e-4)
        for g in p["grads"]:
            np.testing.assert_allclose(g, grad, rtol=1e-4, atol=1e-4)


def test_integrate_pose_sharded_is_the_single_volumes(ranks):
    """The port's gates: the fused slabs equal the same planes of
    ``integrate_pose``'s forward bit for bit (exact, and the fast mode with
    its miss count); every rank holds the same gradient, within rtol 1e-5
    of the single volume's (float64 sums of the same terms, added in
    another order, rounded once)."""
    _shape, got = ranks
    p, f = got["pose"], got["pose_fast"]
    assert p["slabs_equal"] and f["slabs_equal"]
    assert p["miss"] == 0 and f["miss"][0] == f["miss"][1]
    assert all(np.array_equal(g, p["grad"]) for g in p["grads"])
    assert np.abs(p["single_grad"]).max() > 0
    np.testing.assert_allclose(p["grad"], p["single_grad"], rtol=1e-5,
                               atol=1e-5 * np.abs(p["single_grad"]).max())
    np.testing.assert_allclose(p["loss"], p["single_loss"], rtol=1e-5)


def test_integrate_pose_sharded_refuses_a_deformed_slab(ranks):
    _shape, got = ranks
    assert "integrate_pose_sharded is the rigid path" in got["deformed_error"]


def test_pose_gradient_through_sharded_integrate(ranks):
    """tests/test_parallel.py:110 on the port (through
    ``integrate_pose_sharded``): the twist gradient of sum(tsdf^2) is
    finite and nonzero, and within rtol 1e-5 of the single volume's."""
    _shape, got = ranks
    g, single = got["through"]["grad"], got["through"]["single"]
    assert np.all(np.isfinite(g)) and np.any(g != 0.0)
    np.testing.assert_allclose(g, single, rtol=1e-5,
                               atol=1e-5 * np.abs(single).max())


# -- the slab adjoint's twin ------------------------------------------------------


@pytest.mark.parametrize("z0", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_adjoint_twin_is_the_whole_volumes(inputs, z0, dtype):
    """``pose_grad_cuda`` on a z-slab (the plain twin on the CPU) forms its
    centres from the whole volume's planes: its dd and dw equal the same
    planes of the whole volume's bit for bit, and, on a slab whose first
    plane starts a brick, each brick's row of partials
    (``pose_grad_partials``) equals the whole volume's row of that brick."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import (
        BRICK,
        brick_grid,
        integrate_cuda,
        pose_grad_cuda,
        pose_grad_partials,
    )

    cpu = torch.device("cpu")
    cam = Camera.from_numpy(**inputs["cams"]["pose"], device=cpu)
    depth = torch.from_numpy(inputs["pose_depth"])
    storage = getattr(torch, dtype)
    kw = dict(offset=(-750.0, -750.0, 0.0), dtype=storage, device=cpu)
    vol = make_volume((32, 32, 40), 1500.0, **kw)
    integrate_cuda(vol, depth, cam)  # weights to blend into
    gen = torch.Generator().manual_seed(7)
    gd = torch.randn(vol.tsdf.shape, generator=gen).to(storage)
    gw = torch.randn(vol.tsdf.shape, generator=gen).to(storage)
    n = 16
    planes = slice(z0, z0 + n)
    slab = make_volume((32, 32, 40), 1500.0, slab=(z0, n), **kw)
    slab = slab.replace(tsdf=vol.tsdf[planes].clone(),
                        weight=vol.weight[planes].clone())
    dd, dw, dp = pose_grad_cuda(vol, depth, cam, gd, gw)
    sd, sw, sp = pose_grad_cuda(slab, depth, cam, gd[planes].contiguous(),
                                gw[planes].contiguous())
    assert torch.equal(sd, dd[planes]) and torch.equal(sw, dw[planes])
    assert float(sp.abs().max()) > 0
    if z0 % BRICK[0] == 0:
        rows = pose_grad_partials(vol, depth, cam, gd)
        per_z = brick_grid(vol.tsdf.shape)[1] * brick_grid(vol.tsdf.shape)[2]
        first = z0 // BRICK[0] * per_z
        mine = pose_grad_partials(slab, depth, cam, gd[planes].contiguous())
        assert torch.equal(mine, rows[first:first + mine.shape[0]])
        assert float(mine.abs().max()) > 0
