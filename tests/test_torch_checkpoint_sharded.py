"""The port's sharded checkpoint (``tsdf_tpu_torch.utils.checkpoint``:
``save_sharded`` / ``load_sharded`` with ``mesh=``) on four gloo ranks on
the CPU: the cases of tests/test_checkpoint.py (:14, :35, :71), whose JAX
checkpoint is orbax's, on the port's meshes 4x1 and 2x2.

The volumes and frames are built with the JAX package's fixtures in this
process and handed to the ranks as numpy arrays; the ranks (one spawn,
both meshes; ``parallel.distributed.launch``) import no JAX.

Gates:
  * round trips are bit-equal: each restored slab equals ``shard_volume``
    of the original, with the same ``z0``, and the metadata is the saved
    volume's; only the ranks of row tile 0 write, one file a slab;
  * a bf16 volume with deformation and colour saved on 4x1 restores onto
    2x2 and the reverse, a whole volume's checkpoint onto a mesh and a
    mesh's onto a whole volume, each field in its dtype, bit for bit;
  * a fusion resumed from a checkpoint after 2 of 4 frames: within JAX's
    gate of JAX's ``integrate`` straight (tsdf within 1e-4 mm, weights
    equal; tests/test_checkpoint.py:71) and bit-equal with the port's
    single-volume fusion of the 4 frames;
  * refusals, on every rank: a ``like`` of another Z, dtype or field set,
    a directory whose manifest is missing (ValueError naming the cause).
"""

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.parallel.distributed import launch

MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
N = 16  # the round trips' volume
RESUME_N = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(vol) -> dict:
    return {f: np.asarray(getattr(vol, f)) for f in (
        "tsdf", "weight", "physical_size", "offset", "truncation_distance",
        "max_weight", "global_rotation", "global_translation")}


@pytest.fixture(scope="module")
def inputs():
    """The JAX tests' volumes, the resume's frame and camera, and JAX's
    four frames fused straight."""
    import jax.numpy as jnp

    from tsdf_tpu import Camera, integrate, make_volume
    from tsdf_tpu.utils import fixtures

    vol = fixtures.sphere_tsdf(
        make_volume((N,) * 3, 1000.0, offset=(0.0, 0.0, 0.0)), 300.0)
    sphere = _numpy(vol)
    sphere["weight"] = np.random.default_rng(3).random(
        sphere["weight"].shape).astype(np.float32)
    sphere["global_rotation"] = np.array([0.1, 0.2, 0.3], np.float32)
    cam = (Camera.default_depth_camera().move_to([0.0, 0.0, -500.0])
           .look_at([0.0, 0.0, 1000.0]))
    depth = fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)
    ref = make_volume((RESUME_N,) * 3, 2000.0, offset=(-1000, -1000, 0))
    for _ in range(4):
        ref = integrate(ref, jnp.asarray(depth), cam)
    return {
        "sphere": sphere,
        "depth": np.asarray(depth, np.float32),
        "cam": {f: np.asarray(getattr(cam, f))
                for f in ("k", "pose", "k_inv", "pose_inv")},
        "jax_straight": {"tsdf": np.asarray(ref.tsdf),
                         "weight": np.asarray(ref.weight)},
    }


# -- what the ranks run ------------------------------------------------------


def _equal(a, b) -> bool:
    """Every field of two volumes (and a slab's z0) bit for bit."""
    import dataclasses

    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, torch.Tensor):  # None, or a slab's planes
            if x != y:
                return False
        elif (not isinstance(y, torch.Tensor) or x.dtype != y.dtype
              or x.shape != y.shape or not torch.equal(x, y)):
            return False
    return True


def _rich_volume(dev):
    """tests/test_checkpoint.py:35's volume: bf16 storage, colour and
    deformation, each with content."""
    from tsdf_tpu_torch import make_volume

    g = torch.Generator().manual_seed(5)
    vol = make_volume((N,) * 3, 1000.0, offset=(0.0, 0.0, 0.0),
                      with_deformation=True, with_color=True,
                      device=dev).astype(torch.bfloat16)
    return vol.replace(
        tsdf=torch.randn(vol.tsdf.shape, generator=g).to(torch.bfloat16),
        color=torch.randint(0, 256, vol.color.shape, generator=g,
                            dtype=torch.uint8),
        deform=vol.deform + 3.0,
        global_translation=torch.tensor([5.0, -6.0, 7.5]))


def _refused(fn, match) -> bool:
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def _rank_body(dev, inp, root):
    import os
    import shutil

    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, TSDFVolume, integrate, make_volume
    from tsdf_tpu_torch.parallel import make_mesh
    from tsdf_tpu_torch.parallel.ops import (
        integrate_sharded,
        shard_volume,
        unshard_volume,
    )
    from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    torch.set_num_threads(1)
    meshes = {k: make_mesh(nb, nr, device=dev) for k, (nb, nr) in MESHES.items()}
    first = dist.get_rank() == 0
    out = {"roundtrip": {}, "files": {}, "rich": {}, "resume": {},
           "refused": {}}
    sphere = TSDFVolume.from_numpy(**inp["sphere"], device=dev)

    def fresh(mesh, **kw):
        return shard_volume(make_volume((N,) * 3, 1000.0, device=dev, **kw), mesh)

    # round trips on each mesh
    for name, mesh in meshes.items():
        path = os.path.join(root, f"sphere_{name}")
        save_sharded(shard_volume(sphere, mesh), path, mesh=mesh)
        got = load_sharded(path, fresh(mesh), mesh=mesh)
        out["roundtrip"][name] = _equal(got, shard_volume(sphere, mesh))
        out["files"][name] = sorted(os.listdir(path))

    # bf16 + colour + deformation across meshes, whole <-> mesh
    rich = _rich_volume(dev)
    rich_like = dict(with_deformation=True, with_color=True)

    def rich_fresh(mesh):
        return shard_volume(make_volume(
            (N,) * 3, 1000.0, device=dev, **rich_like).astype(torch.bfloat16),
            mesh)

    for src, dst in (("4x1", "2x2"), ("2x2", "4x1")):
        path = os.path.join(root, f"rich_{src}")
        save_sharded(shard_volume(rich, meshes[src]), path, mesh=meshes[src])
        got = load_sharded(path, rich_fresh(meshes[dst]), mesh=meshes[dst])
        out["rich"][f"{src}->{dst}"] = _equal(got, shard_volume(rich, meshes[dst]))
    whole = os.path.join(root, "rich_whole")
    if first:
        save_sharded(rich, whole)
    dist.barrier()
    for name, mesh in meshes.items():
        got = load_sharded(whole, rich_fresh(mesh), mesh=mesh)
        out["rich"][f"whole->{name}"] = _equal(got, shard_volume(rich, mesh))
    like = make_volume((N,) * 3, 1000.0, device=dev,
                       **rich_like).astype(torch.bfloat16)
    got = load_sharded(os.path.join(root, "rich_4x1"), like)
    out["rich"]["4x1->whole"] = _equal(got, rich)

    # a resume mid-fusion on each mesh
    cam = Camera.from_numpy(**inp["cam"], device=dev)
    depth = torch.from_numpy(inp["depth"])

    def vol0():
        return make_volume((RESUME_N,) * 3, 2000.0,
                           offset=(-1000, -1000, 0), device=dev)

    straight = vol0()
    for _ in range(4):
        integrate(straight, depth, cam)
    for name, mesh in meshes.items():
        slab = shard_volume(vol0(), mesh)
        for _ in range(2):
            slab = integrate_sharded(slab, depth, cam, mesh)
        path = os.path.join(root, f"mid_{name}")
        save_sharded(slab, path, mesh=mesh)
        slab = load_sharded(path, shard_volume(vol0(), mesh), mesh=mesh)
        for _ in range(2):
            slab = integrate_sharded(slab, depth, cam, mesh)
        done = unshard_volume(slab, mesh)
        if first:
            out["resume"][name] = {
                "tsdf": done.tsdf.numpy(), "weight": done.weight.numpy(),
                "single_equal": _equal(done, straight)}

    # refusals, on every rank
    mesh = meshes["4x1"]
    path = os.path.join(root, "sphere_4x1")
    z32 = shard_volume(make_volume((N, N, 2 * N), 1000.0, device=dev), mesh)
    incomplete = os.path.join(root, "incomplete")
    if first:
        shutil.copytree(path, incomplete)
        os.remove(os.path.join(incomplete, "manifest.json"))
    dist.barrier()
    out["refused"] = {
        "z": _refused(lambda: load_sharded(path, z32, mesh=mesh), "planes"),
        "dtype": _refused(lambda: load_sharded(
            path, fresh(mesh).astype(torch.bfloat16), mesh=mesh), "tsdf"),
        "fields": _refused(lambda: load_sharded(
            path, fresh(mesh, with_color=True), mesh=mesh), "color"),
        "manifest": _refused(lambda: load_sharded(
            incomplete, fresh(mesh), mesh=mesh), "manifest"),
        "slab without mesh": _refused(lambda: load_sharded(
            path, fresh(mesh)), "mesh="),
    }
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_sharded"))
    return launch(_rank_body, 4, (inputs, root), backend="gloo", device="cpu")


# -- the tests ---------------------------------------------------------------


@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_roundtrip(ranks, shape):
    """tests/test_checkpoint.py:14 on the port: every rank's restored slab
    is its slab of the saved volume; the row tile 0 ranks wrote one file a
    slab, and the manifest."""
    assert all(r["roundtrip"][shape] for r in ranks)
    nb = MESHES[shape][0]
    want = ["manifest.json"] + [f"slab_{b * N // nb:06d}.pt" for b in range(nb)]
    assert ranks[0]["files"][shape] == sorted(want)


@pytest.mark.parametrize("case", ["4x1->2x2", "2x2->4x1", "whole->4x1",
                                  "whole->2x2", "4x1->whole"])
def test_sharded_roundtrip_with_deformation_colour_and_bf16(ranks, case):
    """tests/test_checkpoint.py:35 on the port: bf16 storage, colour and
    deformation restore onto another mesh factorization, and between a
    whole volume and a mesh, bit for bit in their dtypes."""
    assert all(r["rich"][case] for r in ranks)


@pytest.mark.parametrize("shape", list(MESHES))
def test_checkpoint_resume_mid_fusion(ranks, inputs, shape):
    """tests/test_checkpoint.py:71 on the port: 2 frames, save, load, 2
    more equal fusing 4 straight (JAX's gate against JAX's integrate; bit
    for bit against the port's single volume)."""
    got = ranks[0]["resume"][shape]
    want = inputs["jax_straight"]
    np.testing.assert_allclose(got["tsdf"], want["tsdf"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["weight"], want["weight"])
    assert got["weight"].max() == 4.0
    assert got["single_equal"]


@pytest.mark.parametrize("case", ["z", "dtype", "fields", "manifest",
                                  "slab without mesh"])
def test_load_refusals_on_every_rank(ranks, case):
    assert all(r["refused"][case] for r in ranks)
