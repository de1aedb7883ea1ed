"""tsdf_tpu_torch volume and camera vs the JAX package, on the same inputs.

Tolerance: both sides compute in float32 with the same formulas, so
geometry agrees to float32 rounding (rtol 1e-6, atol 1e-4 mm on
coordinates of up to a few metres); matrix inverses come from different
LAPACK builds and are held to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize(
    "size,physical,offset,trunc",
    [
        ((32, 32, 32), 2000.0, None, None),
        ((50, 40, 30), (1500.0, 1200.0, 900.0), (-750.0, -600.0, 100.0), None),
        ((16, 24, 8), 800.0, (10.0, -20.0, 30.0), 25.5),
    ],
)
def test_make_volume_matches_jax(size, physical, offset, trunc):
    j = tsdf_tpu.make_volume(size, physical, offset=offset,
                             truncation_distance=trunc)
    t = make_volume(size, physical, offset=offset, truncation_distance=trunc,
                    device=CPU)
    assert t.size == j.size
    assert t.tsdf.shape == j.tsdf.shape  # [z, y, x], x fastest
    for name in ("physical_size", "offset", "truncation_distance",
                 "max_weight", "global_rotation", "global_translation",
                 "tsdf", "weight"):
        np.testing.assert_allclose(_np(getattr(t, name)),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(_np(t.voxel_size), np.asarray(j.voxel_size),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(t.voxel_centres()),
                               np.asarray(j.voxel_centres()),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(t.space_max), np.asarray(j.space_max),
                               rtol=1e-6)


@pytest.mark.parametrize("which", ["sphere", "sphere_centre", "wall"])
def test_fixture_volumes_match_jax(which):
    j = tsdf_tpu.make_volume((20, 16, 12), (1000.0, 800.0, 600.0),
                             offset=(-500.0, -400.0, 0.0))
    t = make_volume((20, 16, 12), (1000.0, 800.0, 600.0),
                    offset=(-500.0, -400.0, 0.0), device=CPU)
    if which == "sphere":
        j, t = jax_fixtures.sphere_tsdf(j, 250.0), fixtures.sphere_tsdf(t, 250.0)
    elif which == "sphere_centre":
        c = (120.0, -50.0, 330.0)
        j = jax_fixtures.sphere_tsdf(j, 180.0, centre=c)
        t = fixtures.sphere_tsdf(t, 180.0, centre=c)
    else:
        j, t = jax_fixtures.wall_tsdf(j, 410.0), fixtures.wall_tsdf(t, 410.0)
    np.testing.assert_allclose(_np(t.tsdf), np.asarray(j.tsdf),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(t.weight), np.asarray(j.weight))


def test_fixture_depth_maps_match_jax():
    np.testing.assert_array_equal(
        fixtures.sphere_depth_map(160, 120, 40.0, 800.0, 1600.0),
        jax_fixtures.sphere_depth_map(160, 120, 40.0, 800.0, 1600.0),
    )
    np.testing.assert_array_equal(
        fixtures.wall_depth_map(160, 120, 3000.0, 500.0, 1200.0),
        jax_fixtures.wall_depth_map(160, 120, 3000.0, 500.0, 1200.0),
    )


def test_volume_numpy_round_trip():
    rng = np.random.default_rng(0)
    j = tsdf_tpu.make_volume((6, 5, 4), 600.0).replace(
        tsdf=jnp.asarray(rng.normal(size=(4, 5, 6)).astype(np.float32)),
        weight=jnp.asarray(rng.uniform(size=(4, 5, 6)).astype(np.float32)),
    )
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    t = TSDFVolume.from_numpy(
        **{k: None if v is None else np.asarray(v) for k, v in fields.items()},
        device=CPU,
    )
    back = t.to_numpy()
    for k, v in fields.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    again = TSDFVolume.from_numpy(**back, device=CPU)
    for k, v in again.to_numpy().items():
        if v is not None:
            np.testing.assert_array_equal(v, back[k], err_msg=k)


def _both(at, target, intr=(591.1, 590.1, 331.0, 234.6)):
    j = tsdf_tpu.Camera.from_intrinsics(*intr).move_to(at).look_at(target)
    t = Camera.from_intrinsics(*intr, device=CPU).move_to(at).look_at(target)
    return j, t


@pytest.mark.parametrize(
    "at,target",
    [
        ([0.0, 0.0, -500.0], [0.0, 0.0, 1000.0]),
        ([400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0]),
        ([0.0, 0.0, 2600.0], [0.0, 0.0, 1000.0]),
        # straight down and straight up: up vector taken from z
        ([10.0, 900.0, 5.0], [10.0, -100.0, 5.0]),
        ([0.0, -800.0, 0.0], [0.0, 400.0, 0.0]),
    ],
)
def test_camera_transforms_match_jax(at, target):
    j, t = _both(at, target)
    for name in ("k", "k_inv", "pose", "pose_inv"):
        np.testing.assert_allclose(_np(getattr(t, name)),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(_np(t.position), np.asarray(j.position),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(t.rotation), np.asarray(j.rotation),
                               atol=1e-6)
    pts = np.random.default_rng(1).uniform(-2000, 2000, (200, 3)).astype(
        np.float32
    )
    np.testing.assert_allclose(
        _np(t.world_to_camera(torch.from_numpy(pts))),
        np.asarray(j.world_to_camera(jnp.asarray(pts))),
        rtol=1e-5, atol=1e-2,
    )


def test_set_pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [120.0, -40.0, 300.0]
    j = tsdf_tpu.Camera.default_depth_camera().set_pose(jnp.asarray(pose))
    t = Camera.from_intrinsics(591.1, 590.1, 331.0, 234.6, device=CPU
                               ).set_pose(torch.from_numpy(pose))
    np.testing.assert_allclose(_np(t.pose_inv), np.asarray(j.pose_inv),
                               atol=1e-5)
    np.testing.assert_allclose(_np(t.k), np.asarray(j.k))


def test_camera_numpy_round_trip():
    j, _ = _both([400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0])
    t = Camera.from_numpy(
        np.asarray(j.k), np.asarray(j.pose),
        k_inv=np.asarray(j.k_inv), pose_inv=np.asarray(j.pose_inv),
        device=CPU,
    )
    back = t.to_numpy()
    for name in ("k", "k_inv", "pose", "pose_inv"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(j, name)))
    # without the inverses they are recomputed
    t2 = Camera.from_numpy(back["k"], back["pose"], device=CPU)
    np.testing.assert_allclose(_np(t2.pose_inv), back["pose_inv"], atol=1e-5)
