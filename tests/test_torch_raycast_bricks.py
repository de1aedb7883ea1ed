"""The uniform-brick table of ``csrc/raycast.cu``, as its plain PyTorch form
``kernels.raycast.uniform_bricks``, against its definition and against the
samples the raycast twin takes.

The kernel's pre-pass writes one float a brick of ``RAY_BRICK``^3 voxels:
the brick's value when the brick and a one-voxel apron on its high side of
each axis (clamped at the volume's edge) are bitwise equal, NaN otherwise.
A sample whose lower corner lies in a uniform brick then takes that value
for its eight taps. That is exact only if, for every sample the march
takes, the eight taps ``ops.trilinear.trilinear_sample`` reads equal the
brick's value bit for bit, and the twin's weight expression evaluated with
the value in place of the taps gives the twin's bits. Both are held here,
with no tolerance, on the samples of ``ops.raycast.march_rays`` (the twin
the kernel is bit-equal with on the card; it is held against the JAX
raycast in tests/test_torch_raycast.py), for an analytic wall and spheres,
a volume the JAX integrate fused from twelve frames (observed free space a
few ulps off the truncation distance), a volume with NaN voxels behind the
wall, and a volume whose sides are no multiple of the brick.
"""

import dataclasses
import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume, make_volume
from tsdf_tpu_torch.kernels.raycast import (
    RAY_BRICK,
    brick_table_shape,
    uniform_bricks,
)
from tsdf_tpu_torch.utils import fixtures

# the module, not the ``raycast`` function that ``tsdf_tpu_torch.ops``
# exports under the same name
raycast_ops = importlib.import_module("tsdf_tpu_torch.ops.raycast")

CPU = torch.device("cpu")
W, H = 160, 120
FX, FY, CX, CY = 147.775, 147.525, 82.75, 58.65


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(at, target):
    return Camera.from_intrinsics(FX, FY, CX, CY, device=CPU).move_to(
        at).look_at(target)


def _scene(size, wall=1500.0):
    """A wall and a sphere in a volume of ``size`` (x, y, z) voxels over
    2000 mm."""
    vol = make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0),
                      device=CPU)
    w = fixtures.wall_tsdf(vol, wall)
    s = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    return vol.replace(tsdf=torch.minimum(w.tsdf, s.tsdf).contiguous())


def _fused(n_frames=12):
    """A 64^3 volume over 375 mm (the voxel and truncation distance of
    512^3 over 3000 mm) that the JAX integrate fused from ``n_frames``
    noisy depth frames of a sphere bump along a short arc. At this
    truncation distance the running mean of free space leaves it at the
    sixth observation and stays off it from the ninth."""
    rng = np.random.default_rng(3)
    jvol = tsdf_tpu.make_volume((64, 64, 64), 375.0,
                                offset=(-187.5, -187.5, 0.0))
    bump = jax_fixtures.sphere_depth_map(W, H, 40.0, 260.0, 330.0)
    base = np.where(bump > 0, bump, 330).astype(np.float32)
    for i in range(n_frames):
        depth = base + (base > 0) * rng.uniform(-1.0, 1.0, base.shape).astype(
            np.float32)
        jcam = tsdf_tpu.Camera.from_intrinsics(FX, FY, CX, CY).move_to(
            [-11.0 + 2.0 * i, 3.0, -100.0]).look_at([0.0, 0.0, 300.0])
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam)
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


def _table_by_definition(tsdf: np.ndarray, b: int) -> np.ndarray:
    """The table read off its definition, one brick at a time."""
    sz, sy, sx = tsdf.shape
    bits = tsdf.view(np.int32)
    out = np.empty(brick_table_shape(tsdf.shape, b), np.float32)
    for bz, by, bx in itertools.product(*map(range, out.shape)):
        box = bits[np.ix_(*(np.minimum(np.arange(c * b, c * b + b + 1), s - 1)
                            for c, s in ((bz, sz), (by, sy), (bx, sx))))]
        out[bz, by, bx] = (box.reshape(-1)[:1].view(np.float32)[0]
                           if (box == box.flat[0]).all() else np.nan)
    return out


def _blend(c, u, v, w):
    """``ops.trilinear.trilinear_sample``'s weighted sum with every tap
    equal to ``c``: the kernel's expression in a uniform brick."""
    return (c * (1 - u) * (1 - v) * (1 - w) + c * (1 - u) * (1 - v) * w
            + c * (1 - u) * v * (1 - w) + c * (1 - u) * v * w
            + c * u * (1 - v) * (1 - w) + c * u * (1 - v) * w
            + c * u * v * (1 - w) + c * u * v * w)


def _blend_factored(c, u, v, w):
    """``_blend`` with its common products taken once, as the kernel
    evaluates it: the same roundings in the same order."""
    a0, a1 = c * (1 - u), c * u
    b00, b01, b10, b11 = a0 * (1 - v), a0 * v, a1 * (1 - v), a1 * v
    return (b00 * (1 - w) + b00 * w + b01 * (1 - w) + b01 * w
            + b10 * (1 - w) + b10 * w + b11 * (1 - w) + b11 * w)


def _march_samples(monkeypatch, vol, cam, max_steps=raycast_ops.REFERENCE_MAX_STEPS):
    """The twin's vertices and every (point, sample) its march took."""
    taken = []
    sample = raycast_ops.trilinear_sample

    def recorded(values, points, voxel_size):
        out = sample(values, points, voxel_size)
        taken.append((points.clone(), out.clone()))
        return out

    monkeypatch.setattr(raycast_ops, "trilinear_sample", recorded)
    verts = raycast_ops.raycast_vertices(vol, cam, W, H, max_steps=max_steps)
    pts = torch.cat([p for p, _ in taken])
    return verts, pts, torch.cat([s for _, s in taken])


def _check_samples(vol, pts, samples):
    """Every sample in a uniform brick reads only taps equal to the brick's
    value, and the value in place of the taps gives the twin's bits.
    Returns (the count of samples in uniform bricks, the table)."""
    table = uniform_bricks(vol.tsdf)
    sz, sy, sx = vol.tsdf.shape
    vs = vol.voxel_size
    # trilinear_sample's lower corner, fractions and clamped taps
    maxv = torch.stack([vs[0] * sx, vs[1] * sy, vs[2] * sz])
    p = torch.where(pts >= maxv, maxv - vs / 10.0, pts)
    p = torch.where(p < 0.0, torch.zeros_like(p), p)
    g = p / vs - 0.5
    lower = torch.clamp(torch.floor(g), min=0.0)
    u, v, w = (g - lower).unbind(-1)
    lx, ly, lz = lower.to(torch.int64).unbind(-1)
    value = table[lz // RAY_BRICK, ly // RAY_BRICK, lx // RAY_BRICK]
    uniform = torch.isfinite(value)
    flat = vol.tsdf.reshape(-1).view(torch.int32)
    for dz, dy, dx in itertools.product((0, 1), repeat=3):
        tap = flat[(torch.clamp(lz + dz, max=sz - 1) * sy
                    + torch.clamp(ly + dy, max=sy - 1)) * sx
                   + torch.clamp(lx + dx, max=sx - 1)]
        assert torch.equal(tap[uniform], value[uniform].view(torch.int32))
    for blend in (_blend, _blend_factored):
        sub = blend(value, u, v, w)
        assert torch.equal(sub[uniform].view(torch.int32),
                           samples[uniform].view(torch.int32))
    return int(uniform.sum()), table


def test_table_matches_its_definition_on_ragged_volumes():
    rng = np.random.default_rng(0)
    for shape in ((17, 9, 8), (8, 8, 8), (1, 20, 3), (24, 16, 31)):
        tsdf = np.full(shape, 2.5, np.float32)
        # a few changed voxels, a -0.0 beside 0.0, a NaN, an inf
        flat = tsdf.reshape(-1)
        idx = rng.choice(flat.size, size=min(5, flat.size), replace=False)
        flat[idx[:2]] = -1.0
        if flat.size > 4:
            flat[idx[2]] = np.nan
            flat[idx[3]] = np.inf
        want = _table_by_definition(tsdf, RAY_BRICK)
        got = uniform_bricks(torch.from_numpy(tsdf)).numpy()
        assert got.shape == want.shape == brick_table_shape(shape)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    zeros = np.zeros((9, 9, 9), np.float32)
    zeros[8, 8, 8] = -0.0  # bitwise different: the apron of brick 0
    got = uniform_bricks(torch.from_numpy(zeros)).numpy()
    assert np.isnan(got[0, 0, 0]) and got[1, 1, 1] == 0.0
    for b in (2, 4):
        tsdf = rng.integers(0, 2, (11, 7, 13)).astype(np.float32)
        assert np.array_equal(
            uniform_bricks(torch.from_numpy(tsdf), b).numpy().view(np.int32),
            _table_by_definition(tsdf, b).view(np.int32))


@pytest.mark.parametrize(
    "size,at",
    [
        ((64, 64, 64), [60.0, 30.0, -400.0]),
        ((45, 37, 29), [-80.0, 50.0, -300.0]),  # no side a multiple of 8
        ((64, 64, 64), [100.0, -80.0, 200.0]),  # inside the volume
    ],
    ids=["outside", "ragged", "inside"],
)
def test_uniform_samples_are_exact_on_an_analytic_scene(monkeypatch, size, at):
    vol = _scene(size)
    cam = _camera(at, [0.0, 0.0, 1000.0])
    verts, pts, samples = _march_samples(monkeypatch, vol, cam)
    n_uniform, table = _check_samples(vol, pts, samples)
    assert np.array_equal(table.numpy().view(np.int32),
                          _table_by_definition(vol.tsdf.numpy(), RAY_BRICK)
                          .view(np.int32))
    assert int(torch.isfinite(verts).all(-1).sum()) > 0.5 * W * H
    assert n_uniform > 10000, n_uniform


def test_uniform_samples_are_exact_on_a_fused_volume(monkeypatch):
    vol = _fused()
    trunc = float(vol.truncation_distance)
    table = uniform_bricks(vol.tsdf)
    finite = table[torch.isfinite(table)]
    # observed free space: uniform bricks whose value is a few ulps off
    # the truncation distance, beside never-observed ones at it
    off = finite[(finite != trunc) & ((finite - trunc).abs() < 1e-5)]
    assert off.numel() > 0 and bool((finite == trunc).any())
    cam = _camera([0.0, 2.0, -90.0], [0.0, 0.0, 300.0])
    verts, pts, samples = _march_samples(monkeypatch, vol, cam)
    n_uniform, _ = _check_samples(vol, pts, samples)
    assert int(torch.isfinite(verts).all(-1).sum()) > 0.2 * W * H
    assert n_uniform > 10000, n_uniform


def test_nan_voxels_make_their_bricks_load(monkeypatch):
    """NaN voxels behind the wall, where no ray samples (a NaN tap would
    make the twin's march index with a NaN): their bricks, and the bricks
    whose apron holds them, are NaN in the table; every other brick is as
    without them; the samples stay exact."""
    vol = _scene((64, 64, 64), wall=1200.0)
    clean = uniform_bricks(vol.tsdf)
    tsdf = vol.tsdf.clone()
    tsdf[57, 41, 25] = float("nan")  # inside brick (7, 5, 3)
    tsdf[48, 16, 16] = float("nan")  # the low corner of brick (6, 2, 2)
    vol = vol.replace(tsdf=tsdf)
    table = uniform_bricks(vol.tsdf)
    nan_bricks = {(7, 5, 3)} | {(6 - dz, 2 - dy, 2 - dx)
                                for dz, dy, dx in itertools.product((0, 1),
                                                                    repeat=3)}
    for bz, by, bx in itertools.product(*map(range, table.shape)):
        if (bz, by, bx) in nan_bricks:
            assert bool(torch.isnan(table[bz, by, bx])), (bz, by, bx)
        else:
            assert torch.equal(table[bz, by, bx].view(torch.int32),
                               clean[bz, by, bx].view(torch.int32))
    assert bool(torch.isfinite(clean[7, 5, 3])) and bool(
        torch.isfinite(clean[6, 2, 2]))
    cam = _camera([60.0, 30.0, -400.0], [0.0, 0.0, 1000.0])
    verts, pts, samples = _march_samples(monkeypatch, vol, cam)
    assert bool(torch.isfinite(samples).all())
    n_uniform, _ = _check_samples(vol, pts, samples)
    assert n_uniform > 10000, n_uniform
