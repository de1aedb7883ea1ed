"""Rigid integration in tsdf_tpu_torch vs the JAX package.

Tolerances:
  * plain twin vs ``tsdf_tpu.ops.integrate``: weights equal on >= 99.9%
    of voxels and tsdf within 5e-3 mm where the weights agree (the JAX
    package's own kernel-vs-lax gate, tests/test_integrate_pallas.py).
    Both compute in float32; the JAX side projects with a 3x3 matmul, so
    a voxel at a half-pixel sliver may round to the neighbouring pixel;
  * vs ``integrate_pallas(mode="line", interpret=True)``: the JAX
    line-vs-exact gate, weights equal on > 99.5% and tsdf within 5 mm
    where both are observed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.kernels.integrate import integrate_pallas
from tsdf_tpu.ops.integrate import integrate as jax_integrate
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, TSDFVolume
from tsdf_tpu_torch.kernels import integrate as kint
from tsdf_tpu_torch.ops.integrate import integrate

CPU = torch.device("cpu")


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


def _noisy_depth(rng, w, h, radius, lo, hi):
    d = jax_fixtures.sphere_depth_map(w, h, radius, lo, hi).astype(np.float32)
    d = d + (d > 0) * rng.uniform(-4.0, 4.0, d.shape).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.02] = 0.0  # dropouts
    return d


def _assert_gate(tsdf, weight, jvol, min_agree=0.999):
    wj = np.asarray(jvol.weight)
    same = weight == wj
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_allclose(tsdf[same], np.asarray(jvol.tsdf)[same],
                               rtol=0, atol=5e-3)


@pytest.mark.parametrize(
    "size,at,target",
    [
        ((48, 48, 48), [0.0, 0.0, -500.0], [0.0, 0.0, 1000.0]),
        ((40, 32, 36), [400.0, -250.0, -600.0], [-100.0, 150.0, 1200.0]),
    ],
)
def test_twin_matches_jax_over_frames(size, at, target):
    rng = np.random.default_rng(0)
    jvol = tsdf_tpu.make_volume(size, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    tvol = _to_port(jvol)
    base = tsdf_tpu.Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
    for i in range(3):
        jcam = base.move_to(np.add(at, [40.0 * i, -25.0 * i, 10.0 * i])
                            ).look_at(target)
        depth = _noisy_depth(rng, 160, 120, 40.0, 800.0, 1600.0)
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam)
        tvol = integrate(tvol, torch.from_numpy(depth), _cam_to_port(jcam))
    assert float(jnp.sum(jvol.weight)) > 1000
    _assert_gate(tvol.tsdf.numpy(), tvol.weight.numpy(), jvol)


def test_twin_cap_weight_matches_jax():
    jvol = tsdf_tpu.make_volume((24, 24, 24), 1000.0,
                                offset=(-500.0, -500.0, 0.0), max_weight=2.0)
    tvol = _to_port(jvol)
    jcam = tsdf_tpu.Camera.default_depth_camera().move_to(
        [0.0, 0.0, -300.0]).look_at([0.0, 0.0, 500.0])
    depth = jax_fixtures.sphere_depth_map(64, 48, 12.0, 400.0, 800.0)
    for _ in range(4):
        jvol = jax_integrate(jvol, jnp.asarray(depth), jcam, cap_weight=True)
        tvol = integrate(tvol, torch.from_numpy(depth.astype(np.float32)),
                         _cam_to_port(jcam), cap_weight=True)
    assert float(tvol.weight.max()) == 2.0
    _assert_gate(tvol.tsdf.numpy(), tvol.weight.numpy(), jvol)


def test_twin_vs_pallas_line_mode():
    jvol = tsdf_tpu.make_volume((32, 32, 32), 2000.0,
                                offset=(-1000, -1000, 0))
    jcam = tsdf_tpu.Camera.from_intrinsics(
        147.775, 147.525, 82.75, 58.65).move_to(
        [300.0, -200.0, -500.0]).look_at([50.0, 80.0, 1000.0])
    depth = jax_fixtures.sphere_depth_map(160, 120, 40.0, 800.0, 1200.0)
    line, miss = integrate_pallas(jvol, depth, jcam, mode="line",
                                  interpret=True)
    assert int(miss) == 0
    out = integrate(_to_port(jvol), torch.from_numpy(depth.astype(np.float32)),
                    _cam_to_port(jcam))
    wl, wt = np.asarray(line.weight), out.weight.numpy()
    assert (wl == wt).mean() > 0.995
    both = (wl > 0) & (wt > 0)
    assert both.sum() > 100
    np.testing.assert_allclose(out.tsdf.numpy()[both],
                               np.asarray(line.tsdf)[both], rtol=0, atol=5.0)


def _small():
    jvol = tsdf_tpu.make_volume((16, 16, 16), 1000.0,
                                offset=(-500.0, -500.0, 0.0))
    jcam = tsdf_tpu.Camera.default_depth_camera().move_to(
        [0.0, 0.0, -300.0]).look_at([0.0, 0.0, 500.0])
    depth = jax_fixtures.sphere_depth_map(64, 48, 12.0, 400.0, 800.0)
    return _to_port(jvol), _cam_to_port(jcam), torch.from_numpy(
        depth.astype(np.float32))


def test_wrapper_runs_twin_in_place_on_cpu():
    vol, cam, depth = _small()
    want = integrate(vol, depth, cam)
    ptr = vol.tsdf.data_ptr()
    before = kint.KERNEL.launches
    out = kint.integrate_cuda(vol, depth, cam)
    assert kint.KERNEL.launches == before  # no kernel on the CPU
    assert out is vol and vol.tsdf.data_ptr() == ptr
    assert torch.equal(vol.tsdf, want.tsdf)
    assert torch.equal(vol.weight, want.weight)


@pytest.mark.parametrize(
    "bad",
    ["depth_int32", "depth_3d", "depth_strided", "tsdf_f64", "weight_shape",
     "meta_device", "deformed"],
)
def test_wrapper_rejects_bad_inputs(bad):
    vol, cam, depth = _small()
    if bad == "depth_int32":
        depth = depth.to(torch.int32)
    elif bad == "depth_3d":
        depth = depth[None]
    elif bad == "depth_strided":
        depth = depth.t()
    elif bad == "tsdf_f64":
        vol = vol.replace(tsdf=vol.tsdf.double())
    elif bad == "weight_shape":
        vol = vol.replace(weight=vol.weight[:-1].contiguous())
    elif bad == "meta_device":
        depth = depth.to("meta")
    elif bad == "deformed":
        # the rigid kernel refuses a deformed volume with the reason of
        # the JAX integrate_pallas; the warped wrapper fuses it, and is
        # held against tsdf_tpu.ops.integrate
        vol = vol.replace(deform=(vol.voxel_centres() + 20.0).contiguous())
        with pytest.raises(ValueError, match="rigid path"):
            kint.integrate_cuda(vol, depth, cam)
        jvol = tsdf_tpu.make_volume(
            (16, 16, 16), 1000.0, offset=(-500.0, -500.0, 0.0)
        ).replace(deform=jnp.asarray(vol.deform.numpy()))
        jcam = tsdf_tpu.Camera.default_depth_camera().move_to(
            [0.0, 0.0, -300.0]).look_at([0.0, 0.0, 500.0])
        want = jax_integrate(jvol, jnp.asarray(depth.numpy()), jcam)
        out = kint.integrate_warped_cuda(vol, depth, cam)
        _assert_gate(out.tsdf.numpy(), out.weight.numpy(), want)
        return
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        kint.integrate_cuda(vol, depth, cam)
