"""The port's ``utils/profiling.py`` and ``utils/checkpoint.py``, on the
CPU.

Profiling: the cases of tests/test_profiling.py on torch tensors (spans
produce real elapsed and rate numbers and one JSON log line on the
logger ``tsdf_tpu_torch``, ``sync`` reduces the first leaf only,
``trace`` and ``profile_to`` drive ``torch.profiler``). ``median_ms`` and
``profile_step`` need the card: tests/test_torch_cuda_kernels.py.

Checkpoint: the cases of tests/test_checkpoint.py on one device. Round
trips are bit-equal, optional fields included; a fusion resumed from a
checkpoint is bit-equal with the same frames fused straight, and within
tests/test_torch_integrate.py's gate of JAX's ``integrate`` (weights
equal on >= 99.9 % of the voxels, tsdf within 5e-3 mm where they agree).
"""

import dataclasses
import json
import logging
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch import Camera, integrate, make_volume
from tsdf_tpu_torch.utils import fixtures, profiling
from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- profiling ------------------------------------------------------------------


def test_sync_returns_scalar_checksum():
    assert profiling.sync(torch.arange(8.0)) == pytest.approx(28.0)
    # a nest: only the FIRST leaf ('a' -> 28) is reduced; the whole
    # nest would sum to 32
    x = {"b": torch.ones((2, 2)), "a": torch.arange(8.0)}
    assert profiling.sync(x) == pytest.approx(28.0)
    assert profiling.sync((None, [torch.arange(4, dtype=torch.int32)])) == 6.0
    vol = make_volume((4, 4, 4), 400.0, device=CPU)
    assert profiling.sync(vol) == pytest.approx(float(vol.tsdf.sum()))
    with pytest.raises(ValueError):
        profiling.sync({"a": None})


def test_timer_elapsed_rates_and_json_log(caplog):
    with caplog.at_level(logging.INFO, logger="tsdf_tpu_torch"):
        with profiling.Timer("span", voxels=1000) as t:
            time.sleep(0.01)
            t.result = torch.ones(4)
    assert t.elapsed is not None and t.elapsed >= 0.01
    assert t.rate("voxels") == pytest.approx(1000 / t.elapsed)
    records = [r for r in caplog.records if r.name == "tsdf_tpu_torch"]
    assert len(records) == 1
    payload = json.loads(records[0].message)
    assert payload["span"] == "span"
    assert payload["ms"] >= 10.0
    assert payload["voxels_per_s"] == pytest.approx(t.rate("voxels"))


def test_timer_propagates_exceptions_without_masking():
    with pytest.raises(ValueError, match="boom"):
        with profiling.Timer("bad"):
            raise ValueError("boom")


def test_trace_annotation_context():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.trace("region"):
            y = torch.ones(8) * 2
    assert float(y.sum()) == 16.0
    assert "region" in {e.key for e in prof.key_averages()}


def test_profile_to_writes_trace(tmp_path):
    with profiling.profile_to(str(tmp_path / "trace")):
        profiling.sync(torch.ones(16) + 1)
    produced = [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    assert produced and all(p.stat().st_size > 0 for p in produced)
    trace = json.loads(produced[0].read_text())
    assert "traceEvents" in trace


def test_configure_logging_idempotent_level():
    before = list(profiling.log.handlers)
    level = profiling.log.level
    try:
        profiling.configure_logging(logging.DEBUG)
        assert profiling.log.level == logging.DEBUG
        n_after_first = len(profiling.log.handlers)
        profiling.configure_logging(logging.INFO)
        assert profiling.log.level == logging.INFO
        assert len(profiling.log.handlers) == n_after_first <= len(before) + 1
    finally:
        for h in profiling.log.handlers[:]:
            if h not in before:
                profiling.log.removeHandler(h)
        profiling.log.setLevel(level)


# -- checkpoint -----------------------------------------------------------------


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


def test_roundtrip(tmp_path):
    vol = fixtures.sphere_tsdf(
        make_volume((16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0), device=CPU),
        300.0)
    vol = vol.replace(weight=torch.rand(vol.weight.shape,
                                        generator=torch.Generator().manual_seed(3)))
    save_sharded(vol, str(tmp_path / "ckpt"))
    like = make_volume((16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0), device=CPU)
    out = load_sharded(str(tmp_path / "ckpt"), like)
    _equal(out, vol)
    assert out.device == like.device
    # one slab of every plane, a plain dict of tensors loadable with
    # weights_only, named in a manifest of format 2
    state = torch.load(str(tmp_path / "ckpt" / "slab_000000.pt"),
                       weights_only=True)
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert manifest["format"] == 2
    assert manifest["slabs"] == [
        {"file": "slab_000000.pt", "z0": 0, "planes": 16}]
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    assert "color" not in state and "deform" not in state


def test_roundtrip_with_colour_and_deformation(tmp_path):
    vol = make_volume((8, 12, 16), 1000.0, offset=(0.0, 0.0, 0.0),
                      with_deformation=True, with_color=True, device=CPU)
    vol = vol.replace(color=torch.ones_like(vol.color) * 7,
                      deform=vol.deform + 3.0,
                      deform_rot=vol.deform_rot - 0.25,
                      global_rotation=torch.tensor([0.1, 0.2, 0.3]))
    save_sharded(vol, str(tmp_path / "ckpt2"))
    save_sharded(vol, str(tmp_path / "ckpt2"))  # replaces, leaves no temp
    assert sorted(os.listdir(tmp_path / "ckpt2")) == [
        "manifest.json", "slab_000000.pt"]
    like = make_volume((8, 12, 16), 1000.0, offset=(0.0, 0.0, 0.0),
                       with_deformation=True, with_color=True, device=CPU)
    out = load_sharded(str(tmp_path / "ckpt2"), like)
    _equal(out, vol)
    assert out.color.dtype == torch.uint8


@pytest.mark.parametrize("like", ["shape", "no colour", "extra colour"])
def test_load_rejects_a_like_of_another_structure(tmp_path, like):
    vol = make_volume((8, 8, 8), 800.0, with_color=True, device=CPU)
    save_sharded(vol, str(tmp_path / "c"))
    other = {
        "shape": make_volume((8, 8, 4), 800.0, with_color=True, device=CPU),
        "no colour": make_volume((8, 8, 8), 800.0, device=CPU),
        "extra colour": make_volume((8, 8, 8), 800.0, with_color=True,
                                    with_deformation=True, device=CPU),
    }[like]
    with pytest.raises(ValueError):
        load_sharded(str(tmp_path / "c"), other)


def test_checkpoint_resume_mid_fusion(tmp_path):
    """Fuse 2 frames, checkpoint, restore onto a fresh volume, fuse 2
    more: bit-equal with fusing 4 straight, and within the integrate gate
    of JAX's 4 frames."""
    depth = jax_fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)
    jcam = (tsdf_tpu.Camera.default_depth_camera()
            .move_to([0.0, 0.0, -500.0]).look_at([0.0, 0.0, 1000.0]))
    jvol = tsdf_tpu.make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))
    for _ in range(4):
        jvol = tsdf_tpu.integrate(jvol, jnp.asarray(depth), jcam)

    cam = Camera.from_numpy(
        *(np.asarray(getattr(jcam, n)) for n in ("k", "pose", "k_inv",
                                                 "pose_inv")), device=CPU)
    frame = torch.from_numpy(depth.astype(np.float32))

    def fresh():
        return make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0),
                           device=CPU)

    straight = fresh()
    for _ in range(4):
        integrate(straight, frame, cam)
    vol = fresh()
    for _ in range(2):
        integrate(vol, frame, cam)
    save_sharded(vol, str(tmp_path / "mid"))
    restored = load_sharded(str(tmp_path / "mid"), fresh())
    for _ in range(2):
        restored = integrate(restored, frame, cam)
    _equal(restored, straight)
    wt, wj = restored.weight.numpy(), np.asarray(jvol.weight)
    same = wt == wj
    assert same.mean() >= 0.999 and wt.max() == 4.0
    np.testing.assert_allclose(restored.tsdf.numpy()[same],
                               np.asarray(jvol.tsdf)[same], rtol=0, atol=5e-3)
