"""The cell ``lmpose512.refine`` on the CPU: config 4's Levenberg-Marquardt
recoveries through ``recover_pose_lm`` at a tiny size. A sound run is
correct, traced or not, and the traced run reads its per-layer metrics
from the program's ``lm.*`` spans and counters; the control and each
planted fault come out not correct; the span placement and the trust
rule hold on hand-made inputs; ``BENCHMARK.json`` holds the cell's
entries."""

import json
from pathlib import Path

import pytest
import torch

from bench_tiny import run_tiny  # puts the benchmark's folder on sys.path

import run
from harness import spans

CELL = "lmpose512.refine"
ROOT = Path(__file__).resolve().parents[2]
METRICS = ("lm_jacobian_device_ms_per_step", "lm_host_ms_per_step", "lm_inlier_share",
           "device_idle_share.step", "launches_per_step", "syncs_per_step")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    result = run_tiny(CELL, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    if trace:
        values = {k: v["value"] for k, v in result["metrics"].items()}
        assert set(values) == set(METRICS), values
        assert 0.0 < values["lm_inlier_share"] <= 100.0
        assert 0.0 < values["lm_jacobian_device_ms_per_step"] < values["lm_host_ms_per_step"]
        assert result["device"]["busy_s"] > 0
    else:
        assert set(result["metrics"]) == {"steps_per_s", "setup_s"}


def test_the_control_is_not_correct():
    result = run_tiny(CELL, control="bfloat16")
    assert not result["correct"], result["checks"]


def _faults():
    import torch.autograd.forward_ad as fwAD

    from tsdf_tpu_torch.pipelines import pose_recovery

    def short_step(fn):
        def scaled(vol, camera, target, xi, lam, *args, **kwargs):
            xi_new, rms = fn(vol, camera, target, xi, lam, *args, **kwargs)
            return xi + 0.9 * (xi_new - xi), rms
        return scaled

    def column_zeroed(fn):
        calls = []

        def zeroed(*args, **kwargs):
            r, m = fn(*args, **kwargs)
            calls.append(None)
            if len(calls) % 6 == 3:  # the third dual pass: the z rotation
                primal, _tangent = fwAD.unpack_dual(r)
                r = fwAD.make_dual(primal, torch.zeros_like(primal))
            return r, m
        return zeroed

    def half_the_pixels(fn):
        def half(*args, **kwargs):
            r, m = fn(*args, **kwargs)
            keep = torch.ones_like(m)
            keep[: m.shape[0] // 2] = False
            return torch.where(keep, r, 0.0), m & keep
        return half

    def twist_moved(fn):
        def moved(*args, **kwargs):
            xi, history = fn(*args, **kwargs)
            history[1]["xi"] = history[1]["xi"] + torch.tensor(
                [0.0, 0.0, 0.0, 1.0, 0.0, 0.0], device=xi.device)
            return xi, history
        return moved

    return {
        "proposal scaled": (pose_recovery, "lm_step", short_step),
        "jacobian column zeroed": (pose_recovery, "banded_residuals", column_zeroed),
        "rms over half the pixels": (pose_recovery, "banded_residuals", half_the_pixels),
        "history twist moved": (pose_recovery, "recover_pose_lm", twist_moved),
    }


@pytest.mark.parametrize("fault", ["proposal scaled", "jacobian column zeroed",
                                   "rms over half the pixels", "history twist moved"])
def test_a_fault_is_not_correct(fault, monkeypatch):
    module, name, plant = _faults()[fault]
    monkeypatch.setattr(module, name, plant(getattr(module, name)))
    result = run_tiny(CELL)
    assert not result["correct"], (fault, result["checks"])


def test_device_time_goes_to_the_innermost_span_and_its_ancestors():
    tree = [("lm.step", 0.0, 10.0), ("lm.march", 1.0, 3.0), ("lm.jacobian", 4.0, 8.0),
            ("lm.step", 11.0, 14.0), ("lm.jacobian", 12.0, 13.0)]
    ops = [(2.0, 2.0, 2.5),     # launched in lm.march
           (5.0, 9.0, 9.75),    # launched in lm.jacobian, ran after it ended
           (9.0, 9.75, 10.0),   # launched in lm.step alone
           (10.5, 10.5, 11.0),  # launched between the steps
           (12.5, 12.5, 13.5),  # in the second lm.jacobian
           (13.9, 13.9, 16.0)]  # clipped at the window's end
    out = spans.attribute(tree, ops, 0.0, 15.0)
    assert out["lm.step"] == {"count": 2, "host_s": 13.0, "device_s": pytest.approx(3.6)}
    assert out["lm.march"] == {"count": 1, "host_s": 2.0, "device_s": 0.5}
    assert out["lm.jacobian"] == {"count": 2, "host_s": 5.0, "device_s": 1.75}
    assert out["device_s"] == pytest.approx(4.1) and out["inside_s"] == pytest.approx(3.6)


def test_the_readers_leave_a_trace_without_spans_out():
    from harness.trace import TraceSummary

    bare = TraceSummary(window_s=1.0, units=4, kernels=[("k", 0.0, 0.5)], mem_ops=[],
                        syncs=4, gaps=[], port_kernels=frozenset(), extras={})
    for name in METRICS[:3]:
        reader = run.load_module(run.reader_path(name), f"test_reader_{name}")
        assert reader.read(bare) is None and reader.read(None) is None


def test_the_trust_rule_follows_the_program_s_own_records():
    lm_driver = run.load_module(run.BENCH / "drivers" / "lm.py", "test_driver_lm")
    cfg = json.load(open(ROOT / "benchmark" / "configs" / "lmpose512.json"))["lm"]
    zero = torch.zeros(6)
    a, b = zero + 1.0, zero + 2.0
    recs = [dict(rms=10.0, lam=5e-3, accepted=True, xi=zero, xi_new=a),
            dict(rms=13.0, lam=4e-2, accepted=False, xi=a, xi_new=b),
            dict(rms=11.9, lam=2e-2, accepted=True, xi=a, xi_new=b)]
    bad, used = lm_driver.chain_gaps(cfg, recs)
    assert bad == 0 and used == [1e-2, 5e-3, 4e-2]
    recs[2] = dict(recs[2], xi=b)
    assert lm_driver.chain_gaps(cfg, recs)[0] == 1


def test_the_benchmark_holds_the_cell_s_entries():
    bench = json.load(open(ROOT / "BENCHMARK.json"))
    config = next(c for c in bench["configs"] if c["name"] == "lmpose512")
    assert config["reduced"] == [] and config["file"] == "benchmark/configs/lmpose512.json"
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lmpose512", "lm_refine", 1)
    assert {m["name"] for m in run.metrics_of(CELL, bench, "end_to_end")} == {
        "steps_per_s", "setup_s"}
    assert {m["name"] for m in run.metrics_of(CELL, bench, "per_layer")} == set(METRICS)
    for m in bench["per_layer"]:
        if m["name"].startswith("lm_"):
            assert m["workloads"] == [CELL] and m["moves"] == "steps_per_s"
