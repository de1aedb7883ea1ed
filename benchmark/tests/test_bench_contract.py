"""BENCHMARK.json keeps to the benchmark's contract, every name it uses
finds its file, and nothing the benchmark runs takes JAX or the JAX
package (the reference takes nothing of the port either)."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

import bench_tiny  # noqa: F401
from bench_tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(bench):
    import run

    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        mine = {m["name"] for m in run.metrics_of(w["name"], bench, "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = run.metrics_of(w["name"], bench, "per_layer")
        assert layer and all(m["moves"] in mine for m in layer)


def test_every_name_finds_its_file(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        traffic = json.load(open(BENCH / "traffic" / f"{w['traffic']}.json"))
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    import run

    for m in bench["per_layer"]:
        assert run.reader_path(m["name"]).is_file(), m["name"]
    for c in bench["configs"]:
        cfg = json.load(open(ROOT / c["file"]))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def _imports(path: Path) -> set:
    """The top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_jax_in_the_benchmark_and_no_port_in_the_reference():
    for path in sorted(BENCH.rglob("*.py")):
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "flax", "tsdf_tpu"}, path
        if "reference" in path.parts:
            assert "tsdf_tpu_torch" not in names, path


def test_what_the_harness_and_the_reference_load(monkeypatch):
    """In a fresh interpreter: the harness, every driver and the program's
    modules they reach load neither JAX nor the JAX package, and the
    reference loads nothing of the port."""
    import subprocess

    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]
import reference.fusion, reference.tracking, reference.scenefusion, reference.posegrad
assert not [m for m in sys.modules if m.split('.')[0] in ('tsdf_tpu_torch', 'tsdf_tpu', 'jax')]
import run
for d in ('tracked', 'flow', 'posegrad'):
    run.load_module(run.BENCH / 'drivers' / (d + '.py'), 'd_' + d)
import tsdf_tpu_torch.pipelines.kinfu, tsdf_tpu_torch.pipelines.scenefusion
import tsdf_tpu_torch.pipelines.pose_recovery
assert run.forbidden_modules() == [], run.forbidden_modules()
print('clean')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "tsdf_tpu_torch_like", object())
    assert "tsdf_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tsdf_tpu.ops", object())
    assert "tsdf_tpu.ops" in run.forbidden_modules()
