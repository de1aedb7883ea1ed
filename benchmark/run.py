"""Run one cell of the benchmark of ``tsdf_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``: the configuration in ``benchmark/configs/``, the mix
in ``benchmark/traffic/<traffic>.json``, whose ``driver`` names the loop
in ``benchmark/drivers/``, the limits of its check in
``benchmark/limits/<workload>.json``, and each per-layer metric's reader
in ``benchmark/layer_metrics/<metric>.py``, or, where there is none, the
reader named by the metric's name up to its first dot: ``<metric>`` is
then ``<reader>.<cells>``, one quantity split by the end-to-end metric it
moves. The last line of standard
output is the result as one JSON object; the numbers that decided
``correct`` close standard error, each beside its limit.

``--control bfloat16`` runs the program with its bfloat16 storage switched
on: the control that the check must refuse. The benchmark's own runs do
not use it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache of a run lives at a fixed path inside the checkout, so that
# only a checkout's first run builds or compiles (the kernels' library is
# built by the program into tsdf_tpu_torch/csrc/build/)
CACHE = BENCH / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
for path in (str(ROOT), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

# top-level module names that may not be loaded in the process that
# prints the result: JAX and the JAX package this port replaces
FORBIDDEN = ("jax", "jaxlib", "flax", "tsdf_tpu")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, bench: dict) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, limits) by name."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return entry, config, traffic, limits


def metrics_of(workload: str, bench: dict, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those listing it, and those listing no cell whose ``moves``
    (or, end to end, they themselves) the cell reports: the contract has
    a metric without ``workloads`` reported in every such cell, later
    cells included."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e_names)]


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``layer_metrics/<metric>.py``,
    else the one named by the metric's name up to its first dot."""
    own = BENCH / "layer_metrics" / f"{metric}.py"
    if own.is_file():
        return own
    return BENCH / "layer_metrics" / f"{metric.split('.', 1)[0]}.py"


def run(args, device=None, resize=None) -> dict:
    """One run; returns the result object. The harness's tests drive a
    run on the CPU: ``device`` then stands for the card, and ``resize``
    shrinks the cell's configuration and traffic mix in place."""
    import torch

    from harness.common import Ctx

    bench = load_json(ROOT / "BENCHMARK.json")
    entry, config, traffic, limits = cell(args.workload, bench)
    if resize is not None:
        resize(config, traffic)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"{args.workload} needs {entry['chips']} cards, "
                             f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    ctx = Ctx(workload=args.workload, config=config, traffic=traffic,
              limits=limits, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device, control=args.control)
    driver = load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                         f"bench_driver_{traffic['driver']}")
    out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package is loaded: {found}")
    setup_s = out.window_start - T_PROCESS

    metrics = {}
    if ctx.trace:
        for m in metrics_of(args.workload, bench, "per_layer"):
            reader = load_module(reader_path(m["name"]),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.metrics, setup_s=setup_s)
        for m in metrics_of(args.workload, bench, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in out.checks}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": entry["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if ctx.trace:
        from harness.trace import breakdown

        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = breakdown(out.trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None)
    args = p.parse_args(argv)
    result = run(args)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
