"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name: BENCHMARK.json names them, and each has
a file of its own under h100_bench/ (configs/<config>.json,
traffic/<mix>.json, limits/<cell>.json, metrics/<metric>.py,
roofline/<kernel>.py).  The run builds the scene from the seed, drives the
cell's entry (drive.py), checks the frames it presented against the plain
reference (check.py), reads the cell's end-to-end metrics (--trace 0) or
per-layer metrics (--trace 1) and prints one JSON line last on standard
output; the compared numbers and their limits are the last lines on
standard error and the last key of that line.  It exits with 3, printing
no result, without the CUDA cards the cell asks for, and with 4 when a JAX
module is loaded once the window has closed, in its own process or in a
rank process of the cell.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "d3d12_deferred_renderer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def metric_reader(name: str):
    """metrics/<name>.py's read()."""
    spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{name}",
                                                  os.path.join(BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of bench[kind] that the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def free_program() -> None:
    """Drop the program's captured frames and rank programs and their pools."""
    import torch
    from d3d12_deferred_renderer_tpu_torch import frame, parallel

    frame.step_frame_jit.cache_clear()
    parallel.render_sharded.cache_clear()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_once(cell: dict, config: dict, traffic: dict, limits: dict, metrics: list, seed: int,
             seconds: float, trace: bool, device: str = "cuda", t_start: float = T_START) -> dict:
    """One run of a cell -> the result line's object."""
    import torch

    from h100_bench import check, drive, scenegen
    from h100_bench.reading import Reading

    arrays = scenegen.scene_arrays(config["scene"], config["renderer"], seed)
    job = dict(arrays=arrays, fields=config["renderer"], traffic=traffic, seconds=seconds, trace=trace,
               seed=seed, device=device)
    run = drive.ENTRIES[traffic["entry"]](job)
    free_program()
    reading = Reading(cell=cell, config=config, traffic=traffic, arrays=arrays, run=run,
                      setup_s=run["window_start"] - t_start, device=device)
    found = sorted(set(forbidden_modules()) | set(run.get("rank_forbidden", ())))
    if found:
        raise ForbiddenModules(found)
    correct, compared = check.judged(check.numbers(reading, torch.device(device)), limits)
    values = {}
    for m in metrics:
        v = metric_reader(m["name"])(reading)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": int(run["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": run["attempted"] + run.get("span_attempted", 0),
           "failed": run["failed"] + run.get("span_failed", 0), "metrics": values, "device": dev}
    prof = run.get("profile")
    if trace and prof:
        busy = prof.get("busy_s_ranks", [prof["busy_s"]])
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    if device == "cuda":
        dev["power_limit"] = power_limit()
    if "bytes_sent_per_frame" in run:  # sharded.bytes_sent: not a metric yet
        out["_earlier"] = [{"bytes_into_collectives_per_frame_rank0": run["bytes_sent_per_frame"]}]
    out["compared"] = compared
    return out


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = load_json(ROOT, cfg_entry["file"])
    traffic = load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    from h100_bench import check

    limits = check.load_limits(BENCH_DIR, cell["name"])
    metrics = cell_metrics(bench, cell["name"], "per_layer" if args.trace else "end_to_end")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        out = run_once(cell, config, traffic, limits, metrics, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"modules of JAX or the JAX package are loaded: {e.args[0]}", file=sys.stderr)
        return 4
    for line in out.pop("_earlier", []):
        print(json.dumps(line))
    for name, (value, limit) in out["compared"].items():
        print(f"compared {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
