"""A run's result line on the CPU at a small size: its keys, the compared
numbers last; and the runs that must print no result."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from h100_bench import run
from h100_bench.tests import small


def _run(name, trace, seed=2**31 + 21):
    c, config, traffic = small.cell(name)
    metrics = run.cell_metrics(small.bench(), name, "per_layer" if trace else "end_to_end")
    return run.run_once(c, config, traffic, small.LIMITS, metrics, seed, 0.2, trace, device="cpu",
                        t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    out = _run("flagship.present", trace)
    assert list(out)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, (value, limit) in out["compared"].items():
        assert value <= limit, name
    json.loads(json.dumps(out))
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0
        assert all(len(v) <= 10 for v in out["breakdown"].values())
        assert {"present_host_ms", "step_host_ms"} <= set(out["metrics"])
        assert "k2_roofline" not in out["metrics"]  # no device time on the CPU: the reader returns nothing
    else:
        assert set(out["metrics"]) >= {"fps", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_batch_result_line():
    out = _run("flagship.batch8", 0)
    assert out["correct"] and out["attempted"] % 8 == 0


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "flagship.present", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=small.ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copy(os.path.join(small.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(small.BENCH_DIR, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "flagship.present", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_extended_readers_read_as_their_base():
    """A reader named <metric>.<cells> reads what <metric> reads."""
    import types

    arrivals =[i * 0.002 + (0.003 if i % 17 == 0 else 0.0) for i in range(200)]
    r = types.SimpleNamespace(run={"arrivals": arrivals, "spans": {"present": 0.31}, "span_frames": 120})
    for m in small.bench()["per_layer"]:
        if "." in m["name"]:
            base = m["name"].split(".")[0]
            assert run.metric_reader(m["name"])(r) == run.metric_reader(base)(r) is not None
