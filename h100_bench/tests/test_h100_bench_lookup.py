"""The harness finds each cell's configuration, mix, limits, metrics and
rooflines by name, and BENCHMARK.json keeps to its schema."""
import importlib
import json
import os
import re

import pytest

from h100_bench import check, run
from h100_bench.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_schema():
    b = small.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "h100_bench/run.py"] and b["paths"] == ["h100_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in b["workloads"])) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    metrics = b["end_to_end"] + b["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert all(m["moves"] in {e["name"] for e in b["end_to_end"]} for m in b["per_layer"])
    assert all(len(w["why"]) <= 200 for w in b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in small.bench()["workloads"]])
def test_cell_files_by_name(name):
    b = small.bench()
    (c,) = [w for w in b["workloads"] if w["name"] == name]
    (entry,) = [x for x in b["configs"] if x["name"] == c["config"]]
    config = run.load_json(small.ROOT, entry["file"])
    assert config["name"] == c["config"] and config["reduced"] == entry["reduced"]
    traffic = run.load_json(small.BENCH_DIR, "traffic", f"{c['traffic']}.json")
    from h100_bench import drive

    assert traffic["entry"] in drive.ENTRIES
    assert set(check.load_limits(small.BENCH_DIR, name)) == set(check.EXACT + check.FRAME_NUMBERS)
    for kind in ("end_to_end", "per_layer"):
        metrics = run.cell_metrics(b, name, kind)
        assert metrics, (name, kind)
        for m in metrics:
            assert callable(run.metric_reader(m["name"]))


def test_rooflines_by_name():
    for m in small.bench()["per_layer"]:
        if m["name"].endswith("_roofline"):
            mod = importlib.import_module(f"h100_bench.roofline.{m['name'][:-len('_roofline')]}")
            assert mod.KERNELS and callable(mod.work) and m["unit"] == "%"


def test_every_metric_has_a_file():
    b = small.bench()
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(small.BENCH_DIR, "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert names <= files


@pytest.mark.parametrize("name", [w["name"] for w in small.bench()["workloads"]])
def test_cell_reports_what_its_per_layer_metrics_move(name):
    """A cell reports setup_s, another end-to-end metric and a per-layer
    metric, and every per-layer metric it reports moves one of its own
    end-to-end metrics."""
    b = small.bench()
    ends = {m["name"] for m in run.cell_metrics(b, name, "end_to_end")}
    layers = run.cell_metrics(b, name, "per_layer")
    assert "setup_s" in ends and len(ends) >= 2 and layers
    assert all(m["moves"] in ends for m in layers), [(m["name"], m["moves"]) for m in layers if m["moves"] not in ends]


def test_layer_names_agree():
    """A per-layer metric whose name extends another's (present_host_ms.bands)
    reads the same quantity in other cells: the same layer, unit and
    direction, and no cell reports both."""
    b = small.bench()
    by = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for m in b["per_layer"]:
        base = by.get(m["name"].split(".")[0])
        if base is None or base is m:
            continue
        assert (m["unit"], m["better"]) == (base["unit"], base["better"])
        if "layer" in base:
            assert m["layer"] == base["layer"]
        for w in b["workloads"]:
            names = {x["name"] for k in ("end_to_end", "per_layer") for x in run.cell_metrics(b, w["name"], k)}
            assert not {m["name"], base["name"]} <= names, (w["name"], m["name"])
