"""On the card, at the cells' own sizes: a short run of each one-card cell
comes out correct; the control (the reference's lighting in bfloat16 put
in the program's place) does not, on three seeds; nor does a run with a
fault planted in the timed path (tests/faults.py).  Each test prints the
numbers it compared.  Run on the chip with
``python -m pytest -s -p no:cacheprovider h100_bench/tests/test_h100_bench_card.py``
(the bands cell's tests need 4 cards); skipped without the cards."""
import json
import time

import pytest
import torch

from h100_bench import check, control, drive, run
from h100_bench.tests import faults, small

CELLS = [w["name"] for w in small.bench()["workloads"]]
ONE_CARD = [w["name"] for w in small.bench()["workloads"] if w["chips"] == 1]
FAULTS = {"present": ("state_unchanged", "answer_altered"),
          "batch": ("state_unchanged", "half_batch", "answer_altered"),
          "bands": ("state_unchanged", "exchange_left_out", "answer_altered")}


def _full(name):
    b = small.bench()
    (c,) = [w for w in b["workloads"] if w["name"] == name]
    (entry,) = [x for x in b["configs"] if x["name"] == c["config"]]
    return (c, run.load_json(small.ROOT, entry["file"]),
            run.load_json(small.BENCH_DIR, "traffic", f"{c['traffic']}.json"))


def _cards(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s): the benchmark measures the port on the H100")


def _run_once(name, seed):
    c, config, traffic = _full(name)
    metrics = run.cell_metrics(small.bench(), name, "end_to_end")
    run.free_program()
    return run.run_once(c, config, traffic, check.load_limits(small.BENCH_DIR, name), metrics, seed, 1.0, False,
                        t_start=time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_runs_correct(name):
    _cards()
    out = _run_once(name, 4242)
    print(json.dumps({"cell": name, "fault": None, "compared": out["compared"]}))
    assert out["correct"], out["compared"]
    assert out["device"]["count"] == 1 and out["metrics"]["fps"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name):
    c, config, traffic = _full(name)
    _cards(c["chips"])
    limits = check.load_limits(small.BENCH_DIR, name)
    for seed, prog, ctl in control.readings(c, config, traffic, [4343, 4344, 4345], 1.0):
        print(json.dumps({"cell": name, "seed": seed, "program": prog, "control": ctl}))
        assert check.judged(prog, limits)[0], prog
        assert not check.judged({**prog, **ctl}, limits)[0], ctl


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in FAULTS[_full(n)[2]["entry"]]])
def test_fault_is_not_correct_at_cell_size(name, fault, monkeypatch):
    c, _, traffic = _full(name)
    _cards(c["chips"])
    if traffic["entry"] == "bands":
        monkeypatch.setenv(faults.FAULT_ENV, fault)
        monkeypatch.setattr(drive, "band_rank", faults.band_rank)
    else:
        faults.apply(fault, monkeypatch.setattr)
    out = _run_once(name, 4546)
    print(json.dumps({"cell": name, "fault": fault, "compared": out["compared"]}))
    assert out["correct"] is False, out["compared"]
