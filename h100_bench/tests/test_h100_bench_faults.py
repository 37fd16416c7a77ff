"""Each fault a cell can have, planted under a run on the CPU, makes
`correct` false: a step that leaves its state unchanged, an answer altered
where it is made, half of a batch left out, the exchange between ranks
left out.  The cells' own limits are used: the faults read far above them
at any size."""
import time

import pytest

from h100_bench import check, drive, run
from h100_bench.tests import faults, small

CASES = [("flagship.present", "state_unchanged"), ("flagship.present", "answer_altered"),
         ("config4.present", "answer_altered"),
         ("flagship.batch8", "state_unchanged"), ("flagship.batch8", "half_batch"),
         ("flagship.batch8", "answer_altered"),
         ("flagship.bands4", "state_unchanged"), ("flagship.bands4", "exchange_left_out"),
         ("flagship.bands4", "answer_altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, monkeypatch):
    c, config, traffic = small.cell(name)
    if traffic["entry"] == "bands":
        monkeypatch.setenv(faults.FAULT_ENV, fault)
        monkeypatch.setattr(drive, "band_rank", faults.band_rank)
    else:
        faults.apply(fault, monkeypatch.setattr)
    limits = check.load_limits(small.BENCH_DIR, name)
    out = run.run_once(c, config, traffic, limits, [], 2**31 + 5, 0.2, False, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is False, out["compared"]


def test_capacity_overflow_counts_as_failed():
    """A frame whose binning overflows (a stream cap far under the frame's
    records) counts in `failed` and makes `correct` false."""
    c, config, traffic = small.cell("flagship.present")
    config["renderer"]["bin_stream_cap"] = 64
    out = run.run_once(c, config, traffic, check.load_limits(small.BENCH_DIR, c["name"]), [], 7, 0.2, False,
                       device="cpu", t_start=time.perf_counter())
    assert out["failed"] == out["attempted"] > 0
    assert out["compared"]["overflowed_frames"][0] > 0 and out["correct"] is False


def test_overflow_hook_that_misses_frames_is_not_correct():
    """A run whose overflow log sees none of the window's frames (the frame
    module's warning is off, so the hook is never called) counts them in
    overflow_unlogged and makes `correct` false."""
    c, config, traffic = small.cell("flagship.present")
    config["renderer"]["overflow_warn"] = False
    out = run.run_once(c, config, traffic, check.load_limits(small.BENCH_DIR, c["name"]), [], 8, 0.2, False,
                       device="cpu", t_start=time.perf_counter())
    assert out["compared"]["overflow_unlogged"][0] == out["attempted"] > 0
    assert out["correct"] is False
