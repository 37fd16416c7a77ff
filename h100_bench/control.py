"""Readings that the limits of `correct` are set from: the program's and
the control's, at a cell's own size, over many seeds in one process.

    python3 h100_bench/control.py --workload <cell> --seconds 2 --seeds 11 12 13 ...

For each seed it drives the cell's entry for a short window (the cell's
traffic, as a run does), then reads the compared numbers of the program's
sampled frames (check.numbers) and of the control: the reference with its
lighting in bfloat16 put in the program's place at the same clocks
(check.control_numbers).  It prints a JSON line a seed, then one line with
each number's largest program reading and smallest control reading.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def band_ranks(device, jobs: list) -> list:
    """Every job's band rank in one rank process (the rank program is
    captured once and serves every seed)."""
    from h100_bench import drive

    return [drive.band_rank(device, job) for job in jobs]


def readings(cell: dict, config: dict, traffic: dict, seeds: list, seconds: float, device: str = "cuda") -> list:
    """[(seed, program numbers, control numbers)] of each seed."""
    import torch

    from h100_bench import check, drive, scenegen
    from h100_bench.reading import Reading
    from h100_bench.run import free_program

    jobs = [dict(arrays=scenegen.scene_arrays(config["scene"], config["renderer"], s), fields=config["renderer"],
                 traffic=traffic, seconds=seconds, trace=False, seed=s, device=device) for s in seeds]
    if traffic["entry"] == "bands":
        from d3d12_deferred_renderer_tpu_torch import parallel

        per_rank = parallel.run_bands(traffic["ranks"], band_ranks, args=(jobs,), device=device,
                                      timeout_s=traffic["rank_timeout_s"] * len(jobs))
        runs = []
        for k in range(len(jobs)):
            out = per_rank[0][k]
            out["failed"] = max(r[k]["failed"] for r in per_rank)
            runs.append(out)
    else:
        runs = [drive.ENTRIES[traffic["entry"]](job) for job in jobs]
    free_program()
    out = []
    for seed, job, run in zip(seeds, jobs, runs):
        r = Reading(cell=cell, config=config, traffic=traffic, arrays=job["arrays"], run=run, setup_s=0.0,
                    device=device)
        dev = torch.device(device)
        out.append((seed, check.numbers(r, dev), check.control_numbers(r, dev)))
    return out


def main(argv=None) -> int:
    from h100_bench.run import load_json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    (cell,) = [c for c in bench["workloads"] if c["name"] == args.workload]
    (entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = load_json(ROOT, entry["file"])
    traffic = load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    rows = readings(cell, config, traffic, args.seeds, args.seconds)
    for seed, prog, ctl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctl}), flush=True)
    keys = rows[0][2].keys()
    print(json.dumps({"workload": cell["name"], "seeds": len(rows),
                      "program_max": {k: max(r[1][k] for r in rows) for k in rows[0][1]},
                      "control_min": {k: min(r[2][k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
