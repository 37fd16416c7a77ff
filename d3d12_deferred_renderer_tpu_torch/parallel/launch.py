"""Run N band ranks of the screen-row band path on one host.

``run_bands(n, job, args, device)`` spawns n processes (torch.multiprocessing,
spawn method; on the card unless the caller passes device="cpu"), joins
them in one rows group (mesh.make_rows_group, at a free localhost port)
and runs ``job(device, *args)`` in each, the rank's device first; it
returns each rank's result in rank order.  A job returns host objects
(numpy arrays, numbers): results come back pickled.  A spawned rank
imports the module that defines its job, so a job lives in a module that
imports no JAX (this one, or the script that runs the ranks).

Every wait has a deadline: a rank that raises, dies or is still running
when ``timeout_s`` has passed fails the call, and every rank still alive
is killed before it returns.

``sharded_frames`` is the job the tests run: parallel/sharded.render_sharded
of scenes carried as convert.py's arrays.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import make_rows_group, rank_device


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, kind, job, args, results, timeout_s):
    try:
        device = rank_device(kind, rank, n)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # ranks on the CPU share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        make_rows_group(rank, n, f"tcp://localhost:{port}", device, timeout_s)
        try:
            results.put((rank, True, job(device, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: report to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_bands(n: int, job, args=(), device: str = "cuda", timeout_s: float = 300.0) -> list:
    """job(device, *args) in each of n band ranks -> [result of rank 0, ...].
    device "cuda", the default (a card per rank and NCCL when there are
    enough cards, else every rank on card 0 and gloo), or "cpu" (gloo).
    Raises RuntimeError, before it spawns a rank, where the card is asked
    for and there is none (it never falls back to the CPU); RuntimeError
    when a rank fails or dies, TimeoutError past timeout_s."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the band ranks run on the GPU by default; "
            "pass device=\"cpu\" to run them on the CPU"
        )
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, device, job, tuple(args), results, timeout_s),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failed = {}, []
    try:
        while len(got) < n and not failed:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failed.append(f"band ranks {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"band ranks {sorted(set(range(n)) - set(got))} still running "
                                       f"after {timeout_s} s")
                continue
            if ok:
                got[rank] = value
            else:
                failed.append(f"band rank {rank} of {n} raised:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if not failed else 1.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [got[r] for r in range(n)]


def sharded_frames(device, scenes):
    """The band job of the tests: render_sharded of each (arrays, cfg) in
    turn, the scene carried as convert.py's arrays -> [(uint8 frame [H, W,
    3] as numpy, summed overflow), ...]."""
    from ..convert import scene_from_arrays
    from .sharded import render_sharded

    out = []
    for arrays, cfg in scenes:
        frame, stats = render_sharded(scene_from_arrays(arrays, device), cfg, return_stats=True)
        out.append((frame.cpu().numpy(), int(stats["overflow"])))
    return out
