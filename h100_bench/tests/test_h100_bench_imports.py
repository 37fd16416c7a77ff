"""Nothing the benchmark runs loads JAX or the JAX package: top-level module
names compared whole (the port's own name begins with the JAX package's)."""
import subprocess
import sys

import torch

from h100_bench import run
from h100_bench.tests import faults, small

PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import h100_bench.run, h100_bench.drive, h100_bench.check, h100_bench.control, h100_bench.devtrace
import h100_bench.reading, h100_bench.reference.render, h100_bench.roofline.k2, h100_bench.roofline.k3
import d3d12_deferred_renderer_tpu_torch, d3d12_deferred_renderer_tpu_torch.parallel
for name in {metrics!r}:
    h100_bench.run.metric_reader(name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(h100_bench.run.forbidden_modules())
"""


def test_no_jax_in_the_benchmark():
    b = small.bench()
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=small.ROOT, metrics=metrics)],
                         capture_output=True, text=True, timeout=300, cwd=small.ROOT)
    assert out.returncode == 0, out.stderr
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    top = eval(loaded)  # noqa: S307 (our own probe's output)
    assert "d3d12_deferred_renderer_tpu_torch" in top
    for name in ("jax", "jaxlib", "flax", "d3d12_deferred_renderer_tpu"):
        assert name not in top
    assert forbidden == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    for name in ("jaxlib_extras", "d3d12_deferred_renderer_tpu_torch_x", "d3d12_deferred_renderer_tpu.frame", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert "jax.numpy" in found and "d3d12_deferred_renderer_tpu.frame" in found
    assert "jaxlib_extras" not in found and "d3d12_deferred_renderer_tpu_torch_x" not in found


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import h100_bench.reference.render; "
            "print(sorted(m for m in sys.modules if m.startswith('d3d12')))" % small.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_jax_in_a_rank_exits_4(monkeypatch, capsys):
    """The bands cell's ranks run the window in processes of their own: a
    module named jax loaded in rank 1 (of 2 gloo ranks on the CPU) makes
    the run exit with 4 and print no result."""
    from h100_bench import drive

    monkeypatch.setenv(faults.FAULT_ENV, "jax_loaded")
    monkeypatch.setattr(drive, "band_rank", faults.band_rank)
    real = run.run_once

    def small_run(cell, config, traffic, limits, metrics, seed, seconds, trace):
        _, config, traffic = small.cell(cell["name"])
        return real(cell, config, traffic, limits, metrics, seed, 0.2, trace, device="cpu")

    monkeypatch.setattr(run, "run_once", small_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert "jax" not in sys.modules
    rc = run.main(["--workload", "flagship.bands4", "--seed", str(2**31 + 9), "--seconds", "0.2"])
    captured = capsys.readouterr()
    assert rc == 4 and captured.out == "", captured
    assert "jax" in captured.err
