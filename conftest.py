"""Scheduling of the test suite under tests/ for pytest-xdist's --dist loadfile.

loadfile sends each file's tests to one worker together, and by default
queues the files by their count of tests, largest first.  The suite's time
sits in a few JAX files whose tests each compile sharded programs over eight
virtual CPU devices for minutes, so a count-ordered queue can leave one
worker on one file long after the others have finished.  This conftest:

* runs each test listed as "file::test" in HEAVIEST_FIRST as a work unit of
  its own; the rest of its file stays one unit, so that its tests, which
  compile the same small frames, share them in one process;
* turns xdist's count-based reorder off and sorts the collected tests by
  HEAVIEST_FIRST, so the work units are handed out heaviest first; units
  not on the list keep their collection order and come after it;
* hands a worker its next unit only when it is down to one pending test;
* runs torch on one CPU thread in every test under tests/: six workers of
  eight OpenMP threads each, beside JAX's own pools, oversubscribe the cores,
  and a plain-version test then takes 10-75 times its time alone.

It is the repository's root conftest, not tests/conftest.py, so that the
JAX suite's own conftest keeps to the JAX backend's settings.

HEAVIEST_FIRST lists every work unit that took 50 s or more under the tier-1
command (six workers), heaviest first; a file's entry weighs what is left of
it once its listed tests are taken out.  Left in collection order, the units
of 50-200 s stretch the run by about a tenth (the queue simulated over the
per-test times of four runs).  A new unit of 50 s or more (measure it with
--durations=0, setup, call and teardown summed) goes in by its seconds.  A
heavy test that shares little with the rest of its file can be listed as
"file::test" to run on its own.
"""
import pytest

TESTS = "tests/"

HEAVIEST_FIRST = [
    "test_tri_sharded.py",
    "test_tri_sharded.py::test_tri_sharded_mesh_order_independent",
    "test_parallel.py",
    "test_parallel.py::test_sharded_overflow_signal",
    "test_band_raster.py",
    "test_dryrun.py::test_dryrun_three_axis_step",
    "test_dryrun.py::test_dryrun_staged_step",
    "test_band_raster.py::test_sharded_fused_band_full_stack_matches_reference",
    "test_tri_sharded.py::test_tri_sharded_full_stack_mesh_order",
    "test_tri_sharded.py::test_tri_sharded_shadows_match_single_device",
    "test_band_raster.py::test_sharded_pallas_pbr_shadows_matches_reference",
    "test_fused.py",
    "test_parallel.py::test_row_sharded_bloom_fxaa_bump_match_single_device",
    "test_tri_sharded.py::test_tri_sharded_bloom_fxaa_bump_match_single_device",
    "test_tri_sharded.py::test_tri_sharded_overflow_signal",
    "test_band_raster.py::test_sharded_fused_unaligned_band_falls_back_to_staged",
    "test_dryrun.py::test_dryrun_interpret_step",
    "test_band_raster.py::test_batch_sharded_fused_bands_match_sequential",
    "test_setup_pallas.py",
    "test_torch_shadow_vis.py",
    "test_torch_fused.py",
    "test_binning_sorted.py",
    "test_calibrate.py",
    "test_torch_parallel.py",
    "test_frame.py",
    "test_shadows.py",
    "test_torch_band_light.py",
    "test_edge_cases.py",
    "test_lighting.py",
    "test_instancing.py",
    "test_torch_band.py",
    "test_raster_pallas.py",
    "test_torch_config4.py",
    "test_torch_bump.py",
]

_RANK = {entry: i for i, entry in enumerate(HEAVIEST_FIRST)}


def work_unit(nodeid):
    """The tests loadfile sends to a worker together, named as in HEAVIEST_FIRST
    for a test under tests/ (else None): the test itself where it is listed
    on its own, else its file."""
    if not nodeid.startswith(TESTS):
        return None
    name = nodeid.removeprefix(TESTS)
    return name if name in _RANK else name.split("::")[0]


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: _RANK.get(work_unit(item.nodeid), len(HEAVIEST_FIRST)))


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeaviestFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return work_unit(nodeid) or super()._split_scope(nodeid)

        def _reschedule(self, node):
            # A worker runs a test once it holds the next one, so one pending
            # test beyond the running one is enough.  xdist tops a worker up
            # whenever two or fewer are pending, which lets a worker ending a
            # file of small tests take several heavy single tests at once
            # while others go idle.
            if self.workqueue and not node.shutting_down and self._pending_of(self.assigned_work[node]) > 1:
                return
            super()._reschedule(node)

    return HeaviestFirstScheduling(config, log)


def pytest_runtest_setup(item):
    if item.nodeid.startswith(TESTS):
        import torch

        torch.set_num_threads(1)
