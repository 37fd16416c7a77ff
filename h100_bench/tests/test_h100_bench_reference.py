"""The reference against the program's CPU frame at a small size, for both
configurations, and the control (the reference's lighting in bfloat16)
against the reference."""
import pytest
import torch

from h100_bench import check, drive, scenegen
from h100_bench.reference import render
from h100_bench.tests import small


@pytest.mark.parametrize("name", ["flagship.present", "config4.present"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_against_program(name, seed):
    import d3d12_deferred_renderer_tpu_torch as tp

    _, config, _ = small.cell(name)
    arrays = scenegen.scene_arrays(config["scene"], config["renderer"], seed)
    cfg = drive.port_config(config["renderer"])
    state, frame = tp.step_frame(tp.scene_from_arrays(arrays, "cpu"), cfg)
    clock = float(scenegen.advance_clock(arrays["time"], cfg.yaw_per_frame, 1)[0])
    assert float(state.time) == clock
    want = render.render_frame(render.device_scene(arrays, "cpu"), render.renderer_config(config["renderer"]), clock)
    got = check.frame_numbers(frame, want)
    assert got["max_abs_u8"] <= 1 and got["px_over_1lsb_pct"] == 0.0, got
    assert float((want.amax(-1) > 0).double().mean()) > 0.3  # not a blank frame


@pytest.mark.parametrize("name", ["flagship.present", "config4.present"])
def test_control_is_not_correct(name):
    _, config, _ = small.cell(name)
    arrays = scenegen.scene_arrays(config["scene"], config["renderer"], 5)
    scene = render.device_scene(arrays, "cpu")
    rcfg = render.renderer_config(config["renderer"])
    clock = float(scenegen.advance_clock(arrays["time"], 0.01, 1)[0])
    got = check.frame_numbers(render.render_frame(scene, rcfg, clock, torch.bfloat16),
                              render.render_frame(scene, rcfg, clock))
    limits = check.load_limits(small.BENCH_DIR, name)
    assert not check.judged(got, limits)[0], got


def test_raster_first_record_wins_ties():
    """Two copies of one record: the first keeps every pixel (depth LESS)."""
    from h100_bench.reference import raster
    from h100_bench.reference.setup import TRI_AREA, TRI_MESH_ID, TRI_VALID, TRI_Z0

    rec = torch.zeros((2, 32))
    rec[:, 0:6] = torch.tensor([1.0, 1.0, 30.0, 1.0, 1.0, 20.0])  # positive winding in y-down space
    rec[:, TRI_Z0:TRI_Z0 + 3] = 0.5
    rec[:, TRI_VALID] = 1.0
    rec[:, TRI_AREA] = 29.0 * 19.0
    rec[1, TRI_MESH_ID] = 1.0
    f = raster.rasterize(rec, 24, 32)
    covered = f.mesh_id >= 0
    assert covered.sum() > 100 and bool((f.mesh_id[covered] == 0).all())
    assert torch.allclose(f.depth[covered], torch.full_like(f.depth[covered], 0.5), atol=1e-6)
