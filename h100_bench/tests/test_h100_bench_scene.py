"""The frozen scene generators against their seeds."""
import hashlib
import json

import numpy as np

from h100_bench import scenegen
from h100_bench.tests import small


def _digest(arrays, keys) -> str:
    h = hashlib.sha256()
    for k in keys:
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()[:16]


def test_flagship_scene_is_fixed_and_seeded():
    with open(f"{small.ROOT}/h100_bench/configs/flagship_1080p.json") as fh:
        config = json.load(fh)
    a = scenegen.scene_arrays(config["scene"], config["renderer"], 7)
    b = scenegen.scene_arrays(config["scene"], config["renderer"], 7)
    c = scenegen.scene_arrays(config["scene"], config["renderer"], 2**31 + 9)
    assert a["geometry.tri_mesh_id"].shape == (23906,)
    assert a["geometry.fv_pos_cols"].shape == (3, 3, 23906)
    geometry = [k for k in a if k.startswith("geometry.")] + ["position", "scale"]
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for k in geometry:  # the meshes and their placement do not move with the seed
        assert np.array_equal(a[k], c[k]), k
    for k in ("lights.point_position", "lights.point_color", "materials.albedo", "time"):
        assert not np.array_equal(a[k], c[k]), k
    # One set of lights for every seed, in another order: the same work a frame.
    key = lambda x: np.lexsort(x["lights.point_position"].T)  # noqa: E731
    for k in ("lights.point_position", "lights.point_color"):
        assert np.array_equal(a[k][key(a)], c[k][key(c)]), k
    assert _digest(a, geometry) == "73da028e88c5de90"
    assert a["lights.point_position"].shape == (256, 3) and np.all(a["lights.point_radius"] == np.float32(1.2))
    assert 0 <= a["time"] < scenegen.TWO_PI_F32 and a["time"].dtype == np.float32


def test_negative_and_large_seeds():
    _, config, _ = small.cell("flagship.present")
    for seed in (-5, 0, 2**31 + 3, 2**40):
        a = scenegen.scene_arrays(config["scene"], config["renderer"], seed)
        assert np.isfinite(a["lights.point_position"]).all()


def test_clock_matches_the_program():
    import torch

    from d3d12_deferred_renderer_tpu_torch import scene

    t = torch.tensor(6.2, dtype=torch.float32)
    got = []
    for _ in range(40):
        t = scene._mod(t + 0.01, 2.0 * 3.141592653589793)
        got.append(float(t))
    want = scenegen.advance_clock(np.float32(6.2), 0.01, 40)
    assert [float(w) for w in want] == got
