"""PyTorch port: every refusal of the band path (parallel/sharded._check_band_safe
and the height check), as tests/test_parallel.py and
tests/test_band_raster.py hold JAX's: a band too short for the bloom's
downsampling, the bump's tiles or the PCF's downsampling, and a height that
the band count does not divide, each raised before the first collective.
No spawn.  (Split from tests/test_torch_parallel.py.)
"""

import pytest

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.parallel import sharded


def _one_of_n_bands(mp, n):
    """render_sharded as rank 0 of n, without a process group (every check
    below raises before the first collective)."""
    mp.setattr(sharded.BandGroup, "of", staticmethod(lambda group=None: sharded.BandGroup(None, 0, n, True)))


@pytest.mark.parametrize("change,bands,match", [
    (dict(bloom=True, shading="pbr"), 4, "downsample"),        # 32 / 4 = 8 rows: bloom fine
    (dict(bloom=True, shading="pbr"), 16, "downsample"),       # 2 rows
    (dict(normal_mapping=True, shading="pbr"), 8, "tile_h"),   # 4 rows
    (dict(shadows=True, shading="pbr", shadow_vis_downsample=2), 2, "shadow_vis_downsample"),
    (dict(height=30), 4, "not divisible"),
], ids=["bloom_ok", "bloom", "normal_mapping", "shadow_vis_downsample", "height"])
def test_band_refusals_are_loud(change, bands, match):
    cfg = tp.RendererConfig(**{**dict(width=128, height=32, use_pallas=False), **change})
    band = cfg.height // bands
    if match == "downsample" and band % 4 == 0:
        sharded._check_band_safe(cfg, band)  # accepted
        return
    if match != "not divisible":
        with pytest.raises(ValueError, match=match):
            sharded._check_band_safe(cfg, band)
    with pytest.MonkeyPatch.context() as mp:
        _one_of_n_bands(mp, bands)
        with pytest.raises(ValueError, match=match):
            sharded.render_sharded(None, cfg)
