"""Scene-budget auto-calibration.

The counterpart of d3d12_deferred_renderer_tpu/calibrate.py.  Every capacity
cap of RendererConfig (binning tier budgets, record-stream cap, triangles
per tile, sparse-PCF tile cap, live-light list depth) trades memory traffic
and sort keys against headroom, and the right value depends on the scene
and the camera path:

    calibrated_cfg, report = autotune(state, cfg, yaw_steps=24, margin=0.3)

sweeps the whole 2*pi animation orbit, measures the per-frame maxima of each
capacity, picks the binning tier ladder (footprint thresholds) with the
fewest emitted sort keys, and returns a config whose budgets carry `margin`
headroom over the measured maxima.  ``autotune_shadow`` does the same for
the shadow map's light-view binning (cfg.shadow_bin_tiers).  Every derived
cap still overflows loudly at run time.

The measurements run on the scene's device, one host read per orbit step;
the ladder search and the budget arithmetic are host numpy, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import RendererConfig
from .scene import SceneState, animate

# Candidate tier ladders (bin_expand, bin_expand_medium, bin_expand_large).
# The structure is fixed (four tiers, rect expansions); the ladder choice and
# the per-tier budgets are what calibration derives.
_LADDERS: Tuple[Tuple[int, int, int], ...] = (
    (2, 8, 64),      # FLAGSHIP_CONFIG's hand-tuned ladder
    (4, 32, 256),    # the untuned default
    (2, 16, 128),
    (4, 16, 96),
    (2, 8, 128),
    (4, 8, 64),
)


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _tile_rects(aabb, valid, TH: int, TW: int, nty: int, ntx: int):
    """Per triangle: live (its tile rectangle meets the grid) and the
    clamped rectangle (tx0, tx1, ty0, ty1), the binning's criterion."""
    tx0 = torch.floor(aabb[:, 0] / TW).to(torch.int64)
    ty0 = torch.floor(aabb[:, 1] / TH).to(torch.int64)
    tx1 = torch.floor(aabb[:, 2] / TW).to(torch.int64)
    ty1 = torch.floor(aabb[:, 3] / TH).to(torch.int64)
    live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
    return live, tx0.clamp(0, ntx - 1), tx1.clamp(0, ntx - 1), ty0.clamp(0, nty - 1), ty1.clamp(0, nty - 1)


def _measure_frame(state: SceneState, cfg: RendererConfig) -> torch.Tensor:
    """One orbit sample's capacity observables, on the scene's device, in
    one int64 tensor: footprint [T] (tile-rect areas, 0 = not live),
    tile_counts [NT], then total pairs, covered 8 x 128 tiles and the
    largest live-light count of a tile."""
    from .ops.lighting import cull_lights_to_tiles, inverse_view_proj
    from .ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    live, tx0, tx1, ty0, ty1 = _tile_rects(tris.aabb, tris.valid, TH, TW, nty, ntx)
    footprint = torch.where(live, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)

    # True per-tile counts from a 2D difference grid (+1/-1 at the rect
    # corners, a double cumsum): the binning's criterion without its caps.
    one = live.to(torch.int64)
    grid = torch.zeros((nty + 1, ntx + 1), dtype=torch.int64, device=one.device)
    for ys, xs, sign in ((ty0, tx0, 1), (ty0, tx1 + 1, -1), (ty1 + 1, tx0, -1), (ty1 + 1, tx1 + 1, 1)):
        grid.index_put_((ys, xs), sign * one, accumulate=True)
    tile_counts = torch.cumsum(torch.cumsum(grid, 0), 1)[:nty, :ntx].reshape(-1)

    # Covered 8 x 128 tiles (the sparse-PCF cap) and live lights per tile
    # (the list depth) need the frame's depth: the depth-only raster kernel
    # on the display grid, or the reference raster.
    if cfg.use_pallas:
        from .ops.raster_tiles import rasterize_depth

        depth = rasterize_depth(tris.packed, tris.aabb, tris.valid, cfg)
    else:
        from .ops.raster_ref import rasterize_packed

        depth = rasterize_packed(tris.packed, H, W).depth
    if H % 8 == 0 and W % 128 == 0:
        d_t = depth.reshape(H // 8, 8, W // 128, 128).transpose(1, 2).reshape(-1, 8 * 128)
    else:
        d_t = depth.reshape(1, -1)
    covered = (d_t.amin(1) < 1.0).sum()
    L = state.lights.num_point
    if L:
        tl = cull_lights_to_tiles(depth, state.lights, cfg, vp, tile=(TH, TW), max_per_tile=L,
                                  inv_vp=inverse_view_proj(vp))
        light_max = tl.counts.max().to(torch.int64)
    else:
        light_max = torch.zeros((), dtype=torch.int64, device=depth.device)
    scalars = torch.stack([tile_counts.sum(), covered, light_max])
    return torch.cat([footprint, tile_counts, scalars])


def autotune(state: SceneState, cfg: RendererConfig, yaw_steps: int = 24, margin: float = 0.3):
    """Sweep the whole 2*pi yaw orbit in `yaw_steps` samples and derive every
    scene-dependent capacity with `margin` headroom.  Returns
    (calibrated RendererConfig, report dict).

    The derived budgets bind only on the sort path of the binning (small
    scenes take the flat overlap matrix, which has no tier budgets); the
    stream cap, triangle cap, PCF tile cap and light-list depth bind on
    every path."""
    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    k_max = pairs_max = covered_max = lights_max = 0
    _fps = []  # per-frame footprint arrays, for the ladder evaluation
    s = state
    for _ in range(yaw_steps):
        s = animate(s, 2.0 * np.pi / yaw_steps, cfg)
        m = _measure_frame(s, cfg).cpu().numpy()  # the step's one host read
        T = m.shape[0] - NT - 3
        fp, counts, (pairs, covered, lmax) = m[:T], m[T : T + NT], m[T + NT :]
        k_max = max(k_max, int(counts.max()))
        pairs_max = max(pairs_max, int(pairs))
        covered_max = max(covered_max, int(covered))
        lights_max = max(lights_max, int(lmax))
        _fps.append(fp)

    T = _fps[0].shape[0]
    area_scale = max(1, round((H * W) / (1920 * 1080)))

    def bucket_maxima(e, em, el):
        """Per-frame maxima of each tier's occupancy for a ladder (scaled
        thresholds, as bin_triangles applies them)."""
        E, EM, EL = e * area_scale, em * area_scale, el * area_scale
        ns = nm = nl = nb = 0
        for fp in _fps:
            live = fp > 0
            ns = max(ns, int((live & (fp <= E)).sum()))
            nm = max(nm, int((live & (fp > E) & (fp <= EM)).sum()))
            if EL < NT:
                nl = max(nl, int((live & (fp > EM) & (fp <= EL)).sum()))
                nb = max(nb, int((live & (fp > EL)).sum()))
            else:
                nl = max(nl, int((live & (fp > EM)).sum()))
        return ns, nm, nl, nb

    best = None
    for e, em, el in _LADDERS:
        ns, nm, nl, nb = bucket_maxima(e, em, el)
        # Budgets with margin, aligned as the binning expects (128 rows for
        # the small tier, 8 for the rest), in 1080p-equivalent units:
        # bin_triangles multiplies every tier budget and the stream cap by
        # area_scale at run time.
        LS = min(_round_up(ns * (1 + margin) / area_scale + 1, 128), T)
        MB = min(_round_up(nm * (1 + margin) / area_scale + 1, 8), T)
        ML = min(_round_up(nl * (1 + margin) / area_scale + 1, 8), T)
        BB = min(max(_round_up(nb * (1 + margin) / area_scale + 1, 8), 8), T)
        E, EM, EL = e * area_scale, em * area_scale, el * area_scale
        keys = (LS * E + MB * EM + ML * EL + (BB * NT if EL < NT else 0)) * area_scale
        cand = (keys, (e, em, el), (LS, MB, ML, BB))
        if best is None or cand[0] < best[0]:
            best = cand

    keys, (e, em, el), (LS, MB, ML, BB) = best
    stream_cap = min(
        _round_up(pairs_max * (1 + margin) / area_scale, 1024),
        -(-int(keys) // area_scale),  # no more than the emitted keys
    )
    k_cap = min(_round_up(k_max * (1 + margin), 8), T)
    pcf_cap = min(_round_up(covered_max * (1 + margin), 8), NT)
    # Live-light list depth (16-aligned: the lists pad to CHUNK).
    L = state.lights.num_point
    light_cap = min(_round_up(max(lights_max, 1) * (1 + margin), 16), max(L, 1))

    out = dataclasses.replace(
        cfg,
        bin_expand=e, bin_expand_medium=em, bin_expand_large=el,
        bin_max_small=LS, bin_max_medium=MB, bin_max_large=ML, bin_max_big=BB,
        bin_stream_cap=stream_cap, max_tris_per_tile=k_cap, shadow_tiles_cap=pcf_cap,
        # 0: the lit-tile PCF cap follows the cap derived above, not a
        # scene-specific value the config inherited.
        shadow_tiles_cap_lit=0,
        max_live_lights_per_tile=light_cap,
    )
    report = {
        "ladder": (e, em, el),
        "budgets": {"small": LS, "medium": MB, "large": ML, "big": BB},
        "sort_keys": int(keys),
        "stream_cap": stream_cap,
        "max_tris_per_tile": k_cap,
        "shadow_tiles_cap": pcf_cap,
        "max_live_lights_per_tile": light_cap,
        "measured": {
            "tile_count_max": k_max,
            "pairs_max": pairs_max,
            "covered_tiles_max": covered_max,
            "live_lights_max": lights_max,
        },
        "yaw_steps": yaw_steps,
        "margin": margin,
    }
    return out, report


def autotune_shadow(state: SceneState, cfg: RendererConfig, yaw_steps: int = 24, margin: float = 0.3):
    """Light-view binning tiers for the shadow-map pass (cfg.shadow_bin_tiers),
    derived as autotune derives the display tiers: sweep the orbit, measure
    the light view's footprint occupancy per candidate ladder, pick the
    ladder with the fewest emitted sort keys, budget with margin.  Returns
    (RendererConfig with shadow_bin_tiers set, report dict).

    Only the triangles' boxes are read (no raster): the light view is a
    fixed ortho frame, and the meshes' yaw is what moves the footprints."""
    from .ops.shadows import light_view_proj, setup_light_view_triangles

    S = cfg.shadow_map_size
    TH, TW = (16, 128) if S % 128 == 0 else (cfg.tile_h, cfg.tile_w)
    nty, ntx = -(-S // TH), -(-S // TW)
    NT = nty * ntx
    shadow_cfg = dataclasses.replace(cfg, width=S, height=S)
    lvp = light_view_proj(state.lights.direction)
    _fps = []
    pairs_max = 0
    s = state
    for _ in range(yaw_steps):
        s = animate(s, 2.0 * np.pi / yaw_steps, cfg)
        # The setup render_shadow_map runs (cull none, depth only).
        tris = setup_light_view_triangles(s, shadow_cfg, lvp)
        live, tx0, tx1, ty0, ty1 = _tile_rects(tris.aabb, tris.valid, TH, TW, nty, ntx)
        fp = torch.where(live, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0).cpu().numpy()  # one host read
        pairs_max = max(pairs_max, int(fp.sum()))
        _fps.append(fp)

    T = _fps[0].shape[0]
    best = None
    for e, em, el in _LADDERS:
        ns = nm = nl = nb = 0
        for fp in _fps:
            lv = fp > 0
            ns = max(ns, int((lv & (fp <= e)).sum()))
            nm = max(nm, int((lv & (fp > e) & (fp <= em)).sum()))
            if el < NT:
                nl = max(nl, int((lv & (fp > em) & (fp <= el)).sum()))
                nb = max(nb, int((lv & (fp > el)).sum()))
            else:
                nl = max(nl, int((lv & (fp > em)).sum()))
        LS = min(_round_up(ns * (1 + margin) + 1, 128), T)
        MB = min(_round_up(nm * (1 + margin) + 1, 8), T)
        ML = min(_round_up(nl * (1 + margin) + 1, 8), T)
        BB = min(max(_round_up(nb * (1 + margin) + 1, 8), 8), T)
        keys = LS * e + MB * em + ML * el + (BB * NT if el < NT else 0)
        cand = (keys, (e, em, el), (LS, MB, ML, BB))
        if best is None or cand[0] < best[0]:
            best = cand

    keys, (e, em, el), (LS, MB, ML, BB) = best
    tiers = (e, em, MB, el, ML, BB, LS)
    out = dataclasses.replace(cfg, shadow_bin_tiers=tiers)
    report = {
        "tiers": tiers,
        "sort_keys": int(keys),
        "pairs_max": pairs_max,
        "tile": (TH, TW),
        "yaw_steps": yaw_steps,
        "margin": margin,
    }
    return out, report
