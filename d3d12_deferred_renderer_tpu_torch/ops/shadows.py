"""Directional-light shadow mapping (BASELINE config 4).

The counterpart of d3d12_deferred_renderer_tpu/ops/shadows.py, without the
window gather (``shadow_window_gather``, ``pack_cmp_windows`` and
``_pcf_window_rows``: rejected and off in the JAX package; the frame raises
for it).  The shadow map is a depth-only render from the light's
orthographic view:

- ``setup_light_view_triangles``: the depth-only setup kernel
  (setup_cuda.setup_depth_triangles, cull "none": both faces occlude);
- ``render_shadow_map``: with cfg.use_pallas the binned depth-only tile
  raster (raster_tiles.rasterize_depth) on 16-row tiles under
  ``shadow_bin_config``, else the whole-frame reference raster;
- ``shadow_visibility``: percentage-closer filtering of every pixel (dense),
  or of the tiles holding geometry only (sparse, ``cfg.shadow_tiles_cap``),
  optionally only of tiles with a pixel that faces the light (``lit_mask``).

The sparse path compacts the covered tile ids with a stable sort, a fixed
number of slots and no host synchronisation; more covered tiles than slots
add one to the loud overflow count.  The visibility transform composes the
frame's inverse view-projection (pass ``inv_vp``, the one the shading
reads) with the light's, rounded as XLA's dot rounds it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import xmath
from ..config import RendererConfig
from ..scene import SceneState
from .lighting import inverse_view_proj
from .raster_ref import rasterize_packed
from .raster_tiles import rasterize_depth
from .sampling import sample_bilinear_cmp
from .setup_cuda import setup_depth_triangles

F32 = torch.float32


def orthographic_lh(width, height, z_near, z_far, device=None) -> torch.Tensor:
    """XMMatrixOrthographicLH (row-vector convention)."""
    zr = 1.0 / (z_far - z_near)
    m = torch.zeros((4, 4), dtype=F32)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[2, 2] = zr
    m[3, 2] = -z_near * zr
    m[3, 3] = 1.0
    return m.to(device)


@functools.lru_cache(maxsize=None)
def _light_constants(center, extent, distance, device):
    """(center, +x, +y, the ortho projection) of light_view_proj: constant
    per argument set, copied to the device once, so that a frame makes no
    host-to-device copy."""
    vecs = [torch.tensor(v, dtype=F32, device=device) for v in (center, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))]
    return (*vecs, orthographic_lh(extent, extent, 0.1, distance * 2.0, device))


def light_view_proj(light_direction: torch.Tensor, center=(0.0, 0.0, 0.0),
                    extent: float = 24.0, distance: float = 30.0) -> torch.Tensor:
    """Ortho view-projection covering a world box around `center` as seen
    along the light direction; the up vector is +x where the light is
    within ~8 degrees of vertical (a tensor select: no host branch)."""
    center, x_axis, y_axis, proj = _light_constants(tuple(center), extent, distance, light_direction.device)
    d = light_direction / xmath._norm3(light_direction)
    eye = center - d * distance
    up = torch.where(torch.abs(d[1]) > 0.99, x_axis, y_axis)
    return xmath.matmul4_fma(xmath.look_at_lh(eye, center, up), proj)


def shadow_bin_config(cfg: RendererConfig, n_tris: int) -> RendererConfig:
    """The binning and raster config of the shadow-map pass: the map's size,
    8x the triangles per tile, tier budgets with at least the default
    config's headroom (the light's ortho view sees wide occluders face on)
    and a small tier that holds every possibly live record, and 16-row tiles
    on maps whose side is a multiple of 128.  (Calibrated tiers,
    ``cfg.shadow_bin_tiers``, come with calibrate: frame.check_ported
    raises for them.)"""
    S = cfg.shadow_map_size
    shadow_cfg = dataclasses.replace(
        cfg, width=S, height=S, max_tris_per_tile=8 * cfg.max_tris_per_tile,
        bin_max_small=-(-(n_tris + 2048) // 128) * 128,
        bin_expand=max(4, cfg.bin_expand),
        bin_expand_medium=max(32, cfg.bin_expand_medium),
        bin_max_medium=max(512, cfg.bin_max_medium),
        bin_expand_large=max(256, cfg.bin_expand_large),
        bin_max_large=max(64, cfg.bin_max_large),
        bin_max_big=max(16, cfg.bin_max_big),
    )
    if S % 128 == 0:
        shadow_cfg = dataclasses.replace(shadow_cfg, tile_h=16, tile_w=128)
    return shadow_cfg


def setup_light_view_triangles(state: SceneState, shadow_cfg: RendererConfig, lvp: torch.Tensor):
    """Depth-only triangle setup in the light's view (cull "none"), through
    the depth-only setup kernel's wrapper."""
    geo = state.geometry
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    return setup_depth_triangles(geo.fv_pos_cols, geo.tri_mesh_id, xmath.matmul4_fma(model, lvp),
                                 shadow_cfg.width, shadow_cfg.height, cull="none")


def render_shadow_map(state: SceneState, cfg: RendererConfig, return_overflow: bool = False):
    """Depth-only pass from the light's view -> (depth [S, S], light_vp), and
    with return_overflow the int32 binning overflow of the shadow tiles (a
    tile over its triangle cap would drop occluders: loud, as in the main
    pass).  With cfg.use_pallas the binned depth kernel, else the reference
    raster (overflow 0)."""
    S = cfg.shadow_map_size
    lvp = light_view_proj(state.lights.direction)
    if cfg.use_pallas:
        shadow_cfg = shadow_bin_config(cfg, state.geometry.tri_mesh_id.shape[0])
        tris = setup_light_view_triangles(state, shadow_cfg, lvp)
        depth, overflow = rasterize_depth(tris.packed, tris.aabb, tris.valid, shadow_cfg,
                                          return_overflow=True)
    else:
        tris = setup_light_view_triangles(state, dataclasses.replace(cfg, width=S, height=S), lvp)
        depth = rasterize_packed(tris.packed, S, S).depth
        overflow = torch.zeros((), dtype=torch.int32, device=depth.device)
    return (depth, lvp, overflow) if return_overflow else (depth, lvp)


def _light_ndc(ndc_x, ndc_y, depth, M):
    """Light NDC (x, y, z) of screen points through the composed matrix M
    (screen NDC -> light clip), summed in row order as the JAX package
    sums it."""
    lc = [((ndc_x * M[0, j] + ndc_y * M[1, j]) + depth * M[2, j]) + M[3, j] for j in range(4)]
    w = torch.clamp(lc[3], min=1e-8)
    return lc[0] / w, lc[1] / w, lc[2] / w


def _pcf(shadow_depth, nx, ny, z, bias):
    """Visibility of light-NDC points: PCF inside the light frustum, 1 out."""
    uv = torch.stack([(nx + 1.0) * 0.5, (1.0 - ny) * 0.5], dim=-1)
    vis = sample_bilinear_cmp(shadow_depth, uv, z, bias)
    inside = (nx >= -1.0) & (nx <= 1.0) & (ny >= -1.0) & (ny <= 1.0) & (z >= 0.0) & (z <= 1.0)
    return torch.where(inside, vis, torch.ones((), dtype=F32, device=vis.device))


def shadow_visibility(
    depth: torch.Tensor, view_proj: torch.Tensor, shadow_depth: torch.Tensor,
    light_vp: torch.Tensor, cfg: RendererConfig, bias: float = 2e-3,
    return_overflow: bool = False, lit_mask=None, inv_vp=None,
):
    """Per-pixel visibility [H, W] in [0, 1] of the directional light:
    bilinear-weighted PCF (the comparison sampler: compare at each footprint
    texel, then filter) at every pixel's light-space position.

    Sparse when ``cfg.shadow_tiles_cap`` is nonzero and the frame tiles
    evenly into 8 x 128 blocks: only tiles holding geometry (min depth < 1)
    are sampled, bit-equal to the dense path there, the rest return 1.  With
    ``lit_mask`` ([H, W] bool: the pixel faces the light) only tiles with a
    lit covered pixel are sampled, under ``cfg.shadow_tiles_cap_lit``.
    Covered tiles beyond the cap are not sampled and count in the overflow
    (returned with return_overflow).  ``inv_vp`` is the frame's inverse
    view-projection (computed here when None)."""
    if cfg.shadow_vis_downsample > 1:
        raise NotImplementedError(
            "shadow_vis_downsample > 1 is not ported to the PyTorch package yet (ROADMAP.md Queue 1 item 7)"
        )
    H, W = depth.shape
    dev = depth.device
    if inv_vp is None:
        inv_vp = inverse_view_proj(view_proj)
    M = xmath.matmul4_fma(inv_vp, light_vp)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.shadow_tiles_cap != 0 and H % 8 == 0 and W % 128 == 0:
        vis, overflow = _shadow_visibility_sparse(depth, shadow_depth, M, cfg, bias, lit_mask)
        return (vis, overflow) if return_overflow else vis

    xs = (torch.arange(W, dtype=F32, device=dev) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (torch.arange(H, dtype=F32, device=dev) + 0.5) * (2.0 / H)
    nx, ny, z = _light_ndc(xs[None, :], ys[:, None], depth, M)
    vis = _pcf(shadow_depth, nx, ny, z, bias)
    return (vis, zero) if return_overflow else vis


def _shadow_visibility_sparse(depth, shadow_depth, M, cfg, bias, lit_mask):
    """The sparse path of shadow_visibility: the dense path's per-pixel math
    on the compacted [cap, 1024] rows of the sampled 8 x 128 tiles."""
    H, W = depth.shape
    dev = depth.device
    TH, TW = 8, 128
    nty, ntx = H // TH, W // TW
    NT, P = nty * ntx, TH * TW
    cap = cfg.shadow_tiles_cap
    if lit_mask is not None and cfg.shadow_tiles_cap_lit:
        cap = cfg.shadow_tiles_cap_lit
    if cap < 0:  # auto: 3/4 of the tile grid, rounded up to 8
        cap = min(NT, -(-(NT * 3 // 4) // 8) * 8)
    cap = min(cap, NT)

    def tiles(a):
        return a.reshape(nty, TH, ntx, TW).transpose(1, 2).reshape(NT, P)

    d_t = tiles(depth)
    if lit_mask is not None:
        covered = (tiles(lit_mask) & (d_t < 1.0)).any(1)
    else:
        covered = d_t.amin(1) < 1.0
    overflow = (covered.sum() > cap).to(torch.int32)
    # Covered tile ids in ascending order, then NT for the unused slots.
    ids = torch.arange(NT, device=dev)
    order = torch.sort(torch.where(covered, ids, NT + ids)).values[:cap]
    idx = torch.where(order < NT, order, NT)
    idx_c = torch.clamp(idx, max=NT - 1)

    fi = torch.arange(P, dtype=F32, device=dev)
    prow = torch.floor(fi * (1.0 / TW))
    pcol = fi - prow * TW
    pxf = (idx_c % ntx).to(F32)[:, None] * TW + pcol[None, :]
    pyf = (idx_c // ntx).to(F32)[:, None] * TH + prow[None, :]
    ndc_x = (pxf + 0.5) * (2.0 / W) - 1.0
    ndc_y = 1.0 - (pyf + 0.5) * (2.0 / H)
    nx, ny, z = _light_ndc(ndc_x, ndc_y, d_t[idx_c], M)
    rows = _pcf(shadow_depth, nx, ny, z, bias)

    # Row NT takes the unused slots' writes and is dropped.
    out = torch.ones((NT + 1, P), dtype=F32, device=dev)
    out[idx] = rows
    out = out[:NT].reshape(nty, ntx, TH, TW).transpose(1, 2).reshape(H, W)
    return out, overflow
