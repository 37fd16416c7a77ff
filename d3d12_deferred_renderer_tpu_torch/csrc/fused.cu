// Fused tile renderer: raster -> light cull or per-tile light lists ->
// G-buffer quantize -> PBR shading -> tonemap, one block per screen tile.
//
// Replaces the TPU mono-kernel d3d12_deferred_renderer_tpu/ops/fused.py:
// _fused_kernel (helpers raster_pallas._chunk_raster, fused._shade_row,
// fused._world_from_depth, bump.bump_planar): the flagship branch and the
// config-4 variants, as template switches: kBump (uv joins the raster and
// bump.cuh perturbs the raw normals before the G-buffer quantization), kAux
// (the deferred-directional split: no directional term, and the depth,
// decoded normal and mesh-id planes out), kLists (the per-tile light lists
// of the depth prepass and lighting.cull_lights_to_tiles replace the
// in-kernel cull: fused.py:622-648, the kernel without ik_slots), and at run
// time hdr_out (linear HDR out: no tonemap or gamma; implied by kAux) and
// the shadow-visibility plane (has_vis, fused.py:203-205 and :379: vis
// multiplies the directional term; null when absent).  Its plain PyTorch
// version is ops/fused.py:fused_tiles_reference, and the arithmetic below
// follows it operation for operation, in the same association order.
//
// Band mode (the screen-row band path): the uniforms' U_Y0 is the grid's
// first pixel row in the frame and U_H the frame's height, so a band's
// pixel centres, world positions, cull slabs and shading are the full
// frame's; the output is the band's own rows, linear HDR (hdr_out).
//
// One block of 512 threads per tile (up to 1024 pixels, 8 x 128 in the
// flagship config); thread tid owns pixels tid + 512 * j, j < 2, so a warp
// writes neighbouring pixels of one row.  The block keeps the whole tile:
// the cull and the shading need all of its pixels, and first-wins ties
// with attributes do not merge by an atomic.  On an H100, 512 threads of 2
// pixels (97-107 registers) run the flagship frame in 0.276 ms where 256 of
// 4 (64-84 registers) take 0.392 (PERF.md): the serial shading loop of the
// light-heaviest tile sets the time, and halving a thread's pixels halves
// it.
//
// 1-2. Records and raster: raster.cuh, the tile raster this kernel shares
//    with the tile raster kernels (raster.cu).  The tile's segment
//    [offs[t], offs[t] + counts[t]) of the record stream comes through
//    shared memory in chunks of 64 records (bulk copies, double-buffered),
//    rasterized in submission order with a strict z < depth test; a warp
//    runs the edge tests of a record only at the rows of pixels its box
//    touches.  The bump reuses the raster's shared memory once it is done.
// 3. Lights.  In-kernel cull: block min/max reductions give the split
//    distance and the two slabs' world AABBs (min and max are exact, so the
//    order of reduction does not matter).  Each thread tests lights tid,
//    tid + 256, ...; a warp ballot, __popc and a scan over the 8 warps
//    compact the live ids in ascending order into shared memory, together
//    with their light rows.  With kLists the block loads its tile's first
//    counts[t] ids of its row of the lists instead (the G-buffer lighting
//    kernel's load, shade.cu): the count is clamped to the row's length Lk
//    and each id to the light table, so a bad list cannot read outside its
//    arrays, and the tile overflow is 0 (the cull counts its own).
// 4. Shade.  Per pixel: material by mesh id, 10-bit normal round trip,
//    then shade.cuh (shared with the G-buffer lighting kernel, shade.cu):
//    ambient + directional GGX (x visibility) + the point-light GGX loop
//    over the live lights; then Reinhard, gamma.  Output [3, Hp, Wp] f32.
//
// Bound: compute.  The GGX loop runs once per covered pixel and live light
// (about 100 flops each, with a divide-heavy tail); the stream segment, the
// light rows and the output are a few MB per 1080p frame.  The lists add
// NT x Lk x 4 bytes (2040 x 128 x 4 = 1 MB at 1080p) and the visibility
// plane Hp x Wp x 4 (8.4 MB), read once each.

#include "bump.cuh"
#include "raster.cuh"
#include "shade.cuh"

namespace {

using shade::U_EYE;
using shade::U_TONEMAP;
constexpr int kThreads = 512;
constexpr int kPix = 2;  // pixels a thread: tiles of at most 1024 pixels
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float quant10(float x) {
  return rintf(clampp(x, 0.0f, 1.0f) * 1023.0f) / 1023.0f;
}

// Block-wide (min, max) pairs: vals[2i] reduces by min, vals[2i+1] by max.
// Every thread returns with the results in out[0 .. 2 * NP).
template <int NP>
__device__ void block_minmax(float (&vals)[2 * NP], float (*s_red)[12], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) {
    float v = vals[i];
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = (i & 1) ? maxp(v, w) : minp(v, w);
    }
    if (lane == 0) s_red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 2 * NP) {
    const int i = threadIdx.x;
    float v = s_red[0][i];
    for (int w = 1; w < kWarps; ++w) v = (i & 1) ? maxp(v, s_red[w][i]) : minp(v, s_red[w][i]);
    out[i] = v;
  }
  __syncthreads();
}

// n_lights: the point lights the cull tests, or with kLists the rows of
// the light table.  slots: the compaction slots (ik_slots), or with kLists
// the length Lk of each tile's row of light_ids.
template <bool kBump, bool kAux, bool kLists>
__global__ void __launch_bounds__(kThreads)
fused_tile_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                  const float* __restrict__ stream, const float* __restrict__ lights,
                  int n_lights, const float* __restrict__ mats, int n_mats,
                  const float* __restrict__ uniforms, int ntx, int tile_h, int tile_w,
                  const int* __restrict__ light_ids, const int* __restrict__ light_counts,
                  int slots, const float* __restrict__ vis, float inv_gamma, float strength,
                  float w2pf, bool hdr_out, float* __restrict__ color, int Hp, int Wp,
                  int* __restrict__ tile_overflow) {
  // The raster's records and boxes, then the bump's staged planes.
  constexpr size_t kRasterBytes = sizeof(raster::Smem);
  constexpr size_t kBumpBytes = kBump ? bump::kPlanes * kThreads * kPix * sizeof(float) : 0;
  __shared__ __align__(16) unsigned char s_raw[kRasterBytes > kBumpBytes ? kRasterBytes : kBumpBytes];
  raster::Smem& sm = *reinterpret_cast<raster::Smem*>(s_raw);
  float* s_bump = reinterpret_cast<float*>(s_raw);
  __shared__ float s_u[32];
  __shared__ float s_red[kWarps][12];
  __shared__ float s_bounds[12];
  __shared__ int s_warp[kWarps];
  extern __shared__ float s_dyn[];
  float* s_lrow = s_dyn;                                   // [slots][8] live light rows
  int* s_ids = reinterpret_cast<int*>(s_dyn + 8 * slots);  // [slots] (in-kernel cull)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  if (tid < 32) s_u[tid] = uniforms[tid];
  __syncthreads();  // a tile with no records reaches the cull with no other barrier

  // The tile grid's first pixel row in the frame (a band's; 0 for a whole
  // frame): pixel centres and world positions are the full frame's.
  const int y0 = (int)s_u[shade::U_Y0];
  float px[kPix], py[kPix];
  bool inb[kPix];
  raster::tile_pixel_centers<kPix, kThreads>(ty, tx, tile_h, tile_w, y0, px, py, inb);

  // ---- 1-2. raster the tile's records in submission order ----
  float depth[kPix], nrm[3][kPix], uv[2][kPix], mid[kPix];
  raster::raster_tile<kBump>(stream, offs[tile], counts[tile], sm, (float)((tx + 1) * tile_w),
                             (float)((ty + 1) * tile_h + y0), px, py, inb, depth, nrm, uv, mid);

  // ---- 3. the tile's lights: exact cull against two eye-distance slabs,
  // or the tile's row of the light lists ----
  const float ex = s_u[U_EYE], ey = s_u[U_EYE + 1], ez = s_u[U_EYE + 2];
  float wpos[kPix][3], d2[kPix];
  bool cov[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    cov[j] = inb[j] && mid[j] >= 0.0f;
    shade::world_from_depth(s_u, px[j], py[j], depth[j], wpos[j]);
    const float dx = wpos[j][0] - ex, dy = wpos[j][1] - ey, dz = wpos[j][2] - ez;
    d2[j] = (dx * dx + dy * dy) + dz * dz;
  }
  if constexpr (kBump) {
    // Bump the raw normals inside the tile; pixels outside the frame count
    // as background.  (The cull reads only depth and mesh id.)
    const int P = tile_h * tile_w;
    __syncthreads();  // every thread is done with the raster's records
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (inb[j]) {
        const bool inside = px[j] < s_u[shade::U_W] && py[j] < s_u[shade::U_H];
        bump::stage_pixel(s_bump, P, tid + j * kThreads, wpos[j], uv[0][j], uv[1][j],
                          inside ? mid[j] : -1.0f);
      }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kPix; ++j)
      if (inb[j]) {
        const float n0[3] = {nrm[0][j], nrm[1][j], nrm[2][j]};
        float nb[3];
        bump::bump_pixel(s_bump, tile_h, tile_w, tid + j * kThreads, n0, strength, w2pf, nb);
        nrm[0][j] = nb[0], nrm[1][j] = nb[1], nrm[2][j] = nb[2];
      }
  }
  int n_live = 0;
  if constexpr (kLists) {
    n_live = min(max(light_counts[tile], 0), slots);
    const int* tile_ids = light_ids + (size_t)tile * slots;
    for (int q = tid; q < n_live * 8; q += kThreads) {
      const int id = min(max(tile_ids[q >> 3], 0), n_lights - 1);
      s_lrow[q] = lights[8 * (size_t)id + (q & 7)];
    }
    if (tid == 0) tile_overflow[tile] = 0;
    __syncthreads();
  } else {
    float dv[2] = {kBig, -kBig};
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (cov[j]) {
        dv[0] = minp(dv[0], d2[j]);
        dv[1] = maxp(dv[1], d2[j]);
      }
    block_minmax<1>(dv, s_red, s_bounds);
    const float dmid = 0.5f * (s_bounds[0] + s_bounds[1]);
    float bv[12];  // [slab][axis] (min, max)
#pragma unroll
    for (int i = 0; i < 12; i += 2) {
      bv[i] = kBig;
      bv[i + 1] = -kBig;
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!cov[j] || !(d2[j] <= dmid || d2[j] > dmid)) continue;  // a NaN joins no slab
      const int s = d2[j] <= dmid ? 0 : 1;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        bv[6 * s + 2 * a] = minp(bv[6 * s + 2 * a], wpos[j][a]);
        bv[6 * s + 2 * a + 1] = maxp(bv[6 * s + 2 * a + 1], wpos[j][a]);
      }
    }
    block_minmax<6>(bv, s_red, s_bounds);

    int total = 0;
    for (int base = 0; base < n_lights; base += kThreads) {
      const int l = base + tid;
      bool hit = false;
      if (l < n_lights) {
        const float* lr = lights + 8 * (size_t)l;
        const float r2 = lr[3] * lr[3];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float dist2 = 0.0f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float la = lr[a];
            const float dd = maxp(maxp(s_bounds[6 * s + 2 * a] - la, la - s_bounds[6 * s + 2 * a + 1]), 0.0f);
            dist2 = a == 0 ? dd * dd : dist2 + dd * dd;
          }
          hit = hit || dist2 <= r2;
        }
      }
      const unsigned ball = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(ball);
      __syncthreads();
      int before = total, round_total = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s_warp[w] : 0;
        round_total += s_warp[w];
      }
      if (hit) {
        const int pos = before + __popc(ball & ((1u << lane) - 1u));
        if (pos < slots) s_ids[pos] = l;
      }
      total += round_total;
      __syncthreads();
    }
    n_live = min(total, slots);
    if (tid == 0) tile_overflow[tile] = total > slots ? 1 : 0;
    for (int q = tid; q < n_live * 8; q += kThreads) s_lrow[q] = lights[8 * (size_t)s_ids[q >> 3] + (q & 7)];
    __syncthreads();
  }

  // ---- 4. G-buffer round trip + shading + tonemap, per pixel ----
  const size_t plane = (size_t)Hp * Wp;
#pragma unroll 1
  for (int j = 0; j < kPix; ++j) {
    if (!inb[j]) continue;
    const int i = tid + j * kThreads;
    const size_t o = (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w);
    const float nlen = sqrtf((nrm[0][j] * nrm[0][j] + nrm[1][j] * nrm[1][j]) + nrm[2][j] * nrm[2][j]);
    const float inv_nlen = 1.0f / (nlen == 0.0f ? 1.0f : nlen);
    float nd[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nd[c] = quant10((cov[j] ? nrm[c][j] * inv_nlen : 0.0f) * 0.5f + 0.5f) * 2.0f - 1.0f;
    const float dlen = sqrtf((nd[0] * nd[0] + nd[1] * nd[1]) + nd[2] * nd[2]);
    const float inv_dlen = 1.0f / (dlen == 0.0f ? 1.0f : dlen);
    const float N[3] = {nd[0] * inv_dlen, nd[1] * inv_dlen, nd[2] * inv_dlen};
    if constexpr (kAux) {
      color[3 * plane + o] = depth[j];
      color[4 * plane + o] = N[0];
      color[5 * plane + o] = N[1];
      color[6 * plane + o] = N[2];
      color[7 * plane + o] = mid[j];
    }
    if (!(depth[j] < 1.0f)) {
      color[o] = color[plane + o] = color[2 * plane + o] = 0.0f;
      continue;
    }
    float alb[3] = {0.0f, 0.0f, 0.0f}, metal = 0.0f, rough = 0.0f;
    if (cov[j]) {
      const float* mr = mats + 8 * (size_t)min((int)mid[j], n_mats - 1);
      alb[0] = mr[0], alb[1] = mr[1], alb[2] = mr[2], metal = mr[3], rough = mr[4];
    }

    float hdr[3];
    shade::shade_pixel<!kAux>(s_u, wpos[j], N, alb, metal, rough, vis ? vis[o] : 1.0f, s_lrow,
                              n_live, hdr);
    const bool reinhard = s_u[U_TONEMAP] > 0.5f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = hdr[c];
      if (!hdr_out) {
        if (reinhard) v = v / (1.0f + v);
        v = powf(maxp(v, 0.0f), inv_gamma);
      }
      color[c * plane + o] = v;
    }
  }
}

template <bool kBump, bool kAux, bool kLists>
int launch(const int* counts, const int* offs, const float* stream, const float* lights,
           int n_lights, const float* mats, int n_mats, const float* uniforms, int nty, int ntx,
           int tile_h, int tile_w, const int* light_ids, const int* light_counts, int slots,
           const float* vis, float inv_gamma, float strength, float w2pf, bool hdr_out,
           float* color, int* tile_overflow, cudaStream_t cs) {
  const size_t dyn = (size_t)slots * (8 * sizeof(float) + sizeof(int));
  if (dyn > 16 * 1024) {  // static (at most 27 KB) + dynamic past 48 KB needs the opt-in
    const cudaError_t e = cudaFuncSetAttribute(fused_tile_kernel<kBump, kAux, kLists>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  fused_tile_kernel<kBump, kAux, kLists><<<nty * ntx, kThreads, dyn, cs>>>(
      counts, offs, stream, lights, n_lights, mats, n_mats, uniforms, ntx, tile_h, tile_w,
      light_ids, light_counts, slots, vis, inv_gamma, strength, w2pf, hdr_out, color,
      nty * tile_h, ntx * tile_w, tile_overflow);
  return 0;
}

using LaunchFn = decltype(&launch<false, false, false>);
// Indexed by bump * 4 + aux * 2 + lists.
constexpr LaunchFn kLaunch[8] = {
    launch<false, false, false>, launch<false, false, true>, launch<false, true, false>,
    launch<false, true, true>,   launch<true, false, false>, launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>,
};

}  // namespace

// light_ids null: the in-kernel cull into `slots` (ik_slots) compaction
// slots over n_lights lights.  Else the lists [NT, slots] and counts [NT],
// n_lights the light table's rows.  vis [Hp, Wp] or null; never with aux.
extern "C" int fused_tiles_launch(const int* counts, const int* offs, const float* stream,
                                  const float* lights, int n_lights, const float* mats, int n_mats,
                                  const float* uniforms, int nty, int ntx, int tile_h, int tile_w,
                                  const int* light_ids, const int* light_counts, int slots,
                                  const float* vis, float inv_gamma, int bump, float strength,
                                  float w2pf, int hdr_out, int aux, float* color,
                                  int* tile_overflow, cudaStream_t cs) {
  if (nty * ntx > 0) {
    const LaunchFn fn = kLaunch[(bump ? 4 : 0) + (aux ? 2 : 0) + (light_ids ? 1 : 0)];
    const int e = fn(counts, offs, stream, lights, n_lights, mats, n_mats, uniforms, nty, ntx,
                     tile_h, tile_w, light_ids, light_counts, slots, vis, inv_gamma, strength, w2pf,
                     hdr_out != 0 || aux != 0, color, tile_overflow, cs);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
