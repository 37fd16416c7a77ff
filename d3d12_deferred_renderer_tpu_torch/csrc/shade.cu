// G-buffer lighting kernel: tiled-deferred PBR over the encoded G-buffer
// planes, linear HDR out.
//
// Replaces the TPU kernel d3d12_deferred_renderer_tpu/ops/lighting_pallas.py:
// _shade_kernel (helper fused._shade_row), entry shade_pbr_tiled_pallas.
// Its plain PyTorch version is ops/lighting_cuda.py:shade_tiles_reference,
// and the arithmetic below follows it operation for operation.
//
// Layout.  Each screen tile (up to 1024 pixels, 8 x 128 in every shipped
// config) is split over ceil(P / kT) blocks of kT = 128 threads, one pixel
// a thread: a block shades one row of an 8 x 128 tile.  (128 measured
// fastest of 128, 256 and 512 on the staged flagship, PERF.md.)
//
// 1. Each block loads its tile's live light ids (the first counts[t] of the
//    tile's row of ids, ascending, from the per-tile cull) and their 8-float
//    rows into shared memory, and with them 1 / (r * r) of each light, the
//    one term of the loop that does not depend on the pixel (the same
//    expression the loop computes, so the same bits).  The count is clamped
//    to the row's length and each id to the table, so a bad list cannot
//    read outside its arrays.
// 2. Per pixel: decode the G-buffer as lighting.hlsl:34-40 does (albedo
//    pow(max(a, 0), gamma), normal *2-1 renormalized with the zero guard),
//    world position from depth, then shade.cuh, the shading the fused tile
//    renderer runs too: directional GGX times the visibility plane when
//    there is one, the point-light GGX loop, ambient.  Background pixels
//    (depth not below 1) are 0.  Output [3, Hp, Wp] f32.
//
// Band mode: the uniforms' U_Y0 is the first pixel row of the planes in the
// frame and U_H the frame's height.  A band whose height is not a multiple
// of tile_h has padded rows in its last tile row; the wrapper pads them
// with depth 1, so they shade to 0 like background and are cropped, and
// each thread writes only its own pixel of the band's planes.
//
// Bound: the point-light loop, about 120 operations per covered pixel and
// live light (six IEEE divisions and two rsqrt among them), against 48 bytes
// a pixel of planes in and out (about 100 MB at 1920x1080).  The loop's
// work is uneven: the flagship's heaviest tile holds 70-114 live lights
// against 1.7 a pixel on average, and with one block of 4 pixels a thread
// a tile, that tile's block set the kernel's time.  Hence one pixel a
// thread, the tile split over blocks (the heaviest tile's work spreads over
// several SMs, and no thread shades more than one pixel), and two lights a
// step: the terms of lights s and s + 1 are computed independently, so
// their chains of divisions overlap, and added to the sum in order, s first
// (the bits do not change).

#include "shade.cuh"

namespace {

// G-buffer input planes (ops/lighting_cuda.py P_*)
constexpr int P_AR = 0, P_MET = 3, P_NX = 4, P_RGH = 7, P_DEPTH = 8, P_VIS = 9;

constexpr int kT = 128;  // threads (and pixels) of a block

__global__ void __launch_bounds__(kT)
shade_tile_kernel(const float* __restrict__ planes, int n_planes, const float* __restrict__ lights,
                  int n_rows, const int* __restrict__ ids, int lk, const int* __restrict__ counts,
                  const float* __restrict__ uniforms, int ntx, int tile_h, int tile_w, int blocks_per_tile,
                  float gamma, float* __restrict__ hdr, int Hp, int Wp) {
  __shared__ float s_u[shade::U_SIZE];
  extern __shared__ float s_dyn[];
  float* s_lrow = s_dyn;            // [lk][8] live light rows
  float* s_inv_r2 = s_dyn + 8 * lk;  // [lk] 1 / (radius * radius)

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / blocks_per_tile;
  const int i = (blockIdx.x % blocks_per_tile) * kT + tid;  // this thread's pixel of the tile
  const int ty = tile / ntx, tx = tile % ntx;
  if (tid < shade::U_SIZE) s_u[tid] = uniforms[tid];
  const int n_live = min(max(counts[tile], 0), lk);
  const int* tile_ids = ids + (size_t)tile * lk;
  for (int q = tid; q < n_live * 8; q += kT) {
    const int id = min(max(tile_ids[q >> 3], 0), n_rows - 1);
    s_lrow[q] = lights[8 * (size_t)id + (q & 7)];
  }
  __syncthreads();
  for (int s = tid; s < n_live; s += kT) s_inv_r2[s] = 1.0f / (s_lrow[8 * s + 3] * s_lrow[8 * s + 3]);
  __syncthreads();
  if (i >= tile_h * tile_w) return;

  const size_t plane = (size_t)Hp * Wp;
  const int row = i / tile_w, col = i % tile_w;
  const size_t o = (size_t)(ty * tile_h + row) * Wp + (size_t)(tx * tile_w + col);
  const float depth = planes[P_DEPTH * plane + o];
  if (!(depth < 1.0f)) {
    hdr[o] = hdr[plane + o] = hdr[2 * plane + o] = 0.0f;
    return;
  }
  float alb[3], nd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    alb[c] = powf(maxp(planes[(P_AR + c) * plane + o], 0.0f), gamma);
    nd[c] = planes[(P_NX + c) * plane + o] * 2.0f - 1.0f;
  }
  const float dlen = sqrtf((nd[0] * nd[0] + nd[1] * nd[1]) + nd[2] * nd[2]);
  const float inv_dlen = 1.0f / (dlen == 0.0f ? 1.0f : dlen);
  const float N[3] = {nd[0] * inv_dlen, nd[1] * inv_dlen, nd[2] * inv_dlen};
  const float metal = planes[P_MET * plane + o], rough = planes[P_RGH * plane + o];
  const float vis = n_planes > P_VIS ? planes[P_VIS * plane + o] : 1.0f;

  // Rows from U_Y0 on: a band of a frame U_H rows high (raster.cuh's
  // tile_pixel_centers computes the same centres).
  const float px = ((float)(tx * tile_w) + 0.5f) + (float)col;
  const float py = ((float)(ty * tile_h + (int)s_u[shade::U_Y0]) + 0.5f) + (float)row;
  float wpos[3];
  shade::world_from_depth(s_u, px, py, depth, wpos);
  // shade.cuh's shade_pixel, its loop two lights a step.
  shade::Surface sf;
  shade::surface(s_u, wpos, N, alb, metal, rough, sf);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  shade::directional(s_u, N, sf.V, alb, metal, rough, vis, acc);
  int s = 0;
  for (; s + 1 < n_live; s += 2) {
    float ta[3], tb[3];
    shade::point_light(sf, wpos, s_lrow + 8 * s, s_inv_r2[s], ta);
    shade::point_light(sf, wpos, s_lrow + 8 * (s + 1), s_inv_r2[s + 1], tb);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = (acc[c] + ta[c]) + tb[c];
  }
  if (s < n_live) {
    float ta[3];
    shade::point_light(sf, wpos, s_lrow + 8 * s, s_inv_r2[s], ta);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + ta[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) hdr[c * plane + o] = acc[c] + s_u[shade::U_AMBIENT] * alb[c];
}

}  // namespace

extern "C" int shade_tiles_launch(const float* planes, int n_planes, const float* lights,
                                  int n_rows, const int* ids, int lk, const int* counts,
                                  const float* uniforms, int nty, int ntx, int tile_h, int tile_w,
                                  float gamma, float* hdr, cudaStream_t cs) {
  if (nty * ntx <= 0) return (int)cudaGetLastError();
  const size_t dyn = (size_t)lk * 9 * sizeof(float);
  if (dyn > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(shade_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  const int bpt = (tile_h * tile_w + kT - 1) / kT;
  shade_tile_kernel<<<nty * ntx * bpt, kT, dyn, cs>>>(planes, n_planes, lights, n_rows, ids, lk, counts,
                                                      uniforms, ntx, tile_h, tile_w, bpt, gamma, hdr,
                                                      nty * tile_h, ntx * tile_w);
  return (int)cudaGetLastError();
}
