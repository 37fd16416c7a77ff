// G-buffer lighting kernel: tiled-deferred PBR over the encoded G-buffer
// planes, one block per screen tile, linear HDR out.
//
// Replaces the TPU kernel d3d12_deferred_renderer_tpu/ops/lighting_pallas.py:
// _shade_kernel (helper fused._shade_row), entry shade_pbr_tiled_pallas.
// Its plain PyTorch version is ops/lighting_cuda.py:shade_tiles_reference,
// and the arithmetic below follows it operation for operation.
//
// One block of 256 threads per tile (up to 1024 pixels, 8 x 128 in every
// shipped config); thread tid owns pixels tid + 256 * j, j < 4.
//
// 1. The tile's live light ids (the first counts[t] of its row of ids,
//    ascending, from the per-tile cull) and their 8-float rows go to
//    shared memory.  The count is clamped to the row's length and each id
//    to the table, so a bad list cannot read outside its arrays.
// 2. Per pixel: decode the G-buffer as lighting.hlsl:34-40 does (albedo
//    pow(max(a, 0), gamma), normal *2-1 renormalized with the zero guard),
//    world position from depth, then shade.cuh, the shading the fused tile
//    renderer runs too: directional GGX times the visibility plane when
//    there is one, the point-light GGX loop, ambient.  Background pixels
//    (depth not below 1) are 0.  Output [3, Hp, Wp] f32.
//
// Bound: the point-light loop, about 100 operations per covered pixel and
// live light, against 48 bytes a pixel of planes in and out (36-40 in, 12
// out: about 100 MB at 1920x1080).

#include "shade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;
// G-buffer input planes (ops/lighting_cuda.py P_*)
constexpr int P_AR = 0, P_MET = 3, P_NX = 4, P_RGH = 7, P_DEPTH = 8, P_VIS = 9;

__global__ void __launch_bounds__(kThreads)
shade_tile_kernel(const float* __restrict__ planes, int n_planes, const float* __restrict__ lights,
                  int n_rows, const int* __restrict__ ids, int lk, const int* __restrict__ counts,
                  const float* __restrict__ uniforms, int ntx, int tile_h, int tile_w,
                  float gamma, float* __restrict__ hdr, int Hp, int Wp) {
  __shared__ float s_u[shade::U_SIZE];
  extern __shared__ float s_lrow[];  // [lk][8] live light rows

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int P = tile_h * tile_w;
  if (tid < shade::U_SIZE) s_u[tid] = uniforms[tid];
  const int n_live = min(max(counts[tile], 0), lk);
  const int* tile_ids = ids + (size_t)tile * lk;
  for (int q = tid; q < n_live * 8; q += kThreads) {
    const int id = min(max(tile_ids[q >> 3], 0), n_rows - 1);
    s_lrow[q] = lights[8 * (size_t)id + (q & 7)];
  }
  __syncthreads();

  const size_t plane = (size_t)Hp * Wp;
  const bool has_vis = n_planes > P_VIS;
#pragma unroll 1
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    if (i >= P) continue;
    const int row = i / tile_w, col = i % tile_w;
    const size_t o = (size_t)(ty * tile_h + row) * Wp + (size_t)(tx * tile_w + col);
    const float depth = planes[P_DEPTH * plane + o];
    if (!(depth < 1.0f)) {
      hdr[o] = hdr[plane + o] = hdr[2 * plane + o] = 0.0f;
      continue;
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
    const float vis = has_vis ? planes[P_VIS * plane + o] : 1.0f;

    const float px = ((float)(tx * tile_w) + 0.5f) + (float)col;
    const float py = ((float)(ty * tile_h) + 0.5f) + (float)row;
    float wpos[3], out[3];
    shade::world_from_depth(s_u, px, py, depth, wpos);
    shade::shade_pixel(s_u, wpos, N, alb, metal, rough, vis, s_lrow, n_live, out);
#pragma unroll
    for (int c = 0; c < 3; ++c) hdr[c * plane + o] = out[c];
  }
}

}  // namespace

extern "C" int shade_tiles_launch(const float* planes, int n_planes, const float* lights,
                                  int n_rows, const int* ids, int lk, const int* counts,
                                  const float* uniforms, int nty, int ntx, int tile_h, int tile_w,
                                  float gamma, float* hdr, cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0) {
    const size_t dyn = (size_t)lk * 8 * sizeof(float);
    if (dyn > 32 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          shade_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
    shade_tile_kernel<<<n_tiles, kThreads, dyn, cs>>>(
        planes, n_planes, lights, n_rows, ids, lk, counts, uniforms, ntx, tile_h, tile_w, gamma,
        hdr, nty * tile_h, ntx * tile_w);
  }
  return (int)cudaGetLastError();
}
