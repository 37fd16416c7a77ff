// The tile raster, shared by the fused tile renderer (fused.cu) and the tile
// raster kernels (raster.cu: all planes, and depth only), as
// raster_pallas._chunk_raster is shared by the TPU kernels: every kernel
// rasterizes with this one loop, so their depth and mesh-id planes are
// bit-equal.  Its plain PyTorch version is
// ops/raster_tiles.py:raster_tile_pixels.
//
// One block of kThreads threads per tile of at most kThreads * NP pixels
// (NP = kPix = 4 for the 8 x 128 screen tiles, 8 for the shadow map's
// 16 x 128 tiles); thread tid owns pixels tid + kThreads * j, j < NP, so a
// warp covers neighbouring pixels of one row.  The tile's segment [start, start + n) of
// the record stream comes through shared memory in chunks of kChunk records;
// records are taken in submission order with a strict z < depth test and z
// in [0, 1] (a NaN z fails), which is the TPU kernel's chunk-min,
// lowest-slot rule.  The edge functions and interpolations use explicit
// fused multiply-adds where the reference rasterizer contracts
// (ops/raster_ref.py says where and why); every other operation rounds once.
#pragma once

#include "common.cuh"

namespace raster {

constexpr int kThreads = 256;
constexpr int kPix = 4;       // pixels per thread on screen tiles (at most 1024)
constexpr int kStride = 32;   // TRI_STRIDE
constexpr int kChunk = 64;    // records per shared-memory chunk

// Record fields (ops/transform.py TRI_*)
constexpr int TRI_Z0 = 6, TRI_RW0 = 9, TRI_N0 = 12, TRI_UV0 = 21, TRI_MESH_ID = 27,
              TRI_VALID = 28, TRI_AREA = 29;

// sum_v b_v * a[v * step], rounded as the reference rasterizer rounds it.
__device__ __forceinline__ float sum3(float b0, float b1, float b2, const float* a, int step) {
  return __fmaf_rn(b2, a[2 * step], __fmaf_rn(b0, a[0], b1 * a[step]));
}

// Pixel centers of this thread's pixels of tile (ty, tx), and which of them
// lie inside the tile.
template <int NP>
__device__ __forceinline__ void tile_pixel_centers(int ty, int tx, int tile_h, int tile_w,
                                                   float (&px)[NP], float (&py)[NP],
                                                   bool (&inb)[NP]) {
  const int P = tile_h * tile_w;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = threadIdx.x + j * kThreads;
    inb[j] = i < P;
    py[j] = ((float)(ty * tile_h) + 0.5f) + (float)(i / tile_w);
    px[j] = ((float)(tx * tile_w) + 0.5f) + (float)(i % tile_w);
  }
}

// Rasterize records [start, start + n) of `stream` over this thread's
// pixels.  Outputs: depth (cleared to 1) and, with kAttrs, the
// perspective-correct normal, with kUV uv (cleared to 0), and the winner's
// mesh id (-1 background); without kAttrs (depth only) those stay untouched.
// Every thread of the block must call it (it synchronises the block).
template <bool kUV, int NP, bool kAttrs = true>
__device__ __forceinline__ void raster_tile(const float* __restrict__ stream, int start, int n,
                                            float4* s_rec4, const float (&px)[NP],
                                            const float (&py)[NP], const bool (&inb)[NP],
                                            float (&depth)[NP], float (&nrm)[3][NP],
                                            float (&uv)[2][NP], float (&mid)[NP]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    depth[j] = 1.0f;
    nrm[0][j] = nrm[1][j] = nrm[2][j] = 0.0f;
    uv[0][j] = uv[1][j] = 0.0f;
    mid[j] = -1.0f;
  }
  const float* s_rec = reinterpret_cast<const float*>(s_rec4);
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(stream + (size_t)(start + c0) * kStride);
    for (int q = tid; q < m * (kStride / 4); q += kThreads) s_rec4[q] = src[q];
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float* r = s_rec + k * kStride;
      if (!(r[TRI_VALID] > 0.0f)) continue;
      // Edges (v1->v2), (v2->v0), (v0->v1): e = fma(A, px, B*py) + C and
      // the top-left flag (ops/raster_ref.edge_coeffs).
      float A[3], B[3], C[3];
      bool tl[3];
      const int ea[3] = {1, 2, 0}, eb[3] = {2, 0, 1};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float ax = r[2 * ea[e]], ay = r[2 * ea[e] + 1];
        const float bx = r[2 * eb[e]], by = r[2 * eb[e] + 1];
        A[e] = ay - by;
        B[e] = bx - ax;
        C[e] = __fmaf_rn(ax, by, -(bx * ay));
        const float dx = bx - ax, dy = by - ay;
        tl[e] = (dy == 0.0f && dx > 0.0f) || dy < 0.0f;
      }
      const float inv_area = 1.0f / r[TRI_AREA];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (!inb[j]) continue;
        float ev[3];
        bool cov = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          ev[e] = __fmaf_rn(A[e], px[j], B[e] * py[j]) + C[e];
          cov = cov && (ev[e] > 0.0f || (ev[e] == 0.0f && tl[e]));
        }
        if (!cov) continue;
        const float b0 = ev[0] * inv_area, b1 = ev[1] * inv_area, b2 = ev[2] * inv_area;
        const float z = sum3(b0, b1, b2, r + TRI_Z0, 1);
        if (!(z >= 0.0f && z <= 1.0f && z < depth[j])) continue;
        depth[j] = z;
        if constexpr (!kAttrs) continue;
        const float rw = sum3(b0, b1, b2, r + TRI_RW0, 1);
        const float inv_rw = 1.0f / (rw == 0.0f ? 1.0f : rw);
#pragma unroll
        for (int c = 0; c < 3; ++c) nrm[c][j] = sum3(b0, b1, b2, r + TRI_N0 + c, 3) * inv_rw;
        if constexpr (kUV) {
#pragma unroll
          for (int c = 0; c < 2; ++c) uv[c][j] = sum3(b0, b1, b2, r + TRI_UV0 + c, 2) * inv_rw;
        }
        mid[j] = r[TRI_MESH_ID];
      }
    }
  }
}

}  // namespace raster
