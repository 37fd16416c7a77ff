// The tile raster, shared by the fused tile renderer (fused.cu) and the tile
// raster kernels (raster.cu: all planes, and depth only), as
// raster_pallas._chunk_raster is shared by the TPU kernels: every kernel
// rasterizes with this one loop, so their depth and mesh-id planes are
// bit-equal.  Its plain PyTorch version is
// ops/raster_tiles.py:raster_tile_pixels.
//
// One block of kT threads (kThreads = 256 for the raster kernels, 512 for
// the fused tile renderer) walks a run of at most kT * NP pixels (NP = kPix
// = 4 for the 8 x 128 screen tiles, 8 for the shadow map's 16 x 128 tiles,
// 2 in the fused kernel); thread tid owns pixels tid + kT * j, j < NP, so a
// warp covers 32 neighbouring pixels of a row (a "group", one for each j).  A segment [start, start + n) of the
// record stream comes through shared memory in chunks of kChunk records,
// double-buffered: while chunk c is rasterized, one thread's 1-D bulk copy
// (cp.async.bulk, the TMA) brings chunk c + 1, completing on an mbarrier.
// Records are taken in submission order with a strict z < depth test and z
// in [0, 1] (a NaN z fails), which is the TPU kernel's chunk-min,
// lowest-slot rule.  The edge functions and interpolations use explicit
// fused multiply-adds where the reference rasterizer contracts
// (ops/raster_ref.py says where and why); every other operation rounds once.
//
// Per-warp record rejection.  When a chunk lands, one thread per record
// computes the rectangle of pixel centres the record can cover (record_box)
// into shared memory.  A warp then tests each record's rectangle against
// the rectangle of its groups' pixel centres, and runs the edge tests only
// at the groups it touches: a record covers a few pixels of a tile, so most
// warps skip most records with a few warp-uniform instructions.  The skip
// removes only edge tests that would fail, so the planes do not change.
//
// Why the rectangle is conservative.  Let E_k be the exact edge functions
// of the record's float vertices (they sum to twice the area, 2S), and e_k
// the computed ones.  Following each rounding of e = fl(fl(fma(A, px,
// fl(B py))) + C), C = fl(fma(ax, by, -fl(bx ay))), A = fl(ay - by), B =
// fl(bx - ax) gives |e_k - E_k| <= u (2|A||px| + 3|B||py| + |bx ay| + |C|)
// to first order, u = 2^-24, wherever e_k >= 0 > E_k.  A covered pixel has
// every e_k >= 0, so every barycentric E_k / 2S >= -eps / 2S, and then
// px >= xmin - 2 (eps / 2S) w (at most two terms of px - xmin =
// sum_k lambda_k (x_k - xmin) are negative), likewise for xmax, y and h.
// record_box widens the vertices' box by m = max(1, 2 eps' max(w, h) / S')
// with eps' = 4u (...) at the tile's largest pixel coordinates and S' a
// lower bound of 2S: four times the first-order margin and at least one
// pixel.  It keeps every record whose margin has no bound (2S' <= 0, a NaN
// or an infinite vertex) or whose box spans more than kBoxMaxArea pixels
// (a near-plane-clipped record: large coordinates, and it covers most of
// the tile anyway) at every pixel.
#pragma once

#include "common.cuh"

namespace raster {

constexpr int kThreads = 256;
constexpr int kPix = 4;       // pixels per thread on screen tiles (at most 1024)
constexpr int kStride = 32;   // TRI_STRIDE
constexpr int kChunk = 64;    // records per shared-memory chunk
constexpr float kBoxMaxArea = 4096.0f;

// Record fields (ops/transform.py TRI_*)
constexpr int TRI_Z0 = 6, TRI_RW0 = 9, TRI_N0 = 12, TRI_UV0 = 21, TRI_MESH_ID = 27,
              TRI_VALID = 28, TRI_AREA = 29;

// The raster's shared memory: two chunks of records and their boxes (18 KB).
struct Smem {
  float4 rec[2][kChunk * kStride / 4];
  float4 box[2][kChunk];  // (x lo, x hi, y lo, y hi) of the pixel centres a record may cover
  unsigned long long bar[2];  // mbarriers: chunk landed, one per buffer
};

// sum_v b_v * a[v * step], rounded as the reference rasterizer rounds it.
__device__ __forceinline__ float sum3(float b0, float b1, float b2, const float* a, int step) {
  return __fmaf_rn(b2, a[2 * step], __fmaf_rn(b0, a[0], b1 * a[step]));
}

// Pixel centers of this thread's pixels of tile (ty, tx), and which of them
// lie inside the tile.
template <int NP, int kT = kThreads>
__device__ __forceinline__ void tile_pixel_centers(int ty, int tx, int tile_h, int tile_w,
                                                   float (&px)[NP], float (&py)[NP],
                                                   bool (&inb)[NP]) {
  const int P = tile_h * tile_w;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = threadIdx.x + j * kT;
    inb[j] = i < P;
    py[j] = ((float)(ty * tile_h) + 0.5f) + (float)(i / tile_w);
    px[j] = ((float)(tx * tile_w) + 0.5f) + (float)(i % tile_w);
  }
}

// The rectangle of pixel centres that record r can cover in a tile whose
// pixel coordinates are at most (px_max, py_max): the file comment derives
// it.  Records that are not valid get an empty box; records without a
// bounded margin the whole plane.
__device__ __forceinline__ float4 record_box(const float* r, float px_max, float py_max) {
  const float kInf = __int_as_float(0x7f800000);
  if (!(r[TRI_VALID] > 0.0f)) return make_float4(kInf, -kInf, kInf, -kInf);
  const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
  const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
  const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
  const float w = xmax - xmin, h = ymax - ymin;
  // A lower bound of twice the area (NaN with a NaN or infinite vertex).
  const float p = (x1 - x0) * (y2 - y0), q = (x2 - x0) * (y1 - y0);
  const float area_lo = (p - q) - 0x1p-21f * (fabsf(p) + fabsf(q));
  float err = 0.0f;
  const int ea[3] = {1, 2, 0}, eb[3] = {2, 0, 1};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ax = r[2 * ea[e]], ay = r[2 * ea[e] + 1];
    const float bx = r[2 * eb[e]], by = r[2 * eb[e] + 1];
    const float bxay = bx * ay;
    const float C = __fmaf_rn(ax, by, -bxay);
    err = fmaxf(err, (2.0f * fabsf(ay - by) * px_max + 3.0f * fabsf(bx - ax) * py_max)
                         + (fabsf(bxay) + fabsf(C)));
  }
  const float m = fmaxf(1.0f, 2.0f * (0x1p-22f * err) * fmaxf(w, h) / area_lo);
  if (!(area_lo > 0.0f && w * h <= kBoxMaxArea && m < 1e30f))
    return make_float4(-kInf, kInf, -kInf, kInf);
  return make_float4(xmin - m, xmax + m, ymin - m, ymax + m);
}

// The rectangle of pixel centres of each of this warp's groups (one per j,
// empty where no lane's pixel lies in the tile) and of their union.
template <int NP>
struct Groups {
  float x0[NP], x1[NP], y0[NP], y1[NP];
  float ux0, ux1, uy0, uy1;
};

template <int NP>
__device__ __forceinline__ void warp_groups(const float (&px)[NP], const float (&py)[NP],
                                            const bool (&inb)[NP], Groups<NP>& g) {
  const float kInf = __int_as_float(0x7f800000);
  g.ux0 = g.uy0 = kInf;
  g.ux1 = g.uy1 = -kInf;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float x0 = inb[j] ? px[j] : kInf, x1 = inb[j] ? px[j] : -kInf;
    float y0 = inb[j] ? py[j] : kInf, y1 = inb[j] ? py[j] : -kInf;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
      y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
      y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
    }
    g.x0[j] = x0, g.x1[j] = x1, g.y0[j] = y0, g.y1[j] = y1;
    g.ux0 = fminf(g.ux0, x0), g.ux1 = fmaxf(g.ux1, x1);
    g.uy0 = fminf(g.uy0, y0), g.uy1 = fmaxf(g.uy1, y1);
  }
}

__device__ __forceinline__ bool misses(float x0, float x1, float y0, float y1, const float4& b) {
  return x1 < b.x || x0 > b.y || y1 < b.z || y0 > b.w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Issued by one thread: a 1-D bulk copy of records [row0, row0 + m) of the
// stream into dst (rows are 128 bytes, so the copy is 16-byte aligned),
// completing on bar, armed for its bytes.
__device__ __forceinline__ void load_chunk_bulk(const float* stream, size_t row0, int m, float4* dst,
                                                unsigned long long* bar) {
  const unsigned bytes = (unsigned)m * kStride * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(stream + row0 * kStride)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Rasterize records [start, start + n) of `stream` over this thread's
// pixels.  Outputs: depth (cleared to 1) and, with kAttrs, the
// perspective-correct normal, with kUV uv (cleared to 0), and the winner's
// mesh id (-1 background); without kAttrs (depth only) those stay untouched.
// (px_max, py_max) bound the block's pixel coordinates.  Every thread of the
// block must call it with the same segment (it synchronises the block); sm
// may be reused once it returns, after a barrier.
template <bool kUV, int NP, bool kAttrs = true>
__device__ __forceinline__ void raster_tile(const float* __restrict__ stream, int start, int n,
                                            Smem& sm, float px_max, float py_max,
                                            const float (&px)[NP], const float (&py)[NP],
                                            const bool (&inb)[NP], float (&depth)[NP],
                                            float (&nrm)[3][NP], float (&uv)[2][NP],
                                            float (&mid)[NP]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    depth[j] = 1.0f;
    nrm[0][j] = nrm[1][j] = nrm[2][j] = 0.0f;
    uv[0][j] = uv[1][j] = 0.0f;
    mid[j] = -1.0f;
  }
  if (n <= 0) return;
  Groups<NP> g;
  warp_groups(px, py, inb, g);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&sm.bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&sm.bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_chunk_bulk(stream, (size_t)start, min(kChunk, n), sm.rec[0], &sm.bar[0]);
  }
  __syncthreads();  // the barriers are initialised
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, c0 = c * kChunk, m = min(kChunk, n - c0);
    mbar_wait(&sm.bar[buf], (c >> 1) & 1);  // the buffer's (c / 2)-th fill
    // Chunk c has landed, and every thread is done with chunk c - 1, whose
    // buffers chunk c + 1 and its boxes reuse.
    __syncthreads();
    if (c + 1 < n_chunks && tid == 0)
      load_chunk_bulk(stream, (size_t)(start + c0 + kChunk), min(kChunk, n - c0 - kChunk),
                      sm.rec[buf ^ 1], &sm.bar[buf ^ 1]);
    const float* s_rec = reinterpret_cast<const float*>(sm.rec[buf]);
    if (tid < m) sm.box[buf][tid] = record_box(s_rec + tid * kStride, px_max, py_max);
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      // Warp-uniform: the box is shared and the groups are the warp's.
      const float4 b = sm.box[buf][k];
      if (misses(g.ux0, g.ux1, g.uy0, g.uy1, b)) continue;
      bool touch[NP], any = false;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        touch[j] = !misses(g.x0[j], g.x1[j], g.y0[j], g.y1[j], b);
        any = any || touch[j];
      }
      if (!any) continue;  // (a record that is not valid has an empty box)
      const float* r = s_rec + k * kStride;
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
        if (!touch[j] || !inb[j]) continue;
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
        for (int c3 = 0; c3 < 3; ++c3) nrm[c3][j] = sum3(b0, b1, b2, r + TRI_N0 + c3, 3) * inv_rw;
        if constexpr (kUV) {
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) uv[c2][j] = sum3(b0, b1, b2, r + TRI_UV0 + c2, 2) * inv_rw;
        }
        mid[j] = r[TRI_MESH_ID];
      }
    }
  }
  if (tid == 0) {  // every thread has passed its last wait: sm may be reused
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(&sm.bar[0])) : "memory");
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(&sm.bar[1])) : "memory");
  }
}

}  // namespace raster
