// Fused tile renderer: raster -> in-kernel light cull -> G-buffer quantize ->
// PBR shading -> tonemap, one block per screen tile.
//
// Replaces the TPU mono-kernel d3d12_deferred_renderer_tpu/ops/fused.py:
// _fused_kernel (helpers raster_pallas._chunk_raster, fused._shade_row,
// fused._world_from_depth) on the flagship branch: PBR, in-kernel light
// culling, no shadows, bump, bloom or split.  Its plain PyTorch version is
// ops/fused.py:fused_tiles_reference, and the arithmetic below follows it
// operation for operation, in the same association order.
//
// One block of 256 threads per tile (up to 1024 pixels, 8 x 128 in the
// flagship config); thread tid owns pixels tid + 256 * j, j < 4, so a warp
// writes neighbouring pixels of one row.
//
// 1. Records.  The tile's segment [offs[t], offs[t] + counts[t]) of the
//    record stream comes through shared memory in chunks of 64 records.
// 2. Raster.  Records in submission order with a strict z < depth test,
//    z in [0, 1] (a NaN z fails): the chunk-min, lowest-slot rule of the
//    TPU kernel is exactly this sequential rule.  The edge functions and
//    interpolations use explicit fused multiply-adds where the reference
//    rasterizer contracts (ops/raster_ref.py says where and why).
// 3. Cull.  Block min/max reductions give the split distance and the two
//    slabs' world AABBs (min and max are exact, so the order of reduction
//    does not matter).  Each thread tests lights tid, tid + 256, ...; a warp
//    ballot, __popc and a scan over the 8 warps compact the live ids in
//    ascending order into shared memory, together with their light rows.
// 4. Shade.  Per pixel: material by mesh id, 10-bit normal round trip,
//    ambient + directional GGX + the point-light GGX loop over the live
//    lights, Reinhard, gamma.  Output [3, Hp, Wp] f32.
//
// Bound: compute.  The GGX loop runs once per covered pixel and live light
// (about 100 flops each, with a divide-heavy tail); the stream segment, the
// light rows and the output are a few MB per 1080p frame.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;        // pixels per thread: tiles of at most 1024
constexpr int kStride = 32;    // TRI_STRIDE
constexpr int kChunk = 64;     // records per shared-memory chunk
constexpr float kBig = 3.0e38f;
constexpr float kPi = (float)3.141592653589793;
constexpr float kInvPi = (float)(1.0 / 3.141592653589793);

// uniforms layout (ops/fused.py U_*)
constexpr int U_INV_VP = 0, U_EYE = 16, U_LDIR = 19, U_LCOLOR = 22, U_AMBIENT = 25,
              U_W = 26, U_H = 27, U_TONEMAP = 28;

// Record fields (ops/transform.py TRI_*)
constexpr int TRI_Z0 = 6, TRI_RW0 = 9, TRI_N0 = 12, TRI_MESH_ID = 27, TRI_VALID = 28,
              TRI_AREA = 29;

__device__ __forceinline__ float rsqrt_guarded(float x2, float eps) {
  return x2 == 0.0f ? 1.0f : rsqrtf(maxp(x2, eps));
}

// sum_v b_v * a[v * step], rounded as the reference rasterizer rounds it.
__device__ __forceinline__ float sum3(float b0, float b1, float b2, const float* a, int step) {
  return __fmaf_rn(b2, a[2 * step], __fmaf_rn(b0, a[0], b1 * a[step]));
}

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

__global__ void __launch_bounds__(kThreads)
fused_tile_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                  const float* __restrict__ stream, const float* __restrict__ lights,
                  int n_lights, const float* __restrict__ mats,
                  const float* __restrict__ uniforms, int ntx, int tile_h, int tile_w,
                  int ik_slots, float inv_gamma, float* __restrict__ color, int Hp, int Wp,
                  int* __restrict__ tile_overflow) {
  __shared__ float4 s_rec4[kChunk * kStride / 4];
  __shared__ float s_u[32];
  __shared__ float s_red[kWarps][12];
  __shared__ float s_bounds[12];
  __shared__ int s_warp[kWarps];
  extern __shared__ float s_dyn[];
  float* s_lrow = s_dyn;                                // [ik_slots][8] live light rows
  int* s_ids = reinterpret_cast<int*>(s_dyn + 8 * ik_slots);  // [ik_slots]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int P = tile_h * tile_w;
  if (tid < 32) s_u[tid] = uniforms[tid];
  __syncthreads();  // a tile with no records reaches the cull with no other barrier

  float px[kPix], py[kPix];
  bool inb[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    inb[j] = i < P;
    py[j] = ((float)(ty * tile_h) + 0.5f) + (float)(i / tile_w);
    px[j] = ((float)(tx * tile_w) + 0.5f) + (float)(i % tile_w);
  }

  // ---- 1-2. raster the tile's records in submission order ----
  float depth[kPix], nrm[3][kPix], mid[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    depth[j] = 1.0f;
    nrm[0][j] = nrm[1][j] = nrm[2][j] = 0.0f;
    mid[j] = -1.0f;
  }
  const int n = counts[tile];
  const int start = offs[tile];
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
      for (int j = 0; j < kPix; ++j) {
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
        const float rw = sum3(b0, b1, b2, r + TRI_RW0, 1);
        const float inv_rw = 1.0f / (rw == 0.0f ? 1.0f : rw);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          nrm[c][j] = sum3(b0, b1, b2, r + TRI_N0 + c, 3) * inv_rw;
        mid[j] = r[TRI_MESH_ID];
      }
    }
  }

  // ---- 3. exact light cull against two eye-distance slabs ----
  const float ex = s_u[U_EYE], ey = s_u[U_EYE + 1], ez = s_u[U_EYE + 2];
  const float sx2 = 2.0f / s_u[U_W], sy2 = 2.0f / s_u[U_H];
  float wpos[3][kPix], d2[kPix];
  bool cov[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    cov[j] = inb[j] && mid[j] >= 0.0f;
    const float ndc_x = px[j] * sx2 - 1.0f;
    const float ndc_y = 1.0f - py[j] * sy2;
    float h[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      h[c] = ((ndc_x * s_u[U_INV_VP + c] + ndc_y * s_u[U_INV_VP + 4 + c]) +
              depth[j] * s_u[U_INV_VP + 8 + c]) + s_u[U_INV_VP + 12 + c];
    const float inv_hw = 1.0f / (h[3] == 0.0f ? 1.0f : h[3]);
    wpos[0][j] = h[0] * inv_hw;
    wpos[1][j] = h[1] * inv_hw;
    wpos[2][j] = h[2] * inv_hw;
    const float dx = wpos[0][j] - ex, dy = wpos[1][j] - ey, dz = wpos[2][j] - ez;
    d2[j] = (dx * dx + dy * dy) + dz * dz;
  }
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
      bv[6 * s + 2 * a] = minp(bv[6 * s + 2 * a], wpos[a][j]);
      bv[6 * s + 2 * a + 1] = maxp(bv[6 * s + 2 * a + 1], wpos[a][j]);
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
      if (pos < ik_slots) s_ids[pos] = l;
    }
    total += round_total;
    __syncthreads();
  }
  const int n_live = min(total, ik_slots);
  if (tid == 0) tile_overflow[tile] = total > ik_slots ? 1 : 0;
  for (int q = tid; q < n_live * 8; q += kThreads) s_lrow[q] = lights[8 * (size_t)s_ids[q >> 3] + (q & 7)];
  __syncthreads();

  // ---- 4. G-buffer round trip + shading + tonemap, per pixel ----
  const float ldir[3] = {s_u[U_LDIR], s_u[U_LDIR + 1], s_u[U_LDIR + 2]};
  const size_t plane = (size_t)Hp * Wp;
#pragma unroll 1
  for (int j = 0; j < kPix; ++j) {
    if (!inb[j]) continue;
    const int i = tid + j * kThreads;
    const size_t o = (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w);
    if (!(depth[j] < 1.0f)) {
      color[o] = color[plane + o] = color[2 * plane + o] = 0.0f;
      continue;
    }
    float alb[3] = {0.0f, 0.0f, 0.0f}, metal = 0.0f, rough = 0.0f;
    if (cov[j]) {
      const float* mr = mats + 8 * (size_t)mid[j];
      alb[0] = mr[0], alb[1] = mr[1], alb[2] = mr[2], metal = mr[3], rough = mr[4];
    }
    const float nlen = sqrtf((nrm[0][j] * nrm[0][j] + nrm[1][j] * nrm[1][j]) + nrm[2][j] * nrm[2][j]);
    const float inv_nlen = 1.0f / (nlen == 0.0f ? 1.0f : nlen);
    float nd[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nd[c] = quant10((cov[j] ? nrm[c][j] * inv_nlen : 0.0f) * 0.5f + 0.5f) * 2.0f - 1.0f;
    const float dlen = sqrtf((nd[0] * nd[0] + nd[1] * nd[1]) + nd[2] * nd[2]);
    const float inv_dlen = 1.0f / (dlen == 0.0f ? 1.0f : dlen);
    const float N[3] = {nd[0] * inv_dlen, nd[1] * inv_dlen, nd[2] * inv_dlen};

    float V[3] = {ex - wpos[0][j], ey - wpos[1][j], ez - wpos[2][j]};
    const float iv = rsqrt_guarded((V[0] * V[0] + V[1] * V[1]) + V[2] * V[2], 1e-38f);
    V[0] *= iv, V[1] *= iv, V[2] *= iv;

    // Directional GGX (fused._ggx_planar).
    const float alpha = maxp(rough * rough, 1e-3f);
    const float a2 = alpha * alpha;
    const float kk = ((rough + 1.0f) * (rough + 1.0f)) / 8.0f;
    const float ndv = maxp((N[0] * V[0] + N[1] * V[1]) + N[2] * V[2], 1e-4f);
    const float g1 = ndv / (ndv * (1.0f - kk) + kk);
    float f0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) f0[c] = 0.04f * (1.0f - metal) + alb[c] * metal;
    float acc[3];
    {
      float H[3] = {V[0] + ldir[0], V[1] + ldir[1], V[2] + ldir[2]};
      const float ih = rsqrt_guarded((H[0] * H[0] + H[1] * H[1]) + H[2] * H[2], 1e-38f);
      H[0] *= ih, H[1] *= ih, H[2] *= ih;
      const float ndl = maxp((N[0] * ldir[0] + N[1] * ldir[1]) + N[2] * ldir[2], 0.0f);
      const float ndh = maxp((N[0] * H[0] + N[1] * H[1]) + N[2] * H[2], 0.0f);
      const float vdh = maxp((V[0] * H[0] + V[1] * H[1]) + V[2] * H[2], 0.0f);
      const float denom = ndh * ndh * (a2 - 1.0f) + 1.0f;
      const float D = a2 / (kPi * denom * denom);
      const float g2 = ndl / (ndl * (1.0f - kk) + kk + 1e-7f);
      const float G = g1 * g2;
      const float u = 1.0f - vdh;
      const float u2 = u * u;
      const float f5 = u2 * u2 * u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float F = f0[c] + (1.0f - f0[c]) * f5;
        const float spec = (D * G) * F / (4.0f * ndv * ndl + 1e-4f);
        const float diffuse = (1.0f - F) * (1.0f - metal) * alb[c] * kInvPi;
        acc[c] = ((diffuse + spec) * ndl) * s_u[U_LCOLOR + c];
      }
    }
    // Point lights: the live ids of this tile, ascending.
    for (int s = 0; s < n_live; ++s) {
      const float* lr = s_lrow + 8 * s;
      const float t0 = lr[0] - wpos[0][j], t1 = lr[1] - wpos[1][j], t2 = lr[2] - wpos[2][j];
      const float dl2 = (t0 * t0 + t1 * t1) + t2 * t2;
      const float inv_d = rsqrtf(maxp(dl2, 1e-12f));
      const float L0 = t0 * inv_d, L1 = t1 * inv_d, L2 = t2 * inv_d;
      const float inv_r2 = 1.0f / (lr[3] * lr[3]);
      const float q = dl2 * inv_r2;
      const float wq = clampp(1.0f - q * q, 0.0f, 1.0f);
      const float window = wq * wq;
      const float atten = lr[7] * window / (dl2 + 1.0f);
      float H0 = V[0] + L0, H1 = V[1] + L1, H2 = V[2] + L2;
      const float ih = rsqrt_guarded((H0 * H0 + H1 * H1) + H2 * H2, 1e-38f);
      H0 *= ih, H1 *= ih, H2 *= ih;
      const float ndl = maxp((N[0] * L0 + N[1] * L1) + N[2] * L2, 0.0f);
      const float ndh = maxp((N[0] * H0 + N[1] * H1) + N[2] * H2, 0.0f);
      const float vdh = maxp((V[0] * H0 + V[1] * H1) + V[2] * H2, 0.0f);
      const float denom = ndh * ndh * (a2 - 1.0f) + 1.0f;
      const float D = a2 / (kPi * denom * denom);
      const float g2 = ndl / (ndl * (1.0f - kk) + kk + 1e-7f);
      const float dg = D * (g1 * g2);
      const float spec_den = 4.0f * ndv * ndl + 1e-4f;
      const float u5 = 1.0f - vdh;
      const float u5sq = u5 * u5;
      const float f5 = u5sq * u5sq * u5;
      const float scale = ndl * atten;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float F = f0[c] + (1.0f - f0[c]) * f5;
        const float spec = dg * F / spec_den;
        const float diffuse = (1.0f - F) * (1.0f - metal) * alb[c] * kInvPi;
        acc[c] = acc[c] + (diffuse + spec) * scale * lr[4 + c];
      }
    }
    const bool reinhard = s_u[U_TONEMAP] > 0.5f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = acc[c] + s_u[U_AMBIENT] * alb[c];
      if (reinhard) v = v / (1.0f + v);
      color[c * plane + o] = powf(maxp(v, 0.0f), inv_gamma);
    }
  }
}

}  // namespace

extern "C" int fused_tiles_launch(const int* counts, const int* offs, const float* stream,
                                  const float* lights, int n_lights,
                                  const float* mats, const float* uniforms, int nty, int ntx,
                                  int tile_h, int tile_w, int ik_slots, float inv_gamma,
                                  float* color, int* tile_overflow, cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0) {
    const size_t dyn = (size_t)ik_slots * (8 * sizeof(float) + sizeof(int));
    if (dyn > 32 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
    fused_tile_kernel<<<n_tiles, kThreads, dyn, cs>>>(
        counts, offs, stream, lights, n_lights, mats, uniforms, ntx, tile_h, tile_w, ik_slots,
        inv_gamma, color, nty * tile_h, ntx * tile_w, tile_overflow);
  }
  return (int)cudaGetLastError();
}
