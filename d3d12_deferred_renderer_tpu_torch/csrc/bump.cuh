// Procedural bump mapping of one screen tile, shared by the bump kernel
// (bump.cu) and the fused tile renderer (fused.cu), as bump.bump_planar is
// shared by the TPU kernels.  Its plain PyTorch version is
// ops/bump.py:bump_planar, and the arithmetic below follows it operation for
// operation, in the same association order.
//
// Derivatives are forward differences inside the tile, clamped at its edges
// (the last column and row reuse the previous difference), so a tile needs
// only its own pixels.  The block stages the tile's world position, uv and
// mesh id in shared memory (stage_pixel), synchronises, and each thread then
// perturbs the normals of its own pixels (bump_pixel) from its neighbours'
// staged values.  sin and rsqrt are taken in double precision and rounded
// once, as the plain version takes them (xmath.sinf, xmath.rsqrtf).
#pragma once

#include "common.cuh"

namespace bump {

constexpr int kPlanes = 6;  // staged per pixel: world xyz, u, v, mesh id

__device__ __forceinline__ float sin_rn(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float rsqrt_rn(float x) { return (float)(1.0 / sqrt((double)x)); }

// 1 / sqrt(x2), 1 where x2 is 0 (kZero) or below `small`.
template <bool kZero>
__device__ __forceinline__ float inv_len(float x2, float small) {
  const bool guard = kZero ? x2 == 0.0f : x2 < small;
  return guard ? 1.0f : rsqrt_rn(maxp(x2, 1e-38f));
}

// Stage pixel i of the tile (P pixels): world xyz, uv, and the mesh id
// (-1 for background and for pixels outside the frame).
__device__ __forceinline__ void stage_pixel(float* s_pl, int P, int i, const float (&w)[3], float u,
                                            float v, float mid) {
  s_pl[i] = w[0];
  s_pl[P + i] = w[1];
  s_pl[2 * P + i] = w[2];
  s_pl[3 * P + i] = u;
  s_pl[4 * P + i] = v;
  s_pl[5 * P + i] = mid;
}

// The perturbed normal of pixel i of a tile_h x tile_w tile whose staged
// planes are s_pl; n is the pixel's geometric (interpolated) normal.
// w2pf is 2 pi times the height field's frequency, as a float.
__device__ __forceinline__ void bump_pixel(const float* s_pl, int tile_h, int tile_w, int i,
                                           const float (&n)[3], float strength, float w2pf,
                                           float (&out)[3]) {
  const int P = tile_h * tile_w;
  const int r = i / tile_w, c = i % tile_w;
  const int cx1 = c < tile_w - 1 ? c + 1 : c, cx0 = cx1 - 1;
  const int ry1 = r < tile_h - 1 ? r + 1 : r, ry0 = ry1 - 1;
  const int ix1 = r * tile_w + cx1, ix0 = r * tile_w + cx0;
  const int iy1 = ry1 * tile_w + c, iy0 = ry0 * tile_w + c;
  float dpdx[3], dpdy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dpdx[k] = s_pl[k * P + ix1] - s_pl[k * P + ix0];
    dpdy[k] = s_pl[k * P + iy1] - s_pl[k * P + iy0];
  }
  const float* su = s_pl + 3 * P;
  const float* sv = s_pl + 4 * P;
  const float* sm = s_pl + 5 * P;
  const float du_dx = su[ix1] - su[ix0], dv_dx = sv[ix1] - sv[ix0];
  const float du_dy = su[iy1] - su[iy0], dv_dy = sv[iy1] - sv[iy0];

  // Tangents T = d world / d u and B = d world / d v from the 2x2 system.
  const float det = du_dx * dv_dy - dv_dx * du_dy;
  const float inv = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  float T[3], B[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T[k] = (dpdx[k] * dv_dy - dpdy[k] * dv_dx) * inv;
    B[k] = (dpdy[k] * du_dx - dpdx[k] * du_dy) * inv;
  }
  const float u = su[i], v = sv[i];
  const float s_sum = sin_rn(w2pf * (v + u));
  const float s_dif = sin_rn(w2pf * (v - u));
  const float dh_du = 0.5f * (s_sum + s_dif), dh_dv = 0.5f * (s_sum - s_dif);

  const float inv_nlen = inv_len<true>((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2], 0.0f);
  const float nu[3] = {n[0] * inv_nlen, n[1] * inv_nlen, n[2] * inv_nlen};
  float* ts[2] = {T, B};
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // off the normal, then unit length
    float* t = ts[q];
    const float dot = (t[0] * nu[0] + t[1] * nu[1]) + t[2] * nu[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = t[k] - dot * nu[k];
    const float inv_t = inv_len<false>((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2], 1e-24f);
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = t[k] * inv_t;
  }
  float pert[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pert[k] = nu[k] - strength * (dh_du * T[k] + dh_dv * B[k]);
  const float inv_pn = inv_len<true>((pert[0] * pert[0] + pert[1] * pert[1]) + pert[2] * pert[2], 0.0f);

  // Same mesh under every derivative tap, a nondegenerate uv mapping.
  const bool ok = sm[i] >= 0.0f && sm[ix1] == sm[ix0] && sm[iy1] == sm[iy0] && fabsf(det) >= 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = ok ? pert[k] * inv_pn : n[k];
}

}  // namespace bump
