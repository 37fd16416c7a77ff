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
// staged values.  A pixel is perturbed only where it and its four
// derivative taps lie on one mesh (same_mesh, from the staged mesh ids
// alone) and its uv mapping is nondegenerate; everywhere else it keeps its
// normal, so a caller may stage world position and uv at covered pixels
// only and skip the arithmetic where same_mesh fails.  sin is taken in
// double precision and rounded once, as the plain version takes it
// (xmath.sinf); rsqrt is the correctly rounded float32 one, which equals
// the plain version's double-precision 1 / sqrt rounded once (xmath.rsqrtf)
// on every float32 input: bump.cu's bump_rsqrt_check counts the mismatches
// over all of them on the card (chip_smoke.py, tests/test_torch_cuda.py).
#pragma once

#include "common.cuh"

namespace bump {

constexpr int kPlanes = 6;  // staged per pixel: world xyz, u, v, mesh id

__device__ __forceinline__ float sin_rn(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float rsqrt_rn(float x) { return __frsqrt_rn(x); }

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

// Pixel i of a tile_h x tile_w tile and its forward-difference taps: x0, x1
// along the row and y0, y1 down the column, one of each pair i itself.
struct Taps {
  int i, x0, x1, y0, y1;
};

// The pixel in row r, column c.
__device__ __forceinline__ Taps taps(int tile_h, int tile_w, int r, int c) {
  const int cx1 = c < tile_w - 1 ? c + 1 : c;
  const int ry1 = r < tile_h - 1 ? r + 1 : r;
  return {r * tile_w + c, r * tile_w + cx1 - 1, r * tile_w + cx1, (ry1 - 1) * tile_w + c, ry1 * tile_w + c};
}

__device__ __forceinline__ Taps taps(int tile_h, int tile_w, int i) {
  return taps(tile_h, tile_w, i / tile_w, i % tile_w);
}

// The same mesh under every derivative tap: pixel i covered (mesh id >= 0)
// and each pair of taps equal (each pair holds i).
__device__ __forceinline__ bool same_mesh(const float* s_pl, int P, const Taps& t) {
  const float* sm = s_pl + 5 * P;
  return sm[t.i] >= 0.0f && sm[t.x1] == sm[t.x0] && sm[t.y1] == sm[t.y0];
}

// A tangent made orthogonal to the unit normal nu, then of unit length.
__device__ __forceinline__ void tangentize(float (&t)[3], const float (&nu)[3]) {
  const float dot = (t[0] * nu[0] + t[1] * nu[1]) + t[2] * nu[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t[k] - dot * nu[k];
  const float inv_t = inv_len<false>((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2], 1e-24f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t[k] * inv_t;
}

// The perturbed normal of a pixel where same_mesh holds, into `out`; false,
// and `out` untouched, where the uv mapping is degenerate.  n is the pixel's
// geometric (interpolated) normal; w2pf is 2 pi times the height field's
// frequency, as a float.
__device__ __forceinline__ bool perturb(const float* s_pl, int P, const Taps& t, const float (&n)[3],
                                        float strength, float w2pf, float (&out)[3]) {
  float dpdx[3], dpdy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dpdx[k] = s_pl[k * P + t.x1] - s_pl[k * P + t.x0];
    dpdy[k] = s_pl[k * P + t.y1] - s_pl[k * P + t.y0];
  }
  const float* su = s_pl + 3 * P;
  const float* sv = s_pl + 4 * P;
  const float du_dx = su[t.x1] - su[t.x0], dv_dx = sv[t.x1] - sv[t.x0];
  const float du_dy = su[t.y1] - su[t.y0], dv_dy = sv[t.y1] - sv[t.y0];

  // Tangents T = d world / d u and B = d world / d v from the 2x2 system.
  const float det = du_dx * dv_dy - dv_dx * du_dy;
  if (!(fabsf(det) >= 1e-12f)) return false;
  const float inv = 1.0f / det;
  float T[3], B[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T[k] = (dpdx[k] * dv_dy - dpdy[k] * dv_dx) * inv;
    B[k] = (dpdy[k] * du_dx - dpdx[k] * du_dy) * inv;
  }
  const float u = su[t.i], v = sv[t.i];
  const float s_sum = sin_rn(w2pf * (v + u));
  const float s_dif = sin_rn(w2pf * (v - u));
  const float dh_du = 0.5f * (s_sum + s_dif), dh_dv = 0.5f * (s_sum - s_dif);

  const float inv_nlen = inv_len<true>((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2], 0.0f);
  const float nu[3] = {n[0] * inv_nlen, n[1] * inv_nlen, n[2] * inv_nlen};
  tangentize(T, nu);
  tangentize(B, nu);
  float pert[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pert[k] = nu[k] - strength * (dh_du * T[k] + dh_dv * B[k]);
  const float inv_pn = inv_len<true>((pert[0] * pert[0] + pert[1] * pert[1]) + pert[2] * pert[2], 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = pert[k] * inv_pn;
  return true;
}

// The normal of pixel i of a tile_h x tile_w tile whose staged planes are
// s_pl: perturbed where same_mesh holds and the uv mapping is
// nondegenerate, n elsewhere.
__device__ __forceinline__ void bump_pixel(const float* s_pl, int tile_h, int tile_w, int i,
                                           const float (&n)[3], float strength, float w2pf,
                                           float (&out)[3]) {
  const int P = tile_h * tile_w;
  const Taps t = taps(tile_h, tile_w, i);
  if (same_mesh(s_pl, P, t) && perturb(s_pl, P, t, n, strength, w2pf, out)) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = n[k];
}

}  // namespace bump
