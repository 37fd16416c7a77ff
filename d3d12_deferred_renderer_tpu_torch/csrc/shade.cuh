// The deferred shading of one pixel, shared by the fused tile renderer
// (fused.cu) and the G-buffer lighting kernel (shade.cu), as fused._shade_row
// is shared by the TPU kernels.  Its plain PyTorch version is
// ops/lighting_cuda.py:shade_pixels_reference (world_from_depth there too),
// and the arithmetic below follows it operation for operation, in the same
// association order.
#pragma once

#include "common.cuh"

namespace shade {

constexpr float kPi = (float)3.141592653589793;
constexpr float kInvPi = (float)(1.0 / 3.141592653589793);

// uniforms layout (ops/lighting_cuda.py U_*)
constexpr int U_INV_VP = 0, U_EYE = 16, U_LDIR = 19, U_LCOLOR = 22, U_AMBIENT = 25, U_W = 26,
              U_H = 27, U_TONEMAP = 28, U_SIZE = 32;

__device__ __forceinline__ float rsqrt_guarded(float x2, float eps) {
  return x2 == 0.0f ? 1.0f : rsqrtf(maxp(x2, eps));
}

// World position of the pixel center (px, py) at NDC depth `depth`, through
// the inverse view-projection in the uniforms.
__device__ __forceinline__ void world_from_depth(const float* s_u, float px, float py, float depth,
                                                 float (&w)[3]) {
  const float ndc_x = px * (2.0f / s_u[U_W]) - 1.0f;
  const float ndc_y = 1.0f - py * (2.0f / s_u[U_H]);
  float h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = ((ndc_x * s_u[U_INV_VP + c] + ndc_y * s_u[U_INV_VP + 4 + c]) +
            depth * s_u[U_INV_VP + 8 + c]) + s_u[U_INV_VP + 12 + c];
  const float inv_hw = 1.0f / (h[3] == 0.0f ? 1.0f : h[3]);
  w[0] = h[0] * inv_hw;
  w[1] = h[1] * inv_hw;
  w[2] = h[2] * inv_hw;
}

// Unit vector from the world position toward the eye.
__device__ __forceinline__ void view_dir(const float* s_u, const float (&wpos)[3], float (&V)[3]) {
  V[0] = s_u[U_EYE] - wpos[0];
  V[1] = s_u[U_EYE + 1] - wpos[1];
  V[2] = s_u[U_EYE + 2] - wpos[2];
  const float iv = rsqrt_guarded((V[0] * V[0] + V[1] * V[1]) + V[2] * V[2], 1e-38f);
  V[0] *= iv, V[1] *= iv, V[2] *= iv;
}

// Directional GGX (fused._ggx_planar) times the visibility `vis` (1 where
// there is no visibility plane: an exact multiply) times the light color.
// The G-buffer lighting kernel, the fused tile renderer and the directional
// resolve kernel (resolve.cu) all shade the directional light here.
__device__ __forceinline__ void directional(const float* s_u, const float (&N)[3],
                                            const float (&V)[3], const float (&alb)[3],
                                            float metal, float rough, float vis,
                                            float (&out)[3]) {
  const float ldir[3] = {s_u[U_LDIR], s_u[U_LDIR + 1], s_u[U_LDIR + 2]};
  const float alpha = maxp(rough * rough, 1e-3f);
  const float a2 = alpha * alpha;
  const float kk = ((rough + 1.0f) * (rough + 1.0f)) / 8.0f;
  const float ndv = maxp((N[0] * V[0] + N[1] * V[1]) + N[2] * V[2], 1e-4f);
  const float g1 = ndv / (ndv * (1.0f - kk) + kk);
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
    const float f0 = 0.04f * (1.0f - metal) + alb[c] * metal;
    const float F = f0 + (1.0f - f0) * f5;
    const float spec = (D * G) * F / (4.0f * ndv * ndl + 1e-4f);
    const float diffuse = (1.0f - F) * (1.0f - metal) * alb[c] * kInvPi;
    out[c] = (((diffuse + spec) * ndl) * vis) * s_u[U_LCOLOR + c];
  }
}

// Linear HDR of one covered pixel: the directional term (left out with
// kDirect off: the deferred-directional split adds it later), the
// point-light GGX loop over the n_live rows of s_lrow (8 floats each: pos,
// radius, color, intensity) in order, and ambient.
template <bool kDirect = true>
__device__ __forceinline__ void shade_pixel(const float* s_u, const float (&wpos)[3],
                                            const float (&N)[3], const float (&alb)[3],
                                            float metal, float rough, float vis,
                                            const float* s_lrow, int n_live, float (&hdr)[3]) {
  float V[3];
  view_dir(s_u, wpos, V);
  const float alpha = maxp(rough * rough, 1e-3f);
  const float a2 = alpha * alpha;
  const float kk = ((rough + 1.0f) * (rough + 1.0f)) / 8.0f;
  const float ndv = maxp((N[0] * V[0] + N[1] * V[1]) + N[2] * V[2], 1e-4f);
  const float g1 = ndv / (ndv * (1.0f - kk) + kk);
  float f0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) f0[c] = 0.04f * (1.0f - metal) + alb[c] * metal;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kDirect) directional(s_u, N, V, alb, metal, rough, vis, acc);
  // Point lights, in the order of s_lrow (ascending light id).
  for (int s = 0; s < n_live; ++s) {
    const float* lr = s_lrow + 8 * s;
    const float t0 = lr[0] - wpos[0], t1 = lr[1] - wpos[1], t2 = lr[2] - wpos[2];
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
#pragma unroll
  for (int c = 0; c < 3; ++c) hdr[c] = acc[c] + s_u[U_AMBIENT] * alb[c];
}

}  // namespace shade
