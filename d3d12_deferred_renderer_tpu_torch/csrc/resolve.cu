// Directional resolve kernel: the deferred-directional split's last shading
// step, hdr += vis x directional GGX, from the split tile renderer's planes.
//
// Replaces the TPU kernel d3d12_deferred_renderer_tpu/ops/fused.py:
// _dir_resolve_kernel (helpers fused._world_from_depth, fused._ggx_planar),
// entry directional_resolve_pallas.  Its plain PyTorch version is
// ops/fused.py:directional_resolve_reference, and the arithmetic below
// follows it operation for operation.
//
// One thread per pixel.  Input planes [8, Hp, Wp] (hdr rgb, depth, decoded
// normal xyz, mesh id -1 for background) and the visibility [Hp, Wp].  At
// a pixel with depth below 1: the world position from depth at the pixel
// center, the material by mesh id from the baked table, and shade.cuh's
// directional term (the one the G-buffer lighting and fused tile kernels
// shade with) times the visibility, added to the HDR.  Elsewhere the HDR
// passes through.  Output [3, Hp, Wp].
//
// Bound: memory.  A background pixel reads its depth and 3 HDR values and
// writes 3; a covered pixel reads 9 planes; ~80 operations a covered pixel.

#include "shade.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float* __restrict__ planes, const float* __restrict__ vis,
               const float* __restrict__ mats, int n_mats, const float* __restrict__ uniforms,
               int Hp, int Wp, float* __restrict__ hdr) {
  __shared__ float s_u[shade::U_SIZE];
  if (threadIdx.x < shade::U_SIZE) s_u[threadIdx.x] = uniforms[threadIdx.x];
  __syncthreads();
  const size_t plane = (size_t)Hp * Wp;
  const size_t o = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= plane) return;
  const float depth = planes[3 * plane + o];
  float add[3] = {0.0f, 0.0f, 0.0f};
  if (depth < 1.0f) {
    const int row = (int)(o / Wp), col = (int)(o % Wp);
    float w[3], V[3];
    shade::world_from_depth(s_u, (float)col + 0.5f, (float)row + 0.5f, depth, w);
    shade::view_dir(s_u, w, V);
    const float N[3] = {planes[4 * plane + o], planes[5 * plane + o], planes[6 * plane + o]};
    const float mid = planes[7 * plane + o];
    float alb[3] = {0.0f, 0.0f, 0.0f}, metal = 0.0f, rough = 0.0f;
    if (mid >= 0.0f) {
      const float* mr = mats + 8 * (size_t)min((int)mid, n_mats - 1);
      alb[0] = mr[0], alb[1] = mr[1], alb[2] = mr[2], metal = mr[3], rough = mr[4];
    }
    shade::directional(s_u, N, V, alb, metal, rough, vis[o], add);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) hdr[c * plane + o] = planes[c * plane + o] + add[c];
}

}  // namespace

extern "C" int directional_resolve_launch(const float* planes, const float* vis, const float* mats,
                                          int n_mats, const float* uniforms, int Hp, int Wp,
                                          float* hdr, cudaStream_t cs) {
  const size_t n = (size_t)Hp * Wp;
  if (n > 0)
    resolve_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, cs>>>(
        planes, vis, mats, n_mats, uniforms, Hp, Wp, hdr);
  return (int)cudaGetLastError();
}
