// Bump kernel: procedural normal mapping of the staged frame's fragments,
// one block per screen tile.
//
// Replaces the TPU kernel d3d12_deferred_renderer_tpu/ops/bump.py:
// _bump_kernel, entry _apply_normal_mapping_pallas.  Its plain PyTorch
// version is ops/bump.py:bump_tiles_reference.
//
// One block of 256 threads per tile (up to 1024 pixels, 8 x 128 in every
// shipped config); thread tid owns pixels tid + 256 * j, j < 4.  Each thread
// reads its pixels' depth, uv and mesh id, reconstructs the world position
// from depth (shade.cuh, the fused tile renderer's reconstruction), and
// stages them in shared memory; after one barrier it perturbs its pixels'
// normals with bump.cuh (the fused tile renderer's bump) from the staged
// neighbours.  Input planes [7, Hp, Wp]: depth, normal xyz, u, v, mesh id;
// output the normals [3, Hp, Wp].
//
// Bound: memory.  28 bytes a pixel in and 12 out (83 MB at 1920x1080)
// against ~150 operations a pixel, two of them double-precision sines and
// four double-precision reciprocal square roots.

#include "bump.cuh"
#include "shade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;

__global__ void __launch_bounds__(kThreads)
bump_tile_kernel(const float* __restrict__ planes, const float* __restrict__ uniforms, int ntx,
                 int tile_h, int tile_w, float strength, float w2pf, float* __restrict__ out,
                 int Hp, int Wp) {
  __shared__ float s_u[shade::U_SIZE];
  __shared__ float s_pl[bump::kPlanes * kThreads * kPix];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int P = tile_h * tile_w;
  if (tid < shade::U_SIZE) s_u[tid] = uniforms[tid];
  __syncthreads();

  const size_t plane = (size_t)Hp * Wp;
  size_t off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    if (i >= P) continue;
    const int row = i / tile_w, col = i % tile_w;
    off[j] = (size_t)(ty * tile_h + row) * Wp + (size_t)(tx * tile_w + col);
    const float px = ((float)(tx * tile_w) + 0.5f) + (float)col;
    const float py = ((float)(ty * tile_h) + 0.5f) + (float)row;
    float w[3];
    shade::world_from_depth(s_u, px, py, planes[off[j]], w);
    const bool inside = px < s_u[shade::U_W] && py < s_u[shade::U_H];
    bump::stage_pixel(s_pl, P, i, w, planes[4 * plane + off[j]], planes[5 * plane + off[j]],
                      inside ? planes[6 * plane + off[j]] : -1.0f);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    if (i >= P) continue;
    const float n[3] = {planes[plane + off[j]], planes[2 * plane + off[j]], planes[3 * plane + off[j]]};
    float nb[3];
    bump::bump_pixel(s_pl, tile_h, tile_w, i, n, strength, w2pf, nb);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * plane + off[j]] = nb[c];
  }
}

}  // namespace

extern "C" int bump_tiles_launch(const float* planes, const float* uniforms, int nty, int ntx,
                                 int tile_h, int tile_w, float strength, float w2pf, float* out,
                                 cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0)
    bump_tile_kernel<<<n_tiles, kThreads, 0, cs>>>(planes, uniforms, ntx, tile_h, tile_w, strength,
                                                   w2pf, out, nty * tile_h, ntx * tile_w);
  return (int)cudaGetLastError();
}
