// Bump kernel: procedural normal mapping of the staged frame's fragments, in
// place in the tile raster's planes, one block per screen tile.
//
// Replaces the TPU kernel d3d12_deferred_renderer_tpu/ops/bump.py:
// _bump_kernel, entry _apply_normal_mapping_pallas.  Its plain PyTorch
// version is ops/bump.py:bump_tiles_reference.
//
// Input: the tile raster's (K6's) planes [8, Hp, Wp] as it wrote them
// (depth, normal xyz, u, v, mesh id, pad), whose normal planes the kernel
// overwrites with the perturbed normals, so the frame makes no copy of the
// planes for it; the inverse view-projection [16]; the frame's width and
// height, and y0, the grid's first pixel row in the frame (a band of the
// screen-row band path; 0 for a whole frame).  Pixel centres are exact in
// float32 (raster.cuh), and world positions come from the full frame's
// NDC, so a band's normals equal the same rows of the whole frame's.
//
// One block of 256 threads per tile (up to 1024 pixels, 8 x 128 in every
// shipped config); thread tid owns pixels tid + 256 * j, j < 4.  Each thread
// reads its pixels' mesh ids, all four before anything else, and, at
// covered pixels inside the frame only, depth, uv and the normal; it
// reconstructs the world position from depth (shade.cuh, the fused tile
// renderer's reconstruction) and stages them with the normal in shared
// memory, so that every load of the kernel is made before the barrier and
// the loads of a thread's pixels overlap.  After the barrier it perturbs,
// with bump.cuh (the fused tile renderer's bump), the pixels whose
// derivative taps lie on one mesh: only those do the arithmetic and write
// their normal back.  A pixel's normal is read and written by one thread
// only, so the update in place is safe.
//
// Bound: memory.  The mesh id at every pixel, and at covered pixels depth,
// uv and the normal in and out (36 bytes); about 150 operations at each
// perturbed pixel, two of them double-precision sines.  On the card the
// arithmetic after the barrier takes longer than the loads before it
// (chip_smoke.py --time-bump times the loads alone, and the arithmetic
// with float32 sin and rsqrt).

#include "bump.cuh"
#include "shade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;
constexpr int kStaged = bump::kPlanes + 3;  // bump.cuh's planes, then the normal

__global__ void __launch_bounds__(kThreads)
bump_tile_kernel(float* __restrict__ planes, const float* __restrict__ inv_vp, int vp_row, int vp_col,
                 int ntx, int tile_h, int tile_w, int y0, float width, float height, float strength,
                 float w2pf, int Hp, int Wp) {
  __shared__ float s_u[shade::U_SIZE];
  __shared__ float s_pl[kStaged * kThreads * kPix];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int row0 = (tile / ntx) * tile_h, col0 = (tile % ntx) * tile_w;
  const int P = tile_h * tile_w;
  if (tid < 16) s_u[shade::U_INV_VP + tid] = inv_vp[(tid >> 2) * vp_row + (tid & 3) * vp_col];
  if (tid == 0) {
    s_u[shade::U_W] = width;
    s_u[shade::U_H] = height;
  }
  __syncthreads();

  // Row and column of pixel i by shift and mask where tile_w is a power of
  // two (128 in every shipped config), else by division.
  const bool pow2 = (tile_w & (tile_w - 1)) == 0;
  const int shift = __ffs(tile_w) - 1;
  const auto split = [&](int i, int& row, int& col) {
    row = pow2 ? i >> shift : i / tile_w;
    col = pow2 ? i & (tile_w - 1) : i % tile_w;
  };
  const size_t plane = (size_t)Hp * Wp;
  // The mesh ids first (-1 outside the frame): the loads of depth, uv and
  // the normal that follow are made at covered pixels only.
  float mid[kPix];
  size_t off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    int row, col;
    split(i, row, col);
    off[j] = (size_t)(row0 + row) * Wp + (size_t)(col0 + col);
    const float px = ((float)col0 + 0.5f) + (float)col;
    const float py = ((float)(y0 + row0) + 0.5f) + (float)row;
    const bool inside = i < P && px < s_u[shade::U_W] && py < s_u[shade::U_H];
    mid[j] = inside ? planes[6 * plane + off[j]] : -1.0f;
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    if (i >= P) continue;
    if (mid[j] < 0.0f) {
      s_pl[5 * P + i] = mid[j];  // same_mesh reads nothing else of this pixel
      continue;
    }
    int row, col;
    split(i, row, col);
    float w[3];
    shade::world_from_depth(s_u, ((float)col0 + 0.5f) + (float)col, ((float)(y0 + row0) + 0.5f) + (float)row,
                            planes[off[j]], w);
    bump::stage_pixel(s_pl, P, i, w, planes[4 * plane + off[j]], planes[5 * plane + off[j]], mid[j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) s_pl[(bump::kPlanes + k) * P + i] = planes[(1 + k) * plane + off[j]];
  }
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < kPix; ++j) {
    const int i = tid + j * kThreads;
    if (i >= P) continue;
    int row, col;
    split(i, row, col);
    const bump::Taps t = bump::taps(tile_h, tile_w, row, col);
    if (!bump::same_mesh(s_pl, P, t)) continue;
    const float* sn = s_pl + bump::kPlanes * P + i;
    const float n[3] = {sn[0], sn[P], sn[2 * P]};
    float nb[3];
    if (bump::perturb(s_pl, P, t, n, strength, w2pf, nb)) {
      float* nrm = planes + plane + (size_t)(row0 + row) * Wp + (size_t)(col0 + col);
      nrm[0] = nb[0];
      nrm[plane] = nb[1];
      nrm[2 * plane] = nb[2];
    }
  }
}

// The rsqrt check: bits of rsqrt_rn(x) against (float)(1.0 / sqrt((double)x))
// (the plain version's xmath.rsqrtf) for x of every bit pattern from
// `first` on, `count` of them; a NaN matches a NaN.  Mismatches added to
// *mismatches.
__global__ void rsqrt_check_kernel(unsigned first, unsigned count,
                                   unsigned long long* __restrict__ mismatches) {
  unsigned long long bad = 0;
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < count; k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(first + k);
    const float got = bump::rsqrt_rn(x);
    const float want = (float)(1.0 / sqrt((double)x));
    bad += (__float_as_uint(got) != __float_as_uint(want)) && !(got != got && want != want);
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, bad);
}

}  // namespace

// inv_vp [4, 4] read through its strides (vp_row, vp_col, in floats): the
// inverse comes from torch.linalg in column-major order, and no copy is made.
extern "C" int bump_tiles_launch(float* planes, const float* inv_vp, int vp_row, int vp_col, int nty,
                                 int ntx, int tile_h, int tile_w, int y0, float width, float height,
                                 float strength, float w2pf, cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0)
    bump_tile_kernel<<<n_tiles, kThreads, 0, cs>>>(planes, inv_vp, vp_row, vp_col, ntx, tile_h, tile_w, y0,
                                                   width, height, strength, w2pf, nty * tile_h,
                                                   ntx * tile_w);
  return (int)cudaGetLastError();
}

// mismatches: one zeroed u64 on the device.
extern "C" int bump_rsqrt_check_launch(unsigned first, unsigned count, unsigned long long* mismatches,
                                       cudaStream_t cs) {
  if (count > 0) rsqrt_check_kernel<<<4 * 132, 256, 0, cs>>>(first, count, mismatches);
  return (int)cudaGetLastError();
}
