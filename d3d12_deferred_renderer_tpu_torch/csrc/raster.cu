// Tile raster kernels: binned records -> the 8 fragment planes of the staged
// frame (one block per tile), or the depth plane alone (the shadow map and
// the depth prepass; a tile's records split over several blocks).
//
// raster_tile_kernel replaces the TPU kernels
// d3d12_deferred_renderer_tpu/ops/raster_pallas.py:_raster_kernel_stream
// (and _raster_kernel_indirect, whose small-scene record indirection the
// stream variant covers: the port's binning always builds the stream), entry
// rasterize_binned; its plain PyTorch version is
// ops/raster_tiles.py:raster_tiles_reference.  raster_depth_kernel replaces
// _depth_kernel_stream (and _depth_kernel_indirect), entry rasterize_depth;
// its plain version is raster_tiles.py:raster_depth_reference.
//
// The raster is raster.cuh, the one the fused tile renderer (fused.cu) runs,
// so the depth and mesh-id planes of the two kernels are bit-equal.  Each
// thread writes its pixels of the 8 planes in the order of the TPU kernel's
// _RASTER_CHANNELS: depth, normal xyz, u, v, mesh id (a float, -1 for
// background) and a zero pad plane; a warp writes neighbouring pixels of
// one row, so the stores coalesce.
//
// Bound: the output, 32 bytes a pixel (66 MB at 1920x1080), over the card's
// memory rate, against about 26 operations per pixel inside a binned
// record's box for the edge tests.  The records come through shared memory
// once per tile; nothing else is read.
//
// The depth kernel.  A serial walk is bound by the tile with the most
// records (one shadow tile holds 3652 of 27,464), so the depth kernel cuts
// each tile's segment into work items of at most R records and runs one
// block per item.  Depth alone is order-free: the serial result is
// min(1, the least covering z in [0, 1]) (a NaN z never wins), so each item
// rasterizes its records into a per-thread minimum from 1.0 with the same
// loop (raster.cuh's kAttrs off), turns -0.0 into +0.0 and merges every
// pixel below 1.0 into the output, filled with 1.0 first, by atomicMin on
// the float's bits as an unsigned int.  Non-negative floats order as their
// bits do; -0.0's bits (0x80000000) would sort above 1.0, hence the
// canonicalisation.  The minimum does not depend on the order of the
// merges, so the depth is deterministic and equal to the serial walk's as
// torch.equal compares (-0.0 == +0.0), and to the full kernel's depth plane.
// The grid is n_tiles + ceil(rows / R) blocks, a bound on the items that the
// host knows without reading the counts; each block finds its (tile, first
// record) by a block-wide scan of ceil(counts / R), and blocks past the last
// item exit.  The shadow map's tiles are 16 x 128 = 2048 pixels: 256
// threads of 8 pixels each (NP = 8); screen tiles of up to 1024 pixels take
// NP = 4.  It writes 4 bytes a pixel (4.2 MB for a 1024^2 map), so its edge
// tests over the binned pairs bound it.

#include "raster.cuh"

namespace {

using raster::kPix;
using raster::kThreads;
constexpr int kPlanes = 8;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                   const float* __restrict__ stream, int ntx, int tile_h, int tile_w,
                   float* __restrict__ planes, int Hp, int Wp) {
  __shared__ raster::Smem sm;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;

  float px[kPix], py[kPix];
  bool inb[kPix];
  raster::tile_pixel_centers(ty, tx, tile_h, tile_w, px, py, inb);
  float depth[kPix], nrm[3][kPix], uv[2][kPix], mid[kPix];
  raster::raster_tile<true>(stream, offs[tile], counts[tile], sm, (float)((tx + 1) * tile_w),
                            (float)((ty + 1) * tile_h), px, py, inb, depth, nrm, uv, mid);

  const size_t plane = (size_t)Hp * Wp;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!inb[j]) continue;
    const int i = threadIdx.x + j * kThreads;
    const size_t o = (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w);
    const float v[kPlanes] = {depth[j], nrm[0][j], nrm[1][j], nrm[2][j],
                              uv[0][j], uv[1][j], mid[j], 0.0f};
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) planes[p * plane + o] = v[p];
  }
}

__global__ void fill_kernel(unsigned* __restrict__ out, size_t n, unsigned value) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    out[i] = value;
}

// Exclusive prefix sum over the block of one int a thread; *total gets the
// sum.  Every thread must call it.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    sum += s_warp[w];
  }
  *total = sum;
  return before + incl - v;
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
raster_depth_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                    const float* __restrict__ stream, int n_tiles, int ntx, int tile_h,
                    int tile_w, int R, unsigned* __restrict__ depth_out, int Wp) {
  __shared__ raster::Smem sm;
  __shared__ int s_warp[kWarps];
  __shared__ int s_item[3];  // tile, first record of the segment, items in all

  // ---- this block's work item: the b-th in (tile, first record) order ----
  const int b = blockIdx.x, tid = threadIdx.x;
  const int per = (n_tiles + kThreads - 1) / kThreads, t0 = tid * per;
  int mine = 0;
  for (int i = 0; i < per; ++i)
    if (t0 + i < n_tiles) mine += (max(counts[t0 + i], 0) + R - 1) / R;
  int total;
  int acc = block_exclusive_scan(mine, s_warp, &total);
  if (tid == 0) s_item[2] = total;
  if (b >= acc && b < acc + mine) {
    for (int i = 0; i < per; ++i) {
      const int ni = (max(counts[t0 + i], 0) + R - 1) / R;
      if (b < acc + ni) {
        s_item[0] = t0 + i;
        s_item[1] = (b - acc) * R;
        break;
      }
      acc += ni;
    }
  }
  __syncthreads();
  if (b >= s_item[2]) return;  // past the last item (uniform over the block)
  const int tile = s_item[0], k0 = s_item[1];
  const int ty = tile / ntx, tx = tile % ntx;

  float px[NP], py[NP];
  bool inb[NP];
  raster::tile_pixel_centers(ty, tx, tile_h, tile_w, px, py, inb);
  float depth[NP], nrm[3][NP], uv[2][NP], mid[NP];
  raster::raster_tile<false, NP, false>(stream, offs[tile] + k0, min(R, counts[tile] - k0), sm,
                                        (float)((tx + 1) * tile_w), (float)((ty + 1) * tile_h),
                                        px, py, inb, depth, nrm, uv, mid);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    // depth is in [0, 1]; -0.0 + 0.0 is +0.0 and every other value stays.
    const float d = __fadd_rn(depth[j], 0.0f);
    if (!inb[j] || !(d < 1.0f)) continue;
    const int i = tid + j * kThreads;
    atomicMin(depth_out + (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w),
              __float_as_uint(d));
  }
}

}  // namespace

// depth [nty * tile_h, ntx * tile_w] f32, written through its bits; R the
// records of a work item, rows the stream's rows (a bound on every count).
extern "C" int raster_depth_launch(const int* counts, const int* offs, const float* stream, int rows,
                                   int nty, int ntx, int tile_h, int tile_w, int R, float* depth,
                                   cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0) {
    const size_t n = (size_t)n_tiles * tile_h * tile_w;
    unsigned* out = reinterpret_cast<unsigned*>(depth);
    const size_t fill_blocks = (n + kThreads - 1) / kThreads;
    fill_kernel<<<(unsigned)(fill_blocks < 1024 ? fill_blocks : 1024), kThreads, 0, cs>>>(
        out, n, 0x3f800000u /* 1.0f */);
    const int grid = n_tiles + (rows + R - 1) / R;
    if (tile_h * tile_w <= kThreads * kPix)
      raster_depth_kernel<kPix><<<grid, kThreads, 0, cs>>>(counts, offs, stream, n_tiles, ntx, tile_h,
                                                           tile_w, R, out, ntx * tile_w);
    else
      raster_depth_kernel<2 * kPix><<<grid, kThreads, 0, cs>>>(counts, offs, stream, n_tiles, ntx,
                                                               tile_h, tile_w, R, out, ntx * tile_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int raster_tiles_launch(const int* counts, const int* offs, const float* stream,
                                   int nty, int ntx, int tile_h, int tile_w, float* planes,
                                   cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0)
    raster_tile_kernel<<<n_tiles, kThreads, 0, cs>>>(counts, offs, stream, ntx, tile_h, tile_w,
                                                     planes, nty * tile_h, ntx * tile_w);
  return (int)cudaGetLastError();
}
