// Tile raster kernels: binned records -> the 8 fragment planes of the staged
// frame, or the depth plane alone (the shadow map and the depth prepass).
// Both cut each tile's records into work items of at most R records, one
// block each, and merge the items.
//
// The planes (K6) replace the TPU kernels
// d3d12_deferred_renderer_tpu/ops/raster_pallas.py:_raster_kernel_stream
// (and _raster_kernel_indirect, whose small-scene record indirection the
// stream variant covers: the port's binning always builds the stream), entry
// rasterize_binned; their plain PyTorch version is
// ops/raster_tiles.py:raster_tiles_reference.  The depth (K3) replaces
// _depth_kernel_stream (and _depth_kernel_indirect), entry rasterize_depth;
// its plain version is raster_tiles.py:raster_depth_reference.
//
// The raster is raster.cuh, the one the fused tile renderer (fused.cu) runs,
// so the depth and mesh-id planes of the kernels are bit-equal.  A serial
// walk over a tile's records is bound by the tile with the most (403 of
// the flagship's 26,301 binned display records, 3652 of the shadow map's
// 27,464 in one tile), hence the work items.
//
// Work items.  The grid is n_tiles + ceil(rows / R) blocks, a bound on the
// items that the host knows without reading the counts.  A block finds its
// (tile, first record) by a block-wide scan of the items per tile, and
// blocks past the last item exit.
//
// The planes: a visibility buffer.  The serial walk keeps, at each pixel,
// the first record in submission order whose z is the least covering z in
// [0, 1] (the strict z < best test never replaces an equal z, and -0.0
// equals +0.0).  Every attribute is a pure function of (record, pixel).  So
// the kernel runs in three steps on one stream, and reads nothing on the
// host:
// 1. fill a 64-bit key a pixel with the sentinel (bits of 1.0f << 32) |
//    0xFFFFFFFF;
// 2. each work item rasterizes its records with raster.cuh's loop (the same
//    coverage, z in [0, 1] and strict z < best tests), keeping each pixel's
//    winning stream row (Out::kRow), and merges every pixel with best < 1
//    by atomicMin of the key (bits(best + 0.0f) << 32) | row;
// 3. one thread a pixel resolves: the sentinel is background (depth 1,
//    normal and uv 0, mesh id -1); any other key names the winning record,
//    which the thread evaluates again at its pixel with the same code
//    (edges, barycentrics, z, 1/w, normal, uv, mesh id).
// Why this is exact: non-negative floats order as their bits do, and z +
// 0.0f turns -0.0 (bits 0x80000000, which would sort above 1.0) into +0.0,
// so the least key is the least z, ties going to the least stream row; the
// rows of a tile's segment are in submission order, so that is the serial
// walk's winner.  The resolve recomputes z from that record, so the depth
// plane keeps a -0.0 where the serial walk keeps one.  A key's low word is
// a row, not a float, so no covering z in [0, 1) loses to the sentinel, and
// z = 1.0 or a NaN z never passes the test.  The planes are written in the
// order of the TPU kernel's _RASTER_CHANNELS: depth, normal xyz, u, v, mesh
// id (a float, -1 for background) and a zero pad plane; a warp writes 32
// neighbouring pixels of a row, so the stores coalesce.
//
// The depth: order-free.  The serial result is min(1, the least covering z
// in [0, 1]) (a NaN z never wins), so each item rasterizes its records into
// a per-thread minimum from 1.0 with the same loop (Out::kDepth), turns -0.0
// into +0.0 and merges every pixel below 1.0 into the output, filled with
// 1.0 first, by atomicMin on the float's bits as an unsigned int.  The
// minimum does not depend on the order of the merges, so the depth is
// deterministic and equal to the serial walk's as torch.equal compares
// (-0.0 == +0.0), and to the planes' depth plane.  The shadow map's tiles
// are 16 x 128 = 2048 pixels: 256 threads of 8 pixels each (NP = 8); screen
// tiles of up to 1024 pixels take NP = 4.
//
// Band mode.  y0, the grid's first pixel row in the frame, shifts every
// pixel centre (raster.cuh's tile_pixel_centers, the resolve below) and the
// record boxes' coordinate bound; the key and output planes stay the band's
// own rows.  A band's planes are those rows of the full frame's, bit for bit.
//
// Bounds.  The planes: the output, 32 bytes a pixel (66 MB at 1920x1080),
// over the card's memory rate, against about 26 operations per pixel inside
// a binned record's box for the edge tests; the records come through
// shared memory once per item, and the key plane (8 bytes a pixel) is
// scratch.  The depth: 4 bytes a pixel (4.2 MB for a 1024^2 map), so its
// edge tests over the binned pairs bound it.

#include "raster.cuh"

namespace {

using raster::kPix;
using raster::kThreads;
constexpr int kPlanes = 8;
constexpr int kWarps = kThreads / 32;
// The planes kernel's background key: 1.0f's bits over the largest row.
constexpr unsigned long long kNoWinner = (0x3f800000ull << 32) | 0xffffffffull;

template <typename T>
__global__ void fill_kernel(T* __restrict__ out, size_t n, T value) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    out[i] = value;
}

template <typename T>
void fill(T* out, size_t n, T value, cudaStream_t cs) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  fill_kernel<T><<<(unsigned)(blocks < 1024 ? blocks : 1024), kThreads, 0, cs>>>(out, n, value);
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

// Work item b in (tile, first record) order, a tile of count c holding
// ceil(c / R) items: -> (tile, index of its first record in the tile's
// segment), or false past the last item (the same for every thread of the
// block).  Every thread must call it.
__device__ bool work_item(const int* __restrict__ counts, int n_tiles, int R, int b, int* s_warp,
                          int* s_item, int& tile, int& k0) {
  const int tid = threadIdx.x;
  const int per = (n_tiles + kThreads - 1) / kThreads, t0 = tid * per;
  auto items = [&](int t) { return (max(counts[t], 0) + R - 1) / R; };
  int mine = 0;
  for (int i = 0; i < per; ++i)
    if (t0 + i < n_tiles) mine += items(t0 + i);
  int total;
  int acc = block_exclusive_scan(mine, s_warp, &total);
  if (tid == 0) s_item[2] = total;
  if (b >= acc && b < acc + mine) {
    for (int i = 0; i < per; ++i) {
      const int ni = items(t0 + i);
      if (b < acc + ni) {
        s_item[0] = t0 + i;
        s_item[1] = (b - acc) * R;
        break;
      }
      acc += ni;
    }
  }
  __syncthreads();
  if (b >= s_item[2]) return false;
  tile = s_item[0], k0 = s_item[1];
  return true;
}

// Step 2 of the planes kernel: rasterize a work item, keeping each pixel's
// winning row, and merge it into the keys.
__global__ void __launch_bounds__(kThreads)
raster_rows_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                   const float* __restrict__ stream, int n_tiles, int ntx, int tile_h, int tile_w, int y0,
                   int R, unsigned long long* __restrict__ keys, int Wp) {
  __shared__ raster::Smem sm;
  __shared__ int s_warp[kWarps];
  __shared__ int s_item[3];
  int tile, k0;
  if (!work_item(counts, n_tiles, R, blockIdx.x, s_warp, s_item, tile, k0)) return;
  const int ty = tile / ntx, tx = tile % ntx;

  float px[kPix], py[kPix];
  bool inb[kPix];
  raster::tile_pixel_centers(ty, tx, tile_h, tile_w, y0, px, py, inb);
  float depth[kPix], nrm[3][kPix], uv[2][kPix], mid[kPix];
  int win[kPix] = {};
  raster::raster_tile<false, kPix, raster::Out::kRow>(stream, offs[tile] + k0, min(R, counts[tile] - k0), sm,
                                                      (float)((tx + 1) * tile_w), (float)((ty + 1) * tile_h + y0),
                                                      px, py, inb, depth, nrm, uv, mid, win);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    // depth is in [0, 1]; -0.0 + 0.0 is +0.0 and every other value stays.
    const float d = __fadd_rn(depth[j], 0.0f);
    if (!inb[j] || !(d < 1.0f)) continue;
    const int i = threadIdx.x + j * kThreads;
    atomicMin(keys + (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w),
              ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)win[j]);
  }
}

// Step 3 of the planes kernel: one thread a pixel, the winner evaluated
// again at its pixel centre, computed as raster.cuh's tile_pixel_centers
// computes it.
__global__ void __launch_bounds__(kThreads)
resolve_rows_kernel(const unsigned long long* __restrict__ keys, const float* __restrict__ stream,
                    int tile_h, int tile_w, int y0, float* __restrict__ planes, int Hp, int Wp) {
  const size_t plane = (size_t)Hp * Wp;
  const size_t o = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= plane) return;
  const unsigned long long key = keys[o];
  float v[kPlanes] = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1.0f, 0.0f};
  if (key != kNoWinner) {
    const float* r = stream + (size_t)(unsigned)key * raster::kStride;
    const int y = (int)(o / Wp), x = (int)(o % Wp);
    const int ty = y / tile_h, tx = x / tile_w;
    const float px = ((float)(tx * tile_w) + 0.5f) + (float)(x - tx * tile_w);
    const float py = ((float)(ty * tile_h + y0) + 0.5f) + (float)(y - ty * tile_h);
    raster::Edges E;
    raster::record_edges(r, E);
    const float inv_area = 1.0f / r[raster::TRI_AREA];
    float ev[3];
    raster::edge_values(E, px, py, ev);
    const float b0 = ev[0] * inv_area, b1 = ev[1] * inv_area, b2 = ev[2] * inv_area;
    float n3[3], uv2[2];
    raster::record_attrs<true>(r, b0, b1, b2, n3, uv2);
    v[0] = raster::sum3(b0, b1, b2, r + raster::TRI_Z0, 1);
    v[1] = n3[0], v[2] = n3[1], v[3] = n3[2];
    v[4] = uv2[0], v[5] = uv2[1];
    v[6] = r[raster::TRI_MESH_ID];
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) planes[p * plane + o] = v[p];
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
raster_depth_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                    const float* __restrict__ stream, int n_tiles, int ntx, int tile_h,
                    int tile_w, int y0, int R, unsigned* __restrict__ depth_out, int Wp) {
  __shared__ raster::Smem sm;
  __shared__ int s_warp[kWarps];
  __shared__ int s_item[3];
  int tile, k0;
  if (!work_item(counts, n_tiles, R, blockIdx.x, s_warp, s_item, tile, k0)) return;
  const int ty = tile / ntx, tx = tile % ntx;

  float px[NP], py[NP];
  bool inb[NP];
  raster::tile_pixel_centers(ty, tx, tile_h, tile_w, y0, px, py, inb);
  float depth[NP], nrm[3][NP], uv[2][NP], mid[NP];
  raster::raster_tile<false, NP, raster::Out::kDepth>(stream, offs[tile] + k0, min(R, counts[tile] - k0), sm,
                                                      (float)((tx + 1) * tile_w), (float)((ty + 1) * tile_h + y0),
                                                      px, py, inb, depth, nrm, uv, mid);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    // depth is in [0, 1]; -0.0 + 0.0 is +0.0 and every other value stays.
    const float d = __fadd_rn(depth[j], 0.0f);
    if (!inb[j] || !(d < 1.0f)) continue;
    const int i = threadIdx.x + j * kThreads;
    atomicMin(depth_out + (size_t)(ty * tile_h + i / tile_w) * Wp + (size_t)(tx * tile_w + i % tile_w),
              __float_as_uint(d));
  }
}

}  // namespace

// depth [nty * tile_h, ntx * tile_w] f32, written through its bits; y0 the
// grid's first pixel row in the frame; R the records of a work item, rows
// the stream's rows (a bound on every count).
extern "C" int raster_depth_launch(const int* counts, const int* offs, const float* stream, int rows,
                                   int nty, int ntx, int tile_h, int tile_w, int y0, int R, float* depth,
                                   cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0) {
    unsigned* out = reinterpret_cast<unsigned*>(depth);
    fill(out, (size_t)n_tiles * tile_h * tile_w, 0x3f800000u /* 1.0f */, cs);
    const int grid = n_tiles + (rows + R - 1) / R;
    if (tile_h * tile_w <= kThreads * kPix)
      raster_depth_kernel<kPix><<<grid, kThreads, 0, cs>>>(counts, offs, stream, n_tiles, ntx, tile_h,
                                                           tile_w, y0, R, out, ntx * tile_w);
    else
      raster_depth_kernel<2 * kPix><<<grid, kThreads, 0, cs>>>(counts, offs, stream, n_tiles, ntx,
                                                               tile_h, tile_w, y0, R, out, ntx * tile_w);
  }
  return (int)cudaGetLastError();
}

// planes [8, nty * tile_h, ntx * tile_w] f32; keys [nty * tile_h * ntx *
// tile_w] u64 scratch; y0, R and rows as for the depth.
extern "C" int raster_tiles_launch(const int* counts, const int* offs, const float* stream, int rows,
                                   int nty, int ntx, int tile_h, int tile_w, int y0, int R,
                                   unsigned long long* keys, float* planes, cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0) {
    const int Hp = nty * tile_h, Wp = ntx * tile_w;
    const size_t n = (size_t)Hp * Wp;
    fill(keys, n, kNoWinner, cs);
    raster_rows_kernel<<<n_tiles + (rows + R - 1) / R, kThreads, 0, cs>>>(counts, offs, stream, n_tiles, ntx,
                                                                          tile_h, tile_w, y0, R, keys, Wp);
    resolve_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, cs>>>(
        keys, stream, tile_h, tile_w, y0, planes, Hp, Wp);
  }
  return (int)cudaGetLastError();
}
