// Tile raster kernel: binned records -> the 8 fragment planes of the staged
// frame, one block per screen tile.
//
// Replaces the TPU kernels d3d12_deferred_renderer_tpu/ops/raster_pallas.py:
// _raster_kernel_stream (and _raster_kernel_indirect, whose small-scene
// record indirection the stream variant covers: the port's binning always
// builds the stream), entry rasterize_binned.  Its plain PyTorch version is
// ops/raster_tiles.py:raster_tiles_reference.
//
// The raster is raster.cuh, the one the fused tile renderer (fused.cu) runs,
// so the depth and mesh-id planes of the two kernels are bit-equal.  Each
// thread writes its pixels of the 8 planes in the order of the TPU kernel's
// _RASTER_CHANNELS: depth, normal xyz, u, v, mesh id (a float, -1 for
// background) and a zero pad plane; a warp writes neighbouring pixels of
// one row, so the stores coalesce.
//
// Bound: the output, 32 bytes a pixel (66 MB at 1920x1080), over the card's
// memory rate, against about 20 operations per binned (tile, record) pair
// and pixel for the edge tests.  The records come through shared memory
// once per tile; nothing else is read.

#include "raster.cuh"

namespace {

using raster::kChunk;
using raster::kPix;
using raster::kStride;
using raster::kThreads;
constexpr int kPlanes = 8;

__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                   const float* __restrict__ stream, int ntx, int tile_h, int tile_w,
                   float* __restrict__ planes, int Hp, int Wp) {
  __shared__ float4 s_rec4[kChunk * kStride / 4];
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;

  float px[kPix], py[kPix];
  bool inb[kPix];
  raster::tile_pixel_centers(ty, tx, tile_h, tile_w, px, py, inb);
  float depth[kPix], nrm[3][kPix], uv[2][kPix], mid[kPix];
  raster::raster_tile<true>(stream, offs[tile], counts[tile], s_rec4, px, py, inb, depth, nrm,
                            uv, mid);

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

}  // namespace

extern "C" int raster_tiles_launch(const int* counts, const int* offs, const float* stream,
                                   int nty, int ntx, int tile_h, int tile_w, float* planes,
                                   cudaStream_t cs) {
  const int n_tiles = nty * ntx;
  if (n_tiles > 0)
    raster_tile_kernel<<<n_tiles, kThreads, 0, cs>>>(counts, offs, stream, ntx, tile_h, tile_w,
                                                     planes, nty * tile_h, ntx * tile_w);
  return (int)cudaGetLastError();
}
