// Row scatter: out[idx[i]] = val[i] for rows of 128 int32 (512 bytes).
//
// Replaces the TPU microbenchmark kernel tools/ubench_pallas_scatter.py:
// _row_scatter_kernel (entry pallas_row_scatter), which measured the
// per-element placement floor of a counting sort on the TPU: there a
// dynamic-offset store is one whole 128-lane VMEM row.  Its plain PyTorch
// version is ops/scatter.py:row_scatter_reference (out[idx] = val).  No
// frame calls it: binning sorts (torch.sort); the kernel serves the
// measurement that decides sort against counting sort on this card.
//
// One warp per row: lane l moves bytes [16 l, 16 l + 16) of the row with
// one 16-byte load and one 16-byte store, so a warp reads one contiguous
// 512-byte row of val and writes one contiguous row of out.  An index
// outside [0, n) writes nothing.
//
// Bound: bytes.  Each row is read once and written once: 2 x n x 512
// bytes over 3.35 TB/s (0.0225 ms at the flagship binning's 73,664 keys);
// the index adds 4 bytes a row.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kVecPerRow = 128 / 4;  // int4 lanes of a 128-int32 row

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(const int* __restrict__ idx, const int4* __restrict__ val, int n,
                   int4* __restrict__ out) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int j = idx[row];
  if (j < 0 || j >= n) return;
  out[(size_t)j * kVecPerRow + lane] = val[(size_t)row * kVecPerRow + lane];
}

}  // namespace

extern "C" int row_scatter_launch(const int* idx, const int* val, int n, int* out,
                                  cudaStream_t cs) {
  if (n > 0) {
    row_scatter_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, cs>>>(
        idx, reinterpret_cast<const int4*>(val), n, reinterpret_cast<int4*>(out));
  }
  return (int)cudaGetLastError();
}
