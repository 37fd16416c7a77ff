// Triangle setup kernel: transform, near clip, viewport, cull, record packing.
//
// Replaces the TPU setup kernels d3d12_deferred_renderer_tpu/ops/
// setup_pallas.py:_kernel_full (the camera pass, kAttrs) and _kernel_depth
// (the shadow map's depth-only light-view pass), body _setup_body.  Their
// plain PyTorch versions are ops/transform.py:setup_triangles_reference and
// setup_depth_reference, and the arithmetic below follows them operation for
// operation, in the same association order.  The depth-only variant reads
// no normal or uv, clips the 4 clip-space components only (each component
// lerps on its own, so the clip values are the full variant's) and writes
// record fields 12-26 as zero.
//
// Bound: memory traffic and latency.  At 23,906 triangles the kernel reads
// about 2.4 MB (24 face-vertex floats + a mesh id per triangle; 0.9 MB
// depth-only) and writes about 7 MB of records, boxes and valid flags, a
// few microseconds at HBM rates; the math is a few hundred flops per
// triangle, one dependent chain per thread.  So the layout is about latency
// and store efficiency:
// - One thread a triangle in blocks of kThreads: the flagship fills every
//   SM with at least two blocks.
// - Each thread reads its mesh's MVP and model 3x3 from global memory by
//   mesh id through the read-only path: any mesh count, and the triangles
//   of one mesh are contiguous, so a warp's loads mostly broadcast.  An id
//   outside [0, M) selects zero matrices.
// - Nothing is indexed at run time: the near-clip rotation and the
//   canonical winding pick named values with selects (moving bits, rounding
//   nothing), so every per-thread array stays in registers.
// - Each thread writes its two records and boxes to shared memory, its
//   16-byte words rotated by thread so that neither the writes nor the reads
//   conflict in a bank; the block then stores its span of 2B records and
//   boxes as consecutive 16-byte words.  Each thread writes its two valid
//   bytes (record field 28 > 0) itself, so the wrapper launches nothing else.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kStride = 32;             // TRI_STRIDE
constexpr int kWords = kStride / 4;     // 16-byte words a record
constexpr int kStageWords = 2 * kWords + 2;  // a thread's two records and boxes
// Dynamic shared memory, so that larger block sizes may exceed the static
// 48 KB (chip_smoke.py --time-staged builds this source at 64, 128 and 256).
constexpr int kSmemBytes = kThreads * kStageWords * 16;

// Per vertex: clip position (0-3), world normal (4-6), uv (7-8).
struct Slot {
  float x[3][9];
};

__device__ __forceinline__ float lerp_t(float za, float zb) {
  float d = za - zb;
  return za / (d == 0.0f ? 1.0f : d);
}

// a_r for r in {0, 1, 2}.
__device__ __forceinline__ float sel3(int r, float a0, float a1, float a2) {
  return r == 0 ? a0 : (r == 1 ? a1 : a2);
}

// Vertex k of the canonical winding: v1 and v2 swapped when `swap`.
__device__ __forceinline__ float wind(int k, bool swap, float a0, float a1, float a2) {
  return k == 0 ? a0 : ((k == 1) != swap ? a1 : a2);
}

// One slot: viewport, cull, canonical winding, packing (transform._setup_cols)
// into this thread's staged record `rec` (8 words, word q at (q + rot) % 8)
// and box; returns the valid flag.
template <bool kAttrs>
__device__ __forceinline__ bool emit(const Slot& s, float mesh_id, float W, float H, int cull,
                                     float4* rec, int rot, float4* box) {
  float w[3], rw[3], sx[3], sy[3], sz[3];
  const float hw = W * 0.5f, hh = H * 0.5f;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    w[v] = s.x[v][3];
    rw[v] = 1.0f / (w[v] == 0.0f ? 1.0f : w[v]);
    sx[v] = (s.x[v][0] * rw[v] + 1.0f) * hw;
    sy[v] = (1.0f - s.x[v][1] * rw[v]) * hh;
    sz[v] = s.x[v][2] * rw[v];
  }
  const bool w_ok = (w[0] > 1e-6f) && (w[1] > 1e-6f) && (w[2] > 1e-6f);
  const float area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0]);
  const bool front = area2 < 0.0f;  // FrontCounterClockwise=TRUE
  const bool keep = cull == 0 ? true : (cull == 1 ? front : !front);  // none, back, front
  bool valid = w_ok && keep && (area2 != 0.0f);
  const float minx = minp(minp(sx[0], sx[1]), sx[2]);
  const float maxx = maxp(maxp(sx[0], sx[1]), sx[2]);
  const float miny = minp(minp(sy[0], sy[1]), sy[2]);
  const float maxy = maxp(maxp(sy[0], sy[1]), sy[2]);
  const bool on_screen = (maxx >= 0.0f) && (minx < W) && (maxy >= 0.0f) && (miny < H);
  const bool z_ok = (maxp(maxp(sz[0], sz[1]), sz[2]) >= 0.0f) &&
                    (minp(minp(sz[0], sz[1]), sz[2]) <= 1.0f);
  valid = valid && on_screen && z_ok;

  // Canonical positive winding: swap v1 <-> v2 when the area is negative.
  const bool swap = area2 < 0.0f;
  float r[kStride];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rwk = wind(k, swap, rw[0], rw[1], rw[2]);
    r[2 * k] = wind(k, swap, sx[0], sx[1], sx[2]);
    r[2 * k + 1] = wind(k, swap, sy[0], sy[1], sy[2]);
    r[6 + k] = wind(k, swap, sz[0], sz[1], sz[2]);
    r[9 + k] = rwk;
#pragma unroll
    for (int j = 0; j < 3; ++j) r[12 + 3 * k + j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) r[21 + 2 * k + j] = 0.0f;
    if constexpr (kAttrs) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r[12 + 3 * k + j] = wind(k, swap, s.x[0][4 + j], s.x[1][4 + j], s.x[2][4 + j]) * rwk;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        r[21 + 2 * k + j] = wind(k, swap, s.x[0][7 + j], s.x[1][7 + j], s.x[2][7 + j]) * rwk;
    }
  }
  r[27] = mesh_id;
  r[28] = valid ? 1.0f : 0.0f;
  r[29] = fabsf(area2);
  r[30] = 0.0f;
  r[31] = 0.0f;
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    rec[(q + rot) % kWords] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  *box = make_float4(clampp(minx, 0.0f, W), clampp(miny, 0.0f, H), clampp(maxx, 0.0f, W),
                     clampp(maxy, 0.0f, H));
  return valid;
}

template <bool kAttrs>
__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
             const float* __restrict__ uv, const int* __restrict__ mesh_id,
             const float* __restrict__ mvp, const float* __restrict__ model,
             int T, int M, float W, float H, int cull,
             float* __restrict__ packed, float* __restrict__ aabb,
             unsigned char* __restrict__ valid) {
  extern __shared__ float4 stage[];  // [kThreads][2][kWords] records, then [kThreads][2] boxes
  float4* sbox = stage + kThreads * 2 * kWords;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kThreads;
  const int t = t0 + tid;
  const int rot = tid % kWords;
  if (t < T) {
    const int m = __ldg(mesh_id + t);
    const bool m_ok = m >= 0 && m < M;  // out-of-range ids select zero matrices
    float S[16], N[9];
#pragma unroll
    for (int i = 0; i < 16; ++i) S[i] = m_ok ? __ldg(mvp + 16 * m + i) : 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i)
      N[i] = (kAttrs && m_ok) ? __ldg(model + 16 * m + 4 * (i / 3) + (i % 3)) : 0.0f;

    // Corner v's components (clip 0-3, normal 4-6, uv 7-8); a column
    // buffer [3, C, T] holds component j of corner v at (v*C + j)*T + t.
    float c[3][9];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float p0 = __ldg(pos + (3 * v + 0) * T + t), p1 = __ldg(pos + (3 * v + 1) * T + t),
                  p2 = __ldg(pos + (3 * v + 2) * T + t);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        c[v][k] = ((p0 * S[k] + p1 * S[4 + k]) + p2 * S[8 + k]) + S[12 + k];
      if constexpr (kAttrs) {
        const float q0 = __ldg(nrm + (3 * v + 0) * T + t), q1 = __ldg(nrm + (3 * v + 1) * T + t),
                    q2 = __ldg(nrm + (3 * v + 2) * T + t);
#pragma unroll
        for (int j = 0; j < 3; ++j) c[v][4 + j] = (q0 * N[j] + q1 * N[3 + j]) + q2 * N[6 + j];
        c[v][7] = __ldg(uv + (2 * v + 0) * T + t);
        c[v][8] = __ldg(uv + (2 * v + 1) * T + t);
      }
    }

    // Near-plane clip (transform._clip_near_plane_stack): rotate so that the
    // lone inside vertex (one in) or the lone outside vertex (two in) sits at
    // a canonical slot, then lerp the cut edges in clip space.
    const bool in0 = c[0][2] >= 0.0f, in1 = c[1][2] >= 0.0f, in2 = c[2][2] >= 0.0f;
    const int n_in = int(in0) + int(in1) + int(in2);
    const int first_in = in0 ? 0 : (in1 ? 1 : 2);
    const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
    const int r = n_in == 1 ? first_in : (n_in == 2 ? (first_out + 1) % 3 : 0);
    constexpr int kComps = kAttrs ? 9 : 4;
    float a[3][9];  // rotated: a[v] = corner (v + r) % 3
#pragma unroll
    for (int k = 0; k < kComps; ++k) {
      a[0][k] = sel3(r, c[0][k], c[1][k], c[2][k]);
      a[1][k] = sel3(r, c[1][k], c[2][k], c[0][k]);
      a[2][k] = sel3(r, c[2][k], c[0][k], c[1][k]);
    }
    const float tAB = lerp_t(a[0][2], a[1][2]), tAC = lerp_t(a[0][2], a[2][2]),
                tBC = lerp_t(a[1][2], a[2][2]);
    const bool sel1 = n_in == 1, sel2 = n_in == 2, sel3v = n_in == 3;
    Slot s0, s1;
#pragma unroll
    for (int k = 0; k < kComps; ++k) {
      const float A = a[0][k], B = a[1][k], C = a[2][k];
      const float ab = A + (B - A) * tAB;
      const float ac = A + (C - A) * tAC;
      const float bc = B + (C - B) * tBC;
      const float v0[3] = {A, (sel3v || sel2) ? B : (sel1 ? ab : A),
                           sel3v ? C : (sel2 ? bc : (sel1 ? ac : A))};
      const float v1[3] = {A, sel2 ? bc : A, sel2 ? ac : A};
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        s0.x[v][k] = v0[v];
        s1.x[v][k] = v1[v];
      }
    }
    const float mid = float(m);
    float4* rec = stage + 2 * kWords * tid;
    const bool ok0 = emit<kAttrs>(s0, mid, W, H, cull, rec, rot, sbox + 2 * tid);
    const bool ok1 = emit<kAttrs>(s1, mid, W, H, cull, rec + kWords, rot, sbox + 2 * tid + 1);
    reinterpret_cast<uchar2*>(valid)[t] = make_uchar2(ok0, ok1);
  }
  __syncthreads();

  // The block's span: records [2 t0, 2 t0 + 2n) and their boxes, n = the
  // block's triangles (fewer in the tail block).
  const int words = 2 * kWords * min(kThreads, T - t0);
  float4* out = reinterpret_cast<float4*>(packed) + (size_t)t0 * 2 * kWords;
  for (int i = tid; i < words; i += kThreads) {
    const int row = i / kWords, q = i % kWords;
    out[i] = stage[row * kWords + (q + (row / 2) % kWords) % kWords];
  }
  float4* obox = reinterpret_cast<float4*>(aabb) + (size_t)t0 * 2;
  for (int i = tid; i < words / kWords; i += kThreads) obox[i] = sbox[i];
}

template <bool kAttrs>
int launch(const float* pos, const float* nrm, const float* uv, const int* mesh_id,
           const float* mvp, const float* model, int T, int M, float W, float H, int cull,
           float* packed, float* aabb, unsigned char* valid, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      setup_kernel<kAttrs>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  if (T > 0)
    setup_kernel<kAttrs><<<(T + kThreads - 1) / kThreads, kThreads, kSmemBytes, stream>>>(
        pos, nrm, uv, mesh_id, mvp, model, T, M, W, H, cull, packed, aabb, valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int setup_triangles_launch(const float* pos, const float* nrm, const float* uv,
                                      const int* mesh_id, const float* mvp,
                                      const float* model, int T, int M, float W, float H,
                                      int cull, float* packed, float* aabb,
                                      unsigned char* valid, cudaStream_t stream) {
  return launch<true>(pos, nrm, uv, mesh_id, mvp, model, T, M, W, H, cull, packed, aabb, valid,
                      stream);
}

extern "C" int setup_depth_launch(const float* pos, const int* mesh_id, const float* mvp, int T,
                                  int M, float W, float H, int cull, float* packed, float* aabb,
                                  unsigned char* valid, cudaStream_t stream) {
  return launch<false>(pos, nullptr, nullptr, mesh_id, mvp, nullptr, T, M, W, H, cull, packed,
                       aabb, valid, stream);
}
