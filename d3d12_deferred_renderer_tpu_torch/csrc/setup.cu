// Triangle setup kernel: transform, near clip, viewport, cull, record packing.
//
// Replaces the TPU setup kernel d3d12_deferred_renderer_tpu/ops/
// setup_pallas.py:_kernel_full (body _setup_body).  Its plain PyTorch version
// is ops/transform.py:setup_triangles_reference, and the arithmetic below
// follows it operation for operation, in the same association order.
//
// One thread per input triangle.  The block stages every mesh's MVP (16
// floats) and model 3x3 block (9 floats) in shared memory; a triangle reads
// its own by mesh id.  Each thread writes both near-clip slots of its
// triangle straight into packed[2t], packed[2t+1] and aabb[2t], aabb[2t+1],
// in submission order.
//
// Bound: launch and memory traffic.  At 23,906 triangles the kernel reads
// about 2.4 MB (24 face-vertex floats + a mesh id per triangle) and writes
// about 7 MB of records and boxes, a few microseconds at HBM rates; the math
// is a few hundred flops per triangle.  Records go out as float4 stores.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 32;  // TRI_STRIDE

struct Slot {
  float c[3][4];  // clip position per vertex
  float n[3][3];  // world normal per vertex
  float uv[3][2];
};

__device__ __forceinline__ float lerp_t(float za, float zb) {
  float d = za - zb;
  return za / (d == 0.0f ? 1.0f : d);
}

// One slot: viewport, cull, canonical winding, packing (transform._setup_cols).
__device__ void emit(const Slot& s, float mesh_id, float W, float H, int cull,
                     float* __restrict__ rec,
                     float* __restrict__ box) {
  float w[3], rw[3], sx[3], sy[3], sz[3];
  const float hw = W * 0.5f, hh = H * 0.5f;
  for (int v = 0; v < 3; ++v) {
    w[v] = s.c[v][3];
    rw[v] = 1.0f / (w[v] == 0.0f ? 1.0f : w[v]);
    sx[v] = (s.c[v][0] * rw[v] + 1.0f) * hw;
    sy[v] = (1.0f - s.c[v][1] * rw[v]) * hh;
    sz[v] = s.c[v][2] * rw[v];
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
  const int order[3] = {0, swap ? 2 : 1, swap ? 1 : 2};
  float r[kStride];
  for (int k = 0; k < 3; ++k) {
    const int v = order[k];
    r[2 * k] = sx[v];
    r[2 * k + 1] = sy[v];
    r[6 + k] = sz[v];
    r[9 + k] = rw[v];
    for (int j = 0; j < 3; ++j) r[12 + 3 * k + j] = s.n[v][j] * rw[v];
    for (int j = 0; j < 2; ++j) r[21 + 2 * k + j] = s.uv[v][j] * rw[v];
  }
  r[27] = mesh_id;
  r[28] = valid ? 1.0f : 0.0f;
  r[29] = fabsf(area2);
  r[30] = 0.0f;
  r[31] = 0.0f;
  float4* out = reinterpret_cast<float4*>(rec);
  for (int q = 0; q < kStride / 4; ++q)
    out[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  *reinterpret_cast<float4*>(box) = make_float4(
      clampp(minx, 0.0f, W), clampp(miny, 0.0f, H), clampp(maxx, 0.0f, W),
      clampp(maxy, 0.0f, H));
}

__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
             const float* __restrict__ uv, const int* __restrict__ mesh_id,
             const float* __restrict__ mvp, const float* __restrict__ model,
             int T, int M, float W, float H, int cull,
             float* __restrict__ packed, float* __restrict__ aabb) {
  extern __shared__ float smem[];
  float* s_mvp = smem;           // [M][16]
  float* s_mdl = smem + 16 * M;  // [M][9]: model[m][i][j], i, j < 3
  for (int i = threadIdx.x; i < 16 * M; i += blockDim.x) s_mvp[i] = mvp[i];
  for (int i = threadIdx.x; i < 9 * M; i += blockDim.x) {
    const int m = i / 9, k = i % 9;
    s_mdl[i] = model[16 * m + 4 * (k / 3) + (k % 3)];
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int m = mesh_id[t];
  const bool m_ok = m >= 0 && m < M;  // out-of-range ids select zero matrices
  const float* S = s_mvp + 16 * (m_ok ? m : 0);
  const float* N = s_mdl + 9 * (m_ok ? m : 0);
  const float msk = m_ok ? 1.0f : 0.0f;

  // Corner v, component j of a [3, C, T] column buffer: buf[(v*C + j)*T + t].
  float c[3][4], n[3][3], u[3][2];
  for (int v = 0; v < 3; ++v) {
    const float p0 = pos[(3 * v + 0) * T + t], p1 = pos[(3 * v + 1) * T + t],
                p2 = pos[(3 * v + 2) * T + t];
    for (int k = 0; k < 4; ++k)
      c[v][k] = ((p0 * (S[k] * msk) + p1 * (S[4 + k] * msk)) + p2 * (S[8 + k] * msk)) +
                S[12 + k] * msk;
    const float q0 = nrm[(3 * v + 0) * T + t], q1 = nrm[(3 * v + 1) * T + t],
                q2 = nrm[(3 * v + 2) * T + t];
    for (int j = 0; j < 3; ++j)
      n[v][j] = (q0 * (N[j] * msk) + q1 * (N[3 + j] * msk)) + q2 * (N[6 + j] * msk);
    u[v][0] = uv[(2 * v + 0) * T + t];
    u[v][1] = uv[(2 * v + 1) * T + t];
  }

  // Near-plane clip (transform._clip_near_plane_stack): rotate so that the
  // lone inside vertex (one in) or the lone outside vertex (two in) sits at a
  // canonical slot, then lerp the cut edges in clip space.
  const bool in0 = c[0][2] >= 0.0f, in1 = c[1][2] >= 0.0f, in2 = c[2][2] >= 0.0f;
  const int n_in = int(in0) + int(in1) + int(in2);
  const int first_in = in0 ? 0 : (in1 ? 1 : 2);
  const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
  const int r = n_in == 1 ? first_in : (n_in == 2 ? (first_out + 1) % 3 : 0);
  float A[9], Bv[9], Cv[9];  // rotated vertices: 4 clip + 3 normal + 2 uv
  float* rows[3] = {A, Bv, Cv};
  for (int v = 0; v < 3; ++v) {
    const int src = (v + r) % 3;
    float* d = rows[v];
    for (int k = 0; k < 4; ++k) d[k] = c[src][k];
    for (int j = 0; j < 3; ++j) d[4 + j] = n[src][j];
    for (int j = 0; j < 2; ++j) d[7 + j] = u[src][j];
  }
  const float tAB = lerp_t(A[2], Bv[2]), tAC = lerp_t(A[2], Cv[2]), tBC = lerp_t(Bv[2], Cv[2]);
  const bool sel1 = n_in == 1, sel2 = n_in == 2, sel3 = n_in == 3;
  Slot s0, s1;
  for (int k = 0; k < 9; ++k) {
    const float a = A[k], b = Bv[k], cc = Cv[k];
    const float ab = a + (b - a) * tAB;
    const float ac = a + (cc - a) * tAC;
    const float bc = b + (cc - b) * tBC;
    const float s0v1 = (sel3 || sel2) ? b : (sel1 ? ab : a);
    const float s0v2 = sel3 ? cc : (sel2 ? bc : (sel1 ? ac : a));
    const float s1v1 = sel2 ? bc : a;
    const float s1v2 = sel2 ? ac : a;
    const float v0[3] = {a, s0v1, s0v2}, v1[3] = {a, s1v1, s1v2};
    for (int v = 0; v < 3; ++v) {
      if (k < 4) {
        s0.c[v][k] = v0[v];
        s1.c[v][k] = v1[v];
      } else if (k < 7) {
        s0.n[v][k - 4] = v0[v];
        s1.n[v][k - 4] = v1[v];
      } else {
        s0.uv[v][k - 7] = v0[v];
        s1.uv[v][k - 7] = v1[v];
      }
    }
  }
  const float mid = float(m);
  emit(s0, mid, W, H, cull, packed + (size_t)(2 * t) * kStride, aabb + (size_t)(2 * t) * 4);
  emit(s1, mid, W, H, cull, packed + (size_t)(2 * t + 1) * kStride,
       aabb + (size_t)(2 * t + 1) * 4);
}

}  // namespace

extern "C" int setup_triangles_launch(const float* pos, const float* nrm, const float* uv,
                                      const int* mesh_id, const float* mvp,
                                      const float* model, int T, int M, float W, float H,
                                      int cull, float* packed, float* aabb,
                                      cudaStream_t stream) {
  if (T > 0) {
    const int blocks = (T + kThreads - 1) / kThreads;
    const size_t smem = sizeof(float) * 25 * (size_t)M;
    setup_kernel<<<blocks, kThreads, smem, stream>>>(pos, nrm, uv, mesh_id, mvp, model, T,
                                                     M, W, H, cull, packed, aabb);
  }
  return (int)cudaGetLastError();
}
