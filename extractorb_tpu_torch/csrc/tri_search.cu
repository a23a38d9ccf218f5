// K7 tri_search: the epipolar descriptor search of CreateNewMapPoints, with
// the triangulation and its acceptance gates, for B neighbour keyframes.
//
// Replaces extractorb_tpu/slam/local_mapping.py:_triangulation_program (the
// TPU runs it as one vmapped XLA program: dense bf16 bit-plane Hamming
// matrices, matcher.py:search_for_triangulation, then two_view.triangulate
// and the gates).  Two launches:
//   1. search_kernel, one CTA per (neighbour, kp1 row): XOR + popcount over
//      the kp2 columns that pass the epipolar gate d^2 < 3.84 sigma2[oct2]
//      (l = F12^T [x1 y1 1]) and both free masks; the best distance wins, the
//      lower column on ties (jnp.argmin).  A row whose best is <= TH_LOW
//      claims its column with atomicMin on best * N1 + i1 (min distance, then
//      the earlier kp1).
//   2. finalize_kernel, one thread per (neighbour, kp1 row): keeps the rows
//      that won their claim, and with the geometry, triangulates with the
//      3x3 adjugate (two_view.py:138-187) and applies the gates of
//      local_mapping.py:226-245 (positive depth in both views, parallax
//      cosine < 0.9998, reprojection chi2 <= 5.991 sigma2 in both views, the
//      scale-consistency ratio).
// The float arithmetic follows the plain version (frontend/matcher.py,
// tri_search_plain) operation by operation; the build uses -fmad=false.
//
// Bound on the H100: the Hamming scan, B x N1 x N2 popcounts of 256 bits
// (8 x 1128 x 1128 ~ 10^7 pairs per keyframe event) reading the kp2
// descriptors from L1/L2; one CTA per row keeps every SM busy.  The dense
// matrix the TPU builds is never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInf = 1 << 20;
constexpr int kThLow = 50;

struct Side1 {
  const uint8_t* desc;  // (N1,32)
  const float* xy;      // (N1,2)
  const int* oct;       // (N1,)
  const bool* free_;    // (N1,)
  int N1;
};

struct Side2 {
  const uint8_t* desc;  // (B,N2,32)
  const float* xy;      // (B,N2,2)
  const int* oct;       // (B,N2)
  const bool* free_;    // (B,N2)
  const float* F12;     // (B,3,3)
  int N2, B;
};

struct Geom {
  const float* P1;   // (3,4)
  const float* P2;   // (B,3,4)
  const float* R1;   // (3,3)
  const float* t1;   // (3,)
  const float* R2;   // (B,3,3)
  const float* t2;   // (B,3)
  const float* O1;   // (3,)
  const float* O2;   // (B,3)
  const float* sf;   // (L,) scale factors
  float fx, fy, cx, cy, factor;
};

__global__ void __launch_bounds__(kThreads)
search_kernel(const Side1 s1, const Side2 s2, const float* __restrict__ sigma2, int n_lvl,
              int* __restrict__ best_out, int* __restrict__ winner) {
  __shared__ int s_key[kThreads / 32];
  const int i1 = blockIdx.x, b = blockIdx.y;
  const int N1 = s1.N1, N2 = s2.N2;
  int key = 0x7fffffff;  // dist * N2 + column
  if (s1.free_[i1]) {
    const float* F = s2.F12 + 9 * b;
    const float x = s1.xy[2 * i1], y = s1.xy[2 * i1 + 1];
    const float la = x * F[0] + y * F[3] + F[6];
    const float lb = x * F[1] + y * F[4] + F[7];
    const float lc = x * F[2] + y * F[5] + F[8];
    const float den = fmaxf(la * la + lb * lb, 1e-12f);
    uint32_t d1[8];
    const uint32_t* q = reinterpret_cast<const uint32_t*>(s1.desc + 32 * (size_t)i1);
#pragma unroll
    for (int k = 0; k < 8; ++k) d1[k] = q[k];
    const size_t off = (size_t)b * N2;
    for (int j = threadIdx.x; j < N2; j += kThreads) {
      if (!s2.free_[off + j]) continue;
      const float num = la * s2.xy[2 * (off + j)] + lb * s2.xy[2 * (off + j) + 1] + lc;
      const float d2 = num * num / den;
      int o = s2.oct[off + j];
      o = o < 0 ? 0 : (o > n_lvl - 1 ? n_lvl - 1 : o);
      if (!(d2 < 3.84f * sigma2[o])) continue;
      const uint32_t* c = reinterpret_cast<const uint32_t*>(s2.desc + 32 * (off + j));
      int dist = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) dist += __popc(d1[k] ^ c[k]);
      const int kk = dist * N2 + j;
      key = kk < key ? kk : key;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int other = __shfl_xor_sync(0xffffffffu, key, o);
    key = other < key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) key = s_key[w] < key ? s_key[w] : key;
    const bool none = key == 0x7fffffff;
    const int best = none ? kInf : key / N2;
    const int idx = none ? 0 : key % N2;
    const size_t r = (size_t)b * N1 + i1;
    best_out[2 * r] = best;
    best_out[2 * r + 1] = idx;
    if (best <= kThLow) atomicMin(winner + (size_t)b * N2 + idx, best * N1 + i1);
  }
}

__global__ void __launch_bounds__(256)
finalize_kernel(const Side1 s1, const Side2 s2, const float* __restrict__ sigma2, int n_lvl,
                const int* __restrict__ best_in, const int* __restrict__ winner, bool with_geom,
                const Geom g, int* __restrict__ m12, float* __restrict__ X_out,
                bool* __restrict__ ok_out) {
  const int N1 = s1.N1, N2 = s2.N2;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)s2.B * N1) return;
  const int b = (int)(r / N1), i1 = (int)(r % N1);
  const int best = best_in[2 * r], idx = best_in[2 * r + 1];
  const bool accept = best <= kThLow;
  const bool fin = accept && winner[(size_t)b * N2 + idx] == best * N1 + i1;
  const int m = fin ? idx : -1;
  m12[r] = m;
  if (!with_geom) return;
  const int j = m < 0 ? 0 : (m > N2 - 1 ? N2 - 1 : m);
  const size_t cj = (size_t)b * N2 + j;
  const float x1u = s1.xy[2 * i1], x1v = s1.xy[2 * i1 + 1];
  const float x2u = s2.xy[2 * cj], x2v = s2.xy[2 * cj + 1];
  const float* P1 = g.P1;
  const float* P2 = g.P2 + 12 * b;
  float A[4][4];
  for (int c = 0; c < 4; ++c) {
    A[0][c] = x1u * P1[8 + c] - P1[c];
    A[1][c] = x1v * P1[8 + c] - P1[4 + c];
    A[2][c] = x2u * P2[8 + c] - P2[c];
    A[3][c] = x2v * P2[8 + c] - P2[4 + c];
  }
  float M[3][3], bb[3];
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) {
      float s = A[0][a] * A[0][c];
      for (int k = 1; k < 4; ++k) s = s + A[k][a] * A[k][c];
      M[a][c] = s;
    }
    float s = A[0][a] * A[0][3];
    for (int k = 1; k < 4; ++k) s = s + A[k][a] * A[k][3];
    bb[a] = -s;
  }
  const float c00 = M[1][1] * M[2][2] - M[1][2] * M[2][1];
  const float c01 = M[1][2] * M[2][0] - M[1][0] * M[2][2];
  const float c02 = M[1][0] * M[2][1] - M[1][1] * M[2][0];
  const float det = M[0][0] * c00 + M[0][1] * c01 + M[0][2] * c02;
  const float c10 = M[0][2] * M[2][1] - M[0][1] * M[2][2];
  const float c11 = M[0][0] * M[2][2] - M[0][2] * M[2][0];
  const float c12 = M[0][1] * M[2][0] - M[0][0] * M[2][1];
  const float c20 = M[0][1] * M[1][2] - M[0][2] * M[1][1];
  const float c21 = M[0][2] * M[1][0] - M[0][0] * M[1][2];
  const float c22 = M[0][0] * M[1][1] - M[0][1] * M[1][0];
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  float X[3];
  X[0] = (c00 * bb[0] + c10 * bb[1] + c20 * bb[2]) * inv_det;
  X[1] = (c01 * bb[0] + c11 * bb[1] + c21 * bb[2]) * inv_det;
  X[2] = (c02 * bb[0] + c12 * bb[1] + c22 * bb[2]) * inv_det;
  for (int k = 0; k < 3; ++k) X_out[3 * r + k] = X[k];

  const float* O2 = g.O2 + 3 * b;
  const float r10 = X[0] - g.O1[0], r11 = X[1] - g.O1[1], r12 = X[2] - g.O1[2];
  const float r20 = X[0] - O2[0], r21 = X[1] - O2[1], r22 = X[2] - O2[2];
  const float n1 = sqrtf(r10 * r10 + r11 * r11 + r12 * r12);
  const float n2 = sqrtf(r20 * r20 + r21 * r21 + r22 * r22);
  const float cos_par = (r10 * r20 + r11 * r21 + r12 * r22) / fmaxf(n1 * n2, 1e-12f);
  const float* R2 = g.R2 + 9 * b;
  const float* t2 = g.t2 + 3 * b;
  float pc1[3], pc2[3];
  for (int i = 0; i < 3; ++i) {
    pc1[i] = X[0] * g.R1[3 * i] + X[1] * g.R1[3 * i + 1] + X[2] * g.R1[3 * i + 2] + g.t1[i];
    pc2[i] = X[0] * R2[3 * i] + X[1] * R2[3 * i + 1] + X[2] * R2[3 * i + 2] + t2[i];
  }
  bool ok = m >= 0 && pc1[2] > 0.f && pc2[2] > 0.f && cos_par < 0.9998f;
  auto clampl = [&](int o) { return o < 0 ? 0 : (o > n_lvl - 1 ? n_lvl - 1 : o); };
  const int o1 = clampl(s1.oct[i1]), o2 = clampl(s2.oct[cj]);
  {
    const float zz = fmaxf(pc1[2], 1e-9f);
    const float u = g.fx * pc1[0] / zz + g.cx, v = g.fy * pc1[1] / zz + g.cy;
    const float du = u - x1u, dv = v - x1v;
    ok = ok && (du * du + dv * dv <= 5.991f * sigma2[o1]);
  }
  {
    const float zz = fmaxf(pc2[2], 1e-9f);
    const float u = g.fx * pc2[0] / zz + g.cx, v = g.fy * pc2[1] / zz + g.cy;
    const float du = u - x2u, dv = v - x2v;
    ok = ok && (du * du + dv * dv <= 5.991f * sigma2[o2]);
  }
  const float ratio_dist = n2 / fmaxf(n1, 1e-12f);
  const float ratio_oct = g.sf[o1] / g.sf[o2];
  ok = ok && (ratio_dist < ratio_oct * g.factor) && (ratio_dist * g.factor > ratio_oct);
  ok_out[r] = ok;
}

}  // namespace

// desc1 (N1,32) u8, xy1 (N1,2), oct1 (N1,) i32, free1 (N1,) bool; the same for
// the B neighbours (B,N2,...); F12 (B,3,3); sigma2 (n_lvl,).  ws holds
// 2*B*N1 + B*N2 ints.  geom_f: P1 (12), R1 (9), t1 (3), O1 (3), sf (n_lvl) as
// one f32 array (null without geometry); geom_b: P2 (B,12), R2 (B,9),
// t2 (B,3), O2 (B,3) as one f32 array.
extern "C" int tri_search_launch(const void* desc1, const void* xy1, const void* oct1,
                                 const void* free1, int N1, const void* desc2, const void* xy2,
                                 const void* oct2, const void* free2, int N2, int B,
                                 const void* F12, const void* sigma2, int n_lvl,
                                 const void* geom_f, const void* geom_b, float fx, float fy,
                                 float cx, float cy, float factor, void* ws, void* m12, void* X,
                                 void* ok, void* stream) {
  if (N1 <= 0 || N2 <= 0 || B <= 0 || B > 65535 || n_lvl <= 0) return (int)cudaErrorInvalidValue;
  if (257LL * N2 >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // dist * N2 + j fits
  cudaStream_t st = (cudaStream_t)stream;
  int* best = static_cast<int*>(ws);
  int* winner = best + 2 * (size_t)B * N1;
  cudaError_t e = cudaMemsetAsync(winner, 0x7f, sizeof(int) * (size_t)B * N2, st);
  if (e != cudaSuccess) return (int)e;
  const Side1 s1{(const uint8_t*)desc1, (const float*)xy1, (const int*)oct1, (const bool*)free1, N1};
  const Side2 s2{(const uint8_t*)desc2, (const float*)xy2, (const int*)oct2, (const bool*)free2,
                 (const float*)F12, N2, B};
  search_kernel<<<dim3(N1, B), kThreads, 0, st>>>(s1, s2, (const float*)sigma2, n_lvl, best, winner);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  Geom g{};
  const bool with_geom = geom_f != nullptr;
  if (with_geom) {
    const float* f = (const float*)geom_f;
    const float* gb = (const float*)geom_b;
    g.P1 = f;
    g.R1 = f + 12;
    g.t1 = f + 21;
    g.O1 = f + 24;
    g.sf = f + 27;
    g.P2 = gb;
    g.R2 = gb + 12 * (size_t)B;
    g.t2 = gb + 21 * (size_t)B;
    g.O2 = gb + 24 * (size_t)B;
    g.fx = fx;
    g.fy = fy;
    g.cx = cx;
    g.cy = cy;
    g.factor = factor;
  }
  const long long rows = (long long)B * N1;
  finalize_kernel<<<(int)((rows + 255) / 256), 256, 0, st>>>(
      s1, s2, (const float*)sigma2, n_lvl, best, winner, with_geom, g, (int*)m12, (float*)X,
      (bool*)ok);
  return (int)cudaGetLastError();
}
