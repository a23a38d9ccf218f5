// K26 stereo_fisheye: the fisheye rig's stereo match and its triangulation,
// two kernels.
//
// Replaces extractorb_tpu/frontend/stereo.py:compute_stereo_fisheye_matches
// (Frame::ComputeStereoFishEyeMatches, Frame.cc:1139) with the lapping gate
// of :170 lapping_mask, and extractorb_tpu/core/camera.py:triangulate_matches
// (KannalaBrandt8::TriangulateMatches).  The TPU builds the dense (NL, NR)
// distance matrix as a bit-plane MXU product, masks it with lap_l x lap_r and
// takes min / argmin / the second minimum; it then triangulates every row as
// one batched float32 (N,4,4) SVD.
//
// (a) match_kernel: a warp per left keypoint, eight per CTA.  The CTA stages
//     the right descriptors through shared memory in tiles of 256, word-major
//     (lanes read consecutive columns: no bank conflicts), with their lapping
//     flags; each lane XORs and popcounts the columns lane, lane + 32, ... of
//     a tile under the lap_l[i] & lap_r[j] gate and keeps the two smallest
//     keys (distance << 22 | column).  Keys are unique, so the shuffle merge
//     of the lanes' top-2 gives the first index of the minimum (jnp.argmin)
//     and the minimum with only that column removed (the JAX one-hot mask:
//     two equal best distances fail the ratio test).  A row with no column in
//     the gate reports distance 1<<20 and index 0, as the all-masked rows of
//     the JAX matrix do.  The candidate test is best < TH_ORB and
//     float(best) < ratio * float(second), in float32.
// (b) triangulate_kernel: a thread per left keypoint whose candidate passed
//     (the other rows get p3d 0, depth -1, not valid): both bearings by
//     CamKB8::unproject (camera_t.cuh), the right one rotated into the left
//     camera for the parallax gate, the four DLT rows against the unit
//     bearings in float32, and the homogeneous point as the eigenvector of
//     the smallest eigenvalue of the 4x4 A^T A by float64 Jacobi
//     (small_linalg.cuh) in place of the SVD's last right singular vector;
//     then depths along both bearings, the chi2 gates through both cameras
//     (CamKB8::project), and p3d, depth (p3d's z) and the valid mask.
//
// The integer outputs (best, second, their column, the candidate mask) are
// exact.  The plain version solves the same float32 rows by a float64 SVD
// (core/camera.py:triangulation_terms), so the two points differ by the
// eigensolvers' rounding; a match sitting on a gate can still flip
// (core/camera.py:triangulation_gate_margin measures how close it sits).
//
// Bound on the H100: integer operations of the search.  At NL = NR = 1628
// slots (1500 features) that is 2.65M pairs of 8 XOR + 8 popcount + adds,
// ~0.7 us at the card's peak; the triangulation is ~3k float64 operations a
// candidate.  The kernel is launch- and latency-bound at this size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 256;
constexpr unsigned kIdxBits = 22;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kInf = 1 << 20;
constexpr int kMaxLevels = 32;

#include "dual.cuh"
#include "camera_t.cuh"
#include "small_linalg.cuh"  // jacobi_eig

__device__ __forceinline__ void insert(unsigned key, unsigned& k1, unsigned& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
match_kernel(const uint32_t* __restrict__ desc_l, const bool* __restrict__ lap_l, int NL,
             const uint32_t* __restrict__ desc_r, const bool* __restrict__ lap_r, int NR,
             int th_orb, float ratio, int* __restrict__ best_idx, int* __restrict__ best,
             int* __restrict__ second, bool* __restrict__ cand) {
  __shared__ uint32_t words[8][kTile];
  __shared__ bool lap[kTile];
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const bool live = row < NL && lap_l[row];
  uint32_t a[8];
  for (int w = 0; w < 8; ++w) a[w] = live ? desc_l[8 * row + w] : 0u;
  unsigned k1 = kNone, k2 = kNone;
  for (int base = 0; base < NR; base += kTile) {
    const int n = min(kTile, NR - base);
    __syncthreads();
    for (int e = threadIdx.x; e < 8 * kTile; e += kWarps * 32) {
      const int c = e >> 3, w = e & 7;  // consecutive threads read one descriptor's words
      if (c < n) words[w][c] = desc_r[8 * (base + c) + w];
    }
    for (int c = threadIdx.x; c < kTile; c += kWarps * 32) lap[c] = c < n && lap_r[base + c];
    __syncthreads();
    if (!live) continue;
    for (int c = lane; c < n; c += 32) {
      if (!lap[c]) continue;
      unsigned d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ words[w][c]);
      insert((d << kIdxBits) | (unsigned)(base + c), k1, k2);
    }
  }
  if (row >= NL) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    // top-2 of the union of two sorted pairs of distinct keys
    const unsigned n1 = min(k1, o1);
    const unsigned n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
  if (lane == 0) {
    const int b = k1 == kNone ? kInf : (int)(k1 >> kIdxBits);
    const int s = k2 == kNone ? kInf : (int)(k2 >> kIdxBits);
    best[row] = b;
    second[row] = s;
    best_idx[row] = k1 == kNone ? 0 : (int)(k1 & ((1u << kIdxBits) - 1u));
    cand[row] = b < th_orb && (float)b < ratio * (float)s;
  }
}

// the triangulation's constants: both cameras, the rig, the gates and the
// per-octave variances
struct TriPrm {
  CamKB8 cam_l, cam_r;
  float R[9], t[3];  // p_right = R p_left + t
  float min_cos, chi2;
  float sigma2[kMaxLevels];
  int n_lvl;
};

__device__ __forceinline__ float level_sigma2(const TriPrm& q, const int* oct, int i) {
  return q.sigma2[min(max(oct[i], 0), q.n_lvl - 1)];
}

__global__ void triangulate_kernel(const float* __restrict__ uv_l, const float* __restrict__ uv_r,
                                   const int* __restrict__ idx, const bool* __restrict__ cand,
                                   const int* __restrict__ oct_l, const int* __restrict__ oct_r,
                                   int N, const TriPrm q, float* __restrict__ p3d_out,
                                   float* __restrict__ depth_out, bool* __restrict__ valid_out,
                                   int* __restrict__ right_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int j = idx[i];
  float p[3] = {0.f, 0.f, 0.f};
  bool ok = false;
  if (cand[i]) {
    const float ul = uv_l[2 * i], vl = uv_l[2 * i + 1];
    const float ur = uv_r[2 * j], vr = uv_r[2 * j + 1];
    float b1[3], b2[3], b2l[3];
    q.cam_l.unproject(ul, vl, b1);
    q.cam_r.unproject(ur, vr, b2);
    for (int k = 0; k < 3; ++k) b2l[k] = b2[0] * q.R[k] + b2[1] * q.R[3 + k] + b2[2] * q.R[6 + k];
    const float cos_par = b1[0] * b2l[0] + b1[1] * b2l[1] + b1[2] * b2l[2];
    // DLT rows b x (P p) = 0: b_z P_0 - b_x P_2 and b_z P_1 - b_y P_2, with
    // P1 = [I | 0] and P2 = [R | t], in float32 as the JAX rows
    float A[4][4] = {{b1[2], 0.f, -b1[0], 0.f}, {0.f, b1[2], -b1[1], 0.f}};
    for (int r = 0; r < 2; ++r) {
      const float* Pr = r == 0 ? q.R : q.R + 3;
      const float tr = q.t[r];
      const float br = b2[r];
      for (int k = 0; k < 3; ++k) A[2 + r][k] = b2[2] * Pr[k] - br * q.R[6 + k];
      A[2 + r][3] = b2[2] * tr - br * q.t[2];
    }
    double AtA[16], V[16];
    for (int r = 0; r < 4; ++r)
      for (int s = 0; s < 4; ++s) {
        double acc = 0.0;
        for (int k = 0; k < 4; ++k) acc += (double)A[k][r] * (double)A[k][s];
        AtA[4 * r + s] = acc;
      }
    jacobi_eig<4>(AtA, V);
    int m = 0;
    for (int k = 1; k < 4; ++k)
      if (AtA[5 * k] < AtA[5 * m]) m = k;
    const double w = V[12 + m];
    const double safe_w = fabs(w) < 1e-12 ? 1.0 : w;
    for (int k = 0; k < 3; ++k) p[k] = (float)(V[4 * k + m] / safe_w);
    const float z1 = p[0] * b1[0] + p[1] * b1[1] + p[2] * b1[2];
    float pr[3];
    for (int k = 0; k < 3; ++k)
      pr[k] = p[0] * q.R[3 * k] + p[1] * q.R[3 * k + 1] + p[2] * q.R[3 * k + 2] + q.t[k];
    const float z2 = pr[0] * b2[0] + pr[1] * b2[1] + pr[2] * b2[2];
    float u1, v1, u2, v2;
    q.cam_l.project(p[0], p[1], p[2], u1, v1);
    q.cam_r.project(pr[0], pr[1], pr[2], u2, v2);
    const float e1 = (u1 - ul) * (u1 - ul) + (v1 - vl) * (v1 - vl);
    const float e2 = (u2 - ur) * (u2 - ur) + (v2 - vr) * (v2 - vr);
    ok = cos_par < q.min_cos && z1 > 0.f && z2 > 0.f && fabs(w) > 1e-12 &&
         e1 <= q.chi2 * level_sigma2(q, oct_l, i) && e2 <= q.chi2 * level_sigma2(q, oct_r, j);
  }
  for (int k = 0; k < 3; ++k) p3d_out[3 * i + k] = p[k];
  depth_out[i] = ok ? p[2] : -1.f;
  valid_out[i] = ok;
  right_idx[i] = ok ? j : -1;
}

}  // namespace

// (a): desc_l (NL,32) / desc_r (NR,32) uint8 (4-byte aligned), lap_l (NL,),
// lap_r (NR,) bool; out best_idx, best, second (NL,) int32, cand (NL,) bool
extern "C" int stereo_fisheye_match_launch(const void* desc_l, const void* lap_l, int NL,
                                           const void* desc_r, const void* lap_r, int NR,
                                           int th_orb, float ratio, void* best_idx, void* best,
                                           void* second, void* cand, void* stream) {
  if (NL < 0 || NR < 1 || NR >= (1 << kIdxBits)) return (int)cudaErrorInvalidValue;
  if (NL == 0) return (int)cudaGetLastError();
  match_kernel<<<(NL + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)desc_l, (const bool*)lap_l, NL, (const uint32_t*)desc_r,
      (const bool*)lap_r, NR, th_orb, ratio, (int*)best_idx, (int*)best, (int*)second,
      (bool*)cand);
  return (int)cudaGetLastError();
}

// (b): uv_l (N,2), uv_r (NR,2) float32; idx (N,) int32; cand (N,) bool;
// oct_l (N,) / oct_r (NR,) int32 indexing the host table prm's variances;
// prm (host, float32): cam_l fx fy cx cy k1-k4, cam_r the same, R_rl 9,
// t_rl 3, min_cos, chi2, then n_lvl variances; out p3d (N,3), depth (N,),
// valid (N,), right_idx (N,)
extern "C" int fisheye_triangulate_launch(const void* uv_l, const void* uv_r, const void* idx,
                                          const void* cand, const void* oct_l, const void* oct_r,
                                          int N, const float* prm, int n_lvl, void* p3d,
                                          void* depth, void* valid, void* right_idx,
                                          void* stream) {
  if (N < 0 || n_lvl < 1 || n_lvl > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  TriPrm q;
  q.cam_l = CamKB8{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6], prm[7]};
  q.cam_r = CamKB8{prm[8], prm[9], prm[10], prm[11], prm[12], prm[13], prm[14], prm[15]};
  for (int k = 0; k < 9; ++k) q.R[k] = prm[16 + k];
  for (int k = 0; k < 3; ++k) q.t[k] = prm[25 + k];
  q.min_cos = prm[28];
  q.chi2 = prm[29];
  for (int k = 0; k < kMaxLevels; ++k) q.sigma2[k] = k < n_lvl ? prm[30 + k] : 0.f;
  q.n_lvl = n_lvl;
  triangulate_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)uv_l, (const float*)uv_r, (const int*)idx, (const bool*)cand,
      (const int*)oct_l, (const int*)oct_r, N, q,
      (float*)p3d, (float*)depth, (bool*)valid, (int*)right_idx);
  return (int)cudaGetLastError();
}
