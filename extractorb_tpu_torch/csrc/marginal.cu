// K36 marginal: the dense Hessian-block toolbox of the inertial optimizers --
// condition, marginalize and sparsify of an information matrix H (n x n).
//
// Replaces extractorb_tpu/solver/marginal.py (:23 marginalize, :52
// condition, :63 sparsify), which the TPU runs as index gathers, one
// jnp.linalg.svd pseudo-inverse and two matmuls per marginalisation.  One
// CTA runs the whole call:
//   condition:   a masked copy (the block's rows and columns zero); bit-equal;
//   marginalize: thread 0 takes the block's pseudo-inverse from a float64
//                cyclic Jacobi eigen-solve (small_linalg.cuh, K22's, the
//                block zero-padded to 15: padded entries are never rotated,
//                so the block's rotations are those of its own size), keeping
//                |lambda| > 1e-6 -- exactly the singular values JAX's SVD
//                keeps, the block being symmetric (it is symmetrised first);
//                then T = pinv Hba over the CTA and
//                H'_ij = H_ij - H_i,blk T_j (float64 sums) on the kept rows
//                and columns, zero on the block's;
//   sparsify:    its three marginalisations in order (marg(H, 2), marg(H, 1),
//                marg(marg(H, 2), 1)) through the workspace, then
//                (Hac + Hbc) - Hc, in one launch.
// Blocks are at most 15 wide (the inertial states); wider blocks are refused.
//
// Bound on the H100: latency.  n <= 45 here: a few thousand operations and
// one Jacobi of at most 15 x 15 on one thread (~30 sweeps), then n^2 b
// multiply-adds over the CTA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlock = 15;

#include "small_linalg.cuh"  // jacobi_eig

struct MWs {
  float* Hac;    // (n, n) marg(H, block 2)
  float* Hbc;    // (n, n) marg(H, block 1)
  float* Hc;     // (n, n) marg(Hac, block 1)
  double* Pi;    // (15, 15) the block's pseudo-inverse
  double* T;     // (15, n) Pi H[blk, :]
};

inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

size_t carve_m(MWs* w, uint8_t* base, int n) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  uint8_t* q;
  q = take(sizeof(float) * (size_t)n * n); if (w) w->Hac = (float*)q;
  q = take(sizeof(float) * (size_t)n * n); if (w) w->Hbc = (float*)q;
  q = take(sizeof(float) * (size_t)n * n); if (w) w->Hc = (float*)q;
  q = take(sizeof(double) * kMaxBlock * kMaxBlock); if (w) w->Pi = (double*)q;
  q = take(sizeof(double) * kMaxBlock * (size_t)n); if (w) w->T = (double*)q;
  return o;
}

// out = marg(H, [a..e]) by the whole CTA; H and out in global memory (they
// may not alias)
__device__ void marg_cta(const float* H, int n, int a, int e, float* out, const MWs& w) {
  const int b = e - a + 1;
  if (threadIdx.x == 0) {
    double E[kMaxBlock * kMaxBlock], V[kMaxBlock * kMaxBlock];
    for (int i = 0; i < kMaxBlock * kMaxBlock; ++i) E[i] = 0.0;
    for (int i = 0; i < b; ++i)
      for (int j = 0; j < b; ++j)
        E[kMaxBlock * i + j] = 0.5 * ((double)H[(size_t)(a + i) * n + a + j] +
                                      (double)H[(size_t)(a + j) * n + a + i]);
    jacobi_eig<kMaxBlock>(E, V);
    double f[kMaxBlock];
    for (int k = 0; k < b; ++k) {
      const double lv = E[(kMaxBlock + 1) * k];
      f[k] = fabs(lv) > 1e-6 ? 1.0 / lv : 0.0;
    }
    for (int r = 0; r < b; ++r)
      for (int c = 0; c < b; ++c) {
        double s = 0.0;
        for (int k = 0; k < b; ++k) s += V[kMaxBlock * r + k] * f[k] * V[kMaxBlock * c + k];
        w.Pi[kMaxBlock * r + c] = s;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < b * n; i += blockDim.x) {   // T = Pi H[blk, :]
    const int k = i / n, j = i % n;
    double s = 0.0;
    for (int l = 0; l < b; ++l) s += w.Pi[kMaxBlock * k + l] * (double)H[(size_t)(a + l) * n + j];
    w.T[(size_t)k * n + j] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i % n;
    float v = 0.f;
    if ((r < a || r > e) && (c < a || c > e)) {
      double s = 0.0;
      for (int k = 0; k < b; ++k) s += (double)H[(size_t)r * n + a + k] * w.T[(size_t)k * n + c];
      v = (float)((double)H[i] - s);
    }
    out[i] = v;
  }
  __syncthreads();
}

// mode 0: condition(H, s1, e1); 1: marginalize(H, s1, e1); 2:
// sparsify(H, s1, e1, s2, e2)
__global__ void __launch_bounds__(kThreads)
marginal_kernel(const float* __restrict__ H, int n, int mode, int s1, int e1, int s2, int e2,
                MWs w, float* __restrict__ out) {
  if (mode == 0) {
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int r = i / n, c = i % n;
      const bool blk = (r >= s1 && r <= e1) || (c >= s1 && c <= e1);
      out[i] = blk ? 0.f : H[i];
    }
    return;
  }
  if (mode == 1) {
    marg_cta(H, n, s1, e1, out, w);
    return;
  }
  marg_cta(H, n, s2, e2, w.Hac, w);
  marg_cta(H, n, s1, e1, w.Hbc, w);
  marg_cta(w.Hac, n, s1, e1, w.Hc, w);
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) out[i] = (w.Hac[i] + w.Hbc[i]) - w.Hc[i];
}

}  // namespace

extern "C" long long marginal_workspace_bytes(int n) { return (long long)carve_m(nullptr, nullptr, n); }

// H, out (n, n) float32 on the card; ws marginal_workspace_bytes(n).  Blocks
// [s, e] inclusive, 0 <= s <= e < n; for modes 1 and 2 at most 15 wide.
extern "C" int marginal_launch(const void* H, int n, int mode, int s1, int e1, int s2, int e2,
                               void* ws, void* out, void* stream) {
  const bool ok1 = 0 <= s1 && s1 <= e1 && e1 < n;
  const bool ok2 = 0 <= s2 && s2 <= e2 && e2 < n;
  if (n <= 0 || mode < 0 || mode > 2 || !ok1 || (mode == 2 && !ok2) ||
      (mode >= 1 && e1 - s1 + 1 > kMaxBlock) || (mode == 2 && e2 - s2 + 1 > kMaxBlock))
    return (int)cudaErrorInvalidValue;
  MWs w;
  carve_m(&w, static_cast<uint8_t*>(ws), n);
  marginal_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((const float*)H, n, mode, s1, e1, s2,
                                                             e2, w, (float*)out);
  return (int)cudaGetLastError();
}
