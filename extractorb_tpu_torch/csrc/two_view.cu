// K5 two_view: monocular two-view initialisation, the whole chain on the card.
//
// Replaces extractorb_tpu/geometry/two_view.py:reconstruct (the TPU runs it as
// one XLA program of vmapped SVDs over 200 hypotheses).  Four launches, no
// host synchronisation between them:
//   1. hyp_kernel, one CTA per minimal set: the 8-point H and F fits (thread 0
//      fits H, thread 32 fits F; each model's null vector is the smallest
//      eigenvector of the 9x9 normal matrix, by cyclic Jacobi in float64; F is
//      projected to rank 2 by dropping its smallest singular direction), then
//      both models are scored over all N pairs by a block reduction.
//   2. refit_kernel, one CTA per model: the best hypothesis (first maximum,
//      as jnp.argmax), its inliers, the weighted 9x9 normal matrix of all
//      inliers (float64 block reduction), the refit model, and the refit kept
//      where it scores higher.
//   3. checkrt_kernel, one CTA per motion hypothesis (8): E = K^T F K or the
//      Faugeras decomposition of H (3x3 SVDs from Jacobi on A^T A), DLT
//      triangulation of every pair with the 3x3 adjugate, cheirality and
//      reprojection gates, and the 51st-smallest parallax cosine by a bitonic
//      sort in shared memory.
//   4. select_kernel: the best motion (first maximum), the acceptance tests,
//      and the copy of the winning points and mask.
// The per-pair float32 arithmetic follows the plain version in
// geometry/two_view.py operation by operation (the build uses -fmad=false).
//
// Bound on the H100: latency.  200 x 1024 pairs of scoring is ~10^6 cheap
// evaluations; the serial float64 Jacobi sweeps of one thread per model and
// the four dependent launches set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 4096;
constexpr float kChi2F = 3.841f;
constexpr float kChi2H = 5.991f;

struct Ws {
  float* H;        // (S,9) minimal-set homographies
  double* SH;      // (S,)
  float* F;        // (S,9)
  double* SF;      // (S,)
  float* model;    // (2,9) final H21, F21
  double* sbest;   // (2,) minimal-set best scores SH, SF
  uint8_t* inl;    // (2,N) final inliers of H, F
  float* Rs;       // (8,9)
  float* ts;       // (8,3)
  int* n_good;     // (8,)
  int* n_inl;      // (8,)
  float* parallax; // (8,)
  uint8_t* good;   // (8,N)
  float* X;        // (8,N,3)
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t carve(Ws* w, uint8_t* base, int S, int N) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base ? base + o : nullptr;
    o += align16(bytes);
    return p;
  };
  uint8_t* p;
  p = take(sizeof(float) * 9 * S);      if (w) w->H = (float*)p;
  p = take(sizeof(double) * S);         if (w) w->SH = (double*)p;
  p = take(sizeof(float) * 9 * S);      if (w) w->F = (float*)p;
  p = take(sizeof(double) * S);         if (w) w->SF = (double*)p;
  p = take(sizeof(float) * 18);         if (w) w->model = (float*)p;
  p = take(sizeof(double) * 2);         if (w) w->sbest = (double*)p;
  p = take((size_t)2 * N);              if (w) w->inl = p;
  p = take(sizeof(float) * 72);         if (w) w->Rs = (float*)p;
  p = take(sizeof(float) * 24);         if (w) w->ts = (float*)p;
  p = take(sizeof(int) * 8);            if (w) w->n_good = (int*)p;
  p = take(sizeof(int) * 8);            if (w) w->n_inl = (int*)p;
  p = take(sizeof(float) * 8);          if (w) w->parallax = (float*)p;
  p = take((size_t)8 * N);              if (w) w->good = p;
  p = take(sizeof(float) * 24 * N);     if (w) w->X = (float*)p;
  return o;
}

struct Pairs {
  const float* xn1;   // (N,2) normalized
  const float* xn2;
  const float* x1;    // (N,2) pixels
  const float* x2;
  const bool* valid;  // (N,)
  int N;
};

// ---------------------------------------------------------------- reductions

__device__ double block_sum_d(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__device__ int block_sum_i(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// --------------------------------------------------------- small dense algebra

#include "small_linalg.cuh"  // jacobi_eig, matmul3, det3, svd3

// smallest eigenvector of a symmetric 9x9 (AtA destroyed)
__device__ void null_vector9(double* AtA, double* v) {
  double V[81];
  jacobi_eig<9>(AtA, V);
  int k = 0;
  for (int i = 1; i < 9; ++i)
    if (AtA[i * 10] < AtA[k * 10]) k = i;
  for (int i = 0; i < 9; ++i) v[i] = V[i * 9 + k];
}

// adjugate inverse, as geometry/two_view.py:_inv3
__device__ void inv3(const double* m, double* out) {
  const double c00 = m[4] * m[8] - m[5] * m[7];
  const double c01 = m[5] * m[6] - m[3] * m[8];
  const double c02 = m[3] * m[7] - m[4] * m[6];
  const double c10 = m[2] * m[7] - m[1] * m[8];
  const double c11 = m[0] * m[8] - m[2] * m[6];
  const double c12 = m[1] * m[6] - m[0] * m[7];
  const double c20 = m[1] * m[5] - m[2] * m[4];
  const double c21 = m[2] * m[3] - m[0] * m[5];
  const double c22 = m[0] * m[4] - m[1] * m[3];
  const double det = m[0] * c00 + m[1] * c01 + m[2] * c02;
  const double adj[9] = {c00, c10, c20, c01, c11, c21, c02, c12, c22};
  for (int i = 0; i < 9; ++i) out[i] = adj[i] / det;
}

__device__ void unit3(double* t) {
  const double n = fmax(sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]), 1e-12);
  for (int i = 0; i < 3; ++i) t[i] /= n;
}

// ------------------------------------------------------------- models

__device__ void rows_h(float au, float av, float bu, float bv, double* r1, double* r2) {
  const double u1 = au, v1 = av, u2 = bu, v2 = bv;
  const double a[9] = {0.0, 0.0, 0.0, -u1, -v1, -1.0, v2 * u1, v2 * v1, v2};
  const double b[9] = {u1, v1, 1.0, 0.0, 0.0, 0.0, -u2 * u1, -u2 * v1, -u2};
  for (int i = 0; i < 9; ++i) { r1[i] = a[i]; r2[i] = b[i]; }
}

__device__ void row_f(float au, float av, float bu, float bv, double* r) {
  const double u1 = au, v1 = av, u2 = bu, v2 = bv;
  const double a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.0};
  for (int i = 0; i < 9; ++i) r[i] = a[i];
}

__device__ void add_outer(double* AtA, const double* r, double w) {
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) AtA[9 * i + j] += w * r[i] * r[j];
}

// H21 = T2inv Hn T1, rounded to float
__device__ void h_model(const double* hn, const float* T1f, const float* T2invf, float* H) {
  double T1[9], T2inv[9], tmp[9], out[9];
  for (int i = 0; i < 9; ++i) { T1[i] = T1f[i]; T2inv[i] = T2invf[i]; }
  matmul3(T2inv, hn, tmp);
  matmul3(tmp, T1, out);
  for (int i = 0; i < 9; ++i) H[i] = (float)out[i];
}

// F21 = T2^T rank2(Fn) T1, rounded to float
__device__ void f_model(const double* fn, const float* T1f, const float* T2f, float* F) {
  double FtF[9], E[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      FtF[3 * i + j] = fn[i] * fn[j] + fn[3 + i] * fn[3 + j] + fn[6 + i] * fn[6 + j];
  jacobi_eig<3>(FtF, E);
  int k = 0;
  for (int i = 1; i < 3; ++i)
    if (FtF[4 * i] < FtF[4 * k]) k = i;
  const double v[3] = {E[k], E[3 + k], E[6 + k]};
  double Fr[9];
  for (int r = 0; r < 3; ++r) {
    const double fv = fn[3 * r] * v[0] + fn[3 * r + 1] * v[1] + fn[3 * r + 2] * v[2];
    for (int c = 0; c < 3; ++c) Fr[3 * r + c] = fn[3 * r + c] - fv * v[c];
  }
  double T1[9], T2t[9], tmp[9], out[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) { T1[3 * i + j] = T1f[3 * i + j]; T2t[3 * i + j] = T2f[3 * j + i]; }
  matmul3(T2t, Fr, tmp);
  matmul3(tmp, T1, out);
  for (int i = 0; i < 9; ++i) F[i] = (float)out[i];
}

__device__ void h_inverse_f(const float* H, float* Hi) {
  double m[9], o[9];
  for (int i = 0; i < 9; ++i) m[i] = H[i];
  inv3(m, o);
  for (int i = 0; i < 9; ++i) Hi[i] = (float)o[i];
}

__device__ float transfer(const float* H, float a0, float a1, float b0, float b1) {
  const float w = H[6] * a0 + H[7] * a1 + H[8];
  const float inv_w = 1.0f / w;
  const float u = (H[0] * a0 + H[1] * a1 + H[2]) * inv_w;
  const float v = (H[3] * a0 + H[4] * a1 + H[5]) * inv_w;
  const float du = b0 - u, dv = b1 - v;
  return du * du + dv * dv;
}

// one pair's score terms for a homography (H21 and its inverse H12)
__device__ float score_h_pair(const float* H21, const float* H12, const Pairs& P, int i, bool* inl) {
  const float x1u = P.x1[2 * i], x1v = P.x1[2 * i + 1], x2u = P.x2[2 * i], x2v = P.x2[2 * i + 1];
  const float chi1 = transfer(H12, x2u, x2v, x1u, x1v);
  const float chi2 = transfer(H21, x1u, x1v, x2u, x2v);
  const bool ok = P.valid[i], in1 = chi1 <= kChi2H, in2 = chi2 <= kChi2H;
  *inl = ok && in1 && in2;
  const float s1 = (ok && in1) ? kChi2H - chi1 : 0.0f;
  const float s2 = (ok && in2) ? kChi2H - chi2 : 0.0f;
  return s1 + s2;
}

__device__ float score_f_pair(const float* F, const Pairs& P, int i, bool* inl) {
  const float x1u = P.x1[2 * i], x1v = P.x1[2 * i + 1], x2u = P.x2[2 * i], x2v = P.x2[2 * i + 1];
  float l2[3], l1[3];
  for (int k = 0; k < 3; ++k) {
    l2[k] = F[3 * k] * x1u + F[3 * k + 1] * x1v + F[3 * k + 2];
    l1[k] = x2u * F[k] + x2v * F[3 + k] + F[6 + k];
  }
  const float num2 = l2[0] * x2u + l2[1] * x2v + l2[2];
  const float num1 = l1[0] * x1u + l1[1] * x1v + l1[2];
  const float chi1 = num2 * num2 / (l2[0] * l2[0] + l2[1] * l2[1] + 1e-12f);
  const float chi2 = num1 * num1 / (l1[0] * l1[0] + l1[1] * l1[1] + 1e-12f);
  const bool ok = P.valid[i], in1 = chi1 <= kChi2F, in2 = chi2 <= kChi2F;
  *inl = ok && in1 && in2;
  const float s1 = (ok && in1) ? kChi2H - chi1 : 0.0f;
  const float s2 = (ok && in2) ? kChi2H - chi2 : 0.0f;
  return s1 + s2;
}

// ------------------------------------------------------------- kernels

__global__ void __launch_bounds__(kThreads)
hyp_kernel(const Pairs P, const int* __restrict__ sets, const float* __restrict__ mats, Ws w) {
  __shared__ float s_H[9], s_Hi[9], s_F[9];
  __shared__ double s_red[kThreads / 32];
  const int h = blockIdx.x;
  const float* T1 = mats;
  const float* T2 = mats + 9;
  const float* T2inv = mats + 18;
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    double AtA[81];
    for (int i = 0; i < 81; ++i) AtA[i] = 0.0;
    for (int k = 0; k < 8; ++k) {
      const int i = sets[8 * h + k];
      const float au = P.xn1[2 * i], av = P.xn1[2 * i + 1];
      const float bu = P.xn2[2 * i], bv = P.xn2[2 * i + 1];
      if (threadIdx.x == 0) {
        double r1[9], r2[9];
        rows_h(au, av, bu, bv, r1, r2);
        add_outer(AtA, r1, 1.0);
        add_outer(AtA, r2, 1.0);
      } else {
        double r[9];
        row_f(au, av, bu, bv, r);
        add_outer(AtA, r, 1.0);
      }
    }
    double v[9];
    null_vector9(AtA, v);
    if (threadIdx.x == 0) {
      h_model(v, T1, T2inv, s_H);
      h_inverse_f(s_H, s_Hi);
    } else {
      f_model(v, T1, T2, s_F);
    }
  }
  __syncthreads();
  double sh = 0.0, sf = 0.0;
  bool dummy;
  for (int i = threadIdx.x; i < P.N; i += kThreads) {
    sh += score_h_pair(s_H, s_Hi, P, i, &dummy);
    sf += score_f_pair(s_F, P, i, &dummy);
  }
  sh = block_sum_d(sh, s_red);
  sf = block_sum_d(sf, s_red);
  if (threadIdx.x < 9) {
    w.H[9 * h + threadIdx.x] = s_H[threadIdx.x];
    w.F[9 * h + threadIdx.x] = s_F[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    w.SH[h] = sh;
    w.SF[h] = sf;
  }
}

// block 0 refits H, block 1 refits F
__global__ void __launch_bounds__(kThreads)
refit_kernel(const Pairs P, int S, const float* __restrict__ mats, Ws w) {
  __shared__ float s_M[9], s_Mi[9], s_R[9], s_Ri[9];
  __shared__ double s_best, s_red[kThreads / 32], s_acc[45];
  const bool is_h = blockIdx.x == 0;
  const double* scores = is_h ? w.SH : w.SF;
  const float* models = is_h ? w.H : w.F;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int i = 1; i < S; ++i)
      if (scores[i] > scores[b]) b = i;
    s_best = scores[b];
    for (int k = 0; k < 9; ++k) s_M[k] = models[9 * b + k];
    if (is_h) h_inverse_f(s_M, s_Mi);
  }
  __syncthreads();
  // weighted normal matrix of the inliers (upper triangle, 45 sums)
  double acc[45];
  for (int k = 0; k < 45; ++k) acc[k] = 0.0;
  uint8_t* inl_out = w.inl + (is_h ? 0 : P.N);
  for (int i = threadIdx.x; i < P.N; i += kThreads) {
    bool in;
    if (is_h) score_h_pair(s_M, s_Mi, P, i, &in);
    else score_f_pair(s_M, P, i, &in);
    inl_out[i] = in;
    if (!in) continue;
    const float au = P.xn1[2 * i], av = P.xn1[2 * i + 1];
    const float bu = P.xn2[2 * i], bv = P.xn2[2 * i + 1];
    double r1[9], r2[9];
    if (is_h) rows_h(au, av, bu, bv, r1, r2);
    else row_f(au, av, bu, bv, r1);
    int k = 0;
    for (int a = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b) {
        acc[k] += r1[a] * r1[b] + (is_h ? r2[a] * r2[b] : 0.0);
        ++k;
      }
  }
  for (int k = 0; k < 45; ++k) {
    const double s = block_sum_d(acc[k], s_red);
    if (threadIdx.x == 0) s_acc[k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double AtA[81], v[9];
    int k = 0;
    for (int a = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b) {
        AtA[9 * a + b] = s_acc[k];
        AtA[9 * b + a] = s_acc[k];
        ++k;
      }
    null_vector9(AtA, v);
    if (is_h) {
      h_model(v, mats, mats + 18, s_R);
      h_inverse_f(s_R, s_Ri);
    } else {
      f_model(v, mats, mats + 9, s_R);
    }
  }
  __syncthreads();
  double s2 = 0.0;
  for (int i = threadIdx.x; i < P.N; i += kThreads) {
    bool in;
    s2 += is_h ? score_h_pair(s_R, s_Ri, P, i, &in) : score_f_pair(s_R, P, i, &in);
  }
  s2 = block_sum_d(s2, s_red);
  const bool better = s2 > s_best;  // identical in every thread
  if (better) {
    for (int i = threadIdx.x; i < P.N; i += kThreads) {
      bool in;
      if (is_h) score_h_pair(s_R, s_Ri, P, i, &in);
      else score_f_pair(s_R, P, i, &in);
      inl_out[i] = in;
    }
  }
  if (threadIdx.x < 9) w.model[(is_h ? 0 : 9) + threadIdx.x] = better ? s_R[threadIdx.x] : s_M[threadIdx.x];
  if (threadIdx.x == 0) w.sbest[is_h ? 0 : 1] = s_best;
}

__device__ bool use_homography(const Ws& w) {
  const double SH = w.sbest[0], SF = w.sbest[1];
  return (float)(SH / fmax(SH + SF, 1e-9)) > 0.40f;
}

// motion hypothesis j of the chosen model (float64), as _decompose_e/_decompose_h
__device__ void motion(const Ws& w, bool use_h, int j, const float* Kf, double* R, double* t) {
  const double K[9] = {Kf[0], 0.0, Kf[2], 0.0, Kf[1], Kf[3], 0.0, 0.0, 1.0};
  double U[9], s[3], V[9];
  if (!use_h) {
    double F[9], Kt[9], tmp[9], E[9];
    for (int i = 0; i < 9; ++i) F[i] = w.model[9 + i];
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < 3; ++c) Kt[3 * i + c] = K[3 * c + i];
    matmul3(Kt, F, tmp);
    matmul3(tmp, K, E);
    svd3(E, U, s, V);
    double tt[3] = {U[2], U[5], U[8]};
    unit3(tt);
    const int jj = j & 3;
    const double Wm[9] = {0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0};
    double Wu[9], Vt[9], tmp2[9];
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < 3; ++c) {
        Wu[3 * i + c] = jj < 2 ? Wm[3 * i + c] : Wm[3 * c + i];
        Vt[3 * i + c] = V[3 * c + i];
      }
    matmul3(U, Wu, tmp2);
    matmul3(tmp2, Vt, R);
    if (det3(R) < 0.0)
      for (int i = 0; i < 9; ++i) R[i] = -R[i];
    const double sg = (jj & 1) ? -1.0 : 1.0;
    for (int i = 0; i < 3; ++i) t[i] = sg * tt[i];
    return;
  }
  double Hd[9], Ki[9], tmp[9], A[9];
  for (int i = 0; i < 9; ++i) Hd[i] = w.model[i];
  inv3(K, Ki);
  matmul3(Ki, Hd, tmp);
  matmul3(tmp, K, A);
  svd3(A, U, s, V);
  double Vt[9];
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) Vt[3 * i + c] = V[3 * c + i];
  const double sdet = det3(U) * det3(V);
  const double d1 = s[0], d2 = s[1], d3 = s[2];
  const double aux1 = sqrt(fmax((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0));
  const double aux3 = sqrt(fmax((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0));
  const double sg1[4] = {1.0, 1.0, -1.0, -1.0};
  const double sg3[4] = {1.0, -1.0, 1.0, -1.0};
  const double sgs[4] = {1.0, -1.0, -1.0, 1.0};
  const double root = sqrt(fmax((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0));
  const int i = j & 3;
  double Rp[9], tp[3];
  if (j < 4) {
    const double st = root / ((d1 + d3) * d2);
    const double ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2);
    const double r[9] = {ct, 0.0, -sgs[i] * st, 0.0, 1.0, 0.0, sgs[i] * st, 0.0, ct};
    for (int k = 0; k < 9; ++k) Rp[k] = r[k];
    tp[0] = sg1[i] * aux1;
    tp[1] = 0.0;
    tp[2] = -sg3[i] * aux3;
  } else {
    const double sp = root / ((d1 - d3) * d2);
    const double cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2);
    const double r[9] = {cp, 0.0, sgs[i] * sp, 0.0, -1.0, 0.0, sgs[i] * sp, 0.0, -cp};
    for (int k = 0; k < 9; ++k) Rp[k] = r[k];
    tp[0] = sg1[i] * aux1;
    tp[1] = 0.0;
    tp[2] = sg3[i] * aux3;
  }
  double sU[9], tmp2[9];
  for (int k = 0; k < 9; ++k) sU[k] = sdet * U[k];
  matmul3(sU, Rp, tmp2);
  matmul3(tmp2, Vt, R);
  const double scale = j < 4 ? d1 - d3 : d1 + d3;
  for (int r = 0; r < 3; ++r) t[r] = (U[3 * r] * tp[0] + U[3 * r + 1] * tp[1] + U[3 * r + 2] * tp[2]) * scale;
  unit3(t);
}

__global__ void __launch_bounds__(kThreads)
checkrt_kernel(const Pairs P, float fx, float fy, float cx, float cy, Ws w) {
  __shared__ float s_cos[kMaxPairs];
  __shared__ float s_R[9], s_t[3], s_P2[12], s_O2[3];
  __shared__ int s_red[kThreads / 32];
  __shared__ bool s_use_h;
  const int j = blockIdx.x;
  if (threadIdx.x == 0) {
    const bool use_h = use_homography(w);
    s_use_h = use_h;
    const float Kf[4] = {fx, fy, cx, cy};
    double R[9], t[3];
    motion(w, use_h, j, Kf, R, t);
    for (int k = 0; k < 9; ++k) s_R[k] = (float)R[k];
    for (int k = 0; k < 3; ++k) s_t[k] = (float)t[k];
    // P2 = K [R | t] and O2 = -R^T t in float, as the plain version
    const float Km[9] = {fx, 0.f, cx, 0.f, fy, cy, 0.f, 0.f, 1.f};
    float Rt[12];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Rt[4 * r + c] = s_R[3 * r + c];
      Rt[4 * r + 3] = s_t[r];
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c)
        s_P2[4 * r + c] = Km[3 * r] * Rt[c] + Km[3 * r + 1] * Rt[4 + c] + Km[3 * r + 2] * Rt[8 + c];
    for (int i = 0; i < 3; ++i)
      s_O2[i] = -(s_R[i] * s_t[0] + s_R[3 + i] * s_t[1] + s_R[6 + i] * s_t[2]);
  }
  __syncthreads();
  const bool use_h = s_use_h;
  const uint8_t* inl = w.inl + (use_h ? 0 : P.N);
  const float P1[12] = {fx, 0.f, cx, 0.f, 0.f, fy, cy, 0.f, 0.f, 0.f, 1.f, 0.f};
  int n_pow2 = 1;
  while (n_pow2 < P.N) n_pow2 <<= 1;
  int cnt = 0, n_inl = 0;
  for (int i = threadIdx.x; i < n_pow2; i += kThreads) {
    if (i >= P.N) { s_cos[i] = 2.0f; continue; }
    const float x1u = P.x1[2 * i], x1v = P.x1[2 * i + 1], x2u = P.x2[2 * i], x2v = P.x2[2 * i + 1];
    float A[4][4];
    for (int c = 0; c < 4; ++c) {
      A[0][c] = x1u * P1[8 + c] - P1[c];
      A[1][c] = x1v * P1[8 + c] - P1[4 + c];
      A[2][c] = x2u * s_P2[8 + c] - s_P2[c];
      A[3][c] = x2v * s_P2[8 + c] - s_P2[4 + c];
    }
    float M[3][3], bb[3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        float s = A[0][a] * A[0][b];
        for (int r = 1; r < 4; ++r) s = s + A[r][a] * A[r][b];
        M[a][b] = s;
      }
      float s = A[0][a] * A[0][3];
      for (int r = 1; r < 4; ++r) s = s + A[r][a] * A[r][3];
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
    const float X0 = (c00 * bb[0] + c10 * bb[1] + c20 * bb[2]) * inv_det;
    const float X1 = (c01 * bb[0] + c11 * bb[1] + c21 * bb[2]) * inv_det;
    const float X2 = (c02 * bb[0] + c12 * bb[1] + c22 * bb[2]) * inv_det;
    const bool finite = isfinite(X0) && isfinite(X1) && isfinite(X2);
    const float n20 = X0 - s_O2[0], n21 = X1 - s_O2[1], n22 = X2 - s_O2[2];
    const float d1 = sqrtf(X0 * X0 + X1 * X1 + X2 * X2);
    const float d2n = sqrtf(n20 * n20 + n21 * n21 + n22 * n22);
    const float cos_par = (X0 * n20 + X1 * n21 + X2 * n22) / fmaxf(d1 * d2n, 1e-12f);
    float Y[3];
    for (int r = 0; r < 3; ++r) Y[r] = s_R[3 * r] * X0 + s_R[3 * r + 1] * X1 + s_R[3 * r + 2] * X2 + s_t[r];
    const bool depth_ok = X2 > 0.f && Y[2] > 0.f;
    const float u1 = fx * X0 / X2 + cx, v1 = fy * X1 / X2 + cy;
    const float du1 = u1 - x1u, dv1 = v1 - x1v;
    const float e1 = du1 * du1 + dv1 * dv1;
    const float u2 = fx * Y[0] / Y[2] + cx, v2 = fy * Y[1] / Y[2] + cy;
    const float du2 = u2 - x2u, dv2 = v2 - x2v;
    const float e2 = du2 * du2 + dv2 * dv2;
    const bool in = inl[i] != 0;
    const bool counted = in && finite && depth_ok && e1 <= 4.0f && e2 <= 4.0f;
    w.good[(size_t)j * P.N + i] = counted && !(cos_par >= 0.99998f);
    float* Xo = w.X + ((size_t)j * P.N + i) * 3;
    Xo[0] = X0;
    Xo[1] = X1;
    Xo[2] = X2;
    s_cos[i] = counted ? cos_par : 1.0f;
    cnt += counted;
    n_inl += in;
  }
  cnt = block_sum_i(cnt, s_red);
  n_inl = block_sum_i(n_inl, s_red);
  // bitonic sort of s_cos[0 .. n_pow2), ascending
  for (int k = 2; k <= n_pow2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n_pow2; i += kThreads) {
        const int l = i ^ jj;
        if (l > i) {
          const float a = s_cos[i], b = s_cos[l];
          const bool up = (i & k) == 0;
          if ((a > b) == up) { s_cos[i] = b; s_cos[l] = a; }
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = cnt - 1 < 0 ? 0 : cnt - 1;
    if (k > 50) k = 50;
    const float c = fminf(fmaxf(s_cos[k], -1.0f), 1.0f);
    w.parallax[j] = acosf(c) * (float)(180.0 / 3.14159265358979323846);
    w.n_good[j] = (use_h || j < 4) ? cnt : -1;
    w.n_inl[j] = n_inl;
    for (int k2 = 0; k2 < 9; ++k2) w.Rs[9 * j + k2] = s_R[k2];
    for (int k2 = 0; k2 < 3; ++k2) w.ts[3 * j + k2] = s_t[k2];
  }
}

__global__ void __launch_bounds__(kThreads)
select_kernel(int N, Ws w, bool* success, float* R21, float* t21, float* points, bool* tri,
              bool* used_h) {
  __shared__ int s_best;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int j = 1; j < 8; ++j)
      if (w.n_good[j] > w.n_good[b]) b = j;
    const int max_good = w.n_good[b];
    int n_min = (int)(0.9f * (float)w.n_inl[0]);
    if (n_min < 50) n_min = 50;
    const int th = (int)(0.7f * (float)max_good);
    int n_similar = 0;
    for (int j = 0; j < 8; ++j) n_similar += w.n_good[j] > th;
    *success = max_good >= n_min && n_similar == 1 && w.parallax[b] > 1.0f;
    *used_h = use_homography(w);
    for (int k = 0; k < 9; ++k) R21[k] = w.Rs[9 * b + k];
    for (int k = 0; k < 3; ++k) t21[k] = w.ts[3 * b + k];
    s_best = b;
  }
  __syncthreads();
  const int b = s_best;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    tri[i] = w.good[(size_t)b * N + i] != 0;
    for (int c = 0; c < 3; ++c) points[3 * i + c] = w.X[((size_t)b * N + i) * 3 + c];
  }
}

}  // namespace

extern "C" long long two_view_workspace_bytes(int S, int N) {
  return (long long)carve(nullptr, nullptr, S, N);
}

// xn1/xn2/x1/x2 (N,2) f32, valid (N,) bool, sets (S,8) i32,
// mats (3,3,3) f32 = T1, T2, T2^-1; ws of two_view_workspace_bytes(S, N)
extern "C" int two_view_launch(const void* xn1, const void* xn2, const void* x1, const void* x2,
                               const void* valid, const void* sets, const void* mats, int S,
                               int N, float fx, float fy, float cx, float cy, void* ws,
                               void* success, void* R21, void* t21, void* points, void* tri,
                               void* used_h, void* stream) {
  if (S <= 0 || N <= 0 || N > kMaxPairs) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Ws w;
  carve(&w, static_cast<uint8_t*>(ws), S, N);
  const Pairs P{(const float*)xn1, (const float*)xn2, (const float*)x1, (const float*)x2,
                (const bool*)valid, N};
  hyp_kernel<<<S, kThreads, 0, st>>>(P, (const int*)sets, (const float*)mats, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  refit_kernel<<<2, kThreads, 0, st>>>(P, S, (const float*)mats, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  checkrt_kernel<<<8, kThreads, 0, st>>>(P, fx, fy, cx, cy, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_kernel<<<1, kThreads, 0, st>>>(N, w, (bool*)success, (float*)R21, (float*)t21,
                                        (float*)points, (bool*)tri, (bool*)used_h);
  return (int)cudaGetLastError();
}
