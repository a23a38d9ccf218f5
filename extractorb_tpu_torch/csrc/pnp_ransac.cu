// K10 pnp_ransac: RANSAC PnP for relocalization, the whole search on the card.
//
// Replaces extractorb_tpu/solver/pnp.py:ransac_pnp (the TPU runs it as one
// XLA program: 256 vmapped EPnP or DLT solves on 6-point sets, a dense
// [256,N] scoring pass and an argmax).  Three launches, no host
// synchronisation between them:
//   1. pnp_hyp_kernel<solver>, one thread per hypothesis: gathers its 6
//      samples and solves EPnP (centroid + principal axes of the sample as
//      control points, barycentric alphas from a 4x4 solve, the 12x12
//      system's null vector as the smallest eigenvector of M^T M by cyclic
//      Jacobi, beta from the control-point distances, the cheirality flip,
//      Horn's alignment through a 3x3 SVD) or the 6-point DLT (null vector,
//      Procrustes of both signs, the centroid-depth choice), all in float64,
//      and writes R, t in float32.  A set with an index outside [0, N) or a
//      non-finite entry writes NaN.
//   2. pnp_score_kernel, one CTA per hypothesis: threads stride over the N
//      correspondences with the plain version's float32 arithmetic
//      (positive depth, projection, err^2 < th^2, valid), a block reduction
//      writes the inlier count.  NaN compares false, so a NaN hypothesis
//      counts 0.
//   3. pnp_select_kernel, one CTA: the first maximum of the counts by a
//      packed (count, H-1-h) key (jnp.argmax's tie rule), the winner's
//      inlier mask recomputed over N, R, t, n_inliers and ok.
// The arithmetic follows solver/pnp.py's plain version (the build uses
// -fmad=false, so the float32 scoring rounds as the plain version does).
//
// Bound on the H100: latency.  256 minimal solves and 256 x 1128 scorings
// are a few million operations; the serial float64 Jacobi sweeps of one
// thread per hypothesis and three dependent launches set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "small_linalg.cuh"  // jacobi_eig, det3, svd3

constexpr int kSample = 6;
constexpr int kThreads = 256;
constexpr int kHypThreads = 64;
constexpr int kEpnp = 0;
constexpr int kDlt = 1;

__device__ int block_sum_i(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__device__ void add_outer12(double* AtA, const double* r) {
  for (int i = 0; i < 12; ++i)
    for (int j = 0; j < 12; ++j) AtA[12 * i + j] += r[i] * r[j];
}

// smallest eigenvector of the symmetric 12x12 AtA (destroyed)
__device__ void null_vector12(double* AtA, double* v) {
  double V[144];
  jacobi_eig<12>(AtA, V);
  int k = 0;
  for (int i = 1; i < 12; ++i)
    if (AtA[13 * i] < AtA[13 * k]) k = i;
  for (int i = 0; i < 12; ++i) v[i] = V[12 * i + k];
}

// A X = B for a 4x4 A and 6 right-hand sides (Gaussian elimination with
// partial pivoting); X overwrites B (4 x 6, row-major)
__device__ void solve4(double* A, double* B) {
  for (int k = 0; k < 4; ++k) {
    int p = k;
    for (int r = k + 1; r < 4; ++r)
      if (fabs(A[4 * r + k]) > fabs(A[4 * p + k])) p = r;
    if (p != k) {
      for (int c = 0; c < 4; ++c) { const double tmp = A[4 * k + c]; A[4 * k + c] = A[4 * p + c]; A[4 * p + c] = tmp; }
      for (int c = 0; c < kSample; ++c) { const double tmp = B[kSample * k + c]; B[kSample * k + c] = B[kSample * p + c]; B[kSample * p + c] = tmp; }
    }
    for (int r = k + 1; r < 4; ++r) {
      const double f = A[4 * r + k] / A[4 * k + k];
      for (int c = k; c < 4; ++c) A[4 * r + c] -= f * A[4 * k + c];
      for (int c = 0; c < kSample; ++c) B[kSample * r + c] -= f * B[kSample * k + c];
    }
  }
  for (int k = 3; k >= 0; --k)
    for (int c = 0; c < kSample; ++c) {
      double s = B[kSample * k + c];
      for (int j = k + 1; j < 4; ++j) s -= A[4 * k + j] * B[kSample * j + c];
      B[kSample * k + c] = s / A[4 * k + k];
    }
}

// EPnP, as solver/pnp.py:_epnp_pose
__device__ void epnp_pose(double (*p)[3], double (*x)[2], double* R, double* t) {
  double c0[3] = {0.0, 0.0, 0.0};
  for (int s = 0; s < kSample; ++s)
    for (int c = 0; c < 3; ++c) c0[c] += p[s][c];
  for (int c = 0; c < 3; ++c) c0[c] /= kSample;
  double cov[9] = {0.0};
  for (int s = 0; s < kSample; ++s)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) cov[3 * a + b] += (p[s][a] - c0[a]) * (p[s][b] - c0[b]);
  for (int i = 0; i < 9; ++i) cov[i] /= kSample;
  double E[9];
  jacobi_eig<3>(cov, E);
  int ord[3] = {0, 1, 2};  // ascending eigenvalue
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (cov[4 * ord[b]] < cov[4 * ord[a]]) { const int tmp = ord[a]; ord[a] = ord[b]; ord[b] = tmp; }
  double Cw[4][3];
  for (int c = 0; c < 3; ++c) Cw[0][c] = c0[c];
  for (int k = 0; k < 3; ++k) {
    double v[3] = {E[ord[k]], E[3 + ord[k]], E[6 + ord[k]]};
    int m = 0;  // canonical sign: the largest-magnitude entry (first on a tie) positive
    for (int r = 1; r < 3; ++r)
      if (fabs(v[r]) > fabs(v[m])) m = r;
    const double sg = v[m] < 0.0 ? -1.0 : 1.0;
    const double s_ax = sqrt(fmax(cov[4 * ord[k]], 1e-8));
    for (int c = 0; c < 3; ++c) Cw[k + 1][c] = c0[c] + sg * v[c] * s_ax;
  }
  // barycentric alphas: [Cw^T; 1] alpha_s = [p_s; 1]
  double A4[16], B[4 * kSample];
  for (int j = 0; j < 4; ++j) {
    for (int r = 0; r < 3; ++r) A4[4 * r + j] = Cw[j][r];
    A4[12 + j] = 1.0;
  }
  for (int s = 0; s < kSample; ++s) {
    for (int r = 0; r < 3; ++r) B[kSample * r + s] = p[s][r];
    B[kSample * 3 + s] = 1.0;
  }
  solve4(A4, B);  // B[j][s] = alpha[s][j]
  double MtM[144] = {0.0};
  for (int s = 0; s < kSample; ++s) {
    double ru[12], rv[12];
    for (int j = 0; j < 4; ++j) {
      const double a = B[kSample * j + s];
      ru[3 * j] = a;
      ru[3 * j + 1] = 0.0 * a;
      ru[3 * j + 2] = -x[s][0] * a;
      rv[3 * j] = 0.0 * a;
      rv[3 * j + 1] = a;
      rv[3 * j + 2] = -x[s][1] * a;
    }
    add_outer12(MtM, ru);
    add_outer12(MtM, rv);
  }
  double Cc[12];
  null_vector12(MtM, Cc);  // Cc[3j + c]: control point j, camera frame
  const int ii[6] = {0, 0, 0, 1, 1, 2}, jj[6] = {1, 2, 3, 2, 3, 3};
  double num = 0.0, den = 0.0;
  for (int k = 0; k < 6; ++k) {
    double dc = 0.0, dw = 0.0;
    for (int c = 0; c < 3; ++c) {
      const double ec = Cc[3 * ii[k] + c] - Cc[3 * jj[k] + c];
      const double ew = Cw[ii[k]][c] - Cw[jj[k]][c];
      dc += ec * ec;
      dw += ew * ew;
    }
    dc = sqrt(dc);
    dw = sqrt(dw);
    num += dw * dc;
    den += dc * dc;
  }
  const double beta = num / fmax(den, 1e-12);
  double pc[kSample][3], zsum = 0.0;
  for (int s = 0; s < kSample; ++s) {
    for (int c = 0; c < 3; ++c) {
      double v = 0.0;
      for (int j = 0; j < 4; ++j) v += B[kSample * j + s] * (Cc[3 * j + c] * beta);
      pc[s][c] = v;
    }
    zsum += pc[s][2];
  }
  if (zsum / kSample < 0.0)
    for (int s = 0; s < kSample; ++s)
      for (int c = 0; c < 3; ++c) pc[s][c] = -pc[s][c];
  // Horn: p_c = R p_w + t
  double mw[3] = {0.0, 0.0, 0.0}, mc[3] = {0.0, 0.0, 0.0};
  for (int s = 0; s < kSample; ++s)
    for (int c = 0; c < 3; ++c) { mw[c] += p[s][c]; mc[c] += pc[s][c]; }
  for (int c = 0; c < 3; ++c) { mw[c] /= kSample; mc[c] /= kSample; }
  double Hm[9] = {0.0};
  for (int s = 0; s < kSample; ++s)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) Hm[3 * a + b] += (p[s][a] - mw[a]) * (pc[s][b] - mc[b]);
  double U[9], sv[3], V[9], VUt[9];
  svd3(Hm, U, sv, V);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      VUt[3 * i + j] = V[3 * i] * U[3 * j] + V[3 * i + 1] * U[3 * j + 1] + V[3 * i + 2] * U[3 * j + 2];
  const double D[3] = {1.0, 1.0, det3(VUt)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = V[3 * i] * D[0] * U[3 * j] + V[3 * i + 1] * D[1] * U[3 * j + 1] +
                     V[3 * i + 2] * D[2] * U[3 * j + 2];
  for (int i = 0; i < 3; ++i) t[i] = mc[i] - (R[3 * i] * mw[0] + R[3 * i + 1] * mw[1] + R[3 * i + 2] * mw[2]);
}

// nearest rotation to M (Procrustes) and the positive scale, as _orth
__device__ double orth(const double* M, double* R) {
  double U[9], sv[3], V[9], UVt[9];
  svd3(M, U, sv, V);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      UVt[3 * i + j] = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] + U[3 * i + 2] * V[3 * j + 2];
  const double D[3] = {1.0, 1.0, det3(UVt)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = U[3 * i] * D[0] * V[3 * j] + U[3 * i + 1] * D[1] * V[3 * j + 1] +
                     U[3 * i + 2] * D[2] * V[3 * j + 2];
  return fmax((sv[0] + sv[1] + sv[2]) / 3.0, 1e-12);
}

// 6-point DLT, as solver/pnp.py:_dlt_pose
__device__ void dlt_pose(double (*p)[3], double (*x)[2], double* R, double* t) {
  double AtA[144] = {0.0};
  for (int s = 0; s < kSample; ++s) {
    const double X[4] = {p[s][0], p[s][1], p[s][2], 1.0};
    double r1[12], r2[12];
    for (int c = 0; c < 4; ++c) {
      r1[c] = X[c];
      r1[4 + c] = 0.0;
      r1[8 + c] = -x[s][0] * X[c];
      r2[c] = 0.0;
      r2[4 + c] = X[c];
      r2[8 + c] = -x[s][1] * X[c];
    }
    add_outer12(AtA, r1);
    add_outer12(AtA, r2);
  }
  double P[12];
  null_vector12(AtA, P);  // P[4r + c]
  int m = 0;  // fix the arbitrary sign: the largest-magnitude entry (first on a tie) positive
  for (int i = 1; i < 12; ++i)
    if (fabs(P[i]) > fabs(P[m])) m = i;
  if (P[m] < 0.0)
    for (int i = 0; i < 12; ++i) P[i] = -P[i];
  double Ma[9], Mb[9], Ra[9], Rb[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) { Ma[3 * r + c] = P[4 * r + c]; Mb[3 * r + c] = -P[4 * r + c]; }
  const double sa = orth(Ma, Ra), sb = orth(Mb, Rb);
  double c0[3] = {0.0, 0.0, 0.0};
  for (int s = 0; s < kSample; ++s)
    for (int c = 0; c < 3; ++c) c0[c] += p[s][c];
  for (int c = 0; c < 3; ++c) c0[c] /= kSample;
  const double ta2 = P[11] / sa;
  const double za = Ra[6] * c0[0] + Ra[7] * c0[1] + Ra[8] * c0[2] + ta2;
  const bool use_a = za > 0.0;
  for (int i = 0; i < 9; ++i) R[i] = use_a ? Ra[i] : Rb[i];
  for (int i = 0; i < 3; ++i) t[i] = use_a ? P[4 * i + 3] / sa : -P[4 * i + 3] / sb;
}

template <int kSolver>
__global__ void __launch_bounds__(kHypThreads)
pnp_hyp_kernel(const float* __restrict__ p3d, const float* __restrict__ xy, int N,
               const int* __restrict__ sets, int H, float* Rs, float* ts) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double p[kSample][3], x[kSample][2];
  bool good = true;
  for (int s = 0; s < kSample; ++s) {
    const int i = sets[kSample * h + s];
    const bool in = i >= 0 && i < N;
    for (int c = 0; c < 3; ++c) p[s][c] = in ? (double)p3d[3 * i + c] : 0.0;
    for (int c = 0; c < 2; ++c) x[s][c] = in ? (double)xy[2 * i + c] : 0.0;
    good = good && in && isfinite(p[s][0]) && isfinite(p[s][1]) && isfinite(p[s][2]) &&
           isfinite(x[s][0]) && isfinite(x[s][1]);
  }
  double R[9], t[3];
  if (good) {
    if (kSolver == kEpnp) epnp_pose(p, x, R, t);
    else dlt_pose(p, x, R, t);
  } else {
    for (int i = 0; i < 9; ++i) R[i] = nan("");
    for (int i = 0; i < 3; ++i) t[i] = nan("");
  }
  for (int i = 0; i < 9; ++i) Rs[9 * h + i] = (float)R[i];
  for (int i = 0; i < 3; ++i) ts[3 * h + i] = (float)t[i];
}

// one correspondence against a pose Rt (R row-major, then t), float32 in
// the plain version's order
__device__ bool is_inlier(const float* Rt, const float* __restrict__ p3d,
                          const float* __restrict__ xy, const bool* __restrict__ valid, int i,
                          float th2) {
  const float px = p3d[3 * i], py = p3d[3 * i + 1], pz = p3d[3 * i + 2];
  const float x = Rt[0] * px + Rt[1] * py + Rt[2] * pz + Rt[9];
  const float y = Rt[3] * px + Rt[4] * py + Rt[5] * pz + Rt[10];
  const float z = Rt[6] * px + Rt[7] * py + Rt[8] * pz + Rt[11];
  const bool zok = z > 1e-6f;
  const float zz = zok ? z : 1.0f;
  const float dx = x / zz - xy[2 * i];
  const float dy = y / zz - xy[2 * i + 1];
  const float err2 = dx * dx + dy * dy;
  return valid[i] && zok && err2 < th2;
}

__global__ void __launch_bounds__(kThreads)
pnp_score_kernel(const float* __restrict__ p3d, const float* __restrict__ xy,
                 const bool* __restrict__ valid, int N, float th2, const float* __restrict__ Rs,
                 const float* __restrict__ ts, int* counts) {
  __shared__ float s_Rt[12];
  __shared__ int s_red[kThreads / 32];
  const int h = blockIdx.x;
  if (threadIdx.x < 9) s_Rt[threadIdx.x] = Rs[9 * h + threadIdx.x];
  else if (threadIdx.x < 12) s_Rt[threadIdx.x] = ts[3 * h + threadIdx.x - 9];
  __syncthreads();
  int c = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) c += is_inlier(s_Rt, p3d, xy, valid, i, th2);
  c = block_sum_i(c, s_red);
  if (threadIdx.x == 0) counts[h] = c;
}

__global__ void __launch_bounds__(kThreads)
pnp_select_kernel(const float* __restrict__ p3d, const float* __restrict__ xy,
                  const bool* __restrict__ valid, int N, int H, float th2, int min_inliers,
                  const float* __restrict__ Rs, const float* __restrict__ ts,
                  const int* __restrict__ counts, float* R, float* t, bool* inliers,
                  int* n_inliers, bool* ok) {
  __shared__ unsigned long long s_key[kThreads / 32];
  __shared__ int s_red[kThreads / 32];
  __shared__ float s_Rt[12];
  __shared__ int s_best;
  // first maximum: the largest (count, H-1-h)
  unsigned long long key = 0ull;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const unsigned long long k =
        ((unsigned long long)(unsigned)counts[h] << 32) | (unsigned long long)(unsigned)(H - 1 - h);
    key = k > key ? k : key;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
    key = other > key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long best = s_key[0];
    for (int w = 1; w < kThreads / 32; ++w) best = s_key[w] > best ? s_key[w] : best;
    s_best = H - 1 - (int)(best & 0xffffffffull);
  }
  __syncthreads();
  const int b = s_best;
  if (threadIdx.x < 9) s_Rt[threadIdx.x] = Rs[9 * b + threadIdx.x];
  else if (threadIdx.x < 12) s_Rt[threadIdx.x] = ts[3 * b + threadIdx.x - 9];
  __syncthreads();
  int nv = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    inliers[i] = is_inlier(s_Rt, p3d, xy, valid, i, th2);
    nv += valid[i];
  }
  nv = block_sum_i(nv, s_red);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) R[k] = s_Rt[k];
    for (int k = 0; k < 3; ++k) t[k] = s_Rt[9 + k];
    const int n = counts[b];
    *n_inliers = n;
    *ok = n >= min_inliers && nv >= kSample;
  }
}

}  // namespace

// p3d (N,3) f32, xy (N,2) f32, valid (N,) bool, sets (H,6) i32; solver 0
// EPnP, 1 DLT; workspace Rs (H,3,3) f32, ts (H,3) f32, counts (H,) i32;
// out R (3,3), t (3,), inliers (N,) bool, n_inliers () i32, ok () bool
extern "C" int pnp_ransac_launch(const void* p3d, const void* xy, const void* valid,
                                 const void* sets, int N, int H, int solver, float th,
                                 int min_inliers, void* Rs, void* ts, void* counts, void* R,
                                 void* t, void* inliers, void* n_inliers, void* ok,
                                 void* stream) {
  if (H <= 0 || N < 0 || (solver != kEpnp && solver != kDlt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float th2 = th * th;
  const int hyp_blocks = (H + kHypThreads - 1) / kHypThreads;
  if (solver == kEpnp)
    pnp_hyp_kernel<kEpnp><<<hyp_blocks, kHypThreads, 0, st>>>(
        (const float*)p3d, (const float*)xy, N, (const int*)sets, H, (float*)Rs, (float*)ts);
  else
    pnp_hyp_kernel<kDlt><<<hyp_blocks, kHypThreads, 0, st>>>(
        (const float*)p3d, (const float*)xy, N, (const int*)sets, H, (float*)Rs, (float*)ts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pnp_score_kernel<<<H, kThreads, 0, st>>>((const float*)p3d, (const float*)xy,
                                            (const bool*)valid, N, th2, (const float*)Rs,
                                            (const float*)ts, (int*)counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pnp_select_kernel<<<1, kThreads, 0, st>>>((const float*)p3d, (const float*)xy,
                                             (const bool*)valid, N, H, th2, min_inliers,
                                             (const float*)Rs, (const float*)ts,
                                             (const int*)counts, (float*)R, (float*)t,
                                             (bool*)inliers, (int*)n_inliers, (bool*)ok);
  return (int)cudaGetLastError();
}
