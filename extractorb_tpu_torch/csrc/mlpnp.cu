// K25 mlpnp: RANSAC MLPnP on unit bearings and its maximum-likelihood
// refinement, for relocalization on a fisheye (KB8) map.
//
// Replaces extractorb_tpu/solver/pnp.py:mlpnp_ransac and mlpnp_refine (the
// TPU runs the first as one XLA program: 256 vmapped (12,12) SVDs, a dense
// [256,N] bearing-angle scoring pass and an argmax; the second as a
// lax.scan of 8 Gauss-Newton steps over jacfwd Jacobians).  K10's layout
// (pnp_ransac.cu), four launches, no host synchronisation between them:
//   1. mlpnp_hyp_kernel, one thread per hypothesis: gathers its 6 points and
//      bearings, builds each bearing's tangent basis (r, s) and the normal
//      matrix of the (12,12) nullspace system r^T (R p + t) = 0,
//      s^T (R p + t) = 0, takes its smallest eigenvector by cyclic Jacobi
//      (small_linalg.cuh), flips it so the raw points agree with their
//      bearings, and projects the 3x3 block onto SO(3) through svd3
//      (Procrustes, the determinant's sign), t divided by the mean singular
//      value; float64, written as float32.  A set with an index outside
//      [0, N) or a non-finite entry writes NaN.
//   2. mlpnp_score_kernel, one CTA per hypothesis: the inliers (the angle
//      between R p + t and the bearing inside the cone, valid) in the plain
//      version's float32 order, a block reduction writes the count.  NaN
//      compares false, so a NaN hypothesis counts 0.
//   3. mlpnp_select_kernel, one CTA: the first maximum of the counts
//      (jnp.argmax's tie rule), the winner's mask, R, t, n_inliers, ok.
//   4. mlpnp_refine_kernel (its own entry point), one CTA: 8 Gauss-Newton
//      steps on the tangent residuals [r^T u; s^T u], u = (R p + t)/|R p + t|,
//      weighted by info over valid.  Each thread sums the 21 + 6 terms of the
//      6x6 normal equations over its observations in float64 with
//      closed-form Jacobians, the block sums them in a fixed order, thread 0
//      solves (H + 1e-8 I) d = -g by Gaussian elimination and applies
//      Exp(d); two Newton-Schulz steps re-orthonormalize R at the end.
//
// Bound on the H100: latency.  256 float64 Jacobi solves of a 12x12 (one
// thread each), 256 x N scorings and 8 dependent block reductions are a
// few million operations; the serial sweeps and the dependent launches set
// the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "small_linalg.cuh"  // jacobi_eig, det3, svd3

constexpr int kSample = 6;
constexpr int kThreads = 256;
constexpr int kHypThreads = 64;

__device__ int block_sum_i(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// the tangent basis (r, s) of bearing b (solver/pnp.py:_null_basis)
__device__ void null_basis(const double* b, double* r, double* s) {
  const double nb = sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  const double v[3] = {b[0] / nb, b[1] / nb, b[2] / nb};
  const bool use_z = fabs(v[2]) < 0.9;
  const double ref[3] = {use_z ? 0.0 : 1.0, 0.0, use_z ? 1.0 : 0.0};
  double c[3] = {v[1] * ref[2] - v[2] * ref[1], v[2] * ref[0] - v[0] * ref[2],
                 v[0] * ref[1] - v[1] * ref[0]};
  const double nc = fmax(sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]), 1e-12);
  for (int i = 0; i < 3; ++i) r[i] = c[i] / nc;
  s[0] = v[1] * r[2] - v[2] * r[1];
  s[1] = v[2] * r[0] - v[0] * r[2];
  s[2] = v[0] * r[1] - v[1] * r[0];
}

__global__ void __launch_bounds__(kHypThreads)
mlpnp_hyp_kernel(const float* __restrict__ p3d, const float* __restrict__ bear, int N,
                 const int* __restrict__ sets, int H, float* __restrict__ Rs,
                 float* __restrict__ ts) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double p[kSample][3], b[kSample][3];
  bool bad = false;
  for (int k = 0; k < kSample; ++k) {
    const int i = sets[kSample * h + k];
    if (i < 0 || i >= N) {
      bad = true;
      break;
    }
    for (int c = 0; c < 3; ++c) {
      p[k][c] = (double)p3d[3 * i + c];
      b[k][c] = (double)bear[3 * i + c];
      bad = bad || !isfinite(p[k][c]) || !isfinite(b[k][c]);
    }
  }
  if (bad) {
    for (int k = 0; k < 9; ++k) Rs[9 * h + k] = nanf("");
    for (int k = 0; k < 3; ++k) ts[3 * h + k] = nanf("");
    return;
  }
  double AtA[144];
  for (int k = 0; k < 144; ++k) AtA[k] = 0.0;
  for (int k = 0; k < kSample; ++k) {
    double n[2][3];
    null_basis(b[k], n[0], n[1]);
    for (int side = 0; side < 2; ++side) {
      double row[12];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c) row[3 * a + c] = n[side][a] * p[k][c];
      for (int a = 0; a < 3; ++a) row[9 + a] = n[side][a];
      for (int i = 0; i < 12; ++i)
        for (int j = 0; j < 12; ++j) AtA[12 * i + j] += row[i] * row[j];
    }
  }
  double V[144];
  jacobi_eig<12>(AtA, V);
  int kmin = 0;
  for (int i = 1; i < 12; ++i)
    if (AtA[13 * i] < AtA[13 * kmin]) kmin = i;
  double v[12];
  for (int i = 0; i < 12; ++i) v[i] = V[12 * i + kmin];
  // the sign: the raw estimate's points agree with their bearings
  double agree = 0.0;
  for (int k = 0; k < kSample; ++k)
    for (int r = 0; r < 3; ++r) {
      const double pc = v[3 * r] * p[k][0] + v[3 * r + 1] * p[k][1] + v[3 * r + 2] * p[k][2] + v[9 + r];
      agree += pc * b[k][r];
    }
  const double sg = agree < 0.0 ? -1.0 : 1.0;
  double M[9], U[9], sv[3], W[9];
  for (int i = 0; i < 9; ++i) M[i] = sg * v[i];
  svd3(M, U, sv, W);
  double UWt[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      UWt[3 * i + j] = U[3 * i] * W[3 * j] + U[3 * i + 1] * W[3 * j + 1] + U[3 * i + 2] * W[3 * j + 2];
  const double d = det3(UWt);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Rs[9 * h + 3 * i + j] = (float)(U[3 * i] * W[3 * j] + U[3 * i + 1] * W[3 * j + 1] +
                                      d * U[3 * i + 2] * W[3 * j + 2]);
  const double scale = fmax((sv[0] + sv[1] + sv[2]) / 3.0, 1e-12);
  for (int i = 0; i < 3; ++i) ts[3 * h + i] = (float)(sg * v[9 + i] / scale);
}

// one correspondence against a pose Rt (R row-major, then t), float32 in
// the plain version's order
__device__ bool is_inlier(const float* Rt, const float* __restrict__ p3d,
                          const float* __restrict__ bear, const bool* __restrict__ valid, int i,
                          float cos_th) {
  const float px = p3d[3 * i], py = p3d[3 * i + 1], pz = p3d[3 * i + 2];
  const float x = Rt[0] * px + Rt[1] * py + Rt[2] * pz + Rt[9];
  const float y = Rt[3] * px + Rt[4] * py + Rt[5] * pz + Rt[10];
  const float z = Rt[6] * px + Rt[7] * py + Rt[8] * pz + Rt[11];
  const float n = fmaxf(sqrtf(x * x + y * y + z * z), 1e-12f);
  const float c = (x * bear[3 * i] + y * bear[3 * i + 1] + z * bear[3 * i + 2]) / n;
  return valid[i] && c > cos_th;
}

__global__ void __launch_bounds__(kThreads)
mlpnp_score_kernel(const float* __restrict__ p3d, const float* __restrict__ bear,
                   const bool* __restrict__ valid, int N, float cos_th,
                   const float* __restrict__ Rs, const float* __restrict__ ts, int* counts) {
  __shared__ float s_Rt[12];
  __shared__ int s_red[kThreads / 32];
  const int h = blockIdx.x;
  if (threadIdx.x < 9) s_Rt[threadIdx.x] = Rs[9 * h + threadIdx.x];
  else if (threadIdx.x < 12) s_Rt[threadIdx.x] = ts[3 * h + threadIdx.x - 9];
  __syncthreads();
  int c = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) c += is_inlier(s_Rt, p3d, bear, valid, i, cos_th);
  c = block_sum_i(c, s_red);
  if (threadIdx.x == 0) counts[h] = c;
}

__global__ void __launch_bounds__(kThreads)
mlpnp_select_kernel(const float* __restrict__ p3d, const float* __restrict__ bear,
                    const bool* __restrict__ valid, int N, int H, float cos_th, int min_inliers,
                    const float* __restrict__ Rs, const float* __restrict__ ts,
                    const int* __restrict__ counts, float* R, float* t, bool* inliers,
                    int* n_inliers, bool* ok) {
  __shared__ unsigned long long s_key[kThreads / 32];
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
  for (int i = threadIdx.x; i < N; i += kThreads)
    inliers[i] = is_inlier(s_Rt, p3d, bear, valid, i, cos_th);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) R[k] = s_Rt[k];
    for (int k = 0; k < 3; ++k) t[k] = s_Rt[9 + k];
    const int n = counts[b];
    *n_inliers = n;
    *ok = n >= min_inliers;
  }
}

// ------------------------------------------------------------- refinement

constexpr int kSums = 27;  // 21 (upper H) + 6 (g)

// sum kSums doubles per thread over the block in a fixed order; every
// thread gets the sums
__device__ void block_sum_fixed_d(double (&v)[kSums], double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < kSums; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  __syncthreads();
  if (lane == 0)
    for (int i = 0; i < kSums; ++i) red[warp * kSums + i] = v[i];
  __syncthreads();
  for (int i = 0; i < kSums; ++i) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w * kSums + i];
    v[i] = s;
  }
}

// Exp of se(3) in float64: R = I + a W + b W^2, t = (I + b W + c W^2) rho
__device__ void se3_exp_d(const double* xi, double* dR, double* dt) {
  const double w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const double th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8;
  const double th = sqrt(small ? 1.0 : th2);
  const double a = small ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double b = small ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / th2;
  const double c = small ? 1.0 / 6.0 - th2 / 120.0 : (th - sin(th)) / (th2 * th);
  const double W[9] = {0.0, -w2, w1, w2, 0.0, -w0, -w1, w0, 0.0};
  double W2[9];
  matmul3(W, W, W2);
  double Vm[9];
  for (int i = 0; i < 9; ++i) {
    const double I = (i % 4 == 0) ? 1.0 : 0.0;
    dR[i] = I + a * W[i] + b * W2[i];
    Vm[i] = I + b * W[i] + c * W2[i];
  }
  for (int i = 0; i < 3; ++i) dt[i] = Vm[3 * i] * xi[0] + Vm[3 * i + 1] * xi[1] + Vm[3 * i + 2] * xi[2];
}

// solve A x = rhs (6x6 float64, row-major, A destroyed) by partial pivoting
__device__ void solve6_d(double* A, double* rhs, double* x) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[6 * r + c]) > fabs(A[6 * piv + c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        const double tmp = A[6 * c + k];
        A[6 * c + k] = A[6 * piv + k];
        A[6 * piv + k] = tmp;
      }
      const double tmp = rhs[c];
      rhs[c] = rhs[piv];
      rhs[piv] = tmp;
    }
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[6 * r + c] / A[6 * c + c];
      for (int k = c; k < 6; ++k) A[6 * r + k] -= f * A[6 * c + k];
      rhs[r] -= f * rhs[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double s = rhs[r];
    for (int k = r + 1; k < 6; ++k) s -= A[6 * r + k] * x[k];
    x[r] = s / A[6 * r + r];
  }
}

__global__ void __launch_bounds__(kThreads)
mlpnp_refine_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                    const float* __restrict__ p3d, const float* __restrict__ bear,
                    const float* __restrict__ info, const bool* __restrict__ valid, int N,
                    int n_iters, float* __restrict__ R_out, float* __restrict__ t_out) {
  __shared__ double s_R[9], s_t[3];
  __shared__ double s_red[(kThreads / 32) * kSums];
  if (threadIdx.x < 9) s_R[threadIdx.x] = (double)R0[threadIdx.x];
  if (threadIdx.x < 3) s_t[threadIdx.x] = (double)t0[threadIdx.x];
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    double R[9], t[3], acc[kSums];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const double w = (double)info[i] * (valid[i] ? 1.0 : 0.0);
      const double p[3] = {(double)p3d[3 * i], (double)p3d[3 * i + 1], (double)p3d[3 * i + 2]};
      const double b[3] = {(double)bear[3 * i], (double)bear[3 * i + 1], (double)bear[3 * i + 2]};
      double nb[2][3];
      null_basis(b, nb[0], nb[1]);
      double pc[3];
      for (int r = 0; r < 3; ++r) pc[r] = R[3 * r] * p[0] + R[3 * r + 1] * p[1] + R[3 * r + 2] * p[2] + t[r];
      const double n = fmax(sqrt(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]), 1e-12);
      const double u[3] = {pc[0] / n, pc[1] / n, pc[2] / n};
      double res[2], J[2][6];
      for (int rr = 0; rr < 2; ++rr) {
        const double* m = nb[rr];
        res[rr] = m[0] * u[0] + m[1] * u[1] + m[2] * u[2];
        // q = m (I - u u^T) / n, then a = q R: d res / d rho
        const double mu = res[rr];
        double q[3], a[3];
        for (int c = 0; c < 3; ++c) q[c] = (m[c] - mu * u[c]) / n;
        for (int c = 0; c < 3; ++c) a[c] = q[0] * R[c] + q[1] * R[3 + c] + q[2] * R[6 + c];
        for (int c = 0; c < 3; ++c) J[rr][c] = a[c];
        // d res / d phi = -(a x p)
        J[rr][3] = -(a[1] * p[2] - a[2] * p[1]);
        J[rr][4] = -(a[2] * p[0] - a[0] * p[2]);
        J[rr][5] = -(a[0] * p[1] - a[1] * p[0]);
      }
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c) acc[k++] += w * (J[0][a] * J[0][c] + J[1][a] * J[1][c]);
      for (int a = 0; a < 6; ++a) acc[21 + a] += w * (J[0][a] * res[0] + J[1][a] * res[1]);
    }
    block_sum_fixed_d(acc, s_red);
    if (threadIdx.x == 0) {
      double A[36], rhs[6], d[6];
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c) {
          A[6 * a + c] = acc[k];
          A[6 * c + a] = acc[k];
          ++k;
        }
      for (int a = 0; a < 6; ++a) {
        A[7 * a] += 1e-8;
        rhs[a] = -acc[21 + a];
      }
      solve6_d(A, rhs, d);
      double dR[9], dt[3], Rn[9];
      se3_exp_d(d, dR, dt);
      matmul3(R, dR, Rn);
      for (int i = 0; i < 3; ++i)
        s_t[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];
      for (int k2 = 0; k2 < 9; ++k2) s_R[k2] = Rn[k2];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double R[9];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int rep = 0; rep < 2; ++rep) {  // R <- R (1.5 I - 0.5 R^T R)
      double RtR[9], M[9], Rn[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          RtR[3 * i + j] = R[i] * R[j] + R[3 + i] * R[3 + j] + R[6 + i] * R[6 + j];
      for (int k = 0; k < 9; ++k) M[k] = ((k % 4 == 0) ? 1.5 : 0.0) - 0.5 * RtR[k];
      matmul3(R, M, Rn);
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
    for (int k = 0; k < 9; ++k) R_out[k] = (float)R[k];
    for (int k = 0; k < 3; ++k) t_out[k] = (float)s_t[k];
  }
}

}  // namespace

// p3d (N,3) f32, bear (N,3) f32 unit bearings, valid (N,) bool, sets (H,6)
// i32; workspace Rs (H,3,3) f32, ts (H,3) f32, counts (H,) i32; out R (3,3),
// t (3,), inliers (N,) bool, n_inliers () i32, ok () bool
extern "C" int mlpnp_ransac_launch(const void* p3d, const void* bear, const void* valid,
                                   const void* sets, int N, int H, float cos_th,
                                   int min_inliers, void* Rs, void* ts, void* counts, void* R,
                                   void* t, void* inliers, void* n_inliers, void* ok,
                                   void* stream) {
  if (H <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  mlpnp_hyp_kernel<<<(H + kHypThreads - 1) / kHypThreads, kHypThreads, 0, st>>>(
      (const float*)p3d, (const float*)bear, N, (const int*)sets, H, (float*)Rs, (float*)ts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlpnp_score_kernel<<<H, kThreads, 0, st>>>((const float*)p3d, (const float*)bear,
                                              (const bool*)valid, N, cos_th, (const float*)Rs,
                                              (const float*)ts, (int*)counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlpnp_select_kernel<<<1, kThreads, 0, st>>>((const float*)p3d, (const float*)bear,
                                               (const bool*)valid, N, H, cos_th, min_inliers,
                                               (const float*)Rs, (const float*)ts,
                                               (const int*)counts, (float*)R, (float*)t,
                                               (bool*)inliers, (int*)n_inliers, (bool*)ok);
  return (int)cudaGetLastError();
}

// R0 (3,3), t0 (3,), p3d (N,3), bear (N,3), info (N,) f32, valid (N,) bool;
// out R (3,3), t (3,) f32
extern "C" int mlpnp_refine_launch(const void* R0, const void* t0, const void* p3d,
                                   const void* bear, const void* info, const void* valid, int N,
                                   int n_iters, void* R, void* t, void* stream) {
  if (N < 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
  mlpnp_refine_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R0, (const float*)t0, (const float*)p3d, (const float*)bear,
      (const float*)info, (const bool*)valid, N, n_iters, (float*)R, (float*)t);
  return (int)cudaGetLastError();
}
