// K4 pose_lm: the reference's 4 x 10 robust Levenberg-Marquardt pose
// optimisation (mono reprojection edges, and the stereo edge's third row),
// one CTA per problem.
//
// Replaces extractorb_tpu/solver/pose_opt.py:optimize_pose, which the TPU
// runs as a lax.scan over jacfwd Jacobians and masked MXU einsums.  Here the
// Jacobians are analytic (right perturbation R Exp(delta), delta = (rho, phi):
// d pc = [R | -R hat(p)] delta), each thread accumulates the 21 + 6 sums of
// the normal equations and the cost over its observations, the block reduces
// them, and thread 0 solves (H + lambda diag H + 1e-9 I) delta = -b by
// Gaussian elimination with partial pivoting, applies Exp(delta) and keeps the
// step only if the cost fell strictly (lambda x0.5, else x4; lambda starts at
// 1e-3 in every round).  Between rounds the chi2 test re-classifies inliers;
// round 3 drops the Huber kernel.  Padded slots are projected at a safe point
// (0, 0, 1) so they stay finite.  The output rotation is re-orthonormalized
// with two Newton-Schulz steps, as lie.orthonormalize does.
//
// Stereo (obs_ur not null): an observation with ur >= 0 gets the third row
// ur - (u - bf / z) (reference EdgeStereoSE3ProjectXYZOnlyPose), Huber delta
// sqrt(7.815) and the chi2 threshold 7.815; one with ur < 0 stays a mono edge.
// The kernel is a template on the stereo flag, so a mono problem runs the
// mono arithmetic unchanged, and on the camera (camera_t.cuh): the pinhole
// Cam keeps the closed-form Jacobian, CamKB8 (the fisheye camera, mono only)
// takes d pi / d pc in forward mode through its projection, as the JAX
// package's jacfwd through the KB8 closure does.
//
// Bound on the H100: latency.  ~1100 observations and 40 iterations of two
// block reductions each are a few microseconds of arithmetic per iteration;
// the chain of dependent reductions and the serial 6x6 solve set the time.
// A batch of problems runs as parallel CTAs (the fused step batches its
// motion and reference-keyframe branches).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "dual.cuh"
#include "camera_t.cuh"

constexpr int kThreads = 256;
constexpr int kSums = 28;  // 21 (upper H) + 6 (b) + 1 (cost)
constexpr float kChi2 = 5.991f;
constexpr float kChi2Stereo = 7.815f;

// sum `n` per-thread values across the block; every thread gets the sums
template <int n>
__device__ void block_sum(float (&v)[n], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < n; ++i) red[warp * n + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w * n + i];
    v[i] = s;
  }
}

__device__ __forceinline__ void project(const float* R, const float* t, const float* p,
                                        float& x, float& y, float& z) {
  x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
}

__device__ __forceinline__ float rho(float c2, float delta, bool huber) {
  if (!huber) return c2;
  const float d2 = delta * delta;
  return c2 <= d2 ? c2 : 2.f * delta * sqrtf(c2) - d2;
}

// Exp of se(3): R = I + a W + b W^2, t = (I + b W + c W^2) rho
__device__ void se3_exp(const float* xi, float* dR, float* dt) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th2 * th);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  float V[9];
  for (int i = 0; i < 9; ++i) {
    const float I = (i % 4 == 0) ? 1.f : 0.f;
    dR[i] = I + a * W[i] + b * W2[i];
    V[i] = I + b * W[i] + c * W2[i];
  }
  for (int i = 0; i < 3; ++i) dt[i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
}

// solve A x = rhs (6x6, row-major, A destroyed) by partial pivoting
__device__ void solve6(float* A, float* rhs, float* x) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[6 * r + c]) > fabsf(A[6 * piv + c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        const float tmp = A[6 * c + k];
        A[6 * c + k] = A[6 * piv + k];
        A[6 * piv + k] = tmp;
      }
      const float tmp = rhs[c];
      rhs[c] = rhs[piv];
      rhs[piv] = tmp;
    }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[6 * r + c] / A[6 * c + c];
      for (int k = c; k < 6; ++k) A[6 * r + k] -= f * A[6 * c + k];
      rhs[r] -= f * rhs[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = rhs[r];
    for (int k = r + 1; k < 6; ++k) s -= A[6 * r + k] * x[k];
    x[r] = s / A[6 * r + r];
  }
}

// residuals of observation i at pose (R, t): r0, r1 and, for a stereo edge,
// r2; returns chi2 (times inv_sigma2) and sets the edge's Huber delta
template <bool kStereo, class C>
__device__ __forceinline__ float residual(const float* R, const float* t, const float* p,
                                          const float* o, float ur, float is, const C& cam,
                                          float bf, float& x, float& y, float& z, float& r0,
                                          float& r1, float& r2, float& delta) {
  project(R, t, p, x, y, z);
  float u, v;
  cam.project(x, y, z, u, v);
  r0 = o[0] - u;
  r1 = o[1] - v;
  if constexpr (kStereo) {
    const bool has_r = ur >= 0.f;
    r2 = has_r ? ur - (u - bf / z) : 0.f;
    delta = has_r ? sqrtf(kChi2Stereo) : sqrtf(kChi2);
    return (r0 * r0 + r1 * r1 + r2 * r2) * is;
  } else {
    r2 = 0.f;
    delta = sqrtf(kChi2);
    return (r0 * r0 + r1 * r1) * is;
  }
}

template <bool kStereo, class C>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
               const float* __restrict__ pts_w, const float* __restrict__ obs,
               const float* __restrict__ obs_ur, const float* __restrict__ isig,
               const bool* __restrict__ valid, int N, const C cam, float bf, int n_rounds,
               int n_iters, float* __restrict__ R_out, float* __restrict__ t_out,
               bool* __restrict__ inl_out, int* __restrict__ n_inl_out) {
  __shared__ float s_R[9], s_t[3], s_Rn[9], s_tn[3];
  __shared__ float s_red[(kThreads / 32) * kSums];
  extern __shared__ unsigned char s_active_raw[];
  bool* s_active = reinterpret_cast<bool*>(s_active_raw);

  const int bi = blockIdx.x;
  const float* P = pts_w + (size_t)bi * N * 3;
  const float* O = obs + (size_t)bi * N * 2;
  const float* UR = kStereo ? obs_ur + (size_t)bi * N : nullptr;
  const float* S = isig + (size_t)bi * N;
  const bool* Vd = valid + (size_t)bi * N;
  if (threadIdx.x < 9) s_R[threadIdx.x] = R0[bi * 9 + threadIdx.x];
  if (threadIdx.x < 3) s_t[threadIdx.x] = t0[bi * 3 + threadIdx.x];
  for (int i = threadIdx.x; i < N; i += kThreads) s_active[i] = Vd[i];
  __syncthreads();

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < 3;
    float lam = 1e-3f;  // kept identical in every thread
    for (int it = 0; it < n_iters; ++it) {
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
      float R[9], t[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = s_R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = s_t[k];
      for (int i = threadIdx.x; i < N; i += kThreads) {
        if (!s_active[i]) continue;
        const bool ok = Vd[i];
        const float p[3] = {ok ? P[3 * i] : 0.f, ok ? P[3 * i + 1] : 0.f, ok ? P[3 * i + 2] : 1.f};
        const float ur = kStereo ? UR[i] : -1.f;
        const float is = S[i];
        float x, y, z, r0, r1, r2, delta;
        const float chi2 = residual<kStereo>(R, t, p, O + 2 * i, ur, is, cam, bf, x, y, z, r0,
                                             r1, r2, delta);
        float w = huber ? fminf(1.f, delta / sqrtf(fmaxf(chi2, 1e-12f))) : 1.f;
        w *= is;
        // A = J_pi R (2x3, or 3x3 for a stereo edge); J = [-A | A x p]
        constexpr int kRows = kStereo ? 3 : 2;
        float J[kRows][6];
        {
          float a0[3], a1[3];
          cam.a_rows(x, y, z, R, a0, a1);
          for (int c = 0; c < 3; ++c) {
            J[0][c] = -a0[c];
            J[1][c] = -a1[c];
          }
        }
        if constexpr (kStereo) {
          // d(u - bf/z)/d pc = (fx/z, 0, (bf - fx x)/z^2), zero for a mono edge
          const float iz = 1.f / z;
          const float j00 = cam.fx * iz;
          const bool has_r = ur >= 0.f;
          const float j22 = (-cam.fx * x + bf) * iz * iz;
          for (int c = 0; c < 3; ++c) J[2][c] = has_r ? -(j00 * R[c] + j22 * R[6 + c]) : 0.f;
        }
        // A x p with A rows a = -J[.][0..2]
        for (int rr = 0; rr < kRows; ++rr) {
          const float a0 = -J[rr][0], a1 = -J[rr][1], a2 = -J[rr][2];
          J[rr][3] = a1 * p[2] - a2 * p[1];
          J[rr][4] = a2 * p[0] - a0 * p[2];
          J[rr][5] = a0 * p[1] - a1 * p[0];
        }
        int k = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b) {
            if constexpr (kStereo)
              acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] + J[2][a] * J[2][b]);
            else
              acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
          }
        for (int a = 0; a < 6; ++a) {
          if constexpr (kStereo)
            acc[21 + a] += w * (J[0][a] * r0 + J[1][a] * r1 + J[2][a] * r2);
          else
            acc[21 + a] += w * (J[0][a] * r0 + J[1][a] * r1);
        }
        acc[27] += rho(chi2, delta, huber);
      }
      block_sum(acc, s_red);
      if (threadIdx.x == 0) {
        float A[36], rhs[6], xi[6];
        int k = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b) {
            A[6 * a + b] = acc[k];
            A[6 * b + a] = acc[k];
            ++k;
          }
        for (int a = 0; a < 6; ++a) {
          A[7 * a] += lam * A[7 * a] + 1e-9f;
          rhs[a] = -acc[21 + a];
        }
        solve6(A, rhs, xi);
        float dR[9], dt[3];
        se3_exp(xi, dR, dt);
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j)
            s_Rn[3 * i + j] = R[3 * i] * dR[j] + R[3 * i + 1] * dR[3 + j] + R[3 * i + 2] * dR[6 + j];
          s_tn[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];
        }
      }
      __syncthreads();
      float c_new[1] = {0.f};
      float Rn[9], tn[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) Rn[k] = s_Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) tn[k] = s_tn[k];
      for (int i = threadIdx.x; i < N; i += kThreads) {
        if (!s_active[i]) continue;
        const bool ok = Vd[i];
        const float p[3] = {ok ? P[3 * i] : 0.f, ok ? P[3 * i + 1] : 0.f, ok ? P[3 * i + 2] : 1.f};
        float x, y, z, r0, r1, r2, delta;
        const float chi2 = residual<kStereo>(Rn, tn, p, O + 2 * i, kStereo ? UR[i] : -1.f, S[i],
                                             cam, bf, x, y, z, r0, r1, r2, delta);
        c_new[0] += rho(chi2, delta, huber);
      }
      block_sum(c_new, s_red);
      const bool better = c_new[0] < acc[27];
      if (threadIdx.x == 0 && better) {
        for (int k = 0; k < 9; ++k) s_R[k] = s_Rn[k];
        for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
      }
      lam = better ? lam * 0.5f : lam * 4.f;
      __syncthreads();
    }
    // chi2 re-classification for the next round
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const bool ok = Vd[i];
      const float p[3] = {ok ? P[3 * i] : 0.f, ok ? P[3 * i + 1] : 0.f, ok ? P[3 * i + 2] : 1.f};
      const float ur = kStereo ? UR[i] : -1.f;
      float x, y, z, r0, r1, r2, delta;
      const float chi2 = residual<kStereo>(R, t, p, O + 2 * i, ur, S[i], cam, bf, x, y, z, r0,
                                           r1, r2, delta);
      s_active[i] = ok && chi2 <= (kStereo && ur >= 0.f ? kChi2Stereo : kChi2);
    }
    __syncthreads();
  }

  // outputs: orthonormalized R, t, inliers and their count
  int cnt = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    inl_out[(size_t)bi * N + i] = s_active[i];
    cnt += s_active[i];
  }
  float c[1] = {(float)cnt};
  block_sum(c, s_red);
  if (threadIdx.x == 0) {
    float R[9];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int rep = 0; rep < 2; ++rep) {
      float RtR[9], M[9], Rn[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          RtR[3 * i + j] = R[i] * R[j] + R[3 + i] * R[3 + j] + R[6 + i] * R[6 + j];
      for (int k = 0; k < 9; ++k) M[k] = ((k % 4 == 0) ? 1.5f : 0.f) - 0.5f * RtR[k];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          Rn[3 * i + j] = R[3 * i] * M[j] + R[3 * i + 1] * M[3 + j] + R[3 * i + 2] * M[6 + j];
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
    for (int k = 0; k < 9; ++k) R_out[bi * 9 + k] = R[k];
    for (int k = 0; k < 3; ++k) t_out[bi * 3 + k] = s_t[k];
    n_inl_out[bi] = (int)c[0];
  }
}

template <bool kStereo, class C>
int launch(const void* R0, const void* t0, const void* pts, const void* obs, const void* obs_ur,
           const void* isig, const void* valid, int B, int N, C cam, float bf, int n_rounds,
           int n_iters, void* R, void* t, void* inliers, void* n_inliers, cudaStream_t stream) {
  const int smem = N;  // one active flag per observation
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pose_lm_kernel<kStereo, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  pose_lm_kernel<kStereo, C><<<B, kThreads, smem, stream>>>(
      (const float*)R0, (const float*)t0, (const float*)pts, (const float*)obs,
      (const float*)obs_ur, (const float*)isig, (const bool*)valid, N, cam, bf, n_rounds,
      n_iters, (float*)R, (float*)t, (bool*)inliers, (int*)n_inliers);
  return (int)cudaGetLastError();
}

}  // namespace

// obs_ur null: mono problems; else (B, N) right-image u per observation (< 0: mono edge).
// kb8 null: the pinhole camera; else a host array k1..k4 of the KB8 camera (mono only).
extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* pts,
                              const void* obs, const void* obs_ur, const void* isig,
                              const void* valid, int B, int N, float fx, float fy, float cx,
                              float cy, const float* kb8, float bf, int n_rounds, int n_iters,
                              void* R, void* t, void* inliers, void* n_inliers, void* stream) {
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (kb8 != nullptr && obs_ur != nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const Cam cam{fx, fy, cx, cy};
  cudaStream_t s = (cudaStream_t)stream;
  if (kb8 != nullptr)
    return launch<false>(R0, t0, pts, obs, obs_ur, isig, valid, B, N,
                         CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, bf, n_rounds,
                         n_iters, R, t, inliers, n_inliers, s);
  if (obs_ur == nullptr)
    return launch<false>(R0, t0, pts, obs, obs_ur, isig, valid, B, N, cam, bf, n_rounds, n_iters,
                         R, t, inliers, n_inliers, s);
  return launch<true>(R0, t0, pts, obs, obs_ur, isig, valid, B, N, cam, bf, n_rounds, n_iters, R,
                      t, inliers, n_inliers, s);
}
