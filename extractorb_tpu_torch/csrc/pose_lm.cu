// K4 pose_lm: the reference's 4 x 10 robust Levenberg-Marquardt pose
// optimisation (mono reprojection edges, and the stereo edge's third row),
// one CTA per problem.
//
// Replaces extractorb_tpu/solver/pose_opt.py:optimize_pose, which the TPU
// runs as a lax.scan over jacfwd Jacobians and masked MXU einsums.  Here the
// Jacobians are analytic (right perturbation R Exp(delta), delta = (rho, phi):
// d pc = [R | -R hat(p)] delta), each thread accumulates the 21 + 6 sums of
// the normal equations and the cost over its observations, the block reduces
// them, and warp 0 solves (H + lambda diag H + 1e-9 I) delta = -b by
// Gaussian elimination with partial pivoting (a lane a column of [A | -b]),
// applies Exp(delta) and keeps the
// step only if the cost fell strictly (lambda x0.5, else x4; lambda starts at
// 1e-3 in every round).  Between rounds the chi2 test re-classifies inliers;
// round 3 drops the Huber kernel.  Padded slots are projected at a safe point
// (0, 0, 1) so they stay finite.  The output rotation is re-orthonormalized
// with two Newton-Schulz steps, as lie.orthonormalize does.
//
// One pass over the observations and one block reduction per LM step: the
// problem (points, pixels, inverse sigmas, the stereo u and the flags, 26
// or 30 bytes an observation) is staged once in shared memory, and the
// candidate's pass sums the normal equations at the candidate besides its
// cost.  An accepted step makes those the next step's system; a rejected
// one keeps the held sums, as the pose did not move.  A round's chi2
// re-classification is the next round's first linearisation, observation by
// observation in the thread that owns it.  Every sum is the same arithmetic
// in the same thread and the same order as a linearisation at the step's
// start would take, so the result is the same as relinearising every step:
// 1 + n_rounds n_iters + n_rounds passes a call.  A problem larger than a
// CTA's shared memory holds (pose_lm_max_n) takes the global route: the
// same kernel (kGlobal) stages it in the problem's slice of a workspace in
// device memory instead (pose_lm_global_bytes an observation block), and
// every pass reads it from there (L1 and L2 keep most of it); its values
// are the staged route's, bit for bit.
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
// Bound on the H100: latency.  ~1100 observations and 40 iterations of a
// pass and a block reduction each are a few microseconds of arithmetic per
// iteration; the chain of dependent passes, reductions and 6x6 solves sets
// the time (chip_anatomy.py stamps the phases).  A batch of problems runs as parallel CTAs (the fused step
// batches its motion and reference-keyframe branches).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "dual.cuh"
#include "camera_t.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // 21 (upper H) + 6 (b) + 1 (cost)
constexpr float kChi2 = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr int kMaxDevices = 64;

// the phase kinds of chip_anatomy.py's build, which stamps clock64() per
// phase in CTA 0's thread 0; nothing otherwise
#ifndef K4_STAMP
#define K4_STAMP(kind)
#endif
enum Phase : int { kLin = 0, kReduce, kSolve, kCand, kClassify, kPhases };

// sum `n` per-thread values across the block; every thread gets the sums.
// Thread i < n sums value i's warp partials in warp order and broadcasts it.
template <int n>
__device__ void block_sum(float (&v)[n], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  __syncthreads();  // red and out may still be read from the previous call
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < n; ++i) red[warp * n + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * n + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = out[i];
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

// the step of the damped system held in acc (21 upper H, 6 b) at lambda,
// and the candidate (Rn, tn) = (R dR, R dt + t), by warp 0: Gaussian
// elimination with partial pivoting of (H + lambda diag H + 1e-9 I) delta =
// -b on [A | rhs] in Ab, lane j <= 6 owning column j (each row's factor
// read before column c changes), then the back substitution, Exp(delta)
// and the composition on lane 0.  Every value takes the one-thread
// elimination's operations in its order.  All lanes of warp 0 call it.
__device__ void solve_step(const float* acc, float lam, float (*Ab)[8], const float* R,
                           const float* t, float* Rn, float* tn) {
  const int lane = threadIdx.x;
  for (int l = lane; l < 36; l += 32) {
    const int a = l / 6, b = l % 6;
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    float v = acc[6 * lo - lo * (lo - 1) / 2 + (hi - lo)];
    if (a == b) v += lam * v + 1e-9f;
    Ab[a][b] = v;
  }
  if (lane < 6) Ab[lane][6] = -acc[21 + lane];
  __syncwarp();
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(Ab[c][c]);
    for (int r = c + 1; r < 6; ++r) {
      const float v = fabsf(Ab[r][c]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    __syncwarp();
    if (piv != c && lane < 7) {
      const float tmp = Ab[c][lane];
      Ab[c][lane] = Ab[piv][lane];
      Ab[piv][lane] = tmp;
    }
    __syncwarp();
    float f[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) f[r] = r > c ? Ab[r][c] / Ab[c][c] : 0.f;
    __syncwarp();
    if (lane >= c && lane < 7) {
      const float top = Ab[c][lane];
#pragma unroll
      for (int r = 0; r < 6; ++r)
        if (r > c) Ab[r][lane] -= f[r] * top;
    }
    __syncwarp();
  }
  if (lane != 0) return;
  float xi[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = Ab[r][6];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) s -= Ab[r][k] * xi[k];
    xi[r] = s / Ab[r][r];
  }
  float dR[9], dt[3];
  se3_exp(xi, dR, dt);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = R[3 * i] * dR[j] + R[3 * i + 1] * dR[3 + j] + R[3 * i + 2] * dR[6 + j];
    tn[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];
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


// the problem of one CTA, staged in dynamic shared memory: the points (a
// padded slot at (0, 0, 1)), pixels, inverse sigmas, the stereo u, and the
// valid and active flags
template <bool kStereo>
struct Stage {
  float* p;    // (N,3)
  float* o;    // (N,2)
  float* is;   // (N,)
  float* ur;   // (N,), stereo only
  bool* valid;
  bool* active;

  static constexpr int kBytes = 26 + (kStereo ? 4 : 0);  // an observation
  __device__ Stage(void* base, int N) {
    p = static_cast<float*>(base);
    o = p + 3 * N;
    is = o + 2 * N;
    ur = is + N;
    valid = reinterpret_cast<bool*>(ur + (kStereo ? N : 0));
    active = valid + N;
  }
};

// observation i's terms of the normal equations at (R, t): its weighted
// Jacobian products into acc[0, 27), its robust cost into acc[27]
template <bool kStereo, class C>
__device__ __forceinline__ void accumulate(const float* R, const float* p, float ur, float is,
                                           const C& cam, float bf, bool huber, float x, float y,
                                           float z, float r0, float r1, float r2, float delta,
                                           float chi2, float* acc) {
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

// one pass over the thread's observations at (R, t).  classify: every
// observation is re-classified first (active = valid and chi2 under the
// gate), as between two rounds; then each active one adds its terms (sums:
// all of them, else its cost only) to acc.  out: the last round's
// inliers, their count into acc[0].
template <bool kStereo, class C>
__device__ void pass(const Stage<kStereo>& st, int N, const float* R, const float* t,
                     const C& cam, float bf, bool huber, bool classify, bool sums, bool* out,
                     float* acc) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    if (!classify && !st.active[i]) continue;
    const float* p = st.p + 3 * i;
    const float ur = kStereo ? st.ur[i] : -1.f;
    float x, y, z, r0, r1, r2, delta;
    const float chi2 = residual<kStereo>(R, t, p, st.o + 2 * i, ur, st.is[i], cam, bf, x, y, z,
                                         r0, r1, r2, delta);
    if (classify) {
      const bool act = st.valid[i] && chi2 <= (kStereo && ur >= 0.f ? kChi2Stereo : kChi2);
      st.active[i] = act;
      if (out != nullptr) {
        out[i] = act;
        acc[0] += (float)act;
        continue;
      }
      if (!act) continue;
    }
    if (sums)
      accumulate<kStereo>(R, p, ur, st.is[i], cam, bf, huber, x, y, z, r0, r1, r2, delta, chi2,
                          acc);
    else
      acc[27] += rho(chi2, delta, huber);
  }
}

// the bytes of one problem's stage in the global route's workspace
template <bool kStereo>
__host__ __device__ size_t global_stride(int N) {
  return ((size_t)N * Stage<kStereo>::kBytes + 15) / 16 * 16;
}

// kGlobal: the problem is staged in ws (global_stride bytes a problem), else
// in dynamic shared memory
template <bool kStereo, class C, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
               const float* __restrict__ pts_w, const float* __restrict__ obs,
               const float* __restrict__ obs_ur, const float* __restrict__ isig,
               const bool* __restrict__ valid, int N, const C cam, float bf, int n_rounds,
               int n_iters, float* __restrict__ R_out, float* __restrict__ t_out,
               bool* __restrict__ inl_out, int* __restrict__ n_inl_out, uint8_t* ws) {
  __shared__ float s_R[9], s_t[3], s_Rn[9], s_tn[3];
  __shared__ float s_red[kWarps * kSums];
  __shared__ float s_sum[kSums];
  __shared__ float s_acc[kSums];    // the held system, as acc
  __shared__ float s_Ab[6][8];      // the step's [A | rhs]
  extern __shared__ float4 s_raw[];
  const int bi = blockIdx.x;
  const Stage<kStereo> st(kGlobal ? static_cast<void*>(ws + bi * global_stride<kStereo>(N))
                                  : static_cast<void*>(s_raw), N);
  K4_STAMP(kPhases);  // the start

  {
    const float* P = pts_w + (size_t)bi * N * 3;
    const float* O = obs + (size_t)bi * N * 2;
    const float* S = isig + (size_t)bi * N;
    const bool* Vd = valid + (size_t)bi * N;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const bool ok = Vd[i];
      st.p[3 * i] = ok ? P[3 * i] : 0.f;
      st.p[3 * i + 1] = ok ? P[3 * i + 1] : 0.f;
      st.p[3 * i + 2] = ok ? P[3 * i + 2] : 1.f;
      st.o[2 * i] = O[2 * i];
      st.o[2 * i + 1] = O[2 * i + 1];
      st.is[i] = S[i];
      if (kStereo) st.ur[i] = obs_ur[(size_t)bi * N + i];
      st.valid[i] = ok;
      st.active[i] = ok;
    }
  }
  if (threadIdx.x < 9) s_R[threadIdx.x] = R0[bi * 9 + threadIdx.x];
  if (threadIdx.x < 3) s_t[threadIdx.x] = t0[bi * 3 + threadIdx.x];
  __syncthreads();

  // the held system: the block sums at the pose (s_R, s_t)
  float acc[kSums];
  {
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    pass(st, N, R, t, cam, bf, true, false, true, nullptr, acc);
    K4_STAMP(kLin);
    block_sum(acc, s_red, s_acc);
    K4_STAMP(kReduce);
  }

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < 3;
    float lam = 1e-3f;  // kept identical in every thread
    for (int it = 0; it < n_iters; ++it) {
      if (threadIdx.x < 32) solve_step(s_acc, lam, s_Ab, s_R, s_t, s_Rn, s_tn);
      K4_STAMP(kSolve);
      __syncthreads();
      // the candidate's cost and, unless the round ends here, its system
      const bool sums = it + 1 < n_iters;
      float cand[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) cand[k] = 0.f;
      float Rn[9], tn[3];
      for (int k = 0; k < 9; ++k) Rn[k] = s_Rn[k];
      for (int k = 0; k < 3; ++k) tn[k] = s_tn[k];
      pass(st, N, Rn, tn, cam, bf, huber, false, sums, nullptr, cand);
      K4_STAMP(kCand);
      block_sum(cand, s_red, s_sum);
      K4_STAMP(kReduce);
      const bool better = cand[27] < acc[27];
      if (better) {
        if (threadIdx.x == 0) {
          for (int k = 0; k < 9; ++k) s_R[k] = s_Rn[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_tn[k];
        }
        if (threadIdx.x < kSums) s_acc[threadIdx.x] = s_sum[threadIdx.x];
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = cand[k];
      }
      lam = better ? lam * 0.5f : lam * 4.f;
      __syncthreads();
    }
    // the chi2 re-classification; before another round, its first
    // linearisation with the new inliers; after the last, the outputs
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    const bool more = rnd + 1 < n_rounds;
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    pass(st, N, R, t, cam, bf, rnd + 1 < 3, true, true,
         more ? nullptr : inl_out + (size_t)bi * N, acc);
    K4_STAMP(kClassify);
    if (more) {
      block_sum(acc, s_red, s_acc);
      K4_STAMP(kReduce);
    }
  }

  // outputs: orthonormalized R, t, inliers and their count
  float c[1] = {0.f};
  if (n_rounds > 0) {
    c[0] = acc[0];
  } else {
    for (int i = threadIdx.x; i < N; i += kThreads) {
      inl_out[(size_t)bi * N + i] = st.active[i];
      c[0] += (float)st.active[i];
    }
  }
  block_sum(c, s_red, s_sum);
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
  K4_STAMP(kPhases);
}

// the largest N a CTA of pose_lm_kernel<kStereo, C, false> can stage on the
// current device, or -1 on an error; asked of the CUDA runtime once per device,
// which also raises the kernel's dynamic shared memory limit to that N's
template <bool kStereo, class C>
int max_n() {
  static int cached[kMaxDevices] = {};   // the answer + 1, 0 before the first call
  int dev, optin;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  if (cached[dev] > 0) return cached[dev] - 1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&fa, pose_lm_kernel<kStereo, C, false>) != cudaSuccess)
    return -1;
  const int n = (optin - (int)fa.sharedSizeBytes) / Stage<kStereo>::kBytes;
  if (cudaFuncSetAttribute(pose_lm_kernel<kStereo, C, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           n * Stage<kStereo>::kBytes) != cudaSuccess)
    return -1;
  cached[dev] = n + 1;
  return n;
}

// the staged route where N fits a CTA's shared memory and `global` is
// false, else the global route on ws (B global_stride bytes; null: refused)
template <bool kStereo, class C>
int launch(const void* R0, const void* t0, const void* pts, const void* obs, const void* obs_ur,
           const void* isig, const void* valid, int B, int N, C cam, float bf, int n_rounds,
           int n_iters, void* R, void* t, void* inliers, void* n_inliers, void* ws, bool global,
           cudaStream_t stream) {
  const int limit = max_n<kStereo, C>();
  if (limit < 0) return (int)cudaErrorInvalidValue;
  if (!global && N <= limit) {
    const int smem = N * Stage<kStereo>::kBytes;
    pose_lm_kernel<kStereo, C, false><<<B, kThreads, smem, stream>>>(
        (const float*)R0, (const float*)t0, (const float*)pts, (const float*)obs,
        (const float*)obs_ur, (const float*)isig, (const bool*)valid, N, cam, bf, n_rounds,
        n_iters, (float*)R, (float*)t, (bool*)inliers, (int*)n_inliers, nullptr);
  } else {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    pose_lm_kernel<kStereo, C, true><<<B, kThreads, 0, stream>>>(
        (const float*)R0, (const float*)t0, (const float*)pts, (const float*)obs,
        (const float*)obs_ur, (const float*)isig, (const bool*)valid, N, cam, bf, n_rounds,
        n_iters, (float*)R, (float*)t, (bool*)inliers, (int*)n_inliers, (uint8_t*)ws);
  }
  return (int)cudaGetLastError();
}

int launch_any(const void* R0, const void* t0, const void* pts, const void* obs,
               const void* obs_ur, const void* isig, const void* valid, int B, int N, float fx,
               float fy, float cx, float cy, const float* kb8, float bf, int n_rounds,
               int n_iters, void* R, void* t, void* inliers, void* n_inliers, void* ws,
               bool global, void* stream) {
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (kb8 != nullptr && obs_ur != nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const Cam cam{fx, fy, cx, cy};
  cudaStream_t s = (cudaStream_t)stream;
  if (kb8 != nullptr)
    return launch<false>(R0, t0, pts, obs, obs_ur, isig, valid, B, N,
                         CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, bf, n_rounds,
                         n_iters, R, t, inliers, n_inliers, ws, global, s);
  if (obs_ur == nullptr)
    return launch<false>(R0, t0, pts, obs, obs_ur, isig, valid, B, N, cam, bf, n_rounds, n_iters,
                         R, t, inliers, n_inliers, ws, global, s);
  return launch<true>(R0, t0, pts, obs, obs_ur, isig, valid, B, N, cam, bf, n_rounds, n_iters, R,
                      t, inliers, n_inliers, ws, global, s);
}

}  // namespace

// the largest N of one problem that a launch stages in a CTA's shared memory
// (stereo: with obs_ur) on the current device; -1 on an error
extern "C" int pose_lm_max_n(int stereo) {
  if (stereo) return max_n<true, Cam>();
  const int a = max_n<false, Cam>(), b = max_n<false, CamKB8>();
  return a < b ? a : b;
}

// the workspace bytes of B problems of N observations on the global route
// (stereo: with obs_ur)
extern "C" long long pose_lm_global_bytes(int B, int N, int stereo) {
  return (long long)B * (long long)(stereo ? global_stride<true>(N) : global_stride<false>(N));
}

// obs_ur null: mono problems; else (B, N) right-image u per observation (< 0: mono edge).
// kb8 null: the pinhole camera; else a host array k1..k4 of the KB8 camera (mono only).
// An N over pose_lm_max_n takes the global route on ws (pose_lm_global_bytes; null:
// refused with cudaErrorInvalidValue); ws is not read otherwise.
extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* pts,
                              const void* obs, const void* obs_ur, const void* isig,
                              const void* valid, int B, int N, float fx, float fy, float cx,
                              float cy, const float* kb8, float bf, int n_rounds, int n_iters,
                              void* R, void* t, void* inliers, void* n_inliers, void* ws,
                              void* stream) {
  return launch_any(R0, t0, pts, obs, obs_ur, isig, valid, B, N, fx, fy, cx, cy, kb8, bf,
                    n_rounds, n_iters, R, t, inliers, n_inliers, ws, false, stream);
}

// pose_lm_launch on the global route at any N (a test's check of the route
// against the staged one)
extern "C" int pose_lm_global_launch(const void* R0, const void* t0, const void* pts,
                                     const void* obs, const void* obs_ur, const void* isig,
                                     const void* valid, int B, int N, float fx, float fy,
                                     float cx, float cy, const float* kb8, float bf,
                                     int n_rounds, int n_iters, void* R, void* t,
                                     void* inliers, void* n_inliers, void* ws, void* stream) {
  return launch_any(R0, t0, pts, obs, obs_ur, isig, valid, B, N, fx, fy, cx, cy, kb8, bf,
                    n_rounds, n_iters, R, t, inliers, n_inliers, ws, true, stream);
}
