// K22 pose_inertial: the tracking-time visual-inertial state solves, one CTA
// per problem, templated on `joint`.
//
// Replaces extractorb_tpu/solver/inertial.py:optimize_pose_inertial
// (joint = false: Gauss-Newton on the frame's 15-dim state, one inertial
// edge to the fixed previous state) and optimize_pose_inertial_last_frame
// with solver/marginal.py:marginalize inside it (joint = true: the previous
// and the current state solved together, the previous one anchored by its
// prior, then marginalised out of the 30x30 Hessian into the next prior).
// The TPU runs each as a lax.scan of 4 chi2 rounds x 10 iterations over
// jacfwd Jacobians of every residual.  Here, per iteration:
//   - every thread sums the 6x6 + 6 normal equations of its visual unary
//     edges (Jacobians on the current pose, imu_t.cuh vis_rj, through the
//     camera template parameter: the pinhole's closed form or CamKB8's
//     Dual<3> projection Jacobian; Huber in the first three rounds), and the
//     block reduces them in a fixed order;
//   - one thread each takes the inertial edge's Jacobian wrt the current
//     state and (joint) wrt the previous state, and the prior residual's, by
//     Dual<15> forward passes of imu_t.cuh's residuals;
//   - the CTA assembles the 15x15 or 30x30 system and warp 0 solves
//     (H + 1e-8 I) d = -b by Gaussian elimination with partial pivoting.
// The prior's square root enters as Lp Lp^T = V diag(clip(w, 0, 1e7)) V^T of
// a float64 Jacobi eigendecomposition of the symmetrised prior (the JAX
// module's eigh, inertial.py:719-730).  The marginalisation takes the
// pseudo-inverse of the previous-state block by the same eigendecomposition
// (|lambda| > 1e-6), in float64, and symmetrises the result.
//
// Bound on the H100: latency.  ~1000-2000 points and 40 dependent
// iterations of a block reduction, a serial forward pass and a 30x30 solve;
// the arithmetic is microseconds per iteration.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kChi2 = 5.991f;

#include "dual.cuh"
#include "lie_t.cuh"
#include "imu_t.cuh"
#include "small_linalg.cuh"
#include "ba_obs.cuh"
#include "det_reduce.cuh"

// the packed input of inertial.py:_pose_inertial_launch
struct In {
  const float* cur;    // 21: R 9, t 3, v 3, bg 3, ba 3
  const float* prev;   // 21
  const float* Hp;     // 225 prior information (joint)
  const float* prs;    // 21 prior state (joint)
  const float* pk;     // 292 preintegration
  const float* Rcb;    // 9
  const float* tcb;    // 3
};

__device__ In unpack(const float* s) {
  In in;
  in.cur = s;
  in.prev = s + 21;
  in.Hp = s + 42;
  in.prs = s + 267;
  in.pk = s + 288;
  in.Rcb = s + 580;
  in.tcb = s + 589;
  return in;
}

// the prior's raw residual at the previous state moved by d
template <class T>
__device__ void prior_raw(const float* prev, const float* prs, const T* d, T* r) {
  St<T> P;
  apply_delta_t(prev, d, P);
  T Rpr[9], M[9];
  for (int i = 0; i < 9; ++i) Rpr[i] = cst<T>(prs[i]);
  matT_mul(Rpr, P.R, M);
  so3_log_t(M, r);
  T dt[3], o[3];
  for (int i = 0; i < 3; ++i) dt[i] = P.t[i] - prs[9 + i];
  matT_vec(Rpr, dt, o);
  for (int i = 0; i < 3; ++i) {
    r[3 + i] = o[i];
    r[6 + i] = P.v[i] - prs[12 + i];
    r[9 + i] = P.bg[i] - prs[15 + i];
    r[12 + i] = P.ba[i] - prs[18 + i];
  }
}

// residual (15) and Jacobian (15x15, row-major) of the inertial edge wrt the
// previous (which = 0) or the current (1) state
__device__ void edge_jac(const float* prev, const float* cur, const Pk& pk, const float* Lr,
                         const float* Lb, int which, float* r, float* J) {
  D15 d0[15], d1[15];
  for (int a = 0; a < 15; ++a) {
    d0[a] = dconst<15, float>(0.f);
    d1[a] = dconst<15, float>(0.f);
    (which == 0 ? d0 : d1)[a].d[a] = 1.f;
  }
  St<D15> A, B;
  apply_delta_t(prev, d0, A);
  apply_delta_t(cur, d1, B);
  D15 rr[15];
  edge_r15(pk, Lr, Lb, A, B, rr);
  for (int a = 0; a < 15; ++a) {
    r[a] = rr[a].v;
    for (int b = 0; b < 15; ++b) J[15 * a + b] = rr[a].d[b];
  }
}

__device__ void prior_jac(const float* prev, const float* prs, float* r, float* J) {
  D15 d[15], rr[15];
  for (int a = 0; a < 15; ++a) {
    d[a] = dconst<15, float>(0.f);
    d[a].d[a] = 1.f;
  }
  prior_raw(prev, prs, d, rr);
  for (int a = 0; a < 15; ++a) {
    r[a] = rr[a].v;
    for (int b = 0; b < 15; ++b) J[15 * a + b] = rr[a].d[b];
  }
}

// S = V diag(f(w)) V^T of the symmetric 15x15 A (float64 Jacobi): f clamps
// to [0, 1e7] (mode 0, the prior's square-root product) or inverts |w| >
// 1e-6 (mode 1, the pseudo-inverse)
__device__ void eig_apply(const double* A, int mode, double* S) {
  double E[225], V[225];
  for (int i = 0; i < 225; ++i) E[i] = A[i];
  jacobi_eig<15>(E, V);
  double f[15];
  for (int i = 0; i < 15; ++i) {
    const double wv = E[16 * i];
    f[i] = mode == 0 ? fmin(fmax(wv, 0.0), 1e7) : (fabs(wv) > 1e-6 ? 1.0 / wv : 0.0);
  }
  for (int r = 0; r < 15; ++r)
    for (int c = 0; c < 15; ++c) {
      double s = 0.0;
      for (int k = 0; k < 15; ++k) s += V[15 * r + k] * f[k] * V[15 * c + k];
      S[15 * r + c] = s;
    }
}

struct Sh {
  float cur[21], prev[21], prs[21], pk[kPk], Rcb[9], tcb[3];
  float Lr[81], Lb[36], Hc[225];
  float re[15], Jc[225], Jpv[225];   // edge residual, Jacobians wrt current / previous
  float rp[15], Jpr[225], HJ[225], Hr[15];   // prior raw residual, its Jacobian, Hc J, Hc r
  float A[30 * 31];                  // augmented system
  float vis[27];
  float d[30];
  float red[27 * kThreads / 32];
};

template <bool joint>
__device__ void assemble(Sh& s, bool with_b) {
  constexpr int n = joint ? 30 : 15;
  constexpr int oc = joint ? 15 : 0;   // the current state's offset
  if (joint) {  // Hc J and Hc r of the prior (previous-state dims)
    for (int e = threadIdx.x; e < 225 + 15; e += kThreads) {
      if (e < 225) {
        const int k = e / 15, b = e % 15;
        float acc = 0.f;
        for (int l = 0; l < 15; ++l) acc += s.Hc[15 * k + l] * s.Jpr[15 * l + b];
        s.HJ[e] = acc;
      } else {
        const int k = e - 225;
        float acc = 0.f;
        for (int l = 0; l < 15; ++l) acc += s.Hc[15 * k + l] * s.rp[l];
        s.Hr[k] = acc;
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n * (n + 1); e += kThreads) {
    const int a = e / (n + 1), b = e % (n + 1);
    const bool ca = a >= oc, cb = b >= oc && b < n;
    const int la = a - (ca ? oc : 0), lb = b - (cb ? oc : 0);
    float v = 0.f;
    if (b == n) {  // -b
      if (!with_b) continue;
      if (ca && la < 6) v += s.vis[la];
      const float* Ja = ca ? s.Jc : s.Jpv;
      float acc = 0.f;
      for (int r = 0; r < 15; ++r) acc += Ja[15 * r + la] * s.re[r];
      v += acc;
      if (joint && !ca) {
        float pr = 0.f;
        for (int l = 0; l < 15; ++l) pr += s.Jpr[15 * l + la] * s.Hr[l];
        v += pr;
      }
      s.A[(n + 1) * a + n] = -v;
      continue;
    }
    if (ca && cb && la < 6 && lb < 6) {
      const int lo = la < lb ? la : lb, hi = la < lb ? lb : la;
      v += s.vis[6 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
    }
    const float* Ja = ca ? s.Jc : s.Jpv;
    const float* Jb = cb ? s.Jc : s.Jpv;
    float acc = 0.f;
    for (int r = 0; r < 15; ++r) acc += Ja[15 * r + la] * Jb[15 * r + lb];
    v += acc;
    if (joint && !ca && !cb) {
      float pr = 0.f;
      for (int l = 0; l < 15; ++l) pr += s.Jpr[15 * l + la] * s.HJ[15 * l + lb];
      v += pr;
    }
    s.A[(n + 1) * a + b] = v;
  }
}

// warp 0: (A + 1e-8 I) d = rhs, Gaussian elimination with partial pivoting
template <int n>
__device__ void solve_warp(Sh& s) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float* A = s.A;
  constexpr int m = n + 1;
  for (int i = lane; i < n; i += 32) A[m * i + i] += 1e-8f;
  __syncwarp();
  for (int c = 0; c < n; ++c) {
    int piv = c;
    if (lane == 0) {
      for (int r = c + 1; r < n; ++r)
        if (fabsf(A[m * r + c]) > fabsf(A[m * piv + c])) piv = r;
    }
    piv = __shfl_sync(0xffffffffu, piv, 0);
    if (piv != c)
      for (int k = lane; k < m; k += 32) {
        const float t = A[m * c + k];
        A[m * c + k] = A[m * piv + k];
        A[m * piv + k] = t;
      }
    __syncwarp();
    for (int r = c + 1 + lane; r < n; r += 32) {
      const float f = A[m * r + c] / A[m * c + c];
      for (int k = c; k < m; ++k) A[m * r + k] -= f * A[m * c + k];
    }
    __syncwarp();
  }
  if (lane == 0)
    for (int r = n - 1; r >= 0; --r) {
      float acc = A[m * r + n];
      for (int k = r + 1; k < n; ++k) acc -= A[m * r + k] * s.d[k];
      s.d[r] = acc / A[m * r + r];
    }
  __syncwarp();
}

__device__ void apply_to(float* S, const float* d) {
  St<float> o;
  apply_delta_t(S, d, o);
  for (int i = 0; i < 9; ++i) S[i] = o.R[i];
  for (int i = 0; i < 3; ++i) {
    S[9 + i] = o.t[i];
    S[12 + i] = o.v[i];
    S[15 + i] = o.bg[i];
    S[18 + i] = o.ba[i];
  }
}

// the 27 visual sums of this thread's points at the current state into s.vis
template <class C>
__device__ void visual_sums(Sh& s, const float* pts, const float* uv, const float* isig,
                            const bool* active, int N, bool huber, const C& cam) {
  float v[27];
  for (int i = 0; i < 27; ++i) v[i] = 0.f;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    if (!active[i]) continue;
    float r[2], Jp[2][6];
    vis_rj(s.cur, s.cur + 9, pts + 3 * i, uv + 2 * i, s.Rcb, s.tcb, cam, r, Jp, nullptr);
    const float is = isig[i];
    const float chi2 = (r[0] * r[0] + r[1] * r[1]) * is;
    const float wt = (huber ? fminf(huber_delta() / sqrtf(fmaxf(chi2, 1e-12f)), 1.f) : 1.f) * is;
    int n = 6;
    for (int a = 0; a < 6; ++a) {
      v[a] += wt * (Jp[0][a] * r[0] + Jp[1][a] * r[1]);
      for (int b = a; b < 6; ++b) v[n++] += wt * (Jp[0][a] * Jp[0][b] + Jp[1][a] * Jp[1][b]);
    }
  }
  block_sum_fixed<27>(v, s.red);
  if (threadIdx.x == 0)
    for (int i = 0; i < 27; ++i) s.vis[i] = v[i];
}

// the inertial edge's (and, joint, the prior's) residuals and Jacobians
template <bool joint>
__device__ void inertial_terms(Sh& s) {
  const Pk pk{s.pk};
  if (threadIdx.x == 0) edge_jac(s.prev, s.cur, pk, s.Lr, s.Lb, 1, s.re, s.Jc);
  if (joint && threadIdx.x == 32) {
    float r[15];
    edge_jac(s.prev, s.cur, pk, s.Lr, s.Lb, 0, r, s.Jpv);
  }
  if (!joint && threadIdx.x == 32)
    for (int i = 0; i < 225; ++i) s.Jpv[i] = 0.f;
  if (joint && threadIdx.x == 64) prior_jac(s.prev, s.prs, s.rp, s.Jpr);
}

template <bool joint, class C>
__global__ void __launch_bounds__(kThreads)
pose_inertial_kernel(const float* __restrict__ state, const float* __restrict__ pts,
                     const float* __restrict__ uv, const float* __restrict__ isig,
                     const bool* __restrict__ valid, int N, const C cam, int n_rounds,
                     int n_iters, float* __restrict__ out, bool* __restrict__ active,
                     int* __restrict__ n_inl) {
  constexpr int n = joint ? 30 : 15;
  __shared__ Sh s;
  const In in = unpack(state);
  for (int i = threadIdx.x; i < kPk; i += kThreads) s.pk[i] = in.pk[i];
  if (threadIdx.x < 21) {
    s.cur[threadIdx.x] = in.cur[threadIdx.x];
    s.prev[threadIdx.x] = in.prev[threadIdx.x];
    s.prs[threadIdx.x] = in.prs[threadIdx.x];
  }
  if (threadIdx.x < 9) s.Rcb[threadIdx.x] = in.Rcb[threadIdx.x];
  if (threadIdx.x < 3) s.tcb[threadIdx.x] = in.tcb[threadIdx.x];
  for (int i = threadIdx.x; i < N; i += kThreads) active[i] = valid[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    info_sqrt_blk<9>(s.pk + 61, 0, s.Lr);
    info_sqrt_blk<6>(s.pk + 61, 9, s.Lb);
  }
  if (joint && threadIdx.x == 32) {
    double A[225], S[225];
    for (int r = 0; r < 15; ++r)
      for (int c = 0; c < 15; ++c) A[15 * r + c] = 0.5 * ((double)in.Hp[15 * r + c] + in.Hp[15 * c + r]);
    eig_apply(A, 0, S);
    for (int i = 0; i < 225; ++i) s.Hc[i] = (float)S[i];
  }
  __syncthreads();
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < n_rounds - 1;
    for (int it = 0; it < n_iters; ++it) {
      visual_sums(s, pts, uv, isig, active, N, huber, cam);
      inertial_terms<joint>(s);
      __syncthreads();
      assemble<joint>(s, true);
      __syncthreads();
      solve_warp<n>(s);
      __syncthreads();
      if (threadIdx.x == 0) {
        if (joint) apply_to(s.prev, s.d);
        apply_to(s.cur, s.d + (joint ? 15 : 0));
      }
      __syncthreads();
    }
    // re-classify on the raw points
    for (int i = threadIdx.x; i < N; i += kThreads) {
      float r[2];
      vis_rj(s.cur, s.cur + 9, pts + 3 * i, uv + 2 * i, s.Rcb, s.tcb, cam, r, nullptr,
             nullptr);
      active[i] = valid[i] && (r[0] * r[0] + r[1] * r[1]) * isig[i] <= kChi2;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    orthonormalize3(s.cur);
    if (joint) orthonormalize3(s.prev);
  }
  __syncthreads();
  // the final Hessian: visual weights isig (no Huber) on the inliers
  visual_sums(s, pts, uv, isig, active, N, false, cam);
  inertial_terms<joint>(s);
  __syncthreads();
  assemble<joint>(s, false);
  {
    float c = 0.f;
    for (int i = threadIdx.x; i < N; i += kThreads) c += active[i] ? 1.f : 0.f;
    float cc[1] = {c};
    block_sum_fixed<1>(cc, s.red);
    if (threadIdx.x == 0) *n_inl = (int)cc[0];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 21; ++i) out[i] = s.cur[i];
    float* H = out + 21;
    constexpr int m = n + 1;
    if (!joint) {
      for (int r = 0; r < 15; ++r)
        for (int c = 0; c < 15; ++c) H[15 * r + c] = s.A[m * r + c];
    } else {
      // H_cc - H_cp pinv(H_pp) H_pc, pinv by eigh (|lambda| > 1e-6)
      double Hpp[225], Pi[225], T[225];
      for (int r = 0; r < 15; ++r)
        for (int c = 0; c < 15; ++c) Hpp[15 * r + c] = s.A[m * r + c];
      eig_apply(Hpp, 1, Pi);
      for (int r = 0; r < 15; ++r)      // T = pinv(H_pp) H_pc
        for (int c = 0; c < 15; ++c) {
          double acc = 0.0;
          for (int k = 0; k < 15; ++k) acc += Pi[15 * r + k] * s.A[m * k + 15 + c];
          T[15 * r + c] = acc;
        }
      double M[225];
      for (int r = 0; r < 15; ++r)
        for (int c = 0; c < 15; ++c) {
          double acc = 0.0;
          for (int k = 0; k < 15; ++k) acc += (double)s.A[m * (15 + r) + k] * T[15 * k + c];
          M[15 * r + c] = (double)s.A[m * (15 + r) + 15 + c] - acc;
        }
      for (int r = 0; r < 15; ++r)
        for (int c = 0; c < 15; ++c) H[15 * r + c] = (float)(0.5 * (M[15 * r + c] + M[15 * c + r]));
    }
  }
}

template <bool joint, class C>
int launch(const void* state, const void* pts, const void* uv, const void* isig,
           const void* valid, int N, const C& cam, int n_rounds, int n_iters, void* out,
           void* inliers, void* n_inl, cudaStream_t st) {
  pose_inertial_kernel<joint, C><<<1, kThreads, 0, st>>>(
      (const float*)state, (const float*)pts, (const float*)uv, (const float*)isig,
      (const bool*)valid, N, cam, n_rounds, n_iters, (float*)out, (bool*)inliers, (int*)n_inl);
  return (int)cudaGetLastError();
}

template <class C>
int launch(bool joint, const void* state, const void* pts, const void* uv, const void* isig,
           const void* valid, int N, const C& cam, int n_rounds, int n_iters, void* out,
           void* inliers, void* n_inl, cudaStream_t st) {
  return joint ? launch<true>(state, pts, uv, isig, valid, N, cam, n_rounds, n_iters, out,
                              inliers, n_inl, st)
               : launch<false>(state, pts, uv, isig, valid, N, cam, n_rounds, n_iters, out,
                               inliers, n_inl, st);
}

}  // namespace

// state: the packed problem (592 floats: cur 21, prev 21, prior H 225, prior
// state 21, preintegration 292, Rcb 9, tcb 3); pts (N,3), uv (N,2), isig (N,),
// valid (N,); kb8 null: the pinhole camera, else a host array k1..k4 of the
// KB8 camera; out: the current state 21 then H 225; inliers (N,), n_inl ()
extern "C" int pose_inertial_launch(const void* state, const void* pts, const void* uv,
                                    const void* isig, const void* valid, int N, float fx,
                                    float fy, float cx, float cy, const float* kb8, int joint,
                                    int n_rounds, int n_iters, void* out, void* inliers,
                                    void* n_inl, void* stream) {
  if (N <= 0 || n_rounds < 1 || n_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kb8 != nullptr)
    return launch(joint != 0, state, pts, uv, isig, valid, N,
                  CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_rounds, n_iters, out,
                  inliers, n_inl, st);
  return launch(joint != 0, state, pts, uv, isig, valid, N, Cam{fx, fy, cx, cy}, n_rounds,
                n_iters, out, inliers, n_inl, st);
}
