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
// jacfwd Jacobians of every residual.  Here, per iteration, two halves run
// side by side:
//   - warps 0-7 (the visual group, its own named barrier) sum the 6x6 + 6
//     normal equations of the visual unary edges, a thread's points i =
//     tid, tid + 256, ... (Jacobians on the current pose, imu_t.cuh vis_rj,
//     through the camera template parameter: the pinhole's closed form or
//     CamKB8's Dual<3> projection Jacobian; Huber in the first three
//     rounds), then a warp tree and the warps in order;
//   - warp 8 takes the inertial edge's Jacobians, lane l < 30 the tangent
//     l % 15 of state l / 15 (the previous, the current) as a Dual<1>
//     forward pass of imu_t.cuh's residual (legacy: lanes 0-14, the current
//     state only), as K20's edge_lin does; warp 9 the prior residual's (joint),
//     a lane a tangent.  Each lane's operations are those of its tangent in
//     a Dual<15> pass, so the Jacobians are the one-thread pass's bits.
// Then the CTA assembles the 15x15 or 30x30 system (an element a thread)
// and solves (H + 1e-8 I) d = -b by Gaussian elimination with partial
// pivoting: per column the pivot, the first row of the strictly largest
// |a|, by a max-reduction and a ballot on warp 0, then the update a row a
// warp and a column a lane; the back substitution on thread 0 with d and
// each row's operands in registers.  Per column the pivot's reduction, the
// factors' divisions and the two barriers take ~250-300 cycles each, so
// the solve is about half of a call (chip_anatomy.py k22 stamps it).
// The prior's square root enters as Lp Lp^T = V diag(clip(w, 0, 1e7)) V^T of
// a float64 Jacobi eigendecomposition of the symmetrised prior (the JAX
// module's eigh, inertial.py:719-730).  The marginalisation takes the
// pseudo-inverse of the previous-state block by the same eigendecomposition
// (|lambda| > 1e-6), in float64, and symmetrises the result.  The Jacobi
// runs on warp 0 (small_linalg.cuh jacobi_eig_warp: a lane a k of each
// rotation, in the cyclic order), and V f V^T and the marginalisation's
// 15x15x15 products an output a thread, each sum in the one-thread order.
// The problem's points, pixels, inverse sigmas and inlier flags are staged
// once in dynamic shared memory (25 bytes a point) for the 41 visual
// passes; a problem larger than a CTA's shared memory holds reads them from
// global memory instead, through the same code.  Every value keeps the
// arithmetic of the one-thread design it replaces.
//
// Bound on the H100: latency.  ~1000-2000 points and 41 dependent
// iterations of a visual pass, a forward pass and a 30x30 solve; the
// arithmetic is microseconds per iteration.  The joint variant's two 15x15
// float64 Jacobi solves (a rotation's angle a chain of divisions and square
// roots) come on top (chip_anatomy.py k22 stamps the phases).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVis = 256;              // the visual group: warps 0-7
constexpr int kThreads = kVis + 64;    // + warp 8 (edge Jacobians), warp 9 (prior's)
constexpr int kVisWarps = kVis / 32;
constexpr int kMaxDevices = 64;
constexpr float kChi2 = 5.991f;

#include "dual.cuh"
#include "lie_t.cuh"
#include "imu_t.cuh"
#include "small_linalg.cuh"
#include "ba_obs.cuh"

using D1 = Dual<1, float>;
template <>
__device__ __forceinline__ D1 cst<D1>(double v) { return dconst<1, float>((float)v); }

// the phase kinds of chip_anatomy.py's build, which stamps clock64() in
// thread 0 (K22_STAMP), times warp 8's and warp 9's forward passes
// (K22_SPAN) and adds up the elimination's column parts in thread 0's
// registers (K22_LAP); nothing otherwise
#ifndef K22_STAMP
#define K22_STAMP(kind)
#define K22_CLOCK() 0ll
#define K22_SPAN(kind, t0)
#define K22_LAP_INIT()
#define K22_LAP(i)
#define K22_LAP_DONE()
#endif
enum Phase : int {
  kSetup = 0, kVisual, kJoin, kAssemble, kSolve, kApply, kClassify, kFinal, kMarg,
  kEdgeJac, kPriorJac, kBack, kPivot, kSwap, kFactor, kUpdate, kPhases
};

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

struct Sh {
  float cur[21], prev[21], prs[21], pk[kPk], Rcb[9], tcb[3];
  float Lr[81], Lb[36], Hc[225];
  float re[15], Jc[225], Jpv[225];   // edge residual, Jacobians wrt current / previous
  float rp[15], Jpr[225], HJ[225], Hr[15];   // prior raw residual, its Jacobian, Hc J, Hc r
  float A[30 * 31];                  // augmented system
  float vis[27];
  float d[30];
  float f[30];                       // the elimination's factors of a column
  float red[27 * kVisWarps];
  double E[225], V[225], S[225];     // float64 work of the prior and the marginalisation
};

// the problem's visual inputs: staged in shared memory or read in place
struct Vis {
  const float* p;   // (N, 3)
  const float* uv;  // (N, 2)
  const float* is;  // (N,)
  bool* act;        // (N,) the current inliers

  static constexpr int kBytes = 25;  // a point
};

// the edge's residual and Jacobians wrt the current state (into re, Jc)
// and, joint, the previous (Jpv) at (s.prev, s.cur), by warp 8: lane l < 30
// (legacy: l < 15) the tangent l % 15 of state l / 15 (legacy: the current
// state's tangent l).  All lanes of the warp call it.
template <bool joint>
__device__ void edge_jac_warp(Sh& s, int lane) {
  constexpr int kLanes = joint ? 30 : 15;
  if (lane >= kLanes) return;
  const int which = joint ? lane / 15 : 1, dir = lane % 15;
  D1 d0[15], d1[15];
#pragma unroll
  for (int a = 0; a < 15; ++a) {
    d0[a] = dconst<1, float>(0.f);
    d1[a] = dconst<1, float>(0.f);
    d0[a].d[0] = which == 0 && a == dir ? 1.f : 0.f;
    d1[a].d[0] = which == 1 && a == dir ? 1.f : 0.f;
  }
  St<D1> A, B;
  apply_delta_t(s.prev, d0, A);
  apply_delta_t(s.cur, d1, B);
  D1 rr[15];
  edge_r15(Pk{s.pk}, s.Lr, s.Lb, A, B, rr);
  float* J = which == 0 ? s.Jpv : s.Jc;
#pragma unroll
  for (int a = 0; a < 15; ++a) J[15 * a + dir] = rr[a].d[0];
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 15; ++a) s.re[a] = rr[a].v;
}

// the prior's raw residual (rp) and its Jacobian (Jpr) at s.prev, by warp
// 9: lane l < 15 the tangent l.  All lanes of the warp call it.
__device__ void prior_jac_warp(Sh& s, int lane) {
  if (lane >= 15) return;
  D1 d[15], rr[15];
#pragma unroll
  for (int a = 0; a < 15; ++a) {
    d[a] = dconst<1, float>(0.f);
    d[a].d[0] = a == lane ? 1.f : 0.f;
  }
  prior_raw(s.prev, s.prs, d, rr);
#pragma unroll
  for (int a = 0; a < 15; ++a) s.Jpr[15 * a + lane] = rr[a].d[0];
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 15; ++a) s.rp[a] = rr[a].v;
}

// S = V diag(f(w)) V^T of the symmetric 15x15 in s.E (destroyed; float64
// Jacobi by warp 0, then an output a thread): f clamps to [0, 1e7] (mode 0,
// the prior's square-root product) or inverts |w| > 1e-6 (mode 1, the
// pseudo-inverse).  All threads call it; S is valid after the caller's next
// barrier.
__device__ void eig_apply(Sh& s, int mode) {
  if (threadIdx.x < 32) jacobi_eig_warp<15>(s.E, s.V, threadIdx.x);
  __syncthreads();
  for (int e = threadIdx.x; e < 225; e += kThreads) {
    const int r = e / 15, c = e % 15;
    double acc = 0.0;
    for (int k = 0; k < 15; ++k) {
      const double wv = s.E[16 * k];
      const double f = mode == 0 ? fmin(fmax(wv, 0.0), 1e7) : (fabs(wv) > 1e-6 ? 1.0 / wv : 0.0);
      acc += s.V[15 * r + k] * f * s.V[15 * c + k];
    }
    s.S[e] = acc;
  }
}

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

// (A + 1e-8 I) d = rhs by Gaussian elimination with partial pivoting on A
// in shared memory, by the CTA.  Per column c, warp 0 finds the pivot, the
// first row of the strictly largest |a| (a NaN never wins, and a NaN at
// row c keeps row c), by one max-reduction and one ballot over a lane a
// row, swaps the two rows a lane a column and takes each row's factor
// before its column c changes; then warp w updates rows c + 1 + w, c + 11
// + w, ..., lane l column c + l.  Lane 0 substitutes back, the loops
// unrolled so that d and each row's operands stay in registers.  Each
// value takes the one-thread elimination's operations in its order.  All
// threads call it; d is valid after the caller's next barrier.
template <int n>
__device__ void solve(Sh& s) {
  static_assert(n <= 31, "a lane a row and a column");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kWarps = kThreads / 32;
  float* A = s.A;
  constexpr int m = n + 1;
  for (int i = tid; i < n; i += kThreads) A[m * i + i] += 1e-8f;
  __syncthreads();
  K22_LAP_INIT();
  for (int c = 0; c < n; ++c) {
    if (warp == 0) {
      unsigned key = 0;  // |a| + 1 as an integer where the lane's row may pivot
      if (lane >= c && lane < n) {
        const float v = fabsf(A[m * lane + c]);
        key = isnan(v) ? (lane == c ? 0xffffffffu : 0u) : __float_as_uint(v) + 1u;
      }
      const unsigned top = __reduce_max_sync(kAll, key);
      const int piv = __ffs(__ballot_sync(kAll, key == top)) - 1;
      K22_LAP(0);
      if (piv != c && lane < m) {
        const float t = A[m * c + lane];
        A[m * c + lane] = A[m * piv + lane];
        A[m * piv + lane] = t;
      }
      __syncwarp();
      K22_LAP(1);
      if (lane > c && lane < n) s.f[lane] = A[m * lane + c] / A[m * c + c];
      K22_LAP(2);
    }
    __syncthreads();
    const int k = c + lane;
    if (k < m) {
      const float top = A[m * c + k];
      for (int r = c + 1 + warp; r < n; r += kWarps) A[m * r + k] -= s.f[r] * top;
    }
    __syncthreads();
    K22_LAP(3);
  }
  K22_LAP_DONE();
  K22_STAMP(kSolve);
  if (tid != 0) return;
  float d[n];
#pragma unroll
  for (int r = n - 1; r >= 0; --r) {
    const float* Ar = A + m * r;
    float acc = Ar[n];
#pragma unroll
    for (int k2 = r + 1; k2 < n; ++k2) acc -= Ar[k2] * d[k2];
    d[r] = acc / Ar[r];
    s.d[r] = d[r];
  }
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

// the visual group's barrier (warps 0-7), apart from warps 8 and 9
__device__ __forceinline__ void vis_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kVis)); }

// the sum of n floats a thread over the visual group: the warp tree, then
// the warps in order (det_reduce.cuh's block_sum_fixed over 256 threads),
// thread i < n summing value i into out[i]; valid after the next CTA
// barrier.  The visual group's threads call it.
template <int n>
__device__ void vis_sum(float (&v)[n], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (lane == 0)
    for (int i = 0; i < n; ++i) red[warp * n + i] = v[i];
  vis_sync();
  if (threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < kVisWarps; ++w) s += red[w * n + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// the 27 visual sums at the current state into s.vis, by the visual group
template <class C>
__device__ void visual_sums(Sh& s, const Vis& q, int N, bool huber, const C& cam) {
  float v[27];
  for (int i = 0; i < 27; ++i) v[i] = 0.f;
  for (int i = threadIdx.x; i < N; i += kVis) {
    if (!q.act[i]) continue;
    float r[2], Jp[2][6];
    vis_rj(s.cur, s.cur + 9, q.p + 3 * i, q.uv + 2 * i, s.Rcb, s.tcb, cam, r, Jp, nullptr);
    const float is = q.is[i];
    const float chi2 = (r[0] * r[0] + r[1] * r[1]) * is;
    const float wt = (huber ? fminf(huber_delta() / sqrtf(fmaxf(chi2, 1e-12f)), 1.f) : 1.f) * is;
    int n = 6;
    for (int a = 0; a < 6; ++a) {
      v[a] += wt * (Jp[0][a] * r[0] + Jp[1][a] * r[1]);
      for (int b = a; b < 6; ++b) v[n++] += wt * (Jp[0][a] * Jp[0][b] + Jp[1][a] * Jp[1][b]);
    }
  }
  vis_sum<27>(v, s.red, s.vis);
}

// one linearisation: the visual sums by warps 0-7 beside the inertial
// Jacobians by warps 8 and 9, joined by a CTA barrier.  All threads call it.
template <bool joint, class C>
__device__ void linearize(Sh& s, const Vis& q, int N, bool huber, const C& cam) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kVisWarps) {
    visual_sums(s, q, N, huber, cam);
    K22_STAMP(kVisual);
  } else if (warp == kVisWarps) {
    const long long t0 = K22_CLOCK();
    edge_jac_warp<joint>(s, lane);
    if (lane == 0) K22_SPAN(kEdgeJac, t0);
  } else if (joint) {
    const long long t0 = K22_CLOCK();
    prior_jac_warp(s, lane);
    if (lane == 0) K22_SPAN(kPriorJac, t0);
  }
  __syncthreads();
  K22_STAMP(kJoin);
}

template <bool joint, class C>
__global__ void __launch_bounds__(kThreads)
pose_inertial_kernel(const float* __restrict__ state, const float* __restrict__ pts,
                     const float* __restrict__ uv, const float* __restrict__ isig,
                     const bool* __restrict__ valid, int N, const C cam, int n_rounds,
                     int n_iters, bool staged, float* __restrict__ out, bool* __restrict__ active,
                     int* __restrict__ n_inl) {
  constexpr int n = joint ? 30 : 15;
  __shared__ Sh s;
  extern __shared__ float4 s_raw[];
  K22_STAMP(kPhases);  // the start
  const In in = unpack(state);
  for (int i = threadIdx.x; i < kPk; i += kThreads) s.pk[i] = in.pk[i];
  if (threadIdx.x < 21) {
    s.cur[threadIdx.x] = in.cur[threadIdx.x];
    s.prev[threadIdx.x] = in.prev[threadIdx.x];
    s.prs[threadIdx.x] = in.prs[threadIdx.x];
  }
  if (threadIdx.x < 9) s.Rcb[threadIdx.x] = in.Rcb[threadIdx.x];
  if (threadIdx.x < 3) s.tcb[threadIdx.x] = in.tcb[threadIdx.x];
  Vis q;
  if (staged) {
    float* base = reinterpret_cast<float*>(s_raw);
    float* p = base;
    float* o = p + 3 * N;
    float* is = o + 2 * N;
    bool* act = reinterpret_cast<bool*>(is + N);
    for (int i = threadIdx.x; i < N; i += kThreads) {
      p[3 * i] = pts[3 * i];
      p[3 * i + 1] = pts[3 * i + 1];
      p[3 * i + 2] = pts[3 * i + 2];
      o[2 * i] = uv[2 * i];
      o[2 * i + 1] = uv[2 * i + 1];
      is[i] = isig[i];
      act[i] = valid[i];
    }
    q = Vis{p, o, is, act};
  } else {
    for (int i = threadIdx.x; i < N; i += kThreads) active[i] = valid[i];
    q = Vis{pts, uv, isig, active};
  }
  if (joint)  // the symmetrised prior
    for (int e = threadIdx.x; e < 225; e += kThreads) {
      const int r = e / 15, c = e % 15;
      s.E[e] = 0.5 * ((double)in.Hp[15 * r + c] + in.Hp[15 * c + r]);
    }
  __syncthreads();
  if (threadIdx.x == 32) info_sqrt_blk<9>(s.pk + 61, 0, s.Lr);
  if (threadIdx.x == 64) info_sqrt_blk<6>(s.pk + 61, 9, s.Lb);
  if (joint) {
    eig_apply(s, 0);
    __syncthreads();
    for (int e = threadIdx.x; e < 225; e += kThreads) s.Hc[e] = (float)s.S[e];
  }
  __syncthreads();
  K22_STAMP(kSetup);
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < n_rounds - 1;
    for (int it = 0; it < n_iters; ++it) {
      linearize<joint>(s, q, N, huber, cam);
      assemble<joint>(s, true);
      __syncthreads();
      K22_STAMP(kAssemble);
      solve<n>(s);
      __syncthreads();
      K22_STAMP(kBack);
      if (joint && threadIdx.x == 32) apply_to(s.prev, s.d);
      if (threadIdx.x == 0) apply_to(s.cur, s.d + (joint ? 15 : 0));
      __syncthreads();
      K22_STAMP(kApply);
    }
    // re-classify on the raw points
    for (int i = threadIdx.x; i < N; i += kThreads) {
      float r[2];
      vis_rj(s.cur, s.cur + 9, q.p + 3 * i, q.uv + 2 * i, s.Rcb, s.tcb, cam, r, nullptr,
             nullptr);
      q.act[i] = valid[i] && (r[0] * r[0] + r[1] * r[1]) * q.is[i] <= kChi2;
    }
    __syncthreads();
    K22_STAMP(kClassify);
  }
  if (threadIdx.x == 0) orthonormalize3(s.cur);
  if (joint && threadIdx.x == 32) orthonormalize3(s.prev);
  __syncthreads();
  // the final Hessian: visual weights isig (no Huber) on the inliers
  linearize<joint>(s, q, N, false, cam);
  assemble<joint>(s, false);
  if (threadIdx.x < kVis) {  // the inlier count
    float c[1] = {0.f};
    for (int i = threadIdx.x; i < N; i += kVis) c[0] += q.act[i] ? 1.f : 0.f;
    vis_sum<1>(c, s.red, s.d);
  }
  if (staged)
    for (int i = threadIdx.x; i < N; i += kThreads) active[i] = q.act[i];
  __syncthreads();
  if (threadIdx.x == 0) *n_inl = (int)s.d[0];
  if (threadIdx.x < 21) out[threadIdx.x] = s.cur[threadIdx.x];
  float* H = out + 21;
  constexpr int m = n + 1;
  K22_STAMP(kFinal);
  if (!joint) {
    for (int e = threadIdx.x; e < 225; e += kThreads) H[e] = s.A[m * (e / 15) + e % 15];
    return;
  }
  // H_cc - H_cp pinv(H_pp) H_pc, pinv by eigh (|lambda| > 1e-6)
  for (int e = threadIdx.x; e < 225; e += kThreads) s.E[e] = s.A[m * (e / 15) + e % 15];
  __syncthreads();
  eig_apply(s, 1);   // s.S = pinv(H_pp)
  __syncthreads();
  for (int e = threadIdx.x; e < 225; e += kThreads) {   // T = pinv(H_pp) H_pc, into s.E
    const int r = e / 15, c = e % 15;
    double acc = 0.0;
    for (int k = 0; k < 15; ++k) acc += s.S[15 * r + k] * s.A[m * k + 15 + c];
    s.E[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 225; e += kThreads) {   // M = H_cc - H_cp T, into s.V
    const int r = e / 15, c = e % 15;
    double acc = 0.0;
    for (int k = 0; k < 15; ++k) acc += (double)s.A[m * (15 + r) + k] * s.E[15 * k + c];
    s.V[e] = (double)s.A[m * (15 + r) + 15 + c] - acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 225; e += kThreads) {
    const int r = e / 15, c = e % 15;
    H[e] = (float)(0.5 * (s.V[15 * r + c] + s.V[15 * c + r]));
  }
  K22_STAMP(kMarg);
}

// the most points of a problem that pose_inertial_kernel<joint, C> stages in
// shared memory on the current device, or -1 on an error; asked of the CUDA
// runtime once per device, which also raises the kernel's dynamic shared
// memory limit to that size
template <bool joint, class C>
int max_n() {
  static int cached[kMaxDevices] = {};   // the answer + 1, 0 before the first call
  int dev, optin;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  if (cached[dev] > 0) return cached[dev] - 1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&fa, pose_inertial_kernel<joint, C>) != cudaSuccess)
    return -1;
  const int n = (optin - (int)fa.sharedSizeBytes) / Vis::kBytes / 16 * 16;
  if (cudaFuncSetAttribute(pose_inertial_kernel<joint, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           n * Vis::kBytes) != cudaSuccess)
    return -1;
  cached[dev] = n + 1;
  return n;
}

template <bool joint, class C>
int launch(const void* state, const void* pts, const void* uv, const void* isig,
           const void* valid, int N, const C& cam, int n_rounds, int n_iters, void* out,
           void* inliers, void* n_inl, cudaStream_t st) {
  const int limit = max_n<joint, C>();
  if (limit < 0) return (int)cudaErrorInvalidValue;
  const bool staged = N <= limit;
  pose_inertial_kernel<joint, C><<<1, kThreads, staged ? N * Vis::kBytes : 0, st>>>(
      (const float*)state, (const float*)pts, (const float*)uv, (const float*)isig,
      (const bool*)valid, N, cam, n_rounds, n_iters, staged, (float*)out, (bool*)inliers,
      (int*)n_inl);
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

// the most points of a problem that K22 stages in shared memory (joint: the
// joint variant; kb8: through the KB8 camera) on the current device, -1 on
// an error; a larger problem is read from global memory
extern "C" int pose_inertial_max_n(int joint, int kb8) {
  if (kb8) return joint ? max_n<true, CamKB8>() : max_n<false, CamKB8>();
  return joint ? max_n<true, Cam>() : max_n<false, Cam>();
}

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
