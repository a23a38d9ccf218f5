// K14 ba_schur: the global bundle adjustment, Levenberg-Marquardt on the
// reduced camera system (Schur complement) with block-Jacobi PCG; and K30,
// the same solve over n landmark shards.
//
// K14 replaces extractorb_tpu/dist/sharded_ba.py:optimize_schur_sharded on
// one shard (the program the JAX package runs on a single device,
// dist/global_ba.py:212-219): a lax.scan of LM steps, each eliminating the
// landmarks with batched 3x3 inverses and running lax.scan PCG sweeps on
// (Hpp + lam - W (Hll + lam)^-1 W^T) dp = bp - W (Hll + lam)^-1 bl.  Once
// per solve the observations are listed per keyframe and per point, in
// index order (det_reduce.cuh, K6's lists).  Then each LM iteration is:
//   build:   one thread per observation: residual and Jacobians (ba_obs.cuh,
//            K6's code) and the Huber weight at delta_mono, stored, and the
//            cost;
//   reduce:  one CTA per keyframe sums bp and the 6x6 block over its list,
//            one thread per point bl and the 3x3 block over its;
//   invert:  one thread per pose (6x6 Gauss-Jordan of Hpp + lam) or point
//            (3x3 adjugate of Hll + lam; y = Ml bl);
//   W y:     one CTA per keyframe over its list, then per pose the reduced
//            right-hand side b_red = bp - W y and the start of PCG;
//   cg_iters x five launches: W^T p per point over its list (p = z + beta p
//            built on the fly), y = Ml (W^T p) per point, W y per keyframe,
//            per pose Ap = Hpp p + lam p - W y with p.Ap, then the alpha step
//            with the preconditioner and r.z;
//   back-substitution dl = -Ml (bl - W^T x), the retraction, the candidate
//            cost and the accept with lambda x0.5 or x4.
// Scalars (alpha, beta, costs, lambda) stay on the card in float64; the
// rotations are re-orthonormalized at the end and observations classified
// by chi2 <= chi2_mono; the returned cost is the final sum of chi2.
//
// K30 replaces optimize_schur_sharded on n > 1 shards (its shard_map over a
// device mesh): shard s holds points [s Ps, (s+1) Ps) and the Os
// observations of those points (obs_mp local to the shard; the layout of
// dist/global_ba.py and relayout_for_schur), and a copy of the poses.  It
// runs K14's kernels on its own data, shard by shard, and where the JAX
// program psums, the shards' partials are summed in shard order
// (shard_sum.cuh): bp, the Hpp blocks and the current cost after the
// reduce, the (K,6) W y after each W y pass (once for b_red, once per PCG
// step), the candidate cost before the accept and the final cost.  The
// pose-side steps (inverses, PCG vectors and dot products, retraction,
// accept) then run on every shard on the same sums, so the shards' poses
// stay equal, as the replicated values of the shard_map do.  Padding needs
// no case of its own: a padded observation is invalid (weight 0, on no
// list) and a padded point is fixed (no step).
//
// Every sum runs in a fixed order (no float atomics), so a solve gives one
// result per input, as the JAX program does: the blocks over the
// index-ordered lists, the scalars as per-CTA partials summed in block order
// by the last CTA (det_reduce.cuh), the shards in shard order.
//
// The camera is a template parameter (camera_t.cuh via ba_obs.cuh, as K6):
// the pinhole Cam, or CamKB8, whose Jacobians come in forward mode
// (Dual<3>) through its projection in the build and the cost passes.
//
// Bound on the H100: launch latency.  A map of ~24 keyframes and ~10k
// observations is microseconds of arithmetic per pass; the ~5 dependent
// launches per PCG step and ~10 per LM iteration set the time.  K30 on n
// shards of one card launches each pass n times plus a small sum kernel at
// each reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

#include "dual.cuh"
#include "ba_obs.cuh"
#include "det_reduce.cuh"
#include "shard_sum.cuh"

struct Ws {
  float* Rn;    // (K,9) candidates
  float* tn;    // (K,3)
  float* pn;    // (P,3)
  float* J;     // (O,18) pose 2x6 then point 2x3
  float* w;     // (O,)
  float* r;     // (O,2) residuals
  float* bp;    // (K,6), followed by Hpp (one range for the cross-shard sum)
  float* Hpp;   // (K,21)
  float* bl;    // (P,3)
  float* Hll;   // (P,6)
  float* hp;    // (K,6) W y, then Ap
  float* tl;    // (P,3) W^T v
  float* Mp;    // (K,36)
  float* Ml;    // (P,9)
  float* y;     // (P,3)
  float* x;     // (K,6) CG vectors
  float* res;
  float* z;
  float* p;
  double* lam;
  double* sc;   // [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
  double* part; // per-CTA partials of the scalar being reduced
  unsigned* ticket;
  Lists L;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t carve(Ws* w, uint8_t* base, int K, int P, int O, int cg) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  uint8_t* q;
  q = take(sizeof(float) * 9 * K); if (w) w->Rn = (float*)q;
  q = take(sizeof(float) * 3 * K); if (w) w->tn = (float*)q;
  q = take(sizeof(float) * 3 * P); if (w) w->pn = (float*)q;
  q = take(sizeof(float) * 18 * (size_t)O); if (w) w->J = (float*)q;
  q = take(sizeof(float) * (size_t)O); if (w) w->w = (float*)q;
  q = take(sizeof(float) * 2 * (size_t)O); if (w) w->r = (float*)q;
  q = take(sizeof(float) * 27 * K);
  if (w) {
    w->bp = (float*)q;
    w->Hpp = w->bp + 6 * K;
  }
  q = take(sizeof(float) * 3 * P);  if (w) w->bl = (float*)q;
  q = take(sizeof(float) * 6 * P);  if (w) w->Hll = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->hp = (float*)q;
  q = take(sizeof(float) * 3 * P);  if (w) w->tl = (float*)q;
  q = take(sizeof(float) * 36 * K); if (w) w->Mp = (float*)q;
  q = take(sizeof(float) * 9 * P);  if (w) w->Ml = (float*)q;
  q = take(sizeof(float) * 3 * P);  if (w) w->y = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->x = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->res = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->z = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->p = (float*)q;
  q = take(sizeof(double));         if (w) w->lam = (double*)q;
  q = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)q;
  q = take(sizeof(double) * ((size_t)n_blocks(O > K ? O : K) + 1)); if (w) w->part = (double*)q;
  q = take(sizeof(unsigned));       if (w) w->ticket = (unsigned*)q;
  // cnt_kf, cnt_mp, cur_mp contiguous (zeroed together)
  q = take(sizeof(int) * ((size_t)K + 2 * (size_t)P));
  if (w) {
    w->L.cnt_kf = (int*)q;
    w->L.cnt_mp = w->L.cnt_kf + K;
    w->L.cur_mp = w->L.cnt_mp + P;
  }
  q = take(sizeof(int) * ((size_t)K + 1)); if (w) w->L.off_kf = (int*)q;
  q = take(sizeof(int) * ((size_t)P + 1)); if (w) w->L.off_mp = (int*)q;
  q = take(sizeof(int) * (size_t)O); if (w) w->L.list_kf = (int*)q;
  q = take(sizeof(int) * (size_t)O); if (w) w->L.list_mp = (int*)q;
  return o;
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

template <class C>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ pts,
             const Prob q, const C cam, bool huber, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float cost = 0.f;
  if (o < q.O) {
    if (q.valid[o]) {
      const int kf = q.obs_kf[o];
      obs_linearize_rows<false>(R + 9 * kf, t + 3 * kf, pts, q, cam, huber, o, w.J, w.w, w.r, cost);
    } else {
      w.w[o] = 0.f;
    }
  }
  reduce_store((double)cost, w.part, w.ticket, cost_old(w));
}

// bp and the pose blocks: blocks [0, K) are one CTA per keyframe over its
// list; the rest one thread per point over its list (bl, the point block)
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const Prob q, Ws w) {
  __shared__ float red[27 * kThreads / 32];
  if (blockIdx.x < q.K) {
    const int k = blockIdx.x;
    float v[27];  // bp 6, then the upper 6x6 triangle
    for (int i = 0; i < 27; ++i) v[i] = 0.f;
    for (int j = w.L.off_kf[k] + threadIdx.x; j < w.L.off_kf[k + 1]; j += kThreads) {
      const int o = w.L.list_kf[j];
      const float* J = w.J + (size_t)18 * o;
      const float wt = w.w[o], r0 = w.r[2 * o], r1 = w.r[2 * o + 1];
      int n = 6;
      for (int a = 0; a < 6; ++a) {
        v[a] += wt * (J[a] * r0 + J[6 + a] * r1);
        for (int b2 = a; b2 < 6; ++b2) v[n++] += wt * (J[a] * J[b2] + J[6 + a] * J[6 + b2]);
      }
    }
    block_sum_fixed<27>(v, red);
    if (threadIdx.x == 0) {
      for (int a = 0; a < 6; ++a) w.bp[6 * k + a] = v[a];
      for (int i = 0; i < 21; ++i) w.Hpp[21 * k + i] = v[6 + i];
    }
    return;
  }
  const int m = (blockIdx.x - q.K) * kThreads + threadIdx.x;
  if (m >= q.P) return;
  float g[3] = {0.f, 0.f, 0.f}, H[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = w.L.off_mp[m]; j < w.L.off_mp[m + 1]; ++j) {
    const int o = w.L.list_mp[j];
    const float* J = w.J + (size_t)18 * o + 12;
    const float wt = w.w[o], r0 = w.r[2 * o], r1 = w.r[2 * o + 1];
    int n = 0;
    for (int a = 0; a < 3; ++a) {
      g[a] += wt * (J[a] * r0 + J[3 + a] * r1);
      for (int b2 = a; b2 < 3; ++b2) H[n++] += wt * (J[a] * J[b2] + J[3 + a] * J[3 + b2]);
    }
  }
  for (int a = 0; a < 3; ++a) w.bl[3 * m + a] = g[a];
  for (int i = 0; i < 6; ++i) w.Hll[6 * m + i] = H[i];
}

// poses: Mp = (Hpp + lam)^-1; points: Ml = (Hll + lam)^-1, y = Ml (bl masked)
__global__ void __launch_bounds__(kThreads)
invert_kernel(const Prob q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const float lam = (float)*w.lam;
  if (e < q.K) {
    inv6_damped(w.Hpp + 21 * e, lam, w.Mp + 36 * e);
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    float* Mi = w.Ml + 9 * m;
    inv3_damped(w.Hll + 6 * m, lam, Mi);
    const bool fr = !q.fixed_mp[m];
    float b[3];
    for (int a = 0; a < 3; ++a) b[a] = fr ? w.bl[3 * m + a] : 0.f;
    for (int a = 0; a < 3; ++a) w.y[3 * m + a] = Mi[3 * a] * b[0] + Mi[3 * a + 1] * b[1] + Mi[3 * a + 2] * b[2];
  }
}

// hp[kf] = sum over its list of Jp^T (w Jl y[mp]) (W y): one CTA per keyframe
__global__ void __launch_bounds__(kThreads)
w_y_kernel(const Prob q, Ws w) {
  __shared__ float red[6 * kThreads / 32];
  const int k = blockIdx.x;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = w.L.off_kf[k] + threadIdx.x; j < w.L.off_kf[k + 1]; j += kThreads) {
    const int o = w.L.list_kf[j];
    const float* J = w.J + (size_t)18 * o;
    const float* y = w.y + 3 * q.obs_mp[o];
    float u[2];
    for (int rr = 0; rr < 2; ++rr)
      u[rr] = (J[12 + 3 * rr] * y[0] + J[13 + 3 * rr] * y[1] + J[14 + 3 * rr] * y[2]) * w.w[o];
    for (int i = 0; i < 6; ++i) v[i] += J[i] * u[0] + J[6 + i] * u[1];
  }
  block_sum_fixed<6>(v, red);
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i) w.hp[6 * k + i] = v[i];
}

// per pose: b_red = (bp - W y) masked; x = 0, r = b_red, z = Mp r, r.z
__global__ void __launch_bounds__(kThreads)
reduce_rhs_kernel(const Prob q, Ws w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const bool fr = !q.fixed_kf[k];
    float rb[6];
    for (int a = 0; a < 6; ++a) {
      rb[a] = fr ? w.bp[6 * k + a] - w.hp[6 * k + a] : 0.f;
      w.res[6 * k + a] = rb[a];
      w.x[6 * k + a] = 0.f;
      w.p[6 * k + a] = 0.f;
    }
    const float* M = w.Mp + 36 * k;
    for (int a = 0; a < 6; ++a) {
      float s = 0.f;
      for (int b = 0; b < 6; ++b) s += M[6 * a + b] * rb[b];
      s = fr ? s : 0.f;
      w.z[6 * k + a] = s;
      part += (double)(rb[a] * s);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, 0));
}

__device__ __forceinline__ float beta_of(const Ws& w, int it) {
  return it == 0 ? 0.f : (float)(*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// tl[mp] = sum over its list of Jl^T (w Jp v[kf]) (W^T v), one thread per
// point, with v the direction p = z + beta p built on the fly (it >= 0) or x
// (it < 0); fixed keyframes and points contribute nothing
__global__ void __launch_bounds__(kThreads)
wt_v_kernel(const Prob q, Ws w, int it) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= q.P) return;
  float acc[3] = {0.f, 0.f, 0.f};
  if (!q.fixed_mp[m]) {
    const float beta = it >= 0 ? beta_of(w, it) : 0.f;
    for (int j = w.L.off_mp[m]; j < w.L.off_mp[m + 1]; ++j) {
      const int o = w.L.list_mp[j];
      const int kf = q.obs_kf[o];
      if (q.fixed_kf[kf]) continue;
      float v[6];
      for (int i = 0; i < 6; ++i)
        v[i] = it >= 0 ? w.z[6 * kf + i] + beta * w.p[6 * kf + i] : w.x[6 * kf + i];
      const float* J = w.J + (size_t)18 * o;
      float u[2];
      for (int rr = 0; rr < 2; ++rr) {
        float s = 0.f;
        for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * v[i];
        u[rr] = s * w.w[o];
      }
      for (int i = 0; i < 3; ++i) acc[i] += J[12 + i] * u[0] + J[15 + i] * u[1];
    }
  }
  for (int i = 0; i < 3; ++i) w.tl[3 * m + i] = acc[i];
}

// per point: y = Ml (tl masked)
__global__ void __launch_bounds__(kThreads)
point_solve_kernel(const Prob q, Ws w) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= q.P) return;
  const bool fr = !q.fixed_mp[m];
  float b[3];
  for (int a = 0; a < 3; ++a) b[a] = fr ? w.tl[3 * m + a] : 0.f;
  const float* Mi = w.Ml + 9 * m;
  for (int a = 0; a < 3; ++a) w.y[3 * m + a] = Mi[3 * a] * b[0] + Mi[3 * a + 1] * b[1] + Mi[3 * a + 2] * b[2];
}

// per pose: p = z + beta p (masked), Ap = (Hpp p + lam p - W y) masked, p.Ap
__global__ void __launch_bounds__(kThreads)
cg_a_kernel(const Prob q, Ws w, int it, int cg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const bool fr = !q.fixed_kf[k];
    const float beta = beta_of(w, it);
    const float lam = (float)*w.lam;
    float pv[6];
    for (int a = 0; a < 6; ++a) pv[a] = fr ? w.z[6 * k + a] + beta * w.p[6 * k + a] : 0.f;
    const float* H = w.Hpp + 21 * k;
    float Hf[36];
    int kk = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) { Hf[6 * a + b] = H[kk]; Hf[6 * b + a] = H[kk]; ++kk; }
    for (int a = 0; a < 6; ++a) {
      float hv = 0.f;
      for (int b = 0; b < 6; ++b) hv += Hf[6 * a + b] * pv[b];
      const float ap = fr ? hv + lam * pv[a] - w.hp[6 * k + a] : 0.f;
      w.p[6 * k + a] = pv[a];
      w.hp[6 * k + a] = ap;             // Ap kept in hp until cg_b
      part += (double)(pv[a] * ap);
    }
  }
  reduce_store(part, w.part, w.ticket, pAp(w, it, cg));
}

// per pose: x += alpha p, r -= alpha Ap, z = Mp r, r.z
__global__ void __launch_bounds__(kThreads)
cg_b_kernel(const Prob q, Ws w, int it, int cg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const bool fr = !q.fixed_kf[k];
    const float alpha = (float)(*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
    float rb[6];
    for (int a = 0; a < 6; ++a) {
      w.x[6 * k + a] += alpha * w.p[6 * k + a];
      rb[a] = w.res[6 * k + a] - alpha * w.hp[6 * k + a];
      w.res[6 * k + a] = rb[a];
    }
    const float* M = w.Mp + 36 * k;
    for (int a = 0; a < 6; ++a) {
      float s = 0.f;
      for (int b = 0; b < 6; ++b) s += M[6 * a + b] * rb[b];
      s = fr ? s : 0.f;
      w.z[6 * k + a] = s;
      part += (double)(rb[a] * s);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, it + 1));
}

// candidates: poses R Exp(-x), points p + dl with dl = -Ml (bl - W^T x)
__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* __restrict__ R, const float* __restrict__ t,
               const float* __restrict__ pts, const Prob q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < q.K) {
    const bool fr = !q.fixed_kf[e];
    float xi[6];
    for (int i = 0; i < 6; ++i) xi[i] = fr ? -w.x[6 * e + i] : 0.f;
    retract_pose(R + 9 * e, t + 3 * e, xi, w.Rn + 9 * e, w.tn + 3 * e);
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    const bool fr = !q.fixed_mp[m];
    float b[3];
    for (int a = 0; a < 3; ++a) b[a] = fr ? w.bl[3 * m + a] - w.tl[3 * m + a] : 0.f;
    const float* Mi = w.Ml + 9 * m;
    for (int a = 0; a < 3; ++a) {
      const float dl = fr ? -(Mi[3 * a] * b[0] + Mi[3 * a + 1] * b[1] + Mi[3 * a + 2] * b[2]) : 0.f;
      w.pn[3 * m + a] = pts[3 * m + a] + dl;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const Prob q, const C cam, bool huber, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float cost = 0.f;
  if (o < q.O && q.valid[o]) {
    const int kf = q.obs_kf[o];
    cost = rho(obs_chi2_rows<false>(w.Rn + 9 * kf, w.tn + 3 * kf, w.pn, q, cam, o), huber,
               huber_delta());
  }
  reduce_store((double)cost, w.part, w.ticket, cost_new(w));
}

__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ R, float* __restrict__ t, float* __restrict__ pts, const Prob q,
              Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  lm_accept(w.sc, w.lam, e, q.K, q.P, w.Rn, w.tn, w.pn, R, t, pts);
}

// inliers (chi2 <= chi2_th) and the final sum of chi2 over valid observations
template <class C>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ R, const float* __restrict__ t,
                const float* __restrict__ pts, const Prob q, const C cam, float chi2_th,
                bool* __restrict__ inl, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float c = 0.f;
  if (o < q.O) {
    if (!q.valid[o]) {
      inl[o] = false;
    } else {
      const int kf = q.obs_kf[o];
      c = obs_chi2_rows<false>(R + 9 * kf, t + 3 * kf, pts, q, cam, o);
      inl[o] = c <= chi2_th;
    }
  }
  reduce_store((double)c, w.part, w.ticket, cost_new(w));
}

__global__ void init_kernel(Ws w) {
  *w.lam = 1e-4;
  *w.ticket = 0u;
}

__global__ void final_cost_kernel(Ws w, float* cost_out) { *cost_out = (float)*cost_new(w); }

inline int blocks(long long n) { return n_blocks(n); }

// one shard of a solve: its start state (overwritten with the result), its
// observations and points, its workspace and its inlier mask
struct Shard {
  float* R;
  float* t;
  float* pts;
  Prob q;
  Ws w;
  bool* inl;
};

template <class C>
int solve(int n, Shard* sh, ShardComm& cm, const C& cam, int n_iters, int cg_iters, bool huber,
          float chi2_th, void* cost_out) {
  const int K = sh[0].q.K;
  cudaError_t e;
  float* red[kMaxShards];
  float* hp[kMaxShards];
  double* c_old[kMaxShards];
  double* c_new[kMaxShards];
  for (int s = 0; s < n; ++s) {
    red[s] = sh[s].w.bp;
    hp[s] = sh[s].w.hp;
    c_old[s] = sh[s].w.sc;       // cost_old
    c_new[s] = sh[s].w.sc + 1;   // cost_new
  }
// the statement for every shard, on its device and stream
#define EACH(...)                                                     \
  for (int s = 0; s < n; ++s) {                                       \
    if ((e = use_shard(cm, s)) != cudaSuccess) return (int)e;         \
    Shard& S = sh[s];                                                 \
    const cudaStream_t st = cm.st[s];                                 \
    const int nbP = blocks(S.q.P);                                    \
    (void)nbP;                                                        \
    __VA_ARGS__;                                                      \
  }
#define SUM(ptrs, count) \
  if ((e = allreduce(cm, ptrs, count)) != cudaSuccess) return (int)e;
  EACH(init_kernel<<<1, 1, 0, st>>>(S.w);
       if ((e = build_lists(S.q.obs_kf, S.q.obs_mp, S.q.valid, K, S.q.P, S.q.O, S.w.L, st)) !=
           cudaSuccess) return (int)e)
  for (int it = 0; it < n_iters; ++it) {
    EACH(build_kernel<C><<<blocks(S.q.O), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, cam, huber,
                                                               S.w);
         reduce_kernel<<<K + nbP, kThreads, 0, st>>>(S.q, S.w))
    SUM(red, 27LL * K)
    SUM(c_old, 1)
    EACH(invert_kernel<<<blocks(K + S.q.P), kThreads, 0, st>>>(S.q, S.w);
         w_y_kernel<<<K, kThreads, 0, st>>>(S.q, S.w))
    SUM(hp, 6LL * K)
    EACH(reduce_rhs_kernel<<<blocks(K), kThreads, 0, st>>>(S.q, S.w))
    for (int c = 0; c < cg_iters; ++c) {
      EACH(wt_v_kernel<<<nbP, kThreads, 0, st>>>(S.q, S.w, c);
           point_solve_kernel<<<nbP, kThreads, 0, st>>>(S.q, S.w);
           w_y_kernel<<<K, kThreads, 0, st>>>(S.q, S.w))
      SUM(hp, 6LL * K)
      EACH(cg_a_kernel<<<blocks(K), kThreads, 0, st>>>(S.q, S.w, c, cg_iters);
           cg_b_kernel<<<blocks(K), kThreads, 0, st>>>(S.q, S.w, c, cg_iters))
    }
    EACH(wt_v_kernel<<<nbP, kThreads, 0, st>>>(S.q, S.w, -1);
         retract_kernel<<<blocks(K + S.q.P), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, S.w);
         cost_kernel<C><<<blocks(S.q.O), kThreads, 0, st>>>(S.q, cam, huber, S.w))
    SUM(c_new, 1)
    EACH(accept_kernel<<<blocks(K + S.q.P), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, S.w);
         if ((e = cudaGetLastError()) != cudaSuccess) return (int)e)
  }
  EACH(orthonormalize_kernel<<<blocks(K), kThreads, 0, st>>>(S.R, K);
       classify_kernel<C><<<blocks(S.q.O), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, cam, chi2_th,
                                                              S.inl, S.w))
  SUM(c_new, 1)
#undef EACH
#undef SUM
  if ((e = use_shard(cm, 0)) != cudaSuccess) return (int)e;
  final_cost_kernel<<<1, 1, 0, cm.st[0]>>>(sh[0].w, (float*)cost_out);
  return (int)cudaGetLastError();
}

int solve_cam(int n, Shard* sh, ShardComm& cm, float fx, float fy, float cx, float cy,
              const float* kb8, int n_iters, int cg_iters, bool huber, float chi2_th,
              void* cost_out) {
  if (kb8 != nullptr)
    return solve(n, sh, cm, CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_iters,
                 cg_iters, huber, chi2_th, cost_out);
  return solve(n, sh, cm, Cam{fx, fy, cx, cy}, n_iters, cg_iters, huber, chi2_th, cost_out);
}

}  // namespace

extern "C" long long ba_schur_workspace_bytes(int K, int P, int O, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters);
}

// K30's peer route: bytes of the n slots on shard 0's device (the largest
// summed range: bp and the Hpp blocks)
extern "C" long long ba_schur_gather_bytes(int n, int K) {
  return (long long)n * (long long)align16(sizeof(float) * 27 * (size_t)K);
}

// R (K,9), t (K,3), pts (P,3): the start state, overwritten with the result.
// kb8 null: the pinhole camera; else a host array k1..k4 of the KB8 camera.
extern "C" int ba_schur_launch(void* R, void* t, void* pts, const void* obs_kf, const void* obs_mp,
                               const void* obs_uv, const void* isig, const void* valid,
                               const void* fixed_kf, const void* fixed_mp, int K, int P, int O,
                               float fx, float fy, float cx, float cy, const float* kb8,
                               int n_iters, int cg_iters, int use_huber, float chi2_th, void* ws,
                               void* inliers, void* cost_out, void* stream) {
  if (K <= 0 || P <= 0 || O <= 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  Shard sh;
  sh.R = (float*)R;
  sh.t = (float*)t;
  sh.pts = (float*)pts;
  sh.q = Prob{(const int*)obs_kf, (const int*)obs_mp, (const float*)obs_uv, (const float*)isig,
              (const bool*)valid, (const bool*)fixed_kf, (const bool*)fixed_mp, K, P, O};
  carve(&sh.w, static_cast<uint8_t*>(ws), K, P, O, cg_iters);
  sh.inl = (bool*)inliers;
  ShardComm cm;
  cm.st[0] = (cudaStream_t)stream;
  return solve_cam(1, &sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                        chi2_th, cost_out);
}

// K30: n shards of Ps points and Os observations each.  devs (n,) the CUDA
// device of each shard; tab (n, 13) host rows of pointers: R (K,9), t (K,3)
// (each shard's copy of the start poses), pts (Ps,3), obs_kf, obs_mp (local
// to the shard), obs_uv, isig, valid (Os), fixed_kf (K), fixed_mp (Ps), the
// shard's workspace (ba_schur_workspace_bytes(K, Ps, Os, cg_iters)), its
// inlier mask (Os) and its stream.  gather: ba_schur_gather_bytes(n, K) on
// devs[0] when the devices differ, else null.  The result: every shard's R,
// t (equal), pts and inliers; cost_out (float32, on devs[0]) the final sum
// of chi2 over every shard.  The caller's current device is kept.
extern "C" int ba_schur_sharded_launch(int n, const int* devs, const long long* tab, int K,
                                       int Ps, int Os, float fx, float fy, float cx, float cy,
                                       const float* kb8, int n_iters, int cg_iters,
                                       int use_huber, float chi2_th, void* gather,
                                       void* cost_out) {
  if (n < 1 || n > kMaxShards || K <= 0 || Ps <= 0 || Os <= 0 || n_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  Shard sh[kMaxShards];
  cudaStream_t sts[kMaxShards];
  for (int s = 0; s < n; ++s) {
    const long long* r = tab + 13 * (size_t)s;
    sh[s].R = (float*)r[0];
    sh[s].t = (float*)r[1];
    sh[s].pts = (float*)r[2];
    sh[s].q = Prob{(const int*)r[3], (const int*)r[4], (const float*)r[5], (const float*)r[6],
                   (const bool*)r[7], (const bool*)r[8], (const bool*)r[9], K, Ps, Os};
    carve(&sh[s].w, (uint8_t*)r[10], K, Ps, Os, cg_iters);
    sh[s].inl = (bool*)r[11];
    sts[s] = (cudaStream_t)r[12];
  }
  int prev;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  ShardComm cm;
  e = comm_open(cm, n, devs, sts, gather, (size_t)ba_schur_gather_bytes(1, K));
  int err = (int)e;
  if (e == cudaSuccess)
    err = solve_cam(n, sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                         chi2_th, cost_out);
  comm_close(cm);
  cudaSetDevice(prev);
  return err;
}
