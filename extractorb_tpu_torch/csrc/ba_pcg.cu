// K6 ba_pcg: Levenberg-Marquardt bundle adjustment with matrix-free PCG
// (poses + points, mono reprojection edges, Huber kernel).
//
// Replaces extractorb_tpu/solver/ba.py:optimize (solver "cg"), which the TPU
// runs as a lax.scan of LM steps, each a lax.scan of PCG sweeps over
// jacfwd Jacobians, gathers and segment sums.  Once per solve the
// observations are listed per keyframe and per point, in index order
// (det_reduce.cuh).  Then each LM iteration is a sequence of passes:
//   build:   one thread per observation computes the residual, the analytic
//            Jacobians (2x6 for R Exp(delta), 2x3 for the point) and the
//            Huber weight, and stores them, plus the current cost;
//   reduce:  one CTA per keyframe sums the gradient and the 6x6 diagonal
//            block over its list, one thread per point the 3 + 3x3 over its;
//   invert:  one thread per block inverts the damped block (6x6 Gauss-Jordan,
//            3x3 adjugate) and starts PCG (x = 0, r = b, z = M r, p = z);
//   cg_iters x three passes: the Hessian-vector product (a CTA per
//            keyframe and a thread per point over their lists, p built on
//            the fly as z + beta p), the damped and masked product with the
//            p.Ap dot, and the alpha step with the preconditioner and the
//            r.z dot;
//   retract, cost, accept: the candidate poses (R Exp(-x)) and points, their
//            cost, and the accept/reject with the lambda update.
// At the end the rotations are re-orthonormalized (two Newton-Schulz steps)
// and observations classified by chi2.  Each pass's arithmetic is one
// device function, run two ways:
//   * K6 (ba_pcg_launch, solver "cg"): the whole solve is one launch of one
//     thread-block cluster (solve_cluster_kernel).  A cluster barrier stands
//     between two passes, and the scalars (costs, alpha, beta, lambda) go
//     through distributed shared memory: nothing is launched or read back
//     between the passes.
//   * the multi-launch sequence (solve): a kernel per pass, the scalars in a
//     small float64 block on the card, for K33 (n shards) and K35.
// Both sum in the same order, so they give the same bits.
//
// The camera is a template parameter (camera_t.cuh): the pinhole Cam, or
// CamKB8, whose Jacobians come in forward mode through its projection.
// So is the stereo residual (K6 <stereo>, obs_ur not null): an observation
// with ur >= 0 has the third row ur - (u - bf / z), Huber delta sqrt(7.815)
// and the chi2 gate 7.815 (ba_obs.cuh:obs_rows); the build, reduce,
// product, cost and classify passes then run over three rows.
//
// With a dense workspace (solver "schur_dense"), K35 (ba_schur_dense.cu)
// replaces the PCG sweeps: after the reduce pass it eliminates the points,
// assembles and solves the dense reduced camera system and
// back-substitutes into x, which the retraction reads as PCG's solution.
//
// Every sum runs in a fixed order (no float atomics), so a solve gives one
// result per input: the blocks over the index-ordered lists, the scalars by
// per-CTA partials summed in block order.
//
// K33 replaces extractorb_tpu/dist/sharded_ba.py:optimize_sharded (its
// shard_map over a device mesh): the observations are sharded, shard s
// holding the Os observations [s Os, (s+1) Os) (obs_mp global), and every
// shard a copy of the poses and points.  It runs K6's passes on its own
// observations, shard by shard, and where the JAX program psums, the shards'
// partials are summed in shard order (shard_sum.cuh): the gradient (6K + 3P),
// the Hpp and Hll blocks and the current cost after the reduce, the Hessian
// product (6K + 3P) after each product pass, the candidate cost before the
// accept and the final sum of chi2.  The rest (inverses, PCG vectors and
// dots, retraction, accept) runs on every shard on the same sums, so the
// shards' poses and points stay equal, as the replicated values of the
// shard_map do.  It returns the final sum of chi2, as the JAX program does.
// Padding needs no case of its own: a padded observation is invalid (weight
// 0, on no list).  One shard is K6's pass sequence, launched pass by pass.
//
// Bound on the H100: latency.  An init problem (2 keyframes, ~2k
// observations) and a window problem (~10 keyframes, ~10k observations) are
// microseconds of arithmetic per pass, and the passes are dependent:
// 7 + n_iters (6 + 3 cg_iters) + 2 of them a solve (1521 at 12 x 40).  As
// kernels, each costs a launch.  In the cluster each costs a barrier and
// its slowest CTA's chain of dependent loads from L2 (the workspace, ~1-5
// MB, stays there): chip_anatomy.py times the phases.  The product pass
// loads a chunk of list entries at once, and takes each list entry's
// other block from a companion array built with the lists.  K33 on n
// shards of one card launches each pass n times plus a small sum kernel at
// each reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "ba_schur_dense.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

#include "dual.cuh"
#include "ba_obs.cuh"
#include "det_reduce.cuh"
#include "shard_sum.cuh"

struct Ws {
  float* Rn;    // (K,9) candidate poses / points
  float* tn;    // (K,3)
  float* pn;    // (P,3)
  float* J;     // (O,9R): pose Jacobian Rx6, then point Jacobian Rx3 (R = 2, or 3 stereo)
  float* w;     // (O,)
  float* r;     // (O,R) residuals
  float* g;     // (6K+3P) gradient b = J^T W r
  float* Hpp;   // (K,21) upper triangles
  float* Hll;   // (P,6)
  float* h;     // (6K+3P) Hessian-vector product
  float* Mp;    // (K,36)
  float* Ml;    // (P,9)
  float* x;     // (6K+3P) CG vectors
  float* res;
  float* z;
  float* p;
  float* Ap;
  float* cst;   // the cost of a shard other than shard 0 (K33)
  double* lam;  // (1,)
  double* sc;   // scalars: [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
  double* part; // per-CTA partials of the scalar being reduced
  unsigned* ticket;
  Lists L;
  int* mp_of_kf;  // (O,) obs_mp of each entry of L.list_kf
  int* kf_of_mp;  // (O,) obs_kf of each entry of L.list_mp
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// rows: 2, or 3 for the stereo residual (K6 <stereo>)
__host__ __device__ inline size_t carve(Ws* w, uint8_t* base, int K, int P, int O, int cg,
                                        int rows) {
  const size_t nv = (size_t)6 * K + (size_t)3 * P;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  uint8_t* q;
  q = take(sizeof(float) * 9 * K);  if (w) w->Rn = (float*)q;
  q = take(sizeof(float) * 3 * K);  if (w) w->tn = (float*)q;
  q = take(sizeof(float) * 3 * P);  if (w) w->pn = (float*)q;
  q = take(sizeof(float) * 9 * rows * (size_t)O); if (w) w->J = (float*)q;
  q = take(sizeof(float) * (size_t)O); if (w) w->w = (float*)q;
  q = take(sizeof(float) * rows * (size_t)O); if (w) w->r = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->g = (float*)q;
  q = take(sizeof(float) * 21 * K); if (w) w->Hpp = (float*)q;
  q = take(sizeof(float) * 6 * P);  if (w) w->Hll = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->h = (float*)q;
  q = take(sizeof(float) * 36 * K); if (w) w->Mp = (float*)q;
  q = take(sizeof(float) * 9 * P);  if (w) w->Ml = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->x = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->res = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->z = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->p = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->Ap = (float*)q;
  q = take(sizeof(float));          if (w) w->cst = (float*)q;
  q = take(sizeof(double));         if (w) w->lam = (double*)q;
  q = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)q;
  const size_t max_blocks = (size_t)n_blocks(O > (long long)nv ? O : (long long)nv) + K + 1;
  q = take(sizeof(double) * max_blocks); if (w) w->part = (double*)q;
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
  q = take(sizeof(int) * (size_t)O); if (w) w->mp_of_kf = (int*)q;
  q = take(sizeof(int) * (size_t)O); if (w) w->kf_of_mp = (int*)q;
  return o;
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

// The passes' arithmetic, one device function each, shared by the
// multi-launch kernels below (K33 on n shards, K35's route) and the cluster
// solve (K6): an observation o, a block e (pose e < K, else point e - K),
// a scalar e of the 6K + 3P vectors, or a virtual block b of kThreads
// threads as one CTA of the multi-launch grid (b = blockIdx.x there).

// observation o's residual, Jacobian rows and weight into the workspace;
// returns its robust cost
template <bool kS, class C>
__device__ __forceinline__ float build_obs(const float* R, const float* t, const float* pts,
                                           const Prob& q, const C& cam, bool huber, const Ws& w,
                                           int o) {
  float cost = 0.f;
  if (o < q.O) {
    if (q.valid[o]) {
      const int kf = q.obs_kf[o];
      obs_linearize_rows<kS>(R + 9 * kf, t + 3 * kf, pts, q, cam, huber, o, w.J, w.w, w.r, cost);
    } else {
      w.w[o] = 0.f;
    }
  }
  return cost;
}

// the gradient and diagonal blocks: blocks [0, K) are one CTA per keyframe
// over its observation list, the rest one thread per point over its list.
// All threads of the CTA must call it.
template <int kR>
__device__ void reduce_block(const Prob& q, const Ws& w, int b) {
  __shared__ float red[27 * kThreads / 32];
  if (b < q.K) {
    const int k = b;
    float v[27];  // g 6, then the upper 6x6 triangle
    for (int i = 0; i < 27; ++i) v[i] = 0.f;
    for (int j = w.L.off_kf[k] + threadIdx.x; j < w.L.off_kf[k + 1]; j += kThreads) {
      const int o = w.L.list_kf[j];
      const float* J = w.J + (size_t)9 * kR * o;
      const float* r = w.r + (size_t)kR * o;
      const float wt = w.w[o];
      int n = 6;
      for (int a = 0; a < 6; ++a) {
        float g = J[a] * r[0] + J[6 + a] * r[1];
        if (kR == 3) g += J[12 + a] * r[2];
        v[a] += wt * g;
        for (int b2 = a; b2 < 6; ++b2) {
          float h = J[a] * J[b2] + J[6 + a] * J[6 + b2];
          if (kR == 3) h += J[12 + a] * J[12 + b2];
          v[n++] += wt * h;
        }
      }
    }
    block_sum_fixed<27>(v, red);
    if (threadIdx.x == 0) {
      for (int a = 0; a < 6; ++a) w.g[6 * k + a] = v[a];
      for (int i = 0; i < 21; ++i) w.Hpp[21 * k + i] = v[6 + i];
    }
    return;
  }
  const int m = (b - q.K) * kThreads + threadIdx.x;
  if (m >= q.P) return;
  float g[3] = {0.f, 0.f, 0.f}, H[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = w.L.off_mp[m]; j < w.L.off_mp[m + 1]; ++j) {
    const int o = w.L.list_mp[j];
    const float* J = w.J + (size_t)9 * kR * o + 6 * kR;
    const float* r = w.r + (size_t)kR * o;
    const float wt = w.w[o];
    int n = 0;
    for (int a = 0; a < 3; ++a) {
      float ga = J[a] * r[0] + J[3 + a] * r[1];
      if (kR == 3) ga += J[6 + a] * r[2];
      g[a] += wt * ga;
      for (int b2 = a; b2 < 3; ++b2) {
        float h = J[a] * J[b2] + J[3 + a] * J[3 + b2];
        if (kR == 3) h += J[6 + a] * J[6 + b2];
        H[n++] += wt * h;
      }
    }
  }
  for (int a = 0; a < 3; ++a) w.g[(size_t)6 * q.K + 3 * m + a] = g[a];
  for (int i = 0; i < 6; ++i) w.Hll[6 * m + i] = H[i];
}

__device__ __forceinline__ bool free_entry(const Prob& q, int e) {
  return e < 6 * q.K ? !q.fixed_kf[e / 6] : !q.fixed_mp[(e - 6 * q.K) / 3];
}

// block e: invert the damped block and start PCG on it; returns its r.z
__device__ __forceinline__ double invert_elem(const Prob& q, const Ws& w, int e, float lam) {
  double part = 0.0;
  if (e >= q.K + q.P) return part;
  if (e < q.K) {
    float* M = w.Mp + 36 * e;
    inv6_damped(w.Hpp + 21 * e, lam, M);
    const bool fr = !q.fixed_kf[e];
    float rb[6];
    for (int a = 0; a < 6; ++a) {
      rb[a] = fr ? w.g[6 * e + a] : 0.f;
      w.res[6 * e + a] = rb[a];
      w.x[6 * e + a] = 0.f;
      w.p[6 * e + a] = 0.f;
    }
    for (int a = 0; a < 6; ++a) {
      float s = 0.f;
      for (int b = 0; b < 6; ++b) s += M[6 * a + b] * rb[b];
      s = fr ? s : 0.f;
      w.z[6 * e + a] = s;
      part += (double)(rb[a] * s);
    }
  } else {
    const int m = e - q.K;
    float* Mi = w.Ml + 9 * m;
    inv3_damped(w.Hll + 6 * m, lam, Mi);
    const size_t base = (size_t)6 * q.K + (size_t)3 * m;
    const bool fr = !q.fixed_mp[m];
    float rb[3];
    for (int a = 0; a < 3; ++a) {
      rb[a] = fr ? w.g[base + a] : 0.f;
      w.res[base + a] = rb[a];
      w.x[base + a] = 0.f;
      w.p[base + a] = 0.f;
    }
    for (int a = 0; a < 3; ++a) {
      float s = Mi[3 * a] * rb[0] + Mi[3 * a + 1] * rb[1] + Mi[3 * a + 2] * rb[2];
      s = fr ? s : 0.f;
      w.z[base + a] = s;
      part += (double)(rb[a] * s);
    }
  }
  return part;
}

// beta of PCG iteration it from rz[it] and rz[it - 1]
__device__ __forceinline__ float beta_from(int it, double rz_it, double rz_prev) {
  return it == 0 ? 0.f : (float)(rz_it / fmax(rz_prev, 1e-20));
}

// list entry j's companion index: the point of keyframe list entry j, the
// keyframe of point list entry j (one dependent load less in the sweeps)
__device__ __forceinline__ void list_companions(const Prob& q, const Ws& w, int j) {
  if (j < w.L.off_kf[q.K]) w.mp_of_kf[j] = q.obs_mp[w.L.list_kf[j]];
  if (j < w.L.off_mp[q.P]) w.kf_of_mp[j] = q.obs_kf[w.L.list_mp[j]];
}

// the direction p = z + beta p of block base..base+n (0 on a fixed block),
// built on the fly
template <int n>
__device__ __forceinline__ void direction(const Ws& w, size_t base, bool fr, float beta,
                                          float* v) {
  for (int i = 0; i < n; ++i) v[i] = fr ? w.z[base + i] + beta * w.p[base + i] : 0.f;
}

// u = w_o J_o (vp, vl) of observation o
template <int kR>
__device__ __forceinline__ void obs_u(const Ws& w, int o, const float* vp, const float* vl,
                                      float* u) {
  const float* J = w.J + (size_t)9 * kR * o;
  for (int rr = 0; rr < kR; ++rr) {
    float s = 0.f;
    for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * vp[i];
    for (int i = 0; i < 3; ++i) s += J[6 * kR + 3 * rr + i] * vl[i];
    u[rr] = s * w.w[o];
  }
}

// list entries a thread takes together in the product's sweeps: their loads
// are issued at once (an entry past the list's end loads the chunk's first
// entry and adds nothing), their sums still in list order
constexpr int kChunk = 4;

// h = J^T W J p: a CTA per keyframe and a thread per point, over their
// lists; the list's own block's direction is built once.  All threads of
// the CTA must call it.
template <int kR>
__device__ void hv_block(const Prob& q, const Ws& w, int b, float beta) {
  __shared__ float red[6 * kThreads / 32];
  const size_t lb0 = (size_t)6 * q.K;
  if (b < q.K) {
    const int k = b;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, vp[6];
    direction<6>(w, (size_t)6 * k, !q.fixed_kf[k], beta, vp);
    const int end = w.L.off_kf[k + 1];
    for (int j0 = w.L.off_kf[k] + threadIdx.x; j0 < end; j0 += kChunk * kThreads) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c * kThreads;
        const bool on = j < end;
        const int jj = on ? j : j0;
        const int o = w.L.list_kf[jj], m = w.mp_of_kf[jj];
        float vl[3], u[3];
        direction<3>(w, lb0 + (size_t)3 * m, !q.fixed_mp[m], beta, vl);
        obs_u<kR>(w, o, vp, vl, u);
        const float* J = w.J + (size_t)9 * kR * o;
        for (int i = 0; i < 6; ++i) {
          float s = J[i] * u[0] + J[6 + i] * u[1];
          if (kR == 3) s += J[12 + i] * u[2];
          if (on) v[i] += s;
        }
      }
    }
    block_sum_fixed<6>(v, red);
    if (threadIdx.x == 0)
      for (int i = 0; i < 6; ++i) w.h[6 * k + i] = v[i];
    return;
  }
  const int m = (b - q.K) * kThreads + threadIdx.x;
  if (m >= q.P) return;
  float hl[3] = {0.f, 0.f, 0.f}, vl[3];
  direction<3>(w, lb0 + (size_t)3 * m, !q.fixed_mp[m], beta, vl);
  const int end = w.L.off_mp[m + 1];
  for (int j0 = w.L.off_mp[m]; j0 < end; j0 += kChunk) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      const bool on = j < end;
      const int jj = on ? j : j0;
      const int o = w.L.list_mp[jj], kf = w.kf_of_mp[jj];
      float vp[6], u[3];
      direction<6>(w, (size_t)6 * kf, !q.fixed_kf[kf], beta, vp);
      obs_u<kR>(w, o, vp, vl, u);
      const float* J = w.J + (size_t)9 * kR * o + 6 * kR;
      for (int i = 0; i < 3; ++i) {
        float s = J[i] * u[0] + J[3 + i] * u[1];
        if (kR == 3) s += J[6 + i] * u[2];
        if (on) hl[i] += s;
      }
    }
  }
  for (int i = 0; i < 3; ++i) w.h[lb0 + 3 * m + i] = hl[i];
}

// scalar e: p = z + beta p, Ap = (h + lam p) masked; returns its p.Ap
__device__ __forceinline__ double cg_a_elem(const Prob& q, const Ws& w, int e, float beta,
                                            float lam) {
  if (e >= 6 * q.K + 3 * q.P) return 0.0;
  const bool fr = free_entry(q, e);
  const float pe = fr ? w.z[e] + beta * w.p[e] : 0.f;
  const float ap = fr ? w.h[e] + lam * pe : 0.f;
  w.p[e] = pe;
  w.Ap[e] = ap;
  return (double)(pe * ap);
}

// block e: x += alpha p, r -= alpha Ap, z = M r; returns its r.z
template <int n>
__device__ __forceinline__ double cg_b_block(const Ws& w, size_t base, bool fr, const float* M,
                                             float alpha) {
  double part = 0.0;
  float rb[n];
  for (int a = 0; a < n; ++a) {
    w.x[base + a] += alpha * w.p[base + a];
    rb[a] = w.res[base + a] - alpha * w.Ap[base + a];
    w.res[base + a] = rb[a];
  }
  for (int a = 0; a < n; ++a) {
    float s = 0.f;
    for (int b = 0; b < n; ++b) s += M[n * a + b] * rb[b];
    s = fr ? s : 0.f;
    w.z[base + a] = s;
    part += (double)(rb[a] * s);
  }
  return part;
}

__device__ __forceinline__ double cg_b_elem(const Prob& q, const Ws& w, int e, float alpha) {
  if (e >= q.K + q.P) return 0.0;
  if (e < q.K) return cg_b_block<6>(w, (size_t)6 * e, !q.fixed_kf[e], w.Mp + 36 * e, alpha);
  const int m = e - q.K;
  return cg_b_block<3>(w, (size_t)6 * q.K + (size_t)3 * m, !q.fixed_mp[m], w.Ml + 9 * m, alpha);
}

// block e of the candidate (Rn, tn, pn): the state (R, t, pts) moved by -x
__device__ __forceinline__ void retract_elem(const float* R, const float* t, const float* pts,
                                             const Prob& q, const Ws& w, int e, float* Rn,
                                             float* tn, float* pn) {
  if (e < q.K) {
    float xi[6];
    for (int i = 0; i < 6; ++i) xi[i] = -w.x[6 * e + i];
    retract_pose(R + 9 * e, t + 3 * e, xi, Rn + 9 * e, tn + 3 * e);
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    const size_t base = (size_t)6 * q.K + (size_t)3 * m;
    for (int i = 0; i < 3; ++i) pn[3 * m + i] = pts[3 * m + i] - w.x[base + i];
  }
}

// observation o's robust cost at (R, t, pts)
template <bool kS, class C>
__device__ __forceinline__ float cost_obs(const float* R, const float* t, const float* pts,
                                          const Prob& q, const C& cam, bool huber, int o) {
  if (o >= q.O || !q.valid[o]) return 0.f;
  const int kf = q.obs_kf[o];
  return rho(obs_chi2_rows<kS>(R + 9 * kf, t + 3 * kf, pts, q, cam, o), huber,
             obs_delta<kS>(q, o));
}

// observation o an inlier (chi2 <= chi2_th, 7.815 on a stereo row); returns
// its chi2 (0 when invalid)
template <bool kS, class C>
__device__ __forceinline__ float classify_obs(const float* R, const float* t, const float* pts,
                                              const Prob& q, const C& cam, float chi2_th,
                                              bool* inl, int o) {
  float c = 0.f;
  if (o < q.O) {
    if (!q.valid[o]) {
      inl[o] = false;
    } else {
      const int kf = q.obs_kf[o];
      c = obs_chi2_rows<kS>(R + 9 * kf, t + 3 * kf, pts, q, cam, o);
      inl[o] = c <= obs_gate<kS>(q, o, chi2_th);
    }
  }
  return c;
}

// ---------------------------------------------------------------- the
// multi-launch passes (K33, K35's route), scalars in the workspace

__device__ __forceinline__ int gid() { return blockIdx.x * blockDim.x + threadIdx.x; }

__device__ __forceinline__ float beta_of(const Ws& w, int it) {
  return it == 0 ? 0.f : beta_from(it, *rz(w, it), *rz(w, it - 1));
}

template <bool kS, class C>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* R, const float* t, const float* pts, const Prob q, const C cam,
             bool huber, Ws w) {
  reduce_store((double)build_obs<kS>(R, t, pts, q, cam, huber, w, gid()), w.part, w.ticket,
               cost_old(w));
}

template <int kR>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const Prob q, Ws w) {
  reduce_block<kR>(q, w, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads) invert_kernel(const Prob q, Ws w) {
  reduce_store(invert_elem(q, w, gid(), (float)*w.lam), w.part, w.ticket, rz(w, 0));
}

template <int kR>
__global__ void __launch_bounds__(kThreads) hv_kernel(const Prob q, Ws w, int it) {
  hv_block<kR>(q, w, blockIdx.x, beta_of(w, it));
}

__global__ void __launch_bounds__(kThreads) cg_a_kernel(const Prob q, Ws w, int it, int cg) {
  reduce_store(cg_a_elem(q, w, gid(), beta_of(w, it), (float)*w.lam), w.part, w.ticket,
               pAp(w, it, cg));
}

__global__ void __launch_bounds__(kThreads) cg_b_kernel(const Prob q, Ws w, int it, int cg) {
  const float alpha = (float)(*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
  reduce_store(cg_b_elem(q, w, gid(), alpha), w.part, w.ticket, rz(w, it + 1));
}

__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* R, const float* t, const float* pts, const Prob q, Ws w) {
  retract_elem(R, t, pts, q, w, gid(), w.Rn, w.tn, w.pn);
}

template <bool kS, class C>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const Prob q, const C cam, bool huber, Ws w) {
  reduce_store((double)cost_obs<kS>(w.Rn, w.tn, w.pn, q, cam, huber, gid()), w.part, w.ticket,
               cost_new(w));
}

// keep the candidate only if the cost fell; lambda x0.5 or x4
__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ R, float* __restrict__ t, float* __restrict__ pts,
              const Prob q, Ws w, float* __restrict__ cost_out) {
  const int e = gid();
  if (e == 0) *cost_out = fminf((float)*cost_new(w), (float)*cost_old(w));
  lm_accept(w.sc, w.lam, e, q.K, q.P, w.Rn, w.tn, w.pn, R, t, pts);
}

// the inliers; with sum_chi2 (K33) also the sum of chi2 over the valid
// observations, into cost_new
template <bool kS, class C>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* R, const float* t, const float* pts, const Prob q, const C cam,
                float chi2_th, bool* __restrict__ inl, bool sum_chi2, Ws w) {
  const float c = classify_obs<kS>(R, t, pts, q, cam, chi2_th, inl, gid());
  if (sum_chi2) reduce_store((double)c, w.part, w.ticket, cost_new(w));
}

__global__ void __launch_bounds__(kThreads) companions_kernel(const Prob q, Ws w) {
  if (gid() < q.O) list_companions(q, w, gid());
}

__global__ void final_cost_kernel(Ws w, float* cost_out) { *cost_out = (float)*cost_new(w); }

__global__ void init_kernel(Ws w, float* cost_out) {
  *w.lam = 1e-4;
  *w.ticket = 0u;
  *cost_out = INFINITY;
}

inline int blocks(long long n) { return n_blocks(n); }

// one shard of a solve: its start poses and points (overwritten with the
// result), its observations, workspace, inlier mask and cost
struct Shard {
  float* R;
  float* t;
  float* pts;
  Prob q;
  Ws w;
  bool* inl;
  float* cost;
};

// ---------------------------------------------------------------- K6: the
// whole solve in one cluster of G CTAs of kThreads (G = kClusterMax, or 8
// where that many do not fit on the card).  Pass by pass, CTA rank runs the
// multi-launch grid's CTAs as virtual blocks b = rank, rank + G, ..., and a
// cluster barrier stands where a kernel boundary stood.  A scalar's block
// partial (the same warp tree) is written through DSMEM into slot b of the
// scalar's region in every CTA's shared memory, and after the barrier each
// CTA sums its copy in block order, as reduce_store's last CTA does: every
// CTA holds the same alpha, beta, costs and lambda, and the solve is
// bit-equal to the multi-launch sequence whatever G is.  The
// candidate and the state swap buffers at an accepted step instead of
// being copied.

// CTA 0's clock64 per phase kind, in a build of chip_anatomy.py only
#ifndef K6_STAMP
#define K6_STAMP(kind)
#endif
#ifndef K6_CLUSTER
#define K6_CLUSTER 16
#endif
constexpr int kClusterMax = K6_CLUSTER;
enum Phase : int { kLists = 0, kBuild, kReduce, kInvert, kHv, kCgA, kCgB, kRetract, kCost,
                   kAccept, kFinal, kWait, kSum, kHvPoints, kPhases };
// the scalars' regions of slots in each CTA's shared memory
enum Region : int { kCostOld = 0, kCostNew, kRz, kPAp, kRegions };

// virtual block b's partial of v (the warp tree, then the warps in order,
// as reduce_store) into slot b of region in each of the cluster's G CTAs.
// All threads must call it.
__device__ void block_partial(cg::cluster_group& cl, int G, double v, double* region, int b) {
  __shared__ double red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w2 = 0; w2 < kThreads / 32; ++w2) s += red[w2];
    for (int r = 0; r < G; ++r) *cl.map_shared_rank(region + b, r) = s;
  }
  __syncthreads();
}

// the sum in block order of this CTA's copy of nb partials; every thread
// sums them itself (eight loads issued ahead of their adds)
__device__ double region_sum(const double* region, int nb) {
  double s = 0.0;
  int b = 0;
  for (; b + 8 <= nb; b += 8) {
    double x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = region[b + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += x[i];
  }
  for (; b < nb; ++b) s += region[b];
  return s;
}

// R, t, pts: the start state, overwritten with the result; n_slots slots a
// region (the largest pass's blocks)
template <bool kS, class C>
__global__ void __launch_bounds__(kThreads, 1)
solve_cluster_kernel(float* R, float* t, float* pts, const Prob q, const C cam, int n_iters,
                     int cg_iters, bool huber, float chi2_th, Ws w, bool* inl, float* cost_out,
                     int n_slots) {
  constexpr int kR = kRows<kS>;
  extern __shared__ double slots[];
  __shared__ int scan_sh[kThreads];
  cg::cluster_group cl = cg::this_cluster();
  const int G = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  K6_STAMP(kPhases);  // the start
  const int K = q.K, P = q.P, O = q.O;
  const int nbO = n_blocks(O), nbV = n_blocks(6LL * K + 3LL * P), nbB = n_blocks(K + P);
  const int nbP = n_blocks(P);
  const int tid = rank * kThreads + threadIdx.x, nth = G * kThreads;
  double* s_old = slots + kCostOld * n_slots;
  double* s_new = slots + kCostNew * n_slots;
  double* s_rz = slots + kRz * n_slots;
  double* s_pap = slots + kPAp * n_slots;
  auto sync = [&]() {
    cl.sync();
    K6_STAMP(kWait);
  };
  auto partial = [&](double v, double* region, int b) { block_partial(cl, G, v, region, b); };
  auto sum = [&](double* region, int nb) {
    const double v = region_sum(region, nb);
    K6_STAMP(kSum);
    return v;
  };
#define MY_BLOCKS(b, nb) for (int b = rank; b < (nb); b += G)
#define ELEM(b) ((b) * kThreads + (int)threadIdx.x)
  // The reduce and product passes deal their point blocks K + j from the
  // other end of the cluster (j = G - 1 - rank, ...), so that the keyframes
  // that hold observations (the first) and the point blocks that do (the
  // first) start on different CTAs.
#define MY_POINT_BLOCKS(b) for (int b = K + G - 1 - rank; b < K + nbP; b += G)

  // the lists: build_lists's passes
  for (int i = tid; i < K + 2 * P; i += nth) w.L.cnt_kf[i] = 0;  // cnt_kf, cnt_mp, cur_mp
  sync();
  for (int o = tid; o < O; o += nth) lists_count_obs(q.obs_kf, q.obs_mp, q.valid, O, w.L, o);
  sync();
  if (rank == 0) block_scan_into<kThreads>(w.L.cnt_kf, K, w.L.off_kf, scan_sh);
  if (rank == G - 1) block_scan_into<kThreads>(w.L.cnt_mp, P, w.L.off_mp, scan_sh);
  sync();
  MY_BLOCKS(k, K) lists_fill_kf_block(q.obs_kf, q.valid, O, w.L, k);
  for (int o = tid; o < O; o += nth) lists_fill_mp_obs(q.obs_mp, q.valid, O, w.L, o);
  sync();
  for (int m = tid; m < P; m += nth) lists_sort_mp_point(P, w.L, m);
  sync();
  for (int j = tid; j < O; j += nth) list_companions(q, w, j);
  K6_STAMP(kLists);
  sync();

  float *cR = R, *ct = t, *cp = pts;          // the state
  float *nR = w.Rn, *nt = w.tn, *np = w.pn;   // the candidate
  double lam = 1e-4;
  float cost = INFINITY;
  for (int it = 0; it < n_iters; ++it) {
    MY_BLOCKS(b, nbO)
      partial((double)build_obs<kS>(cR, ct, cp, q, cam, huber, w, ELEM(b)), s_old, b);
    K6_STAMP(kBuild);
    sync();
    const double c_old = sum(s_old, nbO);
    MY_BLOCKS(b, K) reduce_block<kR>(q, w, b);
    MY_POINT_BLOCKS(b) reduce_block<kR>(q, w, b);
    K6_STAMP(kReduce);
    sync();
    const float lamf = (float)lam;
    MY_BLOCKS(b, nbB) partial(invert_elem(q, w, ELEM(b), lamf), s_rz, b);
    K6_STAMP(kInvert);
    sync();
    double rz_cur = sum(s_rz, nbB), rz_prev = 0.0;
    for (int c = 0; c < cg_iters; ++c) {
      const float beta = beta_from(c, rz_cur, rz_prev);
      MY_BLOCKS(b, K) hv_block<kR>(q, w, b, beta);
      K6_STAMP(kHv);
      MY_POINT_BLOCKS(b) hv_block<kR>(q, w, b, beta);
      K6_STAMP(kHvPoints);
      sync();
      MY_BLOCKS(b, nbV) partial(cg_a_elem(q, w, ELEM(b), beta, lamf), s_pap, b);
      K6_STAMP(kCgA);
      sync();
      const float alpha = (float)(rz_cur / fmax(sum(s_pap, nbV), 1e-20));
      // the last sweep's r.z is never read: no partial and no barrier, as
      // the retraction reads x where this thread wrote it
      const bool last = c + 1 == cg_iters;
      MY_BLOCKS(b, nbB) {
        const double part = cg_b_elem(q, w, ELEM(b), alpha);
        if (!last) partial(part, s_rz, b);
      }
      K6_STAMP(kCgB);
      if (!last) {
        sync();
        rz_prev = rz_cur;
        rz_cur = sum(s_rz, nbB);
      }
    }
    MY_BLOCKS(b, nbB) retract_elem(cR, ct, cp, q, w, ELEM(b), nR, nt, np);
    K6_STAMP(kRetract);
    sync();
    MY_BLOCKS(b, nbO) partial((double)cost_obs<kS>(nR, nt, np, q, cam, huber, ELEM(b)), s_new, b);
    K6_STAMP(kCost);
    sync();
    // lm_accept's rule, the step taken by swapping the buffers
    const double c_new = sum(s_new, nbO);
    const bool better = (float)c_new < (float)c_old;
    lam = better ? lam * 0.5 : lam * 4.0;
    cost = fminf((float)c_new, (float)c_old);
    if (better) {
      float* tmp;
      tmp = cR; cR = nR; nR = tmp;
      tmp = ct; ct = nt; nt = tmp;
      tmp = cp; cp = np; np = tmp;
    }
    K6_STAMP(kAccept);
  }
  // the result into (R, t, pts), the rotations re-orthonormalized
  for (int e = tid; e < K; e += nth) {
    orthonormalize_rot(cR + 9 * e, R + 9 * e);
    if (ct != t)
      for (int i = 0; i < 3; ++i) t[3 * e + i] = ct[3 * e + i];
  }
  if (cp != pts)
    for (int i = tid; i < 3 * P; i += nth) pts[i] = cp[i];
  sync();
  for (int o = tid; o < O; o += nth) classify_obs<kS>(R, t, pts, q, cam, chi2_th, inl, o);
  if (tid == 0) *cost_out = cost;
  K6_STAMP(kFinal);
#undef MY_BLOCKS
#undef MY_POINT_BLOCKS
#undef ELEM
}

// the cluster size for dynamic shared memory smem: kClusterMax CTAs where
// the card can place such a cluster, else 8; raises (an error) where
// neither fits.  cache keeps the largest smem asked for and the answer.
template <class F>
cudaError_t pick_cluster(F kernel, size_t smem, std::atomic<long long>& cache, int* G) {
  cudaError_t e;
  if (kClusterMax > 8 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return e;
  const long long c = cache.load();   // smem << 8 | G
  if ((c & 0xff) != 0 && (size_t)(c >> 8) >= smem) {
    *G = (int)(c & 0xff);
    return cudaSuccess;
  }
  *G = 0;
  for (int g = kClusterMax; g >= 8 && *G == 0; g /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess) return e;
    if (n >= 1) *G = g;
  }
  if (*G == 0) return cudaErrorInvalidConfiguration;  // not even 8 CTAs fit
  cache.store((long long)smem << 8 | *G);
  return cudaSuccess;
}

template <bool kS, class C>
int solve_cluster(Shard& S, const C& cam, int n_iters, int cg_iters, bool huber, float chi2_th,
                  cudaStream_t st) {
  const int K = S.q.K, P = S.q.P, O = S.q.O;
  int nb = n_blocks(O);
  nb = max(nb, n_blocks(6LL * K + 3LL * P));
  nb = max(nb, n_blocks(K + P));
  void (*kernel)(float*, float*, float*, const Prob, const C, int, int, bool, float, Ws, bool*,
                 float*, int) = solve_cluster_kernel<kS, C>;
  const int n_slots = nb;
  const size_t smem = sizeof(double) * kRegions * (size_t)n_slots;
  static std::atomic<long long> cache{0};
  int G;
  cudaError_t e = pick_cluster(kernel, smem, cache, &G);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, S.R, S.t, S.pts, S.q, cam, n_iters, cg_iters, huber,
                         chi2_th, S.w, S.inl, S.cost, n_slots);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool kS, class C>
int solve(int n, Shard* sh, ShardComm& cm, const C& cam, int n_iters, int cg_iters, bool huber,
          float chi2_th, bool sharded, void* dense) {
  constexpr int kR = kRows<kS>;
  const int K = sh[0].q.K, P = sh[0].q.P;
  const long long nv = 6LL * K + 3LL * P;
  const int nbP = blocks(P);
  cudaError_t e;
  float *g[kMaxShards], *Hp[kMaxShards], *Hl[kMaxShards], *h[kMaxShards];
  double* c_old[kMaxShards];
  double* c_new[kMaxShards];
  for (int s = 0; s < n; ++s) {
    g[s] = sh[s].w.g;
    Hp[s] = sh[s].w.Hpp;
    Hl[s] = sh[s].w.Hll;
    h[s] = sh[s].w.h;
    c_old[s] = sh[s].w.sc;       // cost_old
    c_new[s] = sh[s].w.sc + 1;   // cost_new
  }
// the statement for every shard, on its device and stream
#define EACH(...)                                                     \
  for (int s = 0; s < n; ++s) {                                       \
    if ((e = use_shard(cm, s)) != cudaSuccess) return (int)e;         \
    Shard& S = sh[s];                                                 \
    const cudaStream_t st = cm.st[s];                                 \
    __VA_ARGS__;                                                      \
  }
#define SUM(ptrs, count) \
  if ((e = allreduce(cm, ptrs, count)) != cudaSuccess) return (int)e;
  EACH(init_kernel<<<1, 1, 0, st>>>(S.w, S.cost);
       if ((e = build_lists(S.q.obs_kf, S.q.obs_mp, S.q.valid, K, P, S.q.O, S.w.L, st)) !=
           cudaSuccess) return (int)e;
       companions_kernel<<<blocks(S.q.O), kThreads, 0, st>>>(S.q, S.w))
  for (int it = 0; it < n_iters; ++it) {
    EACH(build_kernel<kS, C><<<blocks(S.q.O), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, cam,
                                                                   huber, S.w);
         reduce_kernel<kR><<<K + nbP, kThreads, 0, st>>>(S.q, S.w))
    SUM(g, nv)
    SUM(Hp, 21LL * K)
    SUM(Hl, 6LL * P)
    SUM(c_old, 1)
    if (dense != nullptr) {
      const Ws& W = sh[0].w;
      const SchurDenseArgs a{W.J, W.w, W.g, W.Hpp, W.Hll, W.lam, W.L.off_kf, W.L.list_kf,
                             W.L.off_mp, W.L.list_mp, sh[0].q.obs_kf, sh[0].q.obs_mp,
                             sh[0].q.fixed_kf, sh[0].q.fixed_mp, K, P, sh[0].q.O, kR, dense,
                             W.x};
      if ((e = (cudaError_t)ba_schur_dense_step(a, cm.st[0])) != cudaSuccess) return (int)e;
    } else {
      EACH(invert_kernel<<<blocks(K + P), kThreads, 0, st>>>(S.q, S.w))
      for (int c = 0; c < cg_iters; ++c) {
        EACH(hv_kernel<kR><<<K + nbP, kThreads, 0, st>>>(S.q, S.w, c))
        SUM(h, nv)
        EACH(cg_a_kernel<<<blocks(nv), kThreads, 0, st>>>(S.q, S.w, c, cg_iters);
             cg_b_kernel<<<blocks(K + P), kThreads, 0, st>>>(S.q, S.w, c, cg_iters))
      }
    }
    EACH(retract_kernel<<<blocks(K + P), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, S.w);
         cost_kernel<kS, C><<<blocks(S.q.O), kThreads, 0, st>>>(S.q, cam, huber, S.w))
    SUM(c_new, 1)
    EACH(accept_kernel<<<blocks(K + P), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, S.w, S.cost);
         if ((e = cudaGetLastError()) != cudaSuccess) return (int)e)
  }
  EACH(orthonormalize_kernel<<<blocks(K), kThreads, 0, st>>>(S.R, K);
       classify_kernel<kS, C><<<blocks(S.q.O), kThreads, 0, st>>>(S.R, S.t, S.pts, S.q, cam,
                                                                  chi2_th, S.inl, sharded, S.w))
  if (sharded) {
    SUM(c_new, 1)
    if ((e = use_shard(cm, 0)) != cudaSuccess) return (int)e;
    final_cost_kernel<<<1, 1, 0, cm.st[0]>>>(sh[0].w, sh[0].cost);
  }
#undef EACH
#undef SUM
  if ((e = use_shard(cm, 0)) != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kS>
int solve_cam(int n, Shard* sh, ShardComm& cm, float fx, float fy, float cx, float cy,
              const float* kb8, int n_iters, int cg_iters, bool huber, float chi2_th,
              bool sharded, void* dense) {
  if (kb8 != nullptr)
    return solve<kS>(n, sh, cm, CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_iters,
                     cg_iters, huber, chi2_th, sharded, dense);
  return solve<kS>(n, sh, cm, Cam{fx, fy, cx, cy}, n_iters, cg_iters, huber, chi2_th, sharded,
                   dense);
}

template <bool kS>
int solve_cluster_cam(Shard& S, float fx, float fy, float cx, float cy, const float* kb8,
                      int n_iters, int cg_iters, bool huber, float chi2_th, cudaStream_t st) {
  if (kb8 != nullptr)
    return solve_cluster<kS>(S, CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_iters,
                             cg_iters, huber, chi2_th, st);
  return solve_cluster<kS>(S, Cam{fx, fy, cx, cy}, n_iters, cg_iters, huber, chi2_th, st);
}

}  // namespace

// stereo: 1 with obs_ur (three residual rows), else 0
extern "C" long long ba_workspace_bytes(int K, int P, int O, int cg_iters, int stereo) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters, stereo ? 3 : 2);
}

// K33's peer route: bytes of the n slots on shard 0's device (the largest
// summed range: the gradient and the product, 6K + 3P floats, or the Hpp or
// Hll blocks)
extern "C" long long ba_pcg_gather_bytes(int n, int K, int P) {
  const size_t nv = 6 * (size_t)K + 3 * (size_t)P;
  size_t m = nv > 21 * (size_t)K ? nv : 21 * (size_t)K;
  m = m > 6 * (size_t)P ? m : 6 * (size_t)P;
  return (long long)n * (long long)align16(sizeof(float) * m);
}

// R (K,9), t (K,3), pts (P,3): the start state, overwritten with the result.
// obs_ur null: mono (K6); else (O,) right-image u, < 0 for a mono
// observation, with bf = fx * baseline (K6 <stereo>).  kb8 null: the pinhole
// camera; else a host array k1..k4 of the KB8 camera.  dense_ws null: PCG
// (solver "cg"); else ba_schur_dense_workspace_bytes(K, P, O) for K35
// (solver "schur_dense").
extern "C" int ba_pcg_launch(void* R, void* t, void* pts, const void* obs_kf, const void* obs_mp,
                             const void* obs_uv, const void* isig, const void* valid,
                             const void* fixed_kf, const void* fixed_mp, const void* obs_ur,
                             float bf, int K, int P, int O, float fx, float fy, float cx,
                             float cy, const float* kb8, int n_iters, int cg_iters, int use_huber,
                             float chi2_th, void* ws, void* dense_ws, void* inliers,
                             void* cost_out, void* stream) {
  if (K <= 0 || P <= 0 || O <= 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  Shard sh;
  sh.R = (float*)R;
  sh.t = (float*)t;
  sh.pts = (float*)pts;
  sh.q = Prob{(const int*)obs_kf, (const int*)obs_mp, (const float*)obs_uv, (const float*)isig,
              (const bool*)valid, (const bool*)fixed_kf, (const bool*)fixed_mp, K, P, O,
              (const float*)obs_ur, bf};
  carve(&sh.w, static_cast<uint8_t*>(ws), K, P, O, cg_iters, obs_ur != nullptr ? 3 : 2);
  sh.inl = (bool*)inliers;
  sh.cost = (float*)cost_out;
  if (dense_ws == nullptr) {  // K6: one cluster launch
    const cudaStream_t st = (cudaStream_t)stream;
    if (obs_ur != nullptr)
      return solve_cluster_cam<true>(sh, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                                     chi2_th, st);
    return solve_cluster_cam<false>(sh, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                                    chi2_th, st);
  }
  ShardComm cm;  // K35: K6's passes launched one by one around its step
  cm.st[0] = (cudaStream_t)stream;
  if (obs_ur != nullptr)
    return solve_cam<true>(1, &sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                           chi2_th, false, dense_ws);
  return solve_cam<false>(1, &sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                          chi2_th, false, dense_ws);
}

// K33: n shards of Os observations each, the poses and points on every
// shard.  devs (n,) the CUDA device of each shard; tab (n, 13) host rows of
// pointers: R (K,9), t (K,3), pts (P,3) (each shard's copy of the start
// state), obs_kf, obs_mp (global), obs_uv, isig, valid (Os), fixed_kf (K),
// fixed_mp (P), the shard's workspace (ba_workspace_bytes(K, P, Os,
// cg_iters, 0)), its inlier mask (Os) and its stream.  gather:
// ba_pcg_gather_bytes(n, K, P) on devs[0] when the devices differ, else
// null.  The result: every shard's R, t and pts (equal) and inliers;
// cost_out (float32, on devs[0]) the final sum of chi2 over every shard.
// The caller's current device is kept.
extern "C" int ba_pcg_sharded_launch(int n, const int* devs, const long long* tab, int K, int P,
                                     int Os, float fx, float fy, float cx, float cy,
                                     const float* kb8, int n_iters, int cg_iters, int use_huber,
                                     float chi2_th, void* gather, void* cost_out) {
  if (n < 1 || n > kMaxShards || K <= 0 || P <= 0 || Os <= 0 || n_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  Shard sh[kMaxShards];
  cudaStream_t sts[kMaxShards];
  for (int s = 0; s < n; ++s) {
    const long long* r = tab + 13 * (size_t)s;
    sh[s].R = (float*)r[0];
    sh[s].t = (float*)r[1];
    sh[s].pts = (float*)r[2];
    sh[s].q = Prob{(const int*)r[3], (const int*)r[4], (const float*)r[5], (const float*)r[6],
                   (const bool*)r[7], (const bool*)r[8], (const bool*)r[9], K, P, Os};
    carve(&sh[s].w, (uint8_t*)r[10], K, P, Os, cg_iters, 2);
    sh[s].inl = (bool*)r[11];
    sh[s].cost = s == 0 ? (float*)cost_out : sh[s].w.cst;
    sts[s] = (cudaStream_t)r[12];
  }
  int prev;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  ShardComm cm;
  e = comm_open(cm, n, devs, sts, gather, (size_t)ba_pcg_gather_bytes(1, K, P));
  int err = (int)e;
  if (e == cudaSuccess)
    err = solve_cam<false>(n, sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0,
                           chi2_th, true, nullptr);
  comm_close(cm);
  cudaSetDevice(prev);
  return err;
}
