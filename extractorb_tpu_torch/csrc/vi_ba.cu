// K20 vi_ba: visual-inertial bundle adjustment, Levenberg-Marquardt with a
// matrix-free PCG over 15-dim keyframe states (pose, velocity, gyro and acc
// biases) and 3-dim points.
//
// Replaces extractorb_tpu/solver/inertial.py:optimize_vi_ba (LocalInertialBA
// / FullInertialBA), which the TPU runs as a lax.scan of LM steps over jacfwd
// Jacobians, each a lax.scan of PCG sweeps.  K6's design (ba_pcg.cu) with
// wider pose blocks:
//   - visual rows: the camera sees a point through the fixed extrinsics
//     (pc = Rcb R^T (pw - t) + tcb); 2x6 Jacobians on the pose slice of the
//     body state and 2x3 on the point (imu_t.cuh vis_rj), through the camera
//     template parameter: the pinhole's closed form, or CamKB8's projection
//     Jacobian in Dual<3> (camera_t.cuh);
//   - chain edges: edge k joins keyframe k-1 and k with the whitened
//     15-dim [EdgeInertial; bias walk] residual and its two 15x15 Jacobians
//     in forward mode (imu_t.cuh's edge_r15), a warp an edge: lane l < 30
//     carries the values and tangent l % 15 of state l / 15 (Dual<1>), the
//     same operations as that tangent of a Dual<15> pass, so the same bits;
//     the Hessian is block-tridiagonal;
//   - KF0's bias priors on the diagonal, the fixed_kf / fixed_mp masks.
// The block-Jacobi preconditioner inverts 15x15 and 3x3 damped blocks.  The
// 15-dim state work runs over lanes in the order of the one-thread
// arithmetic: a 15x15 Gauss-Jordan on [A | M] in shared memory a lane a
// column, each z = M r a lane a row, each edge's J_k p_k + J_o p_o once a
// lane a row and J_k^T of it a lane a column.  The Hessian product is two
// passes: each observation's terms (a thread an observation, the
// keyframes' directions staged in shared memory) and each edge's (a warp),
// written in list order; then each keyframe's and point's sums of them.
// Every sum runs in a fixed order (det_reduce.cuh): each keyframe's
// observations in index order in one CTA, each point's in one thread, the
// scalars by per-CTA partials summed in block order, so the passes give the
// bits of a one-thread-per-row solve.  Each pass's arithmetic is one device
// function, run two ways:
//   * K20 (vi_ba_launch): the whole solve is one launch of one thread-block
//     cluster (solve_cluster_kernel, cluster.cuh): a cluster barrier stands
//     between two passes and the scalars go through distributed shared
//     memory, so nothing is launched or read back between the passes;
//   * the multi-launch sequence (solve): a kernel per pass, the scalars in a
//     small float64 block on the card, for K32 (n shards).
// Both sum in the same order, so they give the same bits.
//
// K32 replaces extractorb_tpu/dist/sharded_ba.py:optimize_vi_sharded on n > 1
// shards (its shard_map over a device mesh, the inertial post-loop GBA):
// shard s holds points [s Ps, (s+1) Ps) and the Os observations of those
// points (obs_mp local to the shard; relayout_point_sharded's layout), and a
// copy of the states and the chain.  It runs K20's passes on its own data,
// shard by shard, and where the JAX program psums, the shards' partials are
// summed in shard order (shard_sum.cuh): the visual cost, the visual
// gradient and 6x6 blocks (27 floats a keyframe), the visual part of each
// Hessian product (6 a keyframe), the landmark half of each PCG dot.  The
// chain edges and the priors are then added to those sums by a pass per
// keyframe on every shard, and the state side (the 15x15 inverses, the PCG
// steps on the states, the retraction, the accept) runs on every shard on
// the same sums, so the shards' states stay equal, as the replicated values
// of the shard_map do.  Only shard 0 counts the replicated parts of a
// scalar (the edges' cost, the state half of a dot).  One shard is K20's
// pass sequence, launched pass by pass.  Padding needs no case of its own:
// a padded observation is invalid (weight 0, on no list) and a padded point
// is fixed.
//
// Bound on the H100: latency, as K6.  A local window (11 keyframes, ~10k
// observations) is microseconds of arithmetic per pass, and the passes are
// dependent: 9 + n_iters (6 + 4 cg_iters) + 2 of them a solve.  In the
// cluster each costs a barrier and its slowest CTA's loads from L2 (the
// workspace, up to ~6 MB, stays there), which are why the Jacobians are
// stored a component at a time and the product's terms as rows in list
// order: chip_anatomy.py times the phases.  K32 on n shards of one card
// launches each pass n times plus a small sum kernel and a state pass at
// each reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kS = 21;   // floats per state: R 9, t 3, v 3, bg 3, ba 3
constexpr int kD = 15;   // tangent dims per keyframe

#include "dual.cuh"
#include "lie_t.cuh"
#include "imu_t.cuh"
#include "ba_obs.cuh"
#include "det_reduce.cuh"
#include "shard_sum.cuh"
#include "cluster.cuh"

// one tangent direction of an edge's Jacobian, a lane each
using D1 = Dual<1, float>;
template <>
__device__ __forceinline__ D1 cst<D1>(double v) { return dconst<1, float>((float)v); }

struct VProb {
  const int* obs_kf;
  const int* obs_mp;
  const float* obs_uv;
  const float* isig;
  const bool* valid;
  const bool* chain_valid;
  const bool* fixed_kf;
  const bool* fixed_mp;
  const float* chain;   // (K, 292)
  const float* ext;     // Rcb 9, tcb 3
  int K, P, O;
  float prior_g, prior_a;
};

struct VWs {
  float* Lr;    // (K,81)
  float* Lb;    // (K,36)
  float* Sn;    // (K,21) candidate states
  float* pn;    // (P,3)
  float* J;     // (18,O): pose slice 2x6 (phi, rho), point 2x3; component i at J[i O + o]
  float* w;     // (O,)
  float* r;     // (O,2)
  float* re;    // (K,15) edge residuals
  float* Ji;    // (K,225) edge Jacobians wrt the first and the second state
  float* Jj;
  float* g;     // (15K+3P)
  float* Hpp;   // (K,225)
  float* Hll;   // (P,6)
  float* h;
  float* Mp;    // (K,225)
  float* Ml;    // (P,9)
  float* x;
  float* res;
  float* z;
  float* p;
  float* Ap;
  float* vis;   // (K,27) a keyframe's visual gradient and 6x6 triangle (K32's sums)
  float* cst;   // the cost of a shard other than shard 0
  double* lam;
  double* sc;   // [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
  double* part;
  unsigned* ticket;
  Lists L;
  int* kpos;    // (O,) an observation's entry in L.list_kf
  int* ppos;    // (O,) in L.list_mp
  float* ck;    // (O,6) the product's keyframe terms, rows in L.list_kf's order
  float* dp;    // (O,4) its point terms (3 and a pad), rows in L.list_mp's order
  float* he;    // (K,3,15) J_k^T ue of each edge of each keyframe (edges_of's order)
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t carve(VWs* w, uint8_t* base, int K, int P, int O, int cg) {
  const size_t nv = (size_t)kD * K + (size_t)3 * P;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  auto f = [&](size_t n) { return (float*)take(sizeof(float) * n); };
  float* q;
  q = f((size_t)81 * K); if (w) w->Lr = q;
  q = f((size_t)36 * K); if (w) w->Lb = q;
  q = f((size_t)kS * K); if (w) w->Sn = q;
  q = f((size_t)3 * P);  if (w) w->pn = q;
  q = f((size_t)18 * O); if (w) w->J = q;
  q = f((size_t)O);      if (w) w->w = q;
  q = f((size_t)2 * O);  if (w) w->r = q;
  q = f((size_t)kD * K); if (w) w->re = q;
  q = f((size_t)225 * K); if (w) w->Ji = q;
  q = f((size_t)225 * K); if (w) w->Jj = q;
  q = f(nv);             if (w) w->g = q;
  q = f((size_t)225 * K); if (w) w->Hpp = q;
  q = f((size_t)6 * P);  if (w) w->Hll = q;
  q = f(nv);             if (w) w->h = q;
  q = f((size_t)225 * K); if (w) w->Mp = q;
  q = f((size_t)9 * P);  if (w) w->Ml = q;
  q = f(nv); if (w) w->x = q;
  q = f(nv); if (w) w->res = q;
  q = f(nv); if (w) w->z = q;
  q = f(nv); if (w) w->p = q;
  q = f(nv); if (w) w->Ap = q;
  q = f((size_t)27 * K); if (w) w->vis = q;
  q = f(1); if (w) w->cst = q;
  uint8_t* b;
  b = take(sizeof(double)); if (w) w->lam = (double*)b;
  b = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)b;
  const size_t max_blocks = (size_t)n_blocks(O > (long long)nv ? O : (long long)nv) + K + 2;
  b = take(sizeof(double) * max_blocks); if (w) w->part = (double*)b;
  b = take(sizeof(unsigned)); if (w) w->ticket = (unsigned*)b;
  b = take(sizeof(int) * ((size_t)K + 2 * (size_t)P));
  if (w) {
    w->L.cnt_kf = (int*)b;
    w->L.cnt_mp = w->L.cnt_kf + K;
    w->L.cur_mp = w->L.cnt_mp + P;
  }
  b = take(sizeof(int) * ((size_t)K + 1)); if (w) w->L.off_kf = (int*)b;
  b = take(sizeof(int) * ((size_t)P + 1)); if (w) w->L.off_mp = (int*)b;
  b = take(sizeof(int) * (size_t)O); if (w) w->L.list_kf = (int*)b;
  b = take(sizeof(int) * (size_t)O); if (w) w->L.list_mp = (int*)b;
  b = take(sizeof(int) * (size_t)O); if (w) w->kpos = (int*)b;
  b = take(sizeof(int) * (size_t)O); if (w) w->ppos = (int*)b;
  q = f((size_t)6 * O); if (w) w->ck = q;
  q = f((size_t)4 * O); if (w) w->dp = q;
  q = f((size_t)45 * K); if (w) w->he = q;
  return o;
}

__device__ __forceinline__ double* cost_old(const VWs& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const VWs& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const VWs& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const VWs& w, int it, int cg) { return w.sc + 3 + cg + it; }

// the observation's world point; a padding slot gets a point 1 m in front of
// its camera (inertial.py:_vis_residual_jac)
__device__ void obs_world(const float* S, const float* pts, const VProb& q, int o, float* pw) {
  if (q.valid[o]) {
    const int m = q.obs_mp[o];
    for (int i = 0; i < 3; ++i) pw[i] = pts[3 * m + i];
    return;
  }
  const float* Rcb = q.ext;
  const float* tcb = q.ext + 9;
  const float d[3] = {0.f - tcb[0], 0.f - tcb[1], 1.f - tcb[2]};
  float pb[3];
  for (int i = 0; i < 3; ++i) pb[i] = Rcb[i] * d[0] + Rcb[3 + i] * d[1] + Rcb[6 + i] * d[2];
  for (int i = 0; i < 3; ++i)
    pw[i] = S[3 * i] * pb[0] + S[3 * i + 1] * pb[1] + S[3 * i + 2] * pb[2] + S[9 + i];
}

template <class C>
__device__ float obs_cost(const float* states, const float* pts, const VProb& q, const C& cam,
                          int o, bool huber, float* r, float (*Jp)[6], float (*Jl)[3], float* wt) {
  const float* S = states + kS * q.obs_kf[o];
  float pw[3];
  obs_world(S, pts, q, o, pw);
  vis_rj(S, S + 9, pw, q.obs_uv + 2 * o, q.ext, q.ext + 9, cam, r, Jp, Jl);
  const float is = q.isig[o];
  const float chi2 = (r[0] * r[0] + r[1] * r[1]) * is;
  const float delta = huber_delta();
  if (wt) *wt = (huber ? fminf(delta / sqrtf(fmaxf(chi2, 1e-12f)), 1.f) : 1.f) * is;
  return rho(chi2, huber, delta);
}

// The passes' arithmetic, one device function each, shared by the
// multi-launch kernels (K32) and the cluster solve (K20): a virtual block b
// of kThreads threads is one CTA of the multi-launch grid (b = blockIdx.x
// there); an element e is a thread of it.

// the whitening factors of edge k, once per solve
__device__ __forceinline__ void setup_edge(const VProb& q, const VWs& w, int k) {
  if (k >= q.K) return;
  const float* C = q.chain + (size_t)kPk * k + 61;
  info_sqrt_blk<9>(C, 0, w.Lr + 81 * k);
  info_sqrt_blk<6>(C, 9, w.Lb + 36 * k);
}

// list entry j's observation's position in each list (where the product's
// per-observation pass writes its terms)
__device__ __forceinline__ void list_positions(const VProb& q, const VWs& w, int j) {
  if (j < w.L.off_kf[q.K]) w.kpos[w.L.list_kf[j]] = j;
  if (j < w.L.off_mp[q.P]) w.ppos[w.L.list_mp[j]] = j;
}

// edge k's residual and its Jacobians wrt the first and the second state
// at `states`, by a warp: lane l < 30 the values and the tangent of
// direction l % 15 of state l / 15 (every operation on a dual acts on each
// tangent alone, given the values).  An invalid edge gets zeros.  All
// lanes of the warp call it.
__device__ void edge_lin(const float* states, const VProb& q, const VWs& w, int k, int lane) {
  float* r = w.re + kD * k;
  float* Ji = w.Ji + 225 * k;
  float* Jj = w.Jj + 225 * k;
  if (!q.chain_valid[k]) {
    for (int i = lane; i < 225; i += 32) Ji[i] = Jj[i] = 0.f;
    if (lane < kD) r[lane] = 0.f;
    return;
  }
  if (lane >= 2 * kD) return;
  const int which = lane / kD, dir = lane % kD;
  const int i = k > 0 ? k - 1 : 0;
  D1 d0[kD], d1[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    d0[a] = dconst<1, float>(0.f);
    d1[a] = dconst<1, float>(0.f);
    d0[a].d[0] = which == 0 && a == dir ? 1.f : 0.f;
    d1[a].d[0] = which == 1 && a == dir ? 1.f : 0.f;
  }
  St<D1> A, B;
  apply_delta_t(states + kS * i, d0, A);
  apply_delta_t(states + kS * k, d1, B);
  D1 rr[kD];
  edge_r15(Pk{q.chain + (size_t)kPk * k}, w.Lr + 81 * k, w.Lb + 36 * k, A, B, rr);
  float* J = which == 0 ? Ji : Jj;
#pragma unroll
  for (int a = 0; a < kD; ++a) J[kD * a + dir] = rr[a].d[0];
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < kD; ++a) r[a] = rr[a].v;
}

// the block sum of n floats per thread in det_reduce.cuh's block_sum_fixed
// order (the warp tree, then the warps in order), thread i < n summing
// value i into out[i]; valid after the caller's next barrier.  All threads
// of the CTA must call it.
template <int n>
__device__ void block_sum_to(float (&v)[n], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  __syncthreads();
  if (lane == 0)
    for (int i = 0; i < n; ++i) red[warp * n + i] = v[i];
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.f;
    for (int w2 = 0; w2 < kWarps; ++w2) s += red[w2 * n + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// virtual block b of the build pass: blocks [0, nbO) a thread per
// observation (residual, Jacobian rows and weight into the workspace),
// block nbO the edges, a warp each, and their cost (counted by the lead
// shard only), a thread per edge.  Returns the thread's cost.  All threads
// of the CTA must call it.
template <class C>
__device__ float build_block(const float* states, const float* pts, const VProb& q, const C& cam,
                             bool huber, bool lead, const VWs& w, int b, int nbO) {
  float cost = 0.f;
  if (b < nbO) {
    const int o = b * kThreads + threadIdx.x;
    if (o < q.O) {
      if (q.valid[o]) {
        float r[2], Jp[2][6], Jl[2][3], wt;
        cost = obs_cost(states, pts, q, cam, o, huber, r, Jp, Jl, &wt);
        float* Jo = w.J + o;
        const size_t O = (size_t)q.O;
        for (int c = 0; c < 6; ++c) { Jo[c * O] = Jp[0][c]; Jo[(6 + c) * O] = Jp[1][c]; }
        for (int c = 0; c < 3; ++c) { Jo[(12 + c) * O] = Jl[0][c]; Jo[(15 + c) * O] = Jl[1][c]; }
        w.w[o] = wt;
        w.r[2 * o] = r[0];
        w.r[2 * o + 1] = r[1];
      } else {
        w.w[o] = 0.f;
      }
    }
    return cost;
  }
  for (int k = threadIdx.x >> 5; k < q.K; k += kWarps) edge_lin(states, q, w, k, threadIdx.x & 31);
  __syncthreads();
  if (lead)
    for (int k = threadIdx.x; k < q.K; k += kThreads) {
      if (!q.chain_valid[k]) continue;
      const float* r = w.re + kD * k;
      for (int a = 0; a < kD; ++a) cost += r[a] * r[a];
    }
  return cost;
}

// the edges at keyframe k: (edge, its Jacobian wrt k) pairs, in a fixed order
__device__ int edges_of(const VProb& q, const VWs& w, int k, int* e_out, const float** J_out,
                        const float** Jo_out, int* other) {
  int n = 0;
  if (q.chain_valid[k]) {  // edge k: k is its second state
    e_out[n] = k; J_out[n] = w.Jj + 225 * k; Jo_out[n] = w.Ji + 225 * k;
    other[n] = k > 0 ? k - 1 : 0; ++n;
  }
  const int e1 = k + 1;
  if (e1 < q.K && q.chain_valid[e1]) {  // edge k+1: k is its first state
    e_out[n] = e1; J_out[n] = w.Ji + 225 * e1; Jo_out[n] = w.Jj + 225 * e1; other[n] = e1; ++n;
  }
  if (k == 0 && q.chain_valid[0]) {  // edge 0 joins keyframe 0 to itself
    e_out[n] = 0; J_out[n] = w.Ji; Jo_out[n] = w.Jj; other[n] = 0; ++n;
  }
  return n;
}

// keyframe k's Hpp block and gradient from its visual sums vis (g 6, then the
// upper 6x6 triangle), its edges and KF0's priors; a CTA of >= 240 threads
__device__ void state_blocks(const VProb& q, const VWs& w, int k, const float* vis) {
  int es[3], oth[3];
  const float *Jk[3], *Jo[3];
  const int ne = edges_of(q, w, k, es, Jk, Jo, oth);
  const bool fr = !q.fixed_kf[k];
  const int t = threadIdx.x;
  if (t < 225) {
    const int a = t / kD, b = t % kD;
    float s = 0.f;
    if (a < 6 && b < 6) {
      const int lo = a < b ? a : b, hi = a < b ? b : a;
      s = vis[6 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
    }
    for (int e = 0; e < ne; ++e) {
      float acc = 0.f;
      for (int rr = 0; rr < kD; ++rr) acc += Jk[e][kD * rr + a] * Jk[e][kD * rr + b];
      s += acc;
    }
    if (k == 0 && a == b) s += a >= 12 ? q.prior_a : (a >= 9 ? q.prior_g : 0.f);
    w.Hpp[225 * k + t] = s;
  } else if (t < 225 + kD) {
    const int a = t - 225;
    float s = a < 6 ? vis[a] : 0.f;
    for (int e = 0; e < ne; ++e) {
      float acc = 0.f;
      for (int rr = 0; rr < kD; ++rr) acc += Jk[e][kD * rr + a] * w.re[kD * es[e] + rr];
      s += acc;
    }
    w.g[kD * k + a] = fr ? s : 0.f;
  }
}

// point m's gradient and 3x3 block over its list
__device__ void reduce_point(const VProb& q, const VWs& w, int m) {
  if (m >= q.P) return;
  float g[3] = {0.f, 0.f, 0.f}, H[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = w.L.off_mp[m]; j < w.L.off_mp[m + 1]; ++j) {
    const int o = w.L.list_mp[j];
    float J[6];
    for (int i = 0; i < 6; ++i) J[i] = w.J[(size_t)(12 + i) * q.O + o];
    const float wt = w.w[o], r0 = w.r[2 * o], r1 = w.r[2 * o + 1];
    int n = 0;
    for (int a = 0; a < 3; ++a) {
      g[a] += wt * (J[a] * r0 + J[3 + a] * r1);
      for (int b2 = a; b2 < 3; ++b2) H[n++] += wt * (J[a] * J[b2] + J[3 + a] * J[3 + b2]);
    }
  }
  const bool fr = !q.fixed_mp[m];
  for (int a = 0; a < 3; ++a) w.g[(size_t)kD * q.K + 3 * m + a] = fr ? g[a] : 0.f;
  for (int i = 0; i < 6; ++i) w.Hll[6 * m + i] = H[i];
}

// the gradient and the diagonal blocks: blocks [0, K) a CTA per keyframe
// (visual list and its edges), the rest a thread per point.  split (K32):
// a keyframe's CTA stores its visual sums in w.vis for the cross-shard sum,
// and state_kernel adds the edges after it.  All threads of the CTA must
// call it.
__device__ void reduce_block(const VProb& q, const VWs& w, int b, bool split) {
  __shared__ float red[27 * kWarps];
  __shared__ float vis[27];
  if (b >= q.K) {
    reduce_point(q, w, (b - q.K) * kThreads + threadIdx.x);
    return;
  }
  const int k = b;
  float v[27];
  for (int i = 0; i < 27; ++i) v[i] = 0.f;
  for (int j = w.L.off_kf[k] + threadIdx.x; j < w.L.off_kf[k + 1]; j += kThreads) {
    const int o = w.L.list_kf[j];
    float J[12];
    for (int i = 0; i < 12; ++i) J[i] = w.J[(size_t)i * q.O + o];
    const float wt = w.w[o], r0 = w.r[2 * o], r1 = w.r[2 * o + 1];
    int n = 6;
    for (int a = 0; a < 6; ++a) {
      v[a] += wt * (J[a] * r0 + J[6 + a] * r1);
      for (int b2 = a; b2 < 6; ++b2) v[n++] += wt * (J[a] * J[b2] + J[6 + a] * J[6 + b2]);
    }
  }
  block_sum_to<27>(v, red, split ? w.vis + 27 * k : vis);
  if (split) return;
  __syncthreads();
  state_blocks(q, w, k, vis);
}

// Mg = (H + lam I)^-1 of a 15x15 block by a warp: Gauss-Jordan with partial
// pivoting on [A | M] in X, lane j < 30 owning column j; every entry takes
// the one-thread elimination's operations in its order (the pivot rows'
// factors read before the pivot column changes).  X keeps M.  All lanes of
// the warp call it.
__device__ void inv15_warp(const float* H, float lam, float* Mg, float (*X)[2 * kD + 1],
                           int lane) {
  const bool mine = lane < 2 * kD;
  if (mine)
    for (int r = 0; r < kD; ++r)
      X[r][lane] = lane < kD ? H[kD * r + lane] + ((r == lane) ? lam : 0.f)
                             : ((r == lane - kD) ? 1.f : 0.f);
  __syncwarp();
  for (int c = 0; c < kD; ++c) {
    int piv = c;
    float best = fabsf(X[c][c]);
    for (int r = c + 1; r < kD; ++r) {
      const float v = fabsf(X[r][c]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    __syncwarp();
    if (mine && piv != c) {
      const float t = X[c][lane];
      X[c][lane] = X[piv][lane];
      X[piv][lane] = t;
    }
    __syncwarp();
    const float inv = 1.f / X[c][c];
    __syncwarp();
    if (mine) X[c][lane] *= inv;
    __syncwarp();
    float f[kD];
#pragma unroll
    for (int r = 0; r < kD; ++r) f[r] = X[r][c];
    __syncwarp();
    if (mine) {
      const float xc = X[c][lane];
#pragma unroll
      for (int r = 0; r < kD; ++r)
        if (r != c) X[r][lane] -= f[r] * xc;
    }
    __syncwarp();
  }
  if (lane >= kD && mine)
    for (int r = 0; r < kD; ++r) Mg[kD * r + lane - kD] = X[r][lane];
  __syncwarp();
}

// keyframe e's part of r.z (the lead shard's) from its r and z, in order
__device__ __forceinline__ double state_rz(const VWs& w, int e) {
  double part = 0.0;
  const size_t base = (size_t)kD * e;
  for (int a = 0; a < kD; ++a) part += (double)(w.res[base + a] * w.z[base + a]);
  return part;
}

// virtual block b of the invert pass, element e = b kThreads + threadIdx.x
// a block (keyframe e < K, else point e - K): the damped block's inverse
// and PCG's start (x = 0, r = g, p = 0, z = M r); returns the thread's part
// of r.z.  The keyframes' inverses and z rows run a warp each.  All threads
// of the CTA must call it.
__device__ double invert_block(const VProb& q, const VWs& w, int b, float lam, bool lead) {
  __shared__ float X[kWarps][kD][2 * kD + 1];
  const int e0 = b * kThreads, e = e0 + threadIdx.x;
  if (e0 < q.K) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = e0 + warp; k < q.K && k < e0 + kThreads; k += kWarps) {
      inv15_warp(w.Hpp + 225 * k, lam, w.Mp + 225 * k, X[warp], lane);
      if (lane < kD) {
        const size_t base = (size_t)kD * k;
        w.res[base + lane] = w.g[base + lane];
        w.x[base + lane] = 0.f;
        w.p[base + lane] = 0.f;
        float s = 0.f;
        for (int c = 0; c < kD; ++c) s += X[warp][lane][kD + c] * w.g[base + c];
        w.z[base + lane] = q.fixed_kf[k] ? 0.f : s;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  double part = 0.0;
  if (e < q.K) {
    if (lead) part = state_rz(w, e);
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    const size_t base = (size_t)kD * q.K + (size_t)3 * m;
    const bool fr = !q.fixed_mp[m];
    float* M = w.Ml + 9 * m;
    inv3_damped(w.Hll + 6 * m, lam, M);
    float rb[3];
    for (int a = 0; a < 3; ++a) {
      rb[a] = w.g[base + a];
      w.res[base + a] = rb[a];
      w.x[base + a] = 0.f;
      w.p[base + a] = 0.f;
    }
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
      for (int c = 0; c < 3; ++c) s += M[3 * a + c] * rb[c];
      s = fr ? s : 0.f;
      w.z[base + a] = s;
      part += (double)(rb[a] * s);
    }
  }
  return part;
}

// PCG's beta of iteration it from rz[it] and rz[it - 1]
__device__ __forceinline__ float beta_from(int it, double rz_it, double rz_prev) {
  return it == 0 ? 0.f : (float)(rz_it / fmax(rz_prev, 1e-20));
}

// p = z + beta p of entry e, masked
__device__ __forceinline__ float pdir(const VWs& w, size_t e, float beta, bool fr) {
  const float z = w.z[e], p = w.p[e];   // loaded whatever fr is: no wait for the mask
  return fr ? z + beta * p : 0.f;
}

// the direction p = z + beta p of block base..base+n (0 on a fixed block)
template <int n>
__device__ __forceinline__ void direction(const VWs& w, size_t base, bool fr, float beta,
                                          float* v) {
  for (int i = 0; i < n; ++i) v[i] = pdir(w, base + i, beta, fr);
}

// The Hessian-vector product in two passes.  First, per observation o (a
// thread each, anywhere in the grid or cluster), u = w_o J_o (vp_k, vl_m)
// and its terms J_pose^T u (6) and J_point^T u (3), written as rows at o's
// entries of the two lists; and per edge of each keyframe (a warp each)
// the chain's term J_k^T ue, ue = J_k p_k + J_other p_other.  Then per
// keyframe (a CTA) and per point (a thread) the sum of its list's rows in
// list order, the edges' terms and KF0's priors.  Each value is the sum
// the one-pass product took, in its order.

// the pose directions of the K keyframes (6 each) into shared memory kd,
// from z and p; all threads of the CTA call it, and a CTA barrier follows
__device__ void stage_kdir(const VProb& q, const VWs& w, float beta, float* kd) {
  for (int i = threadIdx.x; i < 6 * q.K; i += kThreads) {
    const int k = i / 6;
    kd[i] = pdir(w, (size_t)kD * k + i % 6, beta, !q.fixed_kf[k]);
  }
}

// observation o's product terms, the keyframes' directions from kd, and
// its entries of the two lists (on: o is valid)
struct ObsTerms {
  float c[6], d[3];
  int jk, jp;
  bool on;
};

__device__ __forceinline__ ObsTerms hv_terms(const VProb& q, const VWs& w, int o, float beta,
                                             const float* kd) {
  ObsTerms t;
  // an observation past the end reads the last one's inputs and writes
  // nothing: every load is issued before the validity is known
  const int oo = o < q.O ? o : q.O - 1;
  t.on = o < q.O && q.valid[oo];
  const int kf = t.on ? q.obs_kf[oo] : 0, m = t.on ? q.obs_mp[oo] : 0;   // in range
  const size_t O = (size_t)q.O;
  float vl[3], J[18];
  for (int i = 0; i < 18; ++i) J[i] = w.J[i * O + oo];
  const float wt = w.w[oo];
  t.jk = w.kpos[oo];
  t.jp = w.ppos[oo];
  direction<3>(w, (size_t)kD * q.K + (size_t)3 * m, !q.fixed_mp[m], beta, vl);
  const float* vp = kd + 6 * kf;
  float u[2];
  for (int rr = 0; rr < 2; ++rr) {
    float s = 0.f;
    for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * vp[i];
    for (int i = 0; i < 3; ++i) s += J[12 + 3 * rr + i] * vl[i];
    u[rr] = s * wt;
  }
  for (int i = 0; i < 6; ++i) t.c[i] = J[i] * u[0] + J[6 + i] * u[1];
  for (int i = 0; i < 3; ++i) t.d[i] = J[12 + i] * u[0] + J[15 + i] * u[1];
  return t;
}

__device__ __forceinline__ void hv_store(const VWs& w, const ObsTerms& t) {
  if (!t.on) return;
  float2* c = reinterpret_cast<float2*>(w.ck + (size_t)6 * t.jk);
  c[0] = make_float2(t.c[0], t.c[1]);
  c[1] = make_float2(t.c[2], t.c[3]);
  c[2] = make_float2(t.c[4], t.c[5]);
  *reinterpret_cast<float4*>(w.dp + (size_t)4 * t.jp) = make_float4(t.d[0], t.d[1], t.d[2], 0.f);
}

// edge e (edges_of's order) of keyframe k, by a warp: ue's row rr in lane
// rr (the directions' entries shuffled from lane c), then J_k^T ue's
// column a in lane a, into w.he; nothing past the keyframe's edges.  All
// lanes of the warp call it.
__device__ void hv_edge(const VProb& q, const VWs& w, int k, int e, float beta, int lane) {
  int es[3], oth[3];
  const float *Jk[3], *Jo[3];
  const int ne = edges_of(q, w, k, es, Jk, Jo, oth);
  if (e >= ne) return;
  const int l = lane < kD ? lane : 0;
  const float* jk = Jk[e];
  const float* jo = Jo[e];
  const float pk = pdir(w, (size_t)kD * k + l, beta, !q.fixed_kf[k]);
  const float po = pdir(w, (size_t)kD * oth[e] + l, beta, !q.fixed_kf[oth[e]]);
  float row_k[kD], row_o[kD], col[kD];
  for (int c = 0; c < kD; ++c) {
    row_k[c] = jk[kD * l + c];
    row_o[c] = jo[kD * l + c];
    col[c] = jk[kD * c + l];
  }
  float u = 0.f;
  for (int c = 0; c < kD; ++c)
    u += row_k[c] * __shfl_sync(0xffffffffu, pk, c) + row_o[c] * __shfl_sync(0xffffffffu, po, c);
  float acc = 0.f;
  for (int r = 0; r < kD; ++r) acc += col[r] * __shfl_sync(0xffffffffu, u, r);
  if (lane < kD) w.he[(size_t)45 * k + kD * e + lane] = acc;
}

// keyframe k's h entry a < 15 from its visual part vis[a], its edges'
// terms and KF0's priors, masked
__device__ __forceinline__ void hv_state_entry(const VProb& q, const VWs& w, int k, float beta,
                                               const float* vis, int a) {
  int es[3], oth[3];
  const float *Jk[3], *Jo[3];
  const int ne = edges_of(q, w, k, es, Jk, Jo, oth);
  const bool fr = !q.fixed_kf[k];
  float s = a < 6 ? vis[a] : 0.f;
  for (int e = 0; e < ne; ++e) s += w.he[(size_t)45 * k + kD * e + a];
  if (k == 0 && a >= 9)
    s += (a >= 12 ? q.prior_a : q.prior_g) * pdir(w, (size_t)a, beta, fr);
  w.h[kD * k + a] = fr ? s : 0.f;
}

// list entries a thread sums together: their loads are issued at once (an
// entry past the list's end loads the chunk's first entry and adds
// nothing), their sums still in list order: a keyframe's entries are a
// CTA's, a point's (tens in a GBA) one thread's
constexpr int kChunk = 4;
constexpr int kChunkP = 8;

// point m's h from its list's terms, masked
__device__ __forceinline__ void hv_point(const VProb& q, const VWs& w, int m) {
  if (m >= q.P) return;
  float hl[3] = {0.f, 0.f, 0.f};
  const int end = w.L.off_mp[m + 1];
  for (int j0 = w.L.off_mp[m]; j0 < end; j0 += kChunkP) {
#pragma unroll
    for (int c = 0; c < kChunkP; ++c) {
      const int j = j0 + c;
      const bool on = j < end;
      const int jj = on ? j : j0;
      const float4 r = *reinterpret_cast<const float4*>(w.dp + (size_t)4 * jj);
      const float d[3] = {r.x, r.y, r.z};
      for (int i = 0; i < 3; ++i)
        if (on) hl[i] += d[i];
    }
  }
  const bool fm = !q.fixed_mp[m];
  for (int i = 0; i < 3; ++i) w.h[(size_t)kD * q.K + 3 * m + i] = fm ? hl[i] : 0.f;
}

// h = (J^T W J + prior) p, masked, after the first pass: blocks [0, K) a
// CTA per keyframe, the rest a thread per point.  split (K32): a
// keyframe's CTA stores its visual part in w.vis for the cross-shard sum,
// and hv_state_kernel adds the edges after it.  All threads of the CTA
// must call it.
__device__ void hv_block(const VProb& q, const VWs& w, int b, float beta, bool split) {
  __shared__ float red[6 * kWarps];
  __shared__ float vis[6];
  if (b >= q.K) {
    hv_point(q, w, (b - q.K) * kThreads + threadIdx.x);
    return;
  }
  const int k = b;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int end = w.L.off_kf[k + 1];
  for (int j0 = w.L.off_kf[k] + threadIdx.x; j0 < end; j0 += kChunk * kThreads) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c * kThreads;
      const bool on = j < end;
      const int jj = on ? j : j0;
      const float2* row = reinterpret_cast<const float2*>(w.ck + (size_t)6 * jj);
      const float2 r0 = row[0], r1 = row[1], r2 = row[2];
      const float ck[6] = {r0.x, r0.y, r1.x, r1.y, r2.x, r2.y};
      for (int i = 0; i < 6; ++i)
        if (on) v[i] += ck[i];
    }
  }
  block_sum_to<6>(v, red, split ? w.vis + 6 * k : vis);
  if (split) return;
  __syncthreads();
  if (threadIdx.x < kD) hv_state_entry(q, w, k, beta, vis, threadIdx.x);
}

__device__ __forceinline__ bool free_entry(const VProb& q, int e) {
  return e < kD * q.K ? !q.fixed_kf[e / kD] : !q.fixed_mp[(e - kD * q.K) / 3];
}

// entry e's inputs of the first PCG update (on: e is an entry)
struct CgAIn {
  float z, p, h;
  bool fr, on;
};

__device__ __forceinline__ CgAIn cg_a_load(const VProb& q, const VWs& w, int e) {
  CgAIn t;
  t.on = e < kD * q.K + 3 * q.P;
  if (!t.on) return t;
  t.fr = free_entry(q, e);
  t.z = w.z[e];
  t.p = w.p[e];
  t.h = w.h[e];
  return t;
}

// entry e: p = z + beta p, Ap = (h + lam p) masked; returns its p.Ap (the
// state entries on the lead shard only; the others add their landmarks)
__device__ __forceinline__ double cg_a_store(const VProb& q, const VWs& w, int e, const CgAIn& t,
                                             float beta, float lam, bool lead) {
  if (!t.on) return 0.0;
  const float pe = t.fr ? t.z + beta * t.p : 0.f;
  const float ap = t.fr ? t.h + lam * pe : 0.f;
  w.p[e] = pe;
  w.Ap[e] = ap;
  return (lead || e >= kD * q.K) ? (double)(pe * ap) : 0.0;
}

__device__ __forceinline__ double cg_a_elem(const VProb& q, const VWs& w, int e, float beta,
                                            float lam, bool lead) {
  return cg_a_store(q, w, e, cg_a_load(q, w, e), beta, lam, lead);
}

// The second PCG update of virtual block b (element e a block): x += alpha
// p, r -= alpha Ap, z = M r, and the thread's part of r.z.  The keyframes'
// updates and z rows run a warp each (cg_b_rows, ending in a CTA barrier),
// then every element takes its part: a keyframe's from its r and z, a
// point's from its update (cg_b_load, cg_b_finish).

// the keyframe rows of block b (all threads of the CTA call it)
__device__ void cg_b_rows(const VProb& q, const VWs& w, int b, float alpha) {
  const int e0 = b * kThreads;
  if (e0 >= q.K) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = e0 + warp; k < q.K && k < e0 + kThreads; k += kWarps) {
    const size_t base = (size_t)kD * k;
    float M[kD];   // row `lane` of the block's preconditioner, loaded ahead
    if (lane < kD) {
      for (int c = 0; c < kD; ++c) M[c] = w.Mp[225 * k + kD * lane + c];
      w.x[base + lane] += alpha * w.p[base + lane];
      w.res[base + lane] = w.res[base + lane] - alpha * w.Ap[base + lane];
    }
    __syncwarp();
    if (lane < kD) {
      float s = 0.f;
      for (int c = 0; c < kD; ++c) s += M[c] * w.res[base + c];
      w.z[base + lane] = q.fixed_kf[k] ? 0.f : s;
    }
    __syncwarp();
  }
  __syncthreads();
}

// element e's inputs of the update (kind 0: none, 1: a keyframe, 2: a point)
struct CgBIn {
  float x[3], p[3], r[3], ap[3], M[9];
  bool fr;
  int kind;
};

__device__ __forceinline__ CgBIn cg_b_load(const VProb& q, const VWs& w, int e) {
  CgBIn t;
  t.kind = e < q.K ? 1 : (e < q.K + q.P ? 2 : 0);
  if (t.kind != 2) return t;
  const int m = e - q.K;
  const size_t base = (size_t)kD * q.K + (size_t)3 * m;
  t.fr = !q.fixed_mp[m];
  for (int a = 0; a < 3; ++a) {
    t.x[a] = w.x[base + a];
    t.p[a] = w.p[base + a];
    t.r[a] = w.res[base + a];
    t.ap[a] = w.Ap[base + a];
  }
  for (int i = 0; i < 9; ++i) t.M[i] = w.Ml[9 * m + i];
  return t;
}

__device__ __forceinline__ double cg_b_finish(const VProb& q, const VWs& w, int e,
                                              const CgBIn& t, float alpha, bool lead) {
  if (t.kind == 1) return lead ? state_rz(w, e) : 0.0;
  if (t.kind != 2) return 0.0;
  const size_t base = (size_t)kD * q.K + (size_t)3 * (e - q.K);
  double part = 0.0;
  float rb[3];
  for (int a = 0; a < 3; ++a) {
    w.x[base + a] = t.x[a] + alpha * t.p[a];
    rb[a] = t.r[a] - alpha * t.ap[a];
    w.res[base + a] = rb[a];
  }
  for (int a = 0; a < 3; ++a) {
    float s = 0.f;
    for (int c = 0; c < 3; ++c) s += t.M[3 * a + c] * rb[c];
    s = t.fr ? s : 0.f;
    w.z[base + a] = s;
    part += (double)(rb[a] * s);
  }
  return part;
}

__device__ double cg_b_block(const VProb& q, const VWs& w, int b, float alpha, bool lead) {
  cg_b_rows(q, w, b, alpha);
  const int e = b * kThreads + threadIdx.x;
  return cg_b_finish(q, w, e, cg_b_load(q, w, e), alpha, lead);
}

// element e of the candidate (Sn, pn): state e (apply_delta with -x), or
// point e - K
__device__ __forceinline__ void retract_elem(const float* states, const float* pts,
                                             const VProb& q, const VWs& w, int e, float* Sn,
                                             float* pn) {
  if (e < q.K) {
    float d[kD];
    const bool fr = !q.fixed_kf[e];
    for (int i = 0; i < kD; ++i) d[i] = fr ? -w.x[(size_t)kD * e + i] : 0.f;
    St<float> o;
    apply_delta_t(states + kS * e, d, o);
    float* S = Sn + kS * e;
    for (int i = 0; i < 9; ++i) S[i] = o.R[i];
    for (int i = 0; i < 3; ++i) {
      S[9 + i] = o.t[i];
      S[12 + i] = o.v[i];
      S[15 + i] = o.bg[i];
      S[18 + i] = o.ba[i];
    }
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    const bool fr = !q.fixed_mp[m];
    for (int i = 0; i < 3; ++i)
      pn[3 * m + i] = pts[3 * m + i] + (fr ? -w.x[(size_t)kD * q.K + 3 * m + i] : 0.f);
  }
}

// virtual block b of the cost pass at (states, pts): blocks [0, nbO) the
// observations, block nbO the edges (the lead shard only); returns the
// thread's cost
template <class C>
__device__ float cost_block(const float* states, const float* pts, const VProb& q, const C& cam,
                            bool huber, bool lead, const VWs& w, int b, int nbO) {
  float cost = 0.f;
  if (b < nbO) {
    const int o = b * kThreads + threadIdx.x;
    if (o < q.O && q.valid[o]) {
      float r[2];
      cost = obs_cost(states, pts, q, cam, o, huber, r, nullptr, nullptr, nullptr);
    }
  } else if (lead) {
    for (int k = threadIdx.x; k < q.K; k += kThreads) {
      if (!q.chain_valid[k]) continue;
      const int i = k > 0 ? k - 1 : 0;
      St<float> A, B;
      load_state(states + kS * i, A);
      load_state(states + kS * k, B);
      float r[kD];
      edge_r15(Pk{q.chain + (size_t)kPk * k}, w.Lr + 81 * k, w.Lb + 36 * k, A, B, r);
      for (int a = 0; a < kD; ++a) cost += r[a] * r[a];
    }
  }
  return cost;
}

// observation o an inlier (chi2 <= chi2_th) at (states, pts)
template <class C>
__device__ __forceinline__ void classify_obs(const float* states, const float* pts,
                                             const VProb& q, const C& cam, float chi2_th,
                                             bool* inl, int o) {
  if (o >= q.O) return;
  if (!q.valid[o]) { inl[o] = false; return; }
  float r[2];
  obs_cost(states, pts, q, cam, o, false, r, nullptr, nullptr, nullptr);
  inl[o] = (r[0] * r[0] + r[1] * r[1]) * q.isig[o] <= chi2_th;
}

// ---------------------------------------------------------------- the
// multi-launch passes (K32), scalars in the workspace

__device__ __forceinline__ int gid() { return blockIdx.x * blockDim.x + threadIdx.x; }

__device__ __forceinline__ float beta_of(const VWs& w, int it) {
  return it == 0 ? 0.f : beta_from(it, *rz(w, it), *rz(w, it - 1));
}

__global__ void __launch_bounds__(kThreads) setup_kernel(const VProb q, VWs w) {
  setup_edge(q, w, gid());
}

__global__ void __launch_bounds__(kThreads) positions_kernel(const VProb q, VWs w) {
  if (gid() < q.O) list_positions(q, w, gid());
}

template <class C>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
             const C cam, bool huber, bool lead, VWs w) {
  reduce_store((double)build_block(states, pts, q, cam, huber, lead, w, blockIdx.x,
                                   gridDim.x - 1),
               w.part, w.ticket, cost_old(w));
}

__global__ void __launch_bounds__(kThreads) reduce_kernel(const VProb q, VWs w, bool split) {
  reduce_block(q, w, blockIdx.x, split);
}

// K32: the state blocks from the shards' summed visual sums, a CTA per keyframe
__global__ void __launch_bounds__(kThreads) state_kernel(const VProb q, VWs w) {
  state_blocks(q, w, blockIdx.x, w.vis + 27 * blockIdx.x);
}

__global__ void __launch_bounds__(kThreads) invert_kernel(const VProb q, VWs w, bool lead) {
  reduce_store(invert_block(q, w, blockIdx.x, (float)*w.lam, lead), w.part, w.ticket, rz(w, 0));
}

// the first pass: blocks [0, nbO) the observations (the keyframes'
// directions staged in dynamic shared memory), the rest a warp per edge
// of each keyframe
__global__ void __launch_bounds__(kThreads)
hv_obs_kernel(const VProb q, VWs w, int it, int nbO) {
  extern __shared__ float kd[];
  const float beta = beta_of(w, it);
  if ((int)blockIdx.x >= nbO) {
    const int task = ((int)blockIdx.x - nbO) * kWarps + (threadIdx.x >> 5);
    if (task < 3 * q.K) hv_edge(q, w, task / 3, task % 3, beta, threadIdx.x & 31);
    return;
  }
  stage_kdir(q, w, beta, kd);
  __syncthreads();
  hv_store(w, hv_terms(q, w, gid(), beta, kd));
}

__global__ void __launch_bounds__(kThreads) hv_kernel(const VProb q, VWs w, int it, bool split) {
  hv_block(q, w, blockIdx.x, beta_of(w, it), split);
}

// K32: the state side of h from the shards' summed visual parts, a CTA per keyframe
__global__ void __launch_bounds__(kThreads) hv_state_kernel(const VProb q, VWs w, int it) {
  if (threadIdx.x < kD)
    hv_state_entry(q, w, blockIdx.x, beta_of(w, it), w.vis + 6 * blockIdx.x, threadIdx.x);
}

__global__ void __launch_bounds__(kThreads)
cg_a_kernel(const VProb q, VWs w, int it, int cg, bool lead) {
  reduce_store(cg_a_elem(q, w, gid(), beta_of(w, it), (float)*w.lam, lead), w.part, w.ticket,
               pAp(w, it, cg));
}

__global__ void __launch_bounds__(kThreads)
cg_b_kernel(const VProb q, VWs w, int it, int cg, bool lead) {
  const float alpha = (float)(*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
  reduce_store(cg_b_block(q, w, blockIdx.x, alpha, lead), w.part, w.ticket, rz(w, it + 1));
}

__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
               VWs w) {
  retract_elem(states, pts, q, w, gid(), w.Sn, w.pn);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const VProb q, const C cam, bool huber, bool lead, VWs w) {
  reduce_store((double)cost_block(w.Sn, w.pn, q, cam, huber, lead, w, blockIdx.x, gridDim.x - 1),
               w.part, w.ticket, cost_new(w));
}

// keep the candidate only if the cost fell; lambda x0.5 or x4
__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ states, float* __restrict__ pts, const VProb q, VWs w,
              float* __restrict__ cost_out) {
  const int e = gid();
  const bool better = (float)*cost_new(w) < (float)*cost_old(w);
  if (e == 0) {
    *cost_out = fminf((float)*cost_new(w), (float)*cost_old(w));
    *w.lam = better ? *w.lam * 0.5 : *w.lam * 4.0;
  }
  if (!better) return;
  if (e < q.K) {
    for (int i = 0; i < kS; ++i) states[kS * e + i] = w.Sn[kS * e + i];
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    for (int i = 0; i < 3; ++i) pts[3 * m + i] = w.pn[3 * m + i];
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(float* __restrict__ states, int K) {
  const int e = gid();
  if (e < K) orthonormalize3(states + kS * e);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
                const C cam, float chi2_th, bool* __restrict__ inl) {
  classify_obs(states, pts, q, cam, chi2_th, inl, gid());
}

__global__ void init_kernel(VWs w, float* cost_out) {
  *w.lam = 1e-4;
  *w.ticket = 0u;
  *cost_out = INFINITY;
}

// one shard of a solve: its start states and points (overwritten with the
// result), its problem, workspace, inlier mask and cost
struct VShard {
  float* S;
  float* X;
  VProb q;
  VWs w;
  bool* inl;
  float* cost;
};

template <class C>
int solve(int n, VShard* sh, ShardComm& cm, const C& cam, int n_iters, int cg_iters, bool huber,
          float chi2_th) {
  const int K = sh[0].q.K;
  const bool split = n > 1;
  cudaError_t e;
  float* vis[kMaxShards];
  double* c_old[kMaxShards];
  double* c_new[kMaxShards];
  double* dot[kMaxShards];
  for (int s = 0; s < n; ++s) {
    vis[s] = sh[s].w.vis;
    c_old[s] = sh[s].w.sc;       // cost_old
    c_new[s] = sh[s].w.sc + 1;   // cost_new
  }
// the statement for every shard, on its device and stream
#define EACH(...)                                                     \
  for (int s = 0; s < n; ++s) {                                       \
    if ((e = use_shard(cm, s)) != cudaSuccess) return (int)e;         \
    VShard& V = sh[s];                                                \
    const bool lead = s == 0;                                         \
    (void)lead;                                                       \
    const cudaStream_t st = cm.st[s];                                 \
    const int nbP = n_blocks(V.q.P), nbO = n_blocks(V.q.O);           \
    const long long nv = (long long)kD * K + 3LL * V.q.P;             \
    (void)nbP; (void)nbO; (void)nv;                                   \
    __VA_ARGS__;                                                      \
  }
#define SUM(ptrs, count) \
  if ((e = allreduce(cm, ptrs, count)) != cudaSuccess) return (int)e;
// the scalar at sc + off on every shard, summed
#define SUM_SC(off)                                          \
  for (int s = 0; s < n; ++s) dot[s] = sh[s].w.sc + (off);  \
  SUM(dot, 1)
  EACH(init_kernel<<<1, 1, 0, st>>>(V.w, V.cost);
       setup_kernel<<<n_blocks(K), kThreads, 0, st>>>(V.q, V.w);
       if ((e = build_lists(V.q.obs_kf, V.q.obs_mp, V.q.valid, K, V.q.P, V.q.O, V.w.L, st)) !=
           cudaSuccess) return (int)e;
       positions_kernel<<<nbO, kThreads, 0, st>>>(V.q, V.w))
  for (int it = 0; it < n_iters; ++it) {
    EACH(build_kernel<C><<<nbO + 1, kThreads, 0, st>>>(V.S, V.X, V.q, cam, huber, lead, V.w);
         reduce_kernel<<<K + nbP, kThreads, 0, st>>>(V.q, V.w, split))
    SUM(c_old, 1)
    if (split) {
      SUM(vis, 27LL * K)
      EACH(state_kernel<<<K, kThreads, 0, st>>>(V.q, V.w))
    }
    EACH(invert_kernel<<<n_blocks(K + V.q.P), kThreads, 0, st>>>(V.q, V.w, lead))
    SUM_SC(2)
    for (int c = 0; c < cg_iters; ++c) {
      EACH(hv_obs_kernel<<<nbO + n_blocks(3LL * K * 32), kThreads, sizeof(float) * 6 * K, st>>>(
               V.q, V.w, c, nbO);
           hv_kernel<<<K + nbP, kThreads, 0, st>>>(V.q, V.w, c, split))
      if (split) {
        SUM(vis, 6LL * K)
        EACH(hv_state_kernel<<<K, 32, 0, st>>>(V.q, V.w, c))
      }
      EACH(cg_a_kernel<<<n_blocks(nv), kThreads, 0, st>>>(V.q, V.w, c, cg_iters, lead))
      SUM_SC(3 + cg_iters + c)
      EACH(cg_b_kernel<<<n_blocks(K + V.q.P), kThreads, 0, st>>>(V.q, V.w, c, cg_iters, lead))
      SUM_SC(2 + c + 1)
    }
    EACH(retract_kernel<<<n_blocks(K + V.q.P), kThreads, 0, st>>>(V.S, V.X, V.q, V.w);
         cost_kernel<C><<<nbO + 1, kThreads, 0, st>>>(V.q, cam, huber, lead, V.w))
    SUM(c_new, 1)
    EACH(accept_kernel<<<n_blocks(K + V.q.P), kThreads, 0, st>>>(V.S, V.X, V.q, V.w, V.cost);
         if ((e = cudaGetLastError()) != cudaSuccess) return (int)e)
  }
  EACH(finish_kernel<<<n_blocks(K), kThreads, 0, st>>>(V.S, K);
       classify_kernel<C><<<nbO, kThreads, 0, st>>>(V.S, V.X, V.q, cam, chi2_th, V.inl))
#undef EACH
#undef SUM
#undef SUM_SC
  if ((e = use_shard(cm, 0)) != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int solve_cam(int n, VShard* sh, ShardComm& cm, float fx, float fy, float cx, float cy,
              const float* kb8, int n_iters, int cg_iters, bool huber, float chi2_th) {
  if (kb8 != nullptr)
    return solve(n, sh, cm, CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_iters,
                 cg_iters, huber, chi2_th);
  return solve(n, sh, cm, Cam{fx, fy, cx, cy}, n_iters, cg_iters, huber, chi2_th);
}

// ---------------------------------------------------------------- K20: the
// whole solve in one cluster of G CTAs of kThreads (G = kClusterMax, or 8
// where that many do not fit on the card), as cluster.cuh sets out: every
// CTA holds the same costs, alpha, beta and lambda, and the solve is
// bit-equal to the multi-launch sequence on one shard whatever G is.  The
// candidate and the state swap buffers at an accepted step instead of being
// copied.

// the phase kinds of chip_anatomy.py's build, which stamps clock64() per
// phase; nothing otherwise
#ifndef V20_STAMP
#define V20_STAMP(kind)
#endif
#ifndef V20_CLUSTER
#define V20_CLUSTER 16
#endif
constexpr int kClusterMax = V20_CLUSTER;
enum Phase : int { kSetup = 0, kBuildRows, kBuildEdges, kReduce, kInvert, kHv, kHvPoints, kCgA,
                   kCgB, kRetract, kCost, kAccept, kFinal, kWait, kSum, kHvObs, kPhases };
// the scalars' regions of slots in each CTA's shared memory
enum Region : int { kCostOld = 0, kCostNew, kRz, kPAp, kRegions };

// S (K,21), X (P,3): the start, overwritten with the result; n_slots slots
// a region (the largest pass's blocks).  Dynamic shared memory: the
// regions, PassPartials's warp sums of a CTA's blocks (G >= 8), the
// keyframes' directions, then PassPartials's block indices and the CTA's
// live blocks of the element and entry passes (ints).
//
// A virtual block of the element passes (invert, cg_b) or of cg_a's
// entries that holds no keyframe and no free point (the padding points of
// the engine's bucketed problems, fixed points) has the partial +0.0, as
// the multi-launch kernel computes it, and leaves its entries' vectors as
// no pass reads them but through a mask: the CTA skips it, its slots keep
// the +0.0 they were set to, and its entries the +0.0 of the setup.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
solve_cluster_kernel(float* S, float* X, const VProb q, const C cam, int n_iters, int cg_iters,
                     bool huber, float chi2_th, VWs w, bool* inl, float* cost_out, int n_slots) {
  extern __shared__ double slots[];
  __shared__ int scan_sh[kThreads];
  cg::cluster_group cl = cg::this_cluster();
  const int G = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  V20_STAMP(kPhases);  // the start
  const int K = q.K, P = q.P, O = q.O;
  const int nbO = n_blocks(O), nbV = n_blocks((long long)kD * K + 3LL * P);
  const int nbB = n_blocks(K + P);
  const int tid = rank * kThreads + threadIdx.x, nth = G * kThreads;
  double* s_old = slots + kCostOld * n_slots;
  double* s_new = slots + kCostNew * n_slots;
  double* s_rz = slots + kRz * n_slots;
  double* s_pap = slots + kPAp * n_slots;
  const int jmax = (n_slots + 7) / 8;   // the most blocks of a pass on a CTA
  double* red = slots + kRegions * n_slots;
  float* kd = reinterpret_cast<float*>(red + (size_t)jmax * kWarps);
  int* blk = reinterpret_cast<int*>(kd + 6 * (size_t)q.K);
  int* liveB = blk + jmax;   // the CTA's blocks of the element passes that run
  int* liveV = liveB + jmax; // and of cg_a's
  __shared__ int n_live[2];
  PassPartials pp{red, blk};
  auto sync = [&]() {
    cl.sync();
    V20_STAMP(kWait);
  };
  auto push = [&](double* region) { pp.push(cl, G, region); };
  auto sum = [&](double* region, int nb) {
    const double v = region_sum(region, nb);
    V20_STAMP(kSum);
    return v;
  };
#define MY_BLOCKS(b, nb) for (int b = rank; b < (nb); b += G)
#define ELEM(b) ((b) * kThreads + (int)threadIdx.x)
  // The reduce and product passes take the points a thread each from the
  // cluster's far end (point P - 1 on thread 0), so that the first points
  // (the real ones, in the engine's padded problems) go to the CTAs with
  // the fewest keyframe blocks (keyframe b on CTA b mod G).

  // every slot +0.0; the live blocks; the whitening factors, then the lists
  // (build_lists's passes)
  for (int i = threadIdx.x; i < kRegions * n_slots; i += kThreads) slots[i] = 0.0;
  if (threadIdx.x == 0) n_live[0] = n_live[1] = 0;
  __syncthreads();
  MY_BLOCKS(b, nbB) {
    const int e = ELEM(b);
    if (__syncthreads_or(e < K || (e < K + P && !q.fixed_mp[e - K])) && threadIdx.x == 0)
      liveB[n_live[0]++] = b;
  }
  MY_BLOCKS(b, nbV) {
    const int e = ELEM(b);
    if (__syncthreads_or(e < kD * K || (e < kD * K + 3 * P && free_entry(q, e))) &&
        threadIdx.x == 0)
      liveV[n_live[1]++] = b;
  }
  for (int k = tid; k < K; k += nth) setup_edge(q, w, k);
  // the points' PCG entries +0.0, the value the multi-launch passes give a
  // fixed point's (the skipped blocks' are never written)
  for (int i = tid; i < 3 * P; i += nth) {
    const size_t e = (size_t)kD * K + i;
    w.x[e] = w.res[e] = w.z[e] = w.p[e] = w.Ap[e] = 0.f;
  }
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
  for (int j = tid; j < O; j += nth) list_positions(q, w, j);
  V20_STAMP(kSetup);
  sync();
  const int nB = n_live[0], nV = n_live[1];

  float *cS = S, *cp = X;          // the state
  float *nS = w.Sn, *np = w.pn;    // the candidate
  double lam = 1e-4;
  float cost = INFINITY;
  for (int it = 0; it < n_iters; ++it) {
    MY_BLOCKS(b, nbO + 1) {
      pp.add((double)build_block(cS, cp, q, cam, huber, true, w, b, nbO), b);
      V20_STAMP(b < nbO ? kBuildRows : kBuildEdges);
    }
    push(s_old);
    sync();
    const double c_old = sum(s_old, nbO + 1);
    MY_BLOCKS(b, K) reduce_block(q, w, b, false);
    for (int m = P - 1 - tid; m >= 0; m -= nth) reduce_point(q, w, m);
    V20_STAMP(kReduce);
    sync();
    const float lamf = (float)lam;
    for (int j = 0; j < nB; ++j) pp.add(invert_block(q, w, liveB[j], lamf, true), liveB[j]);
    push(s_rz);
    V20_STAMP(kInvert);
    sync();
    double rz_cur = sum(s_rz, nbB), rz_prev = 0.0;
    for (int c = 0; c < cg_iters; ++c) {
      const float beta = beta_from(c, rz_cur, rz_prev);
      // the edges' terms a warp each, from the cluster's last warp down
      for (int task = nth / 32 - 1 - (tid >> 5); task < 3 * K; task += nth / 32)
        hv_edge(q, w, task / 3, task % 3, beta, threadIdx.x & 31);
      stage_kdir(q, w, beta, kd);
      __syncthreads();
      // four observations at a time, their loads ahead of their stores
      for (int o = tid; o < O; o += 4 * nth) {
        ObsTerms t[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) t[c] = hv_terms(q, w, o + c * nth, beta, kd);
#pragma unroll
        for (int c = 0; c < 4; ++c) hv_store(w, t[c]);
      }
      V20_STAMP(kHvObs);
      sync();
      MY_BLOCKS(b, K) hv_block(q, w, b, beta, false);
      V20_STAMP(kHv);
      for (int m = P - 1 - tid; m >= 0; m -= nth) hv_point(q, w, m);
      V20_STAMP(kHvPoints);
      sync();
      // four of the CTA's blocks at a time: their loads ahead of their
      // stores, their partials added in block order
      for (int j0 = 0; j0 < nV; j0 += 4) {
        int b[4];
        CgAIn in[4];
        double v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c] = j0 + c < nV ? liveV[j0 + c] : nbV;
          in[c] = cg_a_load(q, w, ELEM(b[c]));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = cg_a_store(q, w, ELEM(b[c]), in[c], beta, lamf, true);
        pp.add_n(v, min(4, nV - j0), b);
      }
      push(s_pap);
      V20_STAMP(kCgA);
      sync();
      const float alpha = (float)(rz_cur / fmax(sum(s_pap, nbV), 1e-20));
      // the last sweep's r.z is never read: no partial and no barrier, as
      // the retraction reads x where this CTA wrote it (cg_b_rows ends in a
      // CTA barrier after its keyframe warps)
      const bool last = c + 1 == cg_iters;
      for (int j = 0; j < nB; ++j) cg_b_rows(q, w, liveB[j], alpha);
      // two of the CTA's live blocks at a time, as cg_a's
      for (int j0 = 0; j0 < nB; j0 += 2) {
        const int b[2] = {liveB[j0], j0 + 1 < nB ? liveB[j0 + 1] : nbB};
        const CgBIn in0 = cg_b_load(q, w, ELEM(b[0])), in1 = cg_b_load(q, w, ELEM(b[1]));
        double v[2] = {cg_b_finish(q, w, ELEM(b[0]), in0, alpha, true),
                       cg_b_finish(q, w, ELEM(b[1]), in1, alpha, true)};
        if (!last) pp.add_n(v, min(2, nB - j0), b);
      }
      V20_STAMP(kCgB);
      if (!last) {
        push(s_rz);
        sync();
        rz_prev = rz_cur;
        rz_cur = sum(s_rz, nbB);
      }
    }
    MY_BLOCKS(b, nbB) retract_elem(cS, cp, q, w, ELEM(b), nS, np);
    V20_STAMP(kRetract);
    sync();
    MY_BLOCKS(b, nbO + 1) pp.add((double)cost_block(nS, np, q, cam, huber, true, w, b, nbO), b);
    push(s_new);
    V20_STAMP(kCost);
    sync();
    // accept_kernel's rule, the step taken by swapping the buffers
    const double c_new = sum(s_new, nbO + 1);
    const bool better = (float)c_new < (float)c_old;
    lam = better ? lam * 0.5 : lam * 4.0;
    cost = fminf((float)c_new, (float)c_old);
    if (better) {
      float* tmp;
      tmp = cS; cS = nS; nS = tmp;
      tmp = cp; cp = np; np = tmp;
    }
    V20_STAMP(kAccept);
  }
  // the result into (S, X), the rotations re-orthonormalized
  for (int e = tid; e < K; e += nth) {
    if (cS != S)
      for (int i = 0; i < kS; ++i) S[kS * e + i] = cS[kS * e + i];
    orthonormalize3(S + kS * e);
  }
  if (cp != X)
    for (int i = tid; i < 3 * P; i += nth) X[i] = cp[i];
  sync();
  for (int o = tid; o < O; o += nth) classify_obs(S, X, q, cam, chi2_th, inl, o);
  if (tid == 0) *cost_out = cost;
  V20_STAMP(kFinal);
#undef MY_BLOCKS
#undef ELEM
}

template <class C>
int solve_cluster(VShard& V, const C& cam, int n_iters, int cg_iters, bool huber, float chi2_th,
                  cudaStream_t st) {
  const int K = V.q.K, P = V.q.P, O = V.q.O;
  int nb = n_blocks(O) + 1;
  nb = max(nb, n_blocks((long long)kD * K + 3LL * P));
  nb = max(nb, n_blocks(K + P));
  void (*kernel)(float*, float*, const VProb, const C, int, int, bool, float, VWs, bool*, float*,
                 int) = solve_cluster_kernel<C>;
  const size_t jmax = (nb + 7) / 8;
  const size_t smem = sizeof(double) * (kRegions * (size_t)nb + jmax * kWarps) +
                      sizeof(float) * 6 * (size_t)K + sizeof(int) * 3 * jmax;
  static std::atomic<long long> cache{0};
  int G;
  cudaError_t e = pick_cluster(kernel, smem, kClusterMax, cache, &G);
  if (e != cudaSuccess) return (int)e;
  ClusterCfg lc(G, smem, st);
  e = cudaLaunchKernelEx(&lc.cfg, kernel, V.S, V.X, V.q, cam, n_iters, cg_iters, huber, chi2_th,
                         V.w, V.inl, V.cost, nb);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int solve_cluster_cam(VShard& V, float fx, float fy, float cx, float cy, const float* kb8,
                      int n_iters, int cg_iters, bool huber, float chi2_th, cudaStream_t st) {
  if (kb8 != nullptr)
    return solve_cluster(V, CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, n_iters,
                         cg_iters, huber, chi2_th, st);
  return solve_cluster(V, Cam{fx, fy, cx, cy}, n_iters, cg_iters, huber, chi2_th, st);
}

}  // namespace

extern "C" long long vi_ba_workspace_bytes(int K, int P, int O, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters);
}

// K32's peer route: bytes of the n slots on shard 0's device (the largest
// summed range: the visual sums, 27 floats a keyframe)
extern "C" long long vi_ba_gather_bytes(int n, int K) {
  return (long long)n * (long long)align16(sizeof(float) * 27 * (size_t)K);
}

// K20, one cluster launch.  states (K,21) and pts (P,3): the start,
// overwritten with the result; chain (K,292); ext: Rcb 9, tcb 3; kb8 null:
// the pinhole camera, else a host array k1..k4 of the KB8 camera
extern "C" int vi_ba_launch(void* states, void* pts, const void* chain, const void* obs_kf,
                            const void* obs_mp, const void* obs_uv, const void* isig,
                            const void* valid, const void* chain_valid, const void* fixed_kf,
                            const void* fixed_mp, const void* ext, int K, int P, int O, float fx,
                            float fy, float cx, float cy, const float* kb8, float prior_g,
                            float prior_a, int n_iters, int cg_iters, int use_huber,
                            float chi2_th, void* ws, void* inliers, void* cost_out,
                            void* stream) {
  if (K <= 0 || P <= 0 || O <= 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  VShard sh;
  sh.S = (float*)states;
  sh.X = (float*)pts;
  carve(&sh.w, static_cast<uint8_t*>(ws), K, P, O, cg_iters);
  sh.q = VProb{(const int*)obs_kf, (const int*)obs_mp, (const float*)obs_uv, (const float*)isig,
               (const bool*)valid, (const bool*)chain_valid, (const bool*)fixed_kf,
               (const bool*)fixed_mp, (const float*)chain, (const float*)ext, K, P, O,
               prior_g, prior_a};
  sh.inl = (bool*)inliers;
  sh.cost = (float*)cost_out;
  return solve_cluster_cam(sh, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0, chi2_th,
                           (cudaStream_t)stream);
}

// K32: n shards of Ps points and Os observations each.  devs (n,) the CUDA
// device of each shard; tab (n, 15) host rows of pointers: states (K,21) (each
// shard's copy of the start states), pts (Ps,3), chain (K,292), obs_kf, obs_mp
// (local to the shard), obs_uv, isig, valid (Os), chain_valid, fixed_kf (K),
// fixed_mp (Ps), ext (12), the shard's workspace (vi_ba_workspace_bytes(K, Ps,
// Os, cg_iters)), its inlier mask (Os) and its stream.  gather:
// vi_ba_gather_bytes(n, K) on devs[0] when the devices differ, else null.
// The result: every shard's states (equal), pts and inliers; cost_out
// (float32, on devs[0]) the last LM step's smaller cost, as K20's.  The
// caller's current device is kept.
extern "C" int vi_ba_sharded_launch(int n, const int* devs, const long long* tab, int K, int Ps,
                                    int Os, float fx, float fy, float cx, float cy,
                                    const float* kb8, float prior_g, float prior_a, int n_iters,
                                    int cg_iters, int use_huber, float chi2_th, void* gather,
                                    void* cost_out) {
  if (n < 1 || n > kMaxShards || K <= 0 || Ps <= 0 || Os <= 0 || n_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  VShard sh[kMaxShards];
  cudaStream_t sts[kMaxShards];
  for (int s = 0; s < n; ++s) {
    const long long* r = tab + 15 * (size_t)s;
    sh[s].S = (float*)r[0];
    sh[s].X = (float*)r[1];
    sh[s].q = VProb{(const int*)r[3], (const int*)r[4], (const float*)r[5], (const float*)r[6],
                    (const bool*)r[7], (const bool*)r[8], (const bool*)r[9], (const bool*)r[10],
                    (const float*)r[2], (const float*)r[11], K, Ps, Os, prior_g, prior_a};
    carve(&sh[s].w, (uint8_t*)r[12], K, Ps, Os, cg_iters);
    sh[s].inl = (bool*)r[13];
    sh[s].cost = s == 0 ? (float*)cost_out : sh[s].w.cst;
    sts[s] = (cudaStream_t)r[14];
  }
  int prev;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  ShardComm cm;
  e = comm_open(cm, n, devs, sts, gather, (size_t)vi_ba_gather_bytes(1, K));
  int err = (int)e;
  if (e == cudaSuccess)
    err = solve_cam(n, sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0, chi2_th);
  comm_close(cm);
  cudaSetDevice(prev);
  return err;
}
