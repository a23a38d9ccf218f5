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
//     15-dim [EdgeInertial; bias walk] residual, its two 15x15 Jacobians
//     taken in forward mode (two Dual<15> passes of imu_t.cuh's edge_r15,
//     one thread per edge), which makes the Hessian block-tridiagonal;
//   - KF0's bias priors on the diagonal, the fixed_kf / fixed_mp masks.
// The block-Jacobi preconditioner inverts 15x15 and 3x3 damped blocks.
// Every sum runs in a fixed order (det_reduce.cuh): each keyframe's
// observations in index order in one CTA, each point's in one thread, the
// scalars by per-CTA partials summed in block order.  The LM and PCG loop is
// enqueued from C with its scalars on the card: nothing waits on the host.
//
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
// launch sequence.  Padding needs no case of its own: a padded observation
// is invalid (weight 0, on no list) and a padded point is fixed.
//
// Bound on the H100: launch latency, as K6.  A local window (11 keyframes,
// ~10k observations) is microseconds of arithmetic per pass; the 3 x
// cg_iters + 7 dependent launches per LM iteration set the time.  K32 on n
// shards of one card launches each pass n times plus a small sum kernel and
// a state pass at each reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kS = 21;   // floats per state: R 9, t 3, v 3, bg 3, ba 3
constexpr int kD = 15;   // tangent dims per keyframe

#include "dual.cuh"
#include "lie_t.cuh"
#include "imu_t.cuh"
#include "ba_obs.cuh"
#include "det_reduce.cuh"
#include "shard_sum.cuh"

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
  float* J;     // (O,18): pose slice 2x6 (phi, rho), point 2x3
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

// the residual (value pass) or the Jacobian wrt one endpoint (which: 0 the
// first state, 1 the second) of edge k, states from `states`
__device__ void edge_eval(const float* states, const VProb& q, const VWs& w, int k, int which,
                          float* r, float* J) {
  const int i = k > 0 ? k - 1 : 0;
  const Pk pk{q.chain + (size_t)kPk * k};
  D15 d0[kD], d1[kD];
  for (int a = 0; a < kD; ++a) {
    d0[a] = dconst<15, float>(0.f);
    d1[a] = dconst<15, float>(0.f);
    if (J) (which == 0 ? d0 : d1)[a].d[a] = 1.f;
  }
  St<D15> A, B;
  apply_delta_t(states + kS * i, d0, A);
  apply_delta_t(states + kS * k, d1, B);
  D15 rr[kD];
  edge_r15(pk, w.Lr + 81 * k, w.Lb + 36 * k, A, B, rr);
  for (int a = 0; a < kD; ++a) {
    if (r) r[a] = rr[a].v;
    if (J)
      for (int b = 0; b < kD; ++b) J[kD * a + b] = rr[a].d[b];
  }
}

// the whitening factors of every edge, once per solve
__global__ void __launch_bounds__(kThreads) setup_kernel(const VProb q, VWs w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q.K) return;
  const float* C = q.chain + (size_t)kPk * k + 61;
  info_sqrt_blk<9>(C, 0, w.Lr + 81 * k);
  info_sqrt_blk<6>(C, 9, w.Lb + 36 * k);
}

// blocks [0, nbO): one thread per observation; the last block: the edges
// (their cost counted by the lead shard only)
template <class C>
__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
             const C cam, bool huber, bool lead, VWs w) {
  float cost = 0.f;
  if (blockIdx.x + 1 < gridDim.x) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o < q.O) {
      if (q.valid[o]) {
        float r[2], Jp[2][6], Jl[2][3], wt;
        cost = obs_cost(states, pts, q, cam, o, huber, r, Jp, Jl, &wt);
        float* Jo = w.J + (size_t)18 * o;
        for (int c = 0; c < 6; ++c) { Jo[c] = Jp[0][c]; Jo[6 + c] = Jp[1][c]; }
        for (int c = 0; c < 3; ++c) { Jo[12 + c] = Jl[0][c]; Jo[15 + c] = Jl[1][c]; }
        w.w[o] = wt;
        w.r[2 * o] = r[0];
        w.r[2 * o + 1] = r[1];
      } else {
        w.w[o] = 0.f;
      }
    }
  } else {
    for (int k = threadIdx.x; k < q.K; k += kThreads) {
      float* r = w.re + kD * k;
      float* Ji = w.Ji + 225 * k;
      float* Jj = w.Jj + 225 * k;
      if (q.chain_valid[k]) {
        edge_eval(states, q, w, k, 0, r, Ji);
        edge_eval(states, q, w, k, 1, nullptr, Jj);
        if (lead)
          for (int a = 0; a < kD; ++a) cost += r[a] * r[a];
      } else {
        for (int a = 0; a < kD; ++a) r[a] = 0.f;
        for (int a = 0; a < 225; ++a) Ji[a] = Jj[a] = 0.f;
      }
    }
  }
  reduce_store((double)cost, w.part, w.ticket, cost_old(w));
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

// the gradient and the diagonal blocks: a CTA per keyframe (visual list and
// its edges), a thread per point.  split (K32): a keyframe's CTA stores its
// visual sums in w.vis for the cross-shard sum, and state_kernel adds the
// edges after it
__global__ void __launch_bounds__(kThreads) reduce_kernel(const VProb q, VWs w, bool split) {
  __shared__ float red[27 * kThreads / 32];
  __shared__ float vis[27];
  if (blockIdx.x < q.K) {
    const int k = blockIdx.x;
    float v[27];
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
    if (threadIdx.x == 0)
      for (int i = 0; i < 27; ++i) (split ? w.vis + 27 * k : vis)[i] = v[i];
    if (split) return;
    __syncthreads();
    state_blocks(q, w, k, vis);
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
  const bool fr = !q.fixed_mp[m];
  for (int a = 0; a < 3; ++a) w.g[(size_t)kD * q.K + 3 * m + a] = fr ? g[a] : 0.f;
  for (int i = 0; i < 6; ++i) w.Hll[6 * m + i] = H[i];
}

// K32: the state blocks from the shards' summed visual sums, a CTA per keyframe
__global__ void __launch_bounds__(kThreads) state_kernel(const VProb q, VWs w) {
  state_blocks(q, w, blockIdx.x, w.vis + 27 * blockIdx.x);
}

// M = (H + lam I)^-1 of a 15x15 block, Gauss-Jordan with partial pivoting
__device__ void inv15_damped(const float* H, float lam, float* M) {
  float A[225];
  for (int i = 0; i < 225; ++i) {
    A[i] = H[i] + ((i % 16 == 0) ? lam : 0.f);
    M[i] = (i % 16 == 0) ? 1.f : 0.f;
  }
  for (int c = 0; c < kD; ++c) {
    int piv = c;
    for (int r = c + 1; r < kD; ++r)
      if (fabsf(A[kD * r + c]) > fabsf(A[kD * piv + c])) piv = r;
    if (piv != c)
      for (int k2 = 0; k2 < kD; ++k2) {
        float t = A[kD * c + k2]; A[kD * c + k2] = A[kD * piv + k2]; A[kD * piv + k2] = t;
        t = M[kD * c + k2]; M[kD * c + k2] = M[kD * piv + k2]; M[kD * piv + k2] = t;
      }
    const float inv = 1.f / A[kD * c + c];
    for (int k2 = 0; k2 < kD; ++k2) { A[kD * c + k2] *= inv; M[kD * c + k2] *= inv; }
    for (int r = 0; r < kD; ++r) {
      if (r == c) continue;
      const float f = A[kD * r + c];
      for (int k2 = 0; k2 < kD; ++k2) {
        A[kD * r + k2] -= f * A[kD * c + k2];
        M[kD * r + k2] -= f * M[kD * c + k2];
      }
    }
  }
}

// M = (H + lam I)^-1 of a 3x3 block given by its upper triangle (full inverse
// by the adjugate, as ba_obs.cuh)
__global__ void __launch_bounds__(kThreads) invert_kernel(const VProb q, VWs w, bool lead) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (e < q.K + q.P) {
    const float lam = (float)*w.lam;
    const bool pose = e < q.K;
    const int n = pose ? kD : 3;
    const size_t base = pose ? (size_t)kD * e : (size_t)kD * q.K + (size_t)3 * (e - q.K);
    const bool fr = pose ? !q.fixed_kf[e] : !q.fixed_mp[e - q.K];
    float* M = pose ? w.Mp + 225 * e : w.Ml + 9 * (e - q.K);
    if (pose) inv15_damped(w.Hpp + 225 * e, lam, M);
    else inv3_damped(w.Hll + 6 * (e - q.K), lam, M);
    float rb[kD];
    for (int a = 0; a < n; ++a) {
      rb[a] = w.g[base + a];
      w.res[base + a] = rb[a];
      w.x[base + a] = 0.f;
      w.p[base + a] = 0.f;
    }
    for (int a = 0; a < n; ++a) {
      float s = 0.f;
      for (int b = 0; b < n; ++b) s += M[n * a + b] * rb[b];
      s = fr ? s : 0.f;
      w.z[base + a] = s;
      if (lead || !pose) part += (double)(rb[a] * s);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, 0));
}

__device__ __forceinline__ float beta_of(const VWs& w, int it) {
  return it == 0 ? 0.f : (float)(*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// p = z + beta p of entry e, masked
__device__ __forceinline__ float pdir(const VWs& w, size_t e, float beta, bool fr) {
  return fr ? w.z[e] + beta * w.p[e] : 0.f;
}

__device__ __forceinline__ void obs_u(const VProb& q, const VWs& w, int o, float beta, float* u) {
  const int kf = q.obs_kf[o], m = q.obs_mp[o];
  const bool fk = !q.fixed_kf[kf], fm = !q.fixed_mp[m];
  const size_t pb = (size_t)kD * kf, lb = (size_t)kD * q.K + (size_t)3 * m;
  float vp[6], vl[3];
  for (int i = 0; i < 6; ++i) vp[i] = pdir(w, pb + i, beta, fk);
  for (int i = 0; i < 3; ++i) vl[i] = pdir(w, lb + i, beta, fm);
  const float* J = w.J + (size_t)18 * o;
  for (int rr = 0; rr < 2; ++rr) {
    float s = 0.f;
    for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * vp[i];
    for (int i = 0; i < 3; ++i) s += J[12 + 3 * rr + i] * vl[i];
    u[rr] = s * w.w[o];
  }
}

// keyframe k's h = (J^T W J + prior) p from its visual part vis (6), its
// edges and KF0's priors, masked; threads [0, 15)
__device__ void hv_state(const VProb& q, VWs& w, int k, float beta, const float* vis) {
  const int a = threadIdx.x;
  if (a >= kD) return;
  int es[3], oth[3];
  const float *Jk[3], *Jo[3];
  const int ne = edges_of(q, w, k, es, Jk, Jo, oth);
  const bool fr = !q.fixed_kf[k];
  float pk_[kD];
  for (int c = 0; c < kD; ++c) pk_[c] = pdir(w, (size_t)kD * k + c, beta, fr);
  float s = a < 6 ? vis[a] : 0.f;
  for (int e = 0; e < ne; ++e) {
    // ue = J_k p_k + J_other p_other, then J_k^T ue
    const bool fo = !q.fixed_kf[oth[e]];
    float po[kD];
    for (int c = 0; c < kD; ++c) po[c] = pdir(w, (size_t)kD * oth[e] + c, beta, fo);
    float acc = 0.f;
    for (int rr = 0; rr < kD; ++rr) {
      float ue = 0.f;
      for (int c = 0; c < kD; ++c) ue += Jk[e][kD * rr + c] * pk_[c] + Jo[e][kD * rr + c] * po[c];
      acc += Jk[e][kD * rr + a] * ue;
    }
    s += acc;
  }
  if (k == 0 && a >= 9)
    s += (a >= 12 ? q.prior_a : q.prior_g) * pk_[a];
  w.h[kD * k + a] = fr ? s : 0.f;
}

// h = (J^T W J + prior) p, masked: a CTA per keyframe, a thread per point.
// split (K32): a keyframe's CTA stores its visual part in w.vis for the
// cross-shard sum, and hv_state_kernel adds the edges after it
__global__ void __launch_bounds__(kThreads) hv_kernel(const VProb q, VWs w, int it, bool split) {
  __shared__ float red[6 * kThreads / 32];
  __shared__ float vis[6];
  const float beta = beta_of(w, it);
  if (blockIdx.x < q.K) {
    const int k = blockIdx.x;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = w.L.off_kf[k] + threadIdx.x; j < w.L.off_kf[k + 1]; j += kThreads) {
      const int o = w.L.list_kf[j];
      float u[2];
      obs_u(q, w, o, beta, u);
      const float* J = w.J + (size_t)18 * o;
      for (int i = 0; i < 6; ++i) v[i] += J[i] * u[0] + J[6 + i] * u[1];
    }
    block_sum_fixed<6>(v, red);
    if (threadIdx.x == 0)
      for (int i = 0; i < 6; ++i) (split ? w.vis + 6 * k : vis)[i] = v[i];
    if (split) return;
    __syncthreads();
    hv_state(q, w, k, beta, vis);
    return;
  }
  const int m = (blockIdx.x - q.K) * kThreads + threadIdx.x;
  if (m >= q.P) return;
  float hl[3] = {0.f, 0.f, 0.f};
  for (int j = w.L.off_mp[m]; j < w.L.off_mp[m + 1]; ++j) {
    const int o = w.L.list_mp[j];
    float u[2];
    obs_u(q, w, o, beta, u);
    const float* J = w.J + (size_t)18 * o;
    for (int i = 0; i < 3; ++i) hl[i] += J[12 + i] * u[0] + J[15 + i] * u[1];
  }
  const bool fm = !q.fixed_mp[m];
  for (int i = 0; i < 3; ++i) w.h[(size_t)kD * q.K + 3 * m + i] = fm ? hl[i] : 0.f;
}

// K32: the state side of h from the shards' summed visual parts, a CTA per keyframe
__global__ void hv_state_kernel(const VProb q, VWs w, int it) {
  hv_state(q, w, blockIdx.x, beta_of(w, it), w.vis + 6 * blockIdx.x);
}

__device__ __forceinline__ bool free_entry(const VProb& q, int e) {
  return e < kD * q.K ? !q.fixed_kf[e / kD] : !q.fixed_mp[(e - kD * q.K) / 3];
}

// lead: the state entries count in p.Ap (the lead shard; the others add only
// their landmarks)
__global__ void __launch_bounds__(kThreads)
cg_a_kernel(const VProb q, VWs w, int it, int cg, bool lead) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = kD * q.K + 3 * q.P;
  double part = 0.0;
  if (e < nv) {
    const bool fr = free_entry(q, e);
    const float pe = fr ? w.z[e] + beta_of(w, it) * w.p[e] : 0.f;
    const float ap = fr ? w.h[e] + (float)*w.lam * pe : 0.f;
    w.p[e] = pe;
    w.Ap[e] = ap;
    if (lead || e >= kD * q.K) part = (double)(pe * ap);
  }
  reduce_store(part, w.part, w.ticket, pAp(w, it, cg));
}

__global__ void __launch_bounds__(kThreads)
cg_b_kernel(const VProb q, VWs w, int it, int cg, bool lead) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (e < q.K + q.P) {
    const float alpha = (float)(*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
    const bool pose = e < q.K;
    const int n = pose ? kD : 3;
    const size_t base = pose ? (size_t)kD * e : (size_t)kD * q.K + (size_t)3 * (e - q.K);
    const bool fr = pose ? !q.fixed_kf[e] : !q.fixed_mp[e - q.K];
    const float* M = pose ? w.Mp + 225 * e : w.Ml + 9 * (e - q.K);
    float rb[kD];
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
      if (lead || !pose) part += (double)(rb[a] * s);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, it + 1));
}

// the candidate states (apply_delta with -x) and points
__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
               VWs w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < q.K) {
    float d[kD];
    const bool fr = !q.fixed_kf[e];
    for (int i = 0; i < kD; ++i) d[i] = fr ? -w.x[(size_t)kD * e + i] : 0.f;
    St<float> o;
    apply_delta_t(states + kS * e, d, o);
    float* S = w.Sn + kS * e;
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
      w.pn[3 * m + i] = pts[3 * m + i] + (fr ? -w.x[(size_t)kD * q.K + 3 * m + i] : 0.f);
  }
}

// the candidate's cost: observations, then the edges in the last block
template <class C>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const VProb q, const C cam, bool huber, bool lead, VWs w) {
  float cost = 0.f;
  if (blockIdx.x + 1 < gridDim.x) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o < q.O && q.valid[o]) {
      float r[2];
      cost = obs_cost(w.Sn, w.pn, q, cam, o, huber, r, nullptr, nullptr, nullptr);
    }
  } else if (lead) {
    for (int k = threadIdx.x; k < q.K; k += kThreads) {
      if (!q.chain_valid[k]) continue;
      const int i = k > 0 ? k - 1 : 0;
      St<float> A, B;
      load_state(w.Sn + kS * i, A);
      load_state(w.Sn + kS * k, B);
      float r[kD];
      edge_r15(Pk{q.chain + (size_t)kPk * k}, w.Lr + 81 * k, w.Lb + 36 * k, A, B, r);
      for (int a = 0; a < kD; ++a) cost += r[a] * r[a];
    }
  }
  reduce_store((double)cost, w.part, w.ticket, cost_new(w));
}

__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ states, float* __restrict__ pts, const VProb q, VWs w,
              float* __restrict__ cost_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
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

__global__ void __launch_bounds__(kThreads)
finish_kernel(float* __restrict__ states, const float* __restrict__ pts, const VProb q,
              float chi2_th, bool* __restrict__ inl) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < q.K) orthonormalize3(states + kS * e);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ states, const float* __restrict__ pts, const VProb q,
                const C cam, float chi2_th, bool* __restrict__ inl) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= q.O) return;
  if (!q.valid[o]) { inl[o] = false; return; }
  float r[2];
  obs_cost(states, pts, q, cam, o, false, r, nullptr, nullptr, nullptr);
  inl[o] = (r[0] * r[0] + r[1] * r[1]) * q.isig[o] <= chi2_th;
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
           cudaSuccess) return (int)e)
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
      EACH(hv_kernel<<<K + nbP, kThreads, 0, st>>>(V.q, V.w, c, split))
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
  EACH(finish_kernel<<<n_blocks(K), kThreads, 0, st>>>(V.S, V.X, V.q, chi2_th, V.inl);
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

}  // namespace

extern "C" long long vi_ba_workspace_bytes(int K, int P, int O, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters);
}

// K32's peer route: bytes of the n slots on shard 0's device (the largest
// summed range: the visual sums, 27 floats a keyframe)
extern "C" long long vi_ba_gather_bytes(int n, int K) {
  return (long long)n * (long long)align16(sizeof(float) * 27 * (size_t)K);
}

// states (K,21) and pts (P,3): the start, overwritten with the result;
// chain (K,292); ext: Rcb 9, tcb 3; kb8 null: the pinhole camera, else a
// host array k1..k4 of the KB8 camera
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
  ShardComm cm;
  cm.st[0] = (cudaStream_t)stream;
  return solve_cam(1, &sh, cm, fx, fy, cx, cy, kb8, n_iters, cg_iters, use_huber != 0, chi2_th);
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
