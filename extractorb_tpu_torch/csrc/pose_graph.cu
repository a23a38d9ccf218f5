// K13 pose_graph: Levenberg-Marquardt over the Sim3 essential graph with a
// matrix-free block-Jacobi PCG; and K31, the same solve over n edge shards.
//
// Replaces extractorb_tpu/solver/pose_graph.py:optimize_pose_graph, which
// the TPU runs as a lax.scan of LM steps over a vmapped jacfwd of the edge
// residual r = log(m_ij Exp(di) S_i (Exp(dj) S_j)^-1) and a lax.scan of PCG
// sweeps with segment sums.  Once per solve each vertex gets the list of its
// edge ends (2 e + side) in index order.  Then each LM iteration is:
//   build:   one thread per edge evaluates the residual and both 7x7
//            Jacobians at d = 0 in forward-mode dual numbers (Dual<7, double>,
//            lie_t.cuh: the same sim3_exp / sim3_log branches as the JAX
//            package, so the theta -> 0 guards of sim3_log are the JAX
//            function's), stores them, and the current cost;
//   gather:  one warp per vertex sums the gradient and its 7x7 diagonal
//            block over its list (lanes over the entries, then a fixed
//            xor tree);
//   invert:  one thread per vertex inverts its damped block (Gauss-Jordan
//            with partial pivoting) and starts PCG;
//   cg_iters x three launches: the Hessian-vector product, one warp per
//            vertex over its list (each edge's J v, with p = z + beta p built
//            on the fly), the damped and masked product with p.Ap, the alpha
//            step with the preconditioner and r.z (K6's scheme);
//   retract: S <- Exp(-x) S per vertex, the rotation projected onto SO(3)
//            through its SVD (small_linalg.cuh), the candidate cost, and the
//            accept with lambda x0.5 or x4.
// alpha, beta, the costs and lambda stay on the card.
//
// Every value is float64: the wrapper widens the float32 problem and rounds
// the result back.  An essential graph's edges measure scale exactly
// (m_s = 1), so near the optimum the log-scale residuals sit in [1e-5, 1e-3],
// just above sim3_V's Taylor guard, where (s - 1) / sigma loses most of its
// float32 digits to cancellation; a float32 solve then ends ~1e-5 from the
// float64 optimum, the kernel ~1e-7 (its output's rounding).
//
// K31 replaces extractorb_tpu/dist/sharded_pose_graph.py:
// optimize_sharded_pose_graph (a shard_map over a device mesh): shard s
// holds edges [s Es, (s+1) Es) (padded edges have weight 0) and a copy of
// the vertices.  It runs K13's kernels on its own edges, shard by shard, and
// where the JAX program psums, the shards' partials are summed in shard
// order (shard_sum.cuh): the gradient, the 7x7 blocks and the current cost
// after the gather, the Hessian-vector product after each hv pass, the
// candidate cost before the accept.  The vertex-side steps (inverses, PCG
// vectors and dot products, retraction, accept) then run on every shard on
// the same sums, so the shards' vertices stay equal, as the replicated
// values of the shard_map do.
//
// Every sum runs in a fixed order (no float atomics), so a solve gives one
// result per input, as the JAX program does: the vertex sums over the
// index-ordered lists, the scalars (costs, r.z, p.Ap) as per-CTA partials
// summed in block order by the last CTA (det_reduce.cuh's reduce_store),
// the shards in shard order.
//
// Bound on the H100: launch latency.  A graph of ~200 vertices and ~1500
// edges is microseconds of arithmetic per pass; the 3 cg_iters + 7
// dependent launches of each LM iteration set the time.  K31 on n shards of
// one card launches each pass n times plus a small sum kernel at each
// reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "dual.cuh"
#include "lie_t.cuh"
#include "small_linalg.cuh"

constexpr int kThreads = 128;

using real = double;

struct Graph {
  const int* ei;
  const int* ej;
  const real* mR;   // (E,9)
  const real* mt;   // (E,3)
  const real* ms;   // (E,)
  const real* w;    // (E,) weight x valid
  const bool* fixed; // (K,)
  int K, E;
  bool fix_scale;
};

struct Ws {
  real* Rn;   // (K,9) candidates
  real* tn;   // (K,3)
  real* sn;   // (K,)
  real* r;    // (E,7)
  real* Ji;   // (E,49)
  real* Jj;   // (E,49)
  real* g;    // (K,7), followed by Hd (one range for the cross-shard sum)
  real* Hd;   // (K,49)
  real* h;    // (K,7)
  real* M;    // (K,49)
  real* x;
  real* rr;
  real* z;
  real* p;
  real* Ap;
  double* lam;
  double* sc;  // [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
  double* part;  // per-CTA partials of the scalar being reduced
  unsigned* ticket;
  int* cnt;    // (K,) edge ends per vertex
  int* off;    // (K+1,) list offsets
  int* list;   // (2E,) edge ends 2 e + side, grouped by vertex, in index order
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t carve(Ws* w, uint8_t* base, int K, int E, int cg) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  uint8_t* q;
  q = take(sizeof(real) * 9 * K); if (w) w->Rn = (real*)q;
  q = take(sizeof(real) * 3 * K); if (w) w->tn = (real*)q;
  q = take(sizeof(real) * K);     if (w) w->sn = (real*)q;
  q = take(sizeof(real) * 7 * (size_t)E);  if (w) w->r = (real*)q;
  q = take(sizeof(real) * 49 * (size_t)E); if (w) w->Ji = (real*)q;
  q = take(sizeof(real) * 49 * (size_t)E); if (w) w->Jj = (real*)q;
  q = take(sizeof(real) * (size_t)(7 + 49 + 7) * K);
  if (w) {
    w->g = (real*)q;
    w->Hd = w->g + (size_t)7 * K;
    w->h = w->Hd + (size_t)49 * K;
  }
  q = take(sizeof(real) * 49 * K); if (w) w->M = (real*)q;
  q = take(sizeof(real) * 7 * K);  if (w) w->x = (real*)q;
  q = take(sizeof(real) * 7 * K);  if (w) w->rr = (real*)q;
  q = take(sizeof(real) * 7 * K);  if (w) w->z = (real*)q;
  q = take(sizeof(real) * 7 * K);  if (w) w->p = (real*)q;
  q = take(sizeof(real) * 7 * K);  if (w) w->Ap = (real*)q;
  q = take(sizeof(double));         if (w) w->lam = (double*)q;
  q = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)q;
  const long long nb = (long long)(E > 7 * K ? E : 7 * K) / kThreads + 2;
  q = take(sizeof(double) * (size_t)nb); if (w) w->part = (double*)q;
  q = take(sizeof(unsigned)); if (w) w->ticket = (unsigned*)q;
  q = take(sizeof(int) * (size_t)K); if (w) w->cnt = (int*)q;
  q = take(sizeof(int) * ((size_t)K + 1)); if (w) w->off = (int*)q;
  q = take(sizeof(int) * 2 * (size_t)E); if (w) w->list = (int*)q;
  return o;
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

__device__ __forceinline__ bool free_dim(const Graph& q, int k, int a) {
  return !q.fixed[k] && !(q.fix_scale && a == 6);
}

// a double summed over the warp by a fixed xor tree: every lane gets the sum
__device__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#include "det_reduce.cuh"  // block_scan_into, reduce_store
#include "shard_sum.cuh"

// the vertex lists: counts, offsets, then one CTA per vertex compacts the
// edge ends that touch it, in index order
__global__ void __launch_bounds__(kThreads) vl_count(const int* ei, const int* ej, int E, int* cnt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  atomicAdd(cnt + ei[e], 1);
  atomicAdd(cnt + ej[e], 1);
}

__global__ void __launch_bounds__(kScanThreads) vl_scan(const int* cnt, int K, int* off) {
  __shared__ int sh[kScanThreads];
  block_scan_into(cnt, K, off, sh);
}

__global__ void __launch_bounds__(kThreads)
vl_fill(const int* __restrict__ ei, const int* __restrict__ ej, int E, const int* __restrict__ off,
        int* __restrict__ list) {
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int base;
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = off[k];
  __syncthreads();
  for (int n0 = 0; n0 < 2 * E; n0 += kThreads) {
    const int n = n0 + threadIdx.x;
    const bool f = n < 2 * E && ((n & 1) ? ej[n >> 1] : ei[n >> 1]) == k;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w2 = 0; w2 < kThreads / 32; ++w2) {
      before += w2 < warp ? warp_cnt[w2] : 0;
      total += warp_cnt[w2];
    }
    if (f) list[base + before + __popc(bal & ((1u << lane) - 1u))] = n;
    __syncthreads();
    if (threadIdx.x == 0) base += total;
    __syncthreads();
  }
}

// r = log(m (Exp(di) S_i) (Exp(dj) S_j)^-1) with S_i, S_j, m constants
template <class T>
__device__ void edge_residual(const real* Ri, const real* ti, real si, const real* Rj,
                              const real* tj, real sj, const real* mR, const real* mt, real ms,
                              const T* di, const T* dj, T* out) {
  T A[9], a[3], as, B[9], b[3], bs, C[9], c[3], cs, D[9], d[3], ds;
  T Ri_[9], ti_[3], Rj_[9], tj_[3], mR_[9], mt_[3];
  for (int k = 0; k < 9; ++k) { Ri_[k] = cst<T>(Ri[k]); Rj_[k] = cst<T>(Rj[k]); mR_[k] = cst<T>(mR[k]); }
  for (int k = 0; k < 3; ++k) { ti_[k] = cst<T>(ti[k]); tj_[k] = cst<T>(tj[k]); mt_[k] = cst<T>(mt[k]); }
  sim3_exp_t(di, A, a, as);
  sim3_compose_t(A, a, as, Ri_, ti_, cst<T>(si), B, b, bs);        // S_i'
  sim3_exp_t(dj, A, a, as);
  sim3_compose_t(A, a, as, Rj_, tj_, cst<T>(sj), C, c, cs);        // S_j'
  sim3_inverse_t(C, c, cs, D, d, ds);                              // S_j'^-1
  sim3_compose_t(B, b, bs, D, d, ds, A, a, as);                    // S_i' S_j'^-1
  sim3_compose_t(mR_, mt_, cst<T>(ms), A, a, as, C, c, cs);        // m (...)
  sim3_log_t(C, c, cs, out);
}

__device__ __forceinline__ void vertex_pose(const real* R, const real* t, const real* s, int k,
                                            const real*& Rk, const real*& tk, real& sk) {
  Rk = R + 9 * k;
  tk = t + 3 * k;
  sk = s[k];
}

// residual and both Jacobians per edge, stored, and the cost
__global__ void __launch_bounds__(kThreads)
build_kernel(const real* __restrict__ R, const real* __restrict__ t, const real* __restrict__ s,
             const Graph q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double cost = 0.0;
  if (e < q.E) {
    const int i = q.ei[e], j = q.ej[e];
    const real *Ri, *ti, *Rj, *tj;
    real si, sj;
    vertex_pose(R, t, s, i, Ri, ti, si);
    vertex_pose(R, t, s, j, Rj, tj, sj);
    Dual<7, real> dv[7], dz[7], out[7];
    for (int k = 0; k < 7; ++k) {
      dv[k] = dconst<7, real>(0.0);
      dv[k].d[k] = 1.0;
      dz[k] = dconst<7, real>(0.0);
    }
    real* re = w.r + 7 * (size_t)e;
    real* Jie = w.Ji + 49 * (size_t)e;
    real* Jje = w.Jj + 49 * (size_t)e;
    edge_residual<Dual<7, real>>(Ri, ti, si, Rj, tj, sj, q.mR + 9 * e, q.mt + 3 * e, q.ms[e], dv, dz, out);
    for (int a = 0; a < 7; ++a) {
      re[a] = out[a].v;
      for (int b = 0; b < 7; ++b) Jie[7 * a + b] = out[a].d[b];
    }
    edge_residual<Dual<7, real>>(Ri, ti, si, Rj, tj, sj, q.mR + 9 * e, q.mt + 3 * e, q.ms[e], dz, dv, out);
    for (int a = 0; a < 7; ++a)
      for (int b = 0; b < 7; ++b) Jje[7 * a + b] = out[a].d[b];
    const real we = q.w[e];
    real c = 0.0;
    for (int a = 0; a < 7; ++a) c += re[a] * re[a];
    cost = (double)(c * we);
  }
  reduce_store(cost, w.part, w.ticket, cost_old(w));
}

// one warp per vertex: the gradient (masked) and the 7x7 diagonal block over
// its list, lane l taking entries l, l + 32, ... in order, then the lanes
// summed by a fixed tree
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Graph q, Ws w) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (k >= q.K) return;  // whole warps
  real g[7], H[49];
  for (int i = 0; i < 7; ++i) g[i] = 0.0;
  for (int i = 0; i < 49; ++i) H[i] = 0.0;
  for (int n = w.off[k] + lane; n < w.off[k + 1]; n += 32) {
    const int ent = w.list[n];
    const int e = ent >> 1;
    const real we = q.w[e];
    if (we == 0.0) continue;
    const real* J = ((ent & 1) ? w.Jj : w.Ji) + 49 * (size_t)e;
    const real* re = w.r + 7 * (size_t)e;
    for (int f = 0; f < 7; ++f) {
      real gf = 0.0;
      for (int a = 0; a < 7; ++a) gf += J[7 * a + f] * we * re[a];
      if (free_dim(q, k, f)) g[f] += gf;
      for (int g2 = 0; g2 < 7; ++g2) {
        real hf = 0.0;
        for (int a = 0; a < 7; ++a) hf += J[7 * a + f] * we * J[7 * a + g2];
        H[7 * f + g2] += hf;
      }
    }
  }
  for (int i = 0; i < 7; ++i) {
    const real v = warp_sum_d(g[i]);
    if (lane == 0) w.g[7 * k + i] = v;
  }
  for (int i = 0; i < 49; ++i) {
    const real v = warp_sum_d(H[i]);
    if (lane == 0) w.Hd[49 * k + i] = v;
  }
}

// per vertex: M = (Hd + lam I)^-1; x = 0, r = g, z = M r (masked), r.z
__global__ void __launch_bounds__(kThreads)
invert_kernel(const Graph q, Ws w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const real lam = *w.lam;
    real A[49], I[49];
    for (int i = 0; i < 49; ++i) {
      A[i] = w.Hd[49 * k + i] + ((i % 8 == 0) ? lam : 0.0);
      I[i] = (i % 8 == 0) ? 1.0 : 0.0;
    }
    for (int c = 0; c < 7; ++c) {
      int piv = c;
      for (int r = c + 1; r < 7; ++r)
        if (fabs(A[7 * r + c]) > fabs(A[7 * piv + c])) piv = r;
      if (piv != c)
        for (int k2 = 0; k2 < 7; ++k2) {
          real tmp = A[7 * c + k2]; A[7 * c + k2] = A[7 * piv + k2]; A[7 * piv + k2] = tmp;
          tmp = I[7 * c + k2]; I[7 * c + k2] = I[7 * piv + k2]; I[7 * piv + k2] = tmp;
        }
      const real inv = 1.0 / A[8 * c];
      for (int k2 = 0; k2 < 7; ++k2) { A[7 * c + k2] *= inv; I[7 * c + k2] *= inv; }
      for (int r = 0; r < 7; ++r) {
        if (r == c) continue;
        const real f = A[7 * r + c];
        for (int k2 = 0; k2 < 7; ++k2) {
          A[7 * r + k2] -= f * A[7 * c + k2];
          I[7 * r + k2] -= f * I[7 * c + k2];
        }
      }
    }
    for (int i = 0; i < 49; ++i) w.M[49 * k + i] = I[i];
    real rb[7];
    for (int a = 0; a < 7; ++a) {
      rb[a] = w.g[7 * k + a];  // already masked
      w.rr[7 * k + a] = rb[a];
      w.x[7 * k + a] = 0.0;
      w.p[7 * k + a] = 0.0;
    }
    for (int a = 0; a < 7; ++a) {
      real sacc = 0.0;
      for (int b = 0; b < 7; ++b) sacc += I[7 * a + b] * rb[b];
      sacc = free_dim(q, k, a) ? sacc : 0.0;
      w.z[7 * k + a] = sacc;
      part += (double)(rb[a] * sacc);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, 0));
}

__device__ __forceinline__ real beta_of(const Ws& w, int it) {
  return it == 0 ? 0.0 : (*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// h = J^T W J p, one warp per vertex over its list (lanes and order as
// gather_kernel): each edge's u = w (Ji vi + Jj vj) with v = z + beta p_prev
// (masked) built on the fly
__global__ void __launch_bounds__(kThreads)
hv_kernel(const Graph q, Ws w, int it) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (k >= q.K) return;  // whole warps
  const real beta = beta_of(w, it);
  real h[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int n = w.off[k] + lane; n < w.off[k + 1]; n += 32) {
    const int ent = w.list[n];
    const int e = ent >> 1;
    const real we = q.w[e];
    if (we == 0.0) continue;
    const int i = q.ei[e], j = q.ej[e];
    real vi[7], vj[7];
    for (int a = 0; a < 7; ++a) {
      vi[a] = free_dim(q, i, a) ? w.z[7 * i + a] + beta * w.p[7 * i + a] : 0.0;
      vj[a] = free_dim(q, j, a) ? w.z[7 * j + a] + beta * w.p[7 * j + a] : 0.0;
    }
    const real* Ji = w.Ji + 49 * (size_t)e;
    const real* Jj = w.Jj + 49 * (size_t)e;
    real u[7];
    for (int a = 0; a < 7; ++a) {
      real sacc = 0.0, sj = 0.0;
      for (int b = 0; b < 7; ++b) { sacc += Ji[7 * a + b] * vi[b]; sj += Jj[7 * a + b] * vj[b]; }
      u[a] = (sacc + sj) * we;
    }
    const real* J = (ent & 1) ? Jj : Ji;
    for (int f = 0; f < 7; ++f) {
      real hf = 0.0;
      for (int a = 0; a < 7; ++a) hf += J[7 * a + f] * u[a];
      h[f] += hf;
    }
  }
  for (int f = 0; f < 7; ++f) {
    const real v = warp_sum_d(h[f]);
    if (lane == 0) w.h[7 * k + f] = v;
  }
}

// per scalar: p = z + beta p, Ap = (h + lam p) masked, p.Ap partial
__global__ void __launch_bounds__(kThreads)
cg_a_kernel(const Graph q, Ws w, int it, int cg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (e < 7 * q.K) {
    const bool fr = free_dim(q, e / 7, e % 7);
    const real pe = fr ? w.z[e] + beta_of(w, it) * w.p[e] : 0.0;
    const real ap = fr ? w.h[e] + *w.lam * pe : 0.0;
    w.p[e] = pe;
    w.Ap[e] = ap;
    part = (double)(pe * ap);
  }
  reduce_store(part, w.part, w.ticket, pAp(w, it, cg));
}

// per vertex: x += alpha p, r -= alpha Ap, z = M r, r.z partial
__global__ void __launch_bounds__(kThreads)
cg_b_kernel(const Graph q, Ws w, int it, int cg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const real alpha = (*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
    real rb[7];
    for (int a = 0; a < 7; ++a) {
      w.x[7 * k + a] += alpha * w.p[7 * k + a];
      rb[a] = w.rr[7 * k + a] - alpha * w.Ap[7 * k + a];
      w.rr[7 * k + a] = rb[a];
    }
    const real* M = w.M + 49 * k;
    for (int a = 0; a < 7; ++a) {
      real sacc = 0.0;
      for (int b = 0; b < 7; ++b) sacc += M[7 * a + b] * rb[b];
      sacc = free_dim(q, k, a) ? sacc : 0.0;
      w.z[7 * k + a] = sacc;
      part += (double)(rb[a] * sacc);
    }
  }
  reduce_store(part, w.part, w.ticket, rz(w, it + 1));
}

// candidate S_k' = Exp(-x masked) S_k, rotation re-projected by its SVD
__global__ void __launch_bounds__(kThreads)
retract_kernel(const real* __restrict__ R, const real* __restrict__ t,
               const real* __restrict__ s, const Graph q, Ws w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q.K) return;
  real d[7], dR[9], dt[3], ds, Rn[9], tn[3], sn;
  for (int a = 0; a < 7; ++a) d[a] = free_dim(q, k, a) ? -w.x[7 * k + a] : 0.0;
  sim3_exp_t<real>(d, dR, dt, ds);
  sim3_compose_t<real>(dR, dt, ds, R + 9 * k, t + 3 * k, s[k], Rn, tn, sn);
  double A[9], U[9], sv[3], V[9];
  for (int i = 0; i < 9; ++i) A[i] = (double)Rn[i];
  svd3(A, U, sv, V);
  double UVt[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) UVt[3 * i + j] = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] + U[3 * i + 2] * V[3 * j + 2];
  const double dsign = det3(UVt) < 0.0 ? -1.0 : 1.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      w.Rn[9 * k + 3 * i + j] = (real)(U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] +
                                        dsign * U[3 * i + 2] * V[3 * j + 2]);
  for (int i = 0; i < 3; ++i) w.tn[3 * k + i] = tn[i];
  w.sn[k] = sn;
}

__global__ void __launch_bounds__(kThreads)
cost_kernel(const Graph q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double cost = 0.0;
  if (e < q.E && q.w[e] != 0.0) {
    const int i = q.ei[e], j = q.ej[e];
    const real zero[7] = {0, 0, 0, 0, 0, 0, 0};
    real r[7];
    edge_residual<real>(w.Rn + 9 * i, w.tn + 3 * i, w.sn[i], w.Rn + 9 * j, w.tn + 3 * j, w.sn[j],
                         q.mR + 9 * e, q.mt + 3 * e, q.ms[e], zero, zero, r);
    real c = 0.0;
    for (int a = 0; a < 7; ++a) c += r[a] * r[a];
    cost = (double)(c * q.w[e]);
  }
  reduce_store(cost, w.part, w.ticket, cost_new(w));
}

__global__ void __launch_bounds__(kThreads)
accept_kernel(real* __restrict__ R, real* __restrict__ t, real* __restrict__ s, const Graph q,
              Ws w, real* __restrict__ cost_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const real cn = *cost_new(w), co = *cost_old(w);
  const bool better = cn < co;
  if (k == 0) {
    *w.lam = better ? *w.lam * 0.5 : *w.lam * 4.0;
    *cost_out = cn;
  }
  if (!better || k >= q.K) return;
  for (int i = 0; i < 9; ++i) R[9 * k + i] = w.Rn[9 * k + i];
  for (int i = 0; i < 3; ++i) t[3 * k + i] = w.tn[3 * k + i];
  s[k] = w.sn[k];
}

__global__ void init_kernel(Ws w) {
  *w.lam = 1e-4;
  *w.ticket = 0u;
}

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// one shard of a solve: its copy of the vertices (overwritten with the
// result), its edges, its workspace and its cost
struct Shard {
  real* R;
  real* t;
  real* s;
  Graph q;
  Ws w;
  real* cost_out;
};

int solve(int n, Shard* sh, ShardComm& cm, int n_iters, int cg_iters) {
  const int K = sh[0].q.K;
  cudaError_t e;
  real* gH[kMaxShards];
  real* h[kMaxShards];
  double* c_old[kMaxShards];
  double* c_new[kMaxShards];
  for (int s = 0; s < n; ++s) {
    gH[s] = sh[s].w.g;
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
    const int eb = blocks(S.q.E > 0 ? S.q.E : 1);                     \
    (void)eb;                                                         \
    __VA_ARGS__;                                                      \
  }
#define SUM(ptrs, count) \
  if ((e = allreduce(cm, ptrs, count)) != cudaSuccess) return (int)e;
  EACH(if ((e = cudaMemsetAsync(S.cost_out, 0, sizeof(real), st)) != cudaSuccess) return (int)e;
       if ((e = cudaMemsetAsync(S.w.cnt, 0, sizeof(int) * (size_t)K, st)) != cudaSuccess)
           return (int)e;
       init_kernel<<<1, 1, 0, st>>>(S.w);
       vl_count<<<eb, kThreads, 0, st>>>(S.q.ei, S.q.ej, S.q.E, S.w.cnt);
       vl_scan<<<1, kScanThreads, 0, st>>>(S.w.cnt, K, S.w.off);
       vl_fill<<<K, kThreads, 0, st>>>(S.q.ei, S.q.ej, S.q.E, S.w.off, S.w.list))
  for (int it = 0; it < n_iters; ++it) {
    EACH(build_kernel<<<eb, kThreads, 0, st>>>(S.R, S.t, S.s, S.q, S.w);
         gather_kernel<<<blocks(32LL * K), kThreads, 0, st>>>(S.q, S.w))
    SUM(gH, 56LL * K)
    SUM(c_old, 1)
    EACH(invert_kernel<<<blocks(K), kThreads, 0, st>>>(S.q, S.w))
    for (int c = 0; c < cg_iters; ++c) {
      EACH(hv_kernel<<<blocks(32LL * K), kThreads, 0, st>>>(S.q, S.w, c))
      SUM(h, 7LL * K)
      EACH(cg_a_kernel<<<blocks(7 * K), kThreads, 0, st>>>(S.q, S.w, c, cg_iters);
           cg_b_kernel<<<blocks(K), kThreads, 0, st>>>(S.q, S.w, c, cg_iters))
    }
    EACH(retract_kernel<<<blocks(K), kThreads, 0, st>>>(S.R, S.t, S.s, S.q, S.w);
         cost_kernel<<<eb, kThreads, 0, st>>>(S.q, S.w))
    SUM(c_new, 1)
    EACH(accept_kernel<<<blocks(K), kThreads, 0, st>>>(S.R, S.t, S.s, S.q, S.w, S.cost_out);
         if ((e = cudaGetLastError()) != cudaSuccess) return (int)e)
  }
#undef EACH
#undef SUM
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long pose_graph_workspace_bytes(int K, int E, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, E, cg_iters);
}

// K31's peer route: bytes of the n slots on shard 0's device (the largest
// summed range: the gradient and the 7x7 blocks)
extern "C" long long pose_graph_gather_bytes(int n, int K) {
  return (long long)n * (long long)align16(sizeof(real) * 56 * (size_t)K);
}

// R (K,9), t (K,3), s (K,): the start state, overwritten with the result;
// edges ei, ej (E,) i32, mR (E,9), mt (E,3), ms (E,), w (E,) weight x valid,
// fixed (K,) bool; every real array and cost_out float64
extern "C" int pose_graph_launch(void* R, void* t, void* s, const void* ei, const void* ej,
                                 const void* mR, const void* mt, const void* ms, const void* wt,
                                 const void* fixed, int K, int E, int n_iters, int cg_iters,
                                 int fix_scale, void* ws, void* cost_out, void* stream) {
  if (K <= 0 || E < 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  Shard sh;
  sh.R = (real*)R;
  sh.t = (real*)t;
  sh.s = (real*)s;
  sh.q = Graph{(const int*)ei, (const int*)ej, (const real*)mR, (const real*)mt,
               (const real*)ms, (const real*)wt, (const bool*)fixed, K, E, fix_scale != 0};
  carve(&sh.w, static_cast<uint8_t*>(ws), K, E, cg_iters);
  sh.cost_out = (real*)cost_out;
  ShardComm cm;
  cm.st[0] = (cudaStream_t)stream;
  return solve(1, &sh, cm, n_iters, cg_iters);
}

// K31: n shards of Es edges each.  devs (n,) the CUDA device of each shard;
// tab (n, 13) host rows of pointers: R (K,9), t (K,3), s (K,) (each shard's
// copy of the start vertices), ei, ej, mR, mt, ms, w (its Es edges), fixed
// (K), its workspace (pose_graph_workspace_bytes(K, Es, cg_iters)), its cost
// and its stream; all reals float64.  gather: pose_graph_gather_bytes(n, K)
// on devs[0] when the devices differ, else null.  Every shard ends with the
// same vertices and cost.  The caller's current device is kept.
extern "C" int pose_graph_sharded_launch(int n, const int* devs, const long long* tab, int K,
                                         int Es, int n_iters, int cg_iters, int fix_scale,
                                         void* gather) {
  if (n < 1 || n > kMaxShards || K <= 0 || Es < 0 || n_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  Shard sh[kMaxShards];
  cudaStream_t sts[kMaxShards];
  for (int s = 0; s < n; ++s) {
    const long long* r = tab + 13 * (size_t)s;
    sh[s].R = (real*)r[0];
    sh[s].t = (real*)r[1];
    sh[s].s = (real*)r[2];
    sh[s].q = Graph{(const int*)r[3], (const int*)r[4], (const real*)r[5], (const real*)r[6],
                    (const real*)r[7], (const real*)r[8], (const bool*)r[9], K, Es,
                    fix_scale != 0};
    carve(&sh[s].w, (uint8_t*)r[10], K, Es, cg_iters);
    sh[s].cost_out = (real*)r[11];
    sts[s] = (cudaStream_t)r[12];
  }
  int prev;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  ShardComm cm;
  e = comm_open(cm, n, devs, sts, gather, (size_t)pose_graph_gather_bytes(1, K));
  int err = (int)e;
  if (e == cudaSuccess) err = solve(n, sh, cm, n_iters, cg_iters);
  comm_close(cm);
  cudaSetDevice(prev);
  return err;
}
