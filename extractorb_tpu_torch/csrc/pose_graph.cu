// K13 pose_graph: Levenberg-Marquardt over the Sim3 essential graph with a
// matrix-free block-Jacobi PCG.
//
// Replaces extractorb_tpu/solver/pose_graph.py:optimize_pose_graph, which
// the TPU runs as a lax.scan of LM steps over a vmapped jacfwd of the edge
// residual r = log(m_ij Exp(di) S_i (Exp(dj) S_j)^-1) and a lax.scan of PCG
// sweeps with segment sums.  Here each LM iteration is:
//   build:   one thread per edge evaluates the residual and both 7x7
//            Jacobians at d = 0 in forward-mode dual numbers (Dual<7, double>,
//            lie_t.cuh: the same sim3_exp / sim3_log branches as the JAX
//            package, so the theta -> 0 guards of sim3_log are the JAX
//            function's), stores them, adds the gradient and the 7x7
//            diagonal blocks with atomics, and the current cost;
//   invert:  one thread per vertex inverts its damped block (Gauss-Jordan
//            with partial pivoting) and starts PCG;
//   cg_iters x three launches: the Hessian-vector product over the edges
//            (p = z + beta p built on the fly), the damped and masked
//            product with p.Ap, the alpha step with the preconditioner and
//            r.z (K6's scheme);
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
// Bound on the H100: launch latency.  A graph of ~200 vertices and ~1500
// edges is microseconds of arithmetic per pass; the 3 cg_iters + 6
// dependent launches of each LM iteration set the time.  Atomics make the
// summation order (and the last bits) vary from run to run.

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
  // zeroed at every LM iteration, contiguous: g, Hd, h
  real* g;    // (K,7)
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
  return o;
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

__device__ __forceinline__ bool free_dim(const Graph& q, int k, int a) {
  return !q.fixed[k] && !(q.fix_scale && a == 6);
}

__device__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// residual and both Jacobians per edge; gradient, diagonal blocks, cost
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
    if (we != 0.0) {
      for (int side = 0; side < 2; ++side) {
        const real* J = side ? Jje : Jie;
        const int k = side ? j : i;
        for (int f = 0; f < 7; ++f) {
          real gf = 0.0;
          for (int a = 0; a < 7; ++a) gf += J[7 * a + f] * we * re[a];
          if (free_dim(q, k, f)) atomicAdd(w.g + 7 * k + f, gf);
          for (int g2 = 0; g2 < 7; ++g2) {
            real hf = 0.0;
            for (int a = 0; a < 7; ++a) hf += J[7 * a + f] * we * J[7 * a + g2];
            atomicAdd(w.Hd + 49 * k + 7 * f + g2, hf);
          }
        }
      }
    }
  }
  cost = warp_sum_d(cost);
  if ((threadIdx.x & 31) == 0 && cost != 0.0) atomicAdd(cost_old(w), cost);
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
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(rz(w, 0), part);
}

__device__ __forceinline__ real beta_of(const Ws& w, int it) {
  return it == 0 ? 0.0 : (*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// h += J^T W J p over the edges, p = z + beta p_prev (masked) on the fly
__global__ void __launch_bounds__(kThreads)
hv_kernel(const Graph q, Ws w, int it) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= q.E) return;
  const real we = q.w[e];
  if (we == 0.0) return;
  const int i = q.ei[e], j = q.ej[e];
  const real beta = beta_of(w, it);
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
  for (int f = 0; f < 7; ++f) {
    real hi = 0.0, hj = 0.0;
    for (int a = 0; a < 7; ++a) { hi += Ji[7 * a + f] * u[a]; hj += Jj[7 * a + f] * u[a]; }
    atomicAdd(w.h + 7 * i + f, hi);
    atomicAdd(w.h + 7 * j + f, hj);
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
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(pAp(w, it, cg), part);
}

// per vertex: x += alpha p, r -= alpha Ap, z = M r, r.z partial; clear h
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
      w.h[7 * k + a] = 0.0;
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
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(rz(w, it + 1), part);
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
  cost = warp_sum_d(cost);
  if ((threadIdx.x & 31) == 0 && cost != 0.0) atomicAdd(cost_new(w), cost);
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

__global__ void init_kernel(Ws w) { *w.lam = 1e-4; }

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" long long pose_graph_workspace_bytes(int K, int E, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, E, cg_iters);
}

// R (K,9), t (K,3), s (K,): the start state, overwritten with the result;
// edges ei, ej (E,) i32, mR (E,9), mt (E,3), ms (E,), w (E,) weight x valid,
// fixed (K,) bool; every real array and cost_out float64
extern "C" int pose_graph_launch(void* R, void* t, void* s, const void* ei, const void* ej,
                                 const void* mR, const void* mt, const void* ms, const void* wt,
                                 const void* fixed, int K, int E, int n_iters, int cg_iters,
                                 int fix_scale, void* ws, void* cost_out, void* stream) {
  if (K <= 0 || E < 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Ws w;
  carve(&w, static_cast<uint8_t*>(ws), K, E, cg_iters);
  const Graph q{(const int*)ei, (const int*)ej, (const real*)mR, (const real*)mt,
                (const real*)ms, (const real*)wt, (const bool*)fixed, K, E, fix_scale != 0};
  real* Rf = (real*)R;
  real* tf = (real*)t;
  real* sf = (real*)s;
  const size_t zero_bytes = sizeof(real) * (size_t)(7 + 49 + 7) * K;
  const size_t sc_bytes = sizeof(double) * (3 + 2 * (size_t)cg_iters);
  cudaError_t e;
  if ((e = cudaMemsetAsync(cost_out, 0, sizeof(real), st)) != cudaSuccess) return (int)e;
  init_kernel<<<1, 1, 0, st>>>(w);
  const int eb = blocks(E > 0 ? E : 1);
  for (int it = 0; it < n_iters; ++it) {
    if ((e = cudaMemsetAsync(w.g, 0, zero_bytes, st)) != cudaSuccess) return (int)e;
    if ((e = cudaMemsetAsync(w.sc, 0, sc_bytes, st)) != cudaSuccess) return (int)e;
    build_kernel<<<eb, kThreads, 0, st>>>(Rf, tf, sf, q, w);
    invert_kernel<<<blocks(K), kThreads, 0, st>>>(q, w);
    for (int c = 0; c < cg_iters; ++c) {
      hv_kernel<<<eb, kThreads, 0, st>>>(q, w, c);
      cg_a_kernel<<<blocks(7 * K), kThreads, 0, st>>>(q, w, c, cg_iters);
      cg_b_kernel<<<blocks(K), kThreads, 0, st>>>(q, w, c, cg_iters);
    }
    retract_kernel<<<blocks(K), kThreads, 0, st>>>(Rf, tf, sf, q, w);
    cost_kernel<<<eb, kThreads, 0, st>>>(q, w);
    accept_kernel<<<blocks(K), kThreads, 0, st>>>(Rf, tf, sf, q, w, (real*)cost_out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
