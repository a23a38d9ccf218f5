// K23 pose_graph_4dof: Levenberg-Marquardt over the 4-DoF essential graph
// of an inertial map (yaw about world z and the translation per keyframe),
// with a matrix-free block-Jacobi PCG.
//
// Replaces extractorb_tpu/solver/pose_graph.py:optimize_pose_graph_4dof
// (ORB-SLAM3's OptimizeEssentialGraph4DoF), which the TPU runs as a
// lax.scan of LM steps over a vmapped jacfwd of the edge residual
// r = log_se3(m_ij (T_i <+ d_i) (T_j <+ d_j)^-1), segment sums and a
// lax.scan of PCG sweeps.  Here one CTA runs the whole solve in one launch:
//   lists:   once per solve, each vertex's edge ends in edge order (integer
//            atomics count and place them, an insertion sort orders each
//            list), so every block sum below runs in a fixed order;
//   build:   each thread evaluates its edges' residual and both 6x4
//            Jacobians at d = 0 in forward-mode dual numbers (Dual<4>,
//            lie_t.cuh: the JAX package's so3_exp / so3_log / se3_log
//            branches), and the cost;
//   vertex:  each thread sums its vertices' gradient and 4x4 diagonal block
//            over their lists, inverts the damped block (Gauss-Jordan with
//            partial pivoting) and starts PCG;
//   PCG:     cg_iters sweeps of an edge pass (u_e = w_e (J_i p_i + J_j p_j))
//            and vertex passes (h = sum J^T u, alpha, the preconditioner,
//            beta); the dot products are block sums in a fixed order;
//   retract: T_k <- T_k [Exp((0, 0, -x_k0)), -x_k(1:4)]^-1, the rotation
//            projected onto SO(3) through its SVD (small_linalg.cuh, float64),
//            the candidate's cost, and the accept with lambda x0.5 or x4.
// Nothing in the solve depends on scheduling: one input gives one result.
// The solve runs in float32 (held to the float64 plain solve: no farther
// from it than the float32 plain solve); every dot product and cost sums
// in double.
//
// Bound on the H100: the dependent steps of one CTA.  A graph of ~24
// vertices and ~100 edges is microseconds of arithmetic; 15 LM iterations
// of 50 PCG sweeps, each a few block barriers and dependent global-memory
// passes, set the time.  A graph of hundreds of vertices and ~10^4 edges
// gives each of the 256 threads ~40 edges a pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "dual.cuh"
#include "lie_t.cuh"
#include "small_linalg.cuh"

constexpr int kThreads = 256;

template <class S>
struct Graph {
  const int* ei;
  const int* ej;
  const S* mR;       // (E,9)
  const S* mt;       // (E,3)
  const S* w;        // (E,) weight x valid
  const bool* fixed; // (K,)
  int K, E;
};

template <class S>
struct Ws {
  S* Rn;   // (K,9) candidates
  S* tn;   // (K,3)
  S* r;    // (E,6)
  S* Ji;   // (E,24) row-major 6x4
  S* Jj;   // (E,24)
  S* u;    // (E,6) w_e (J_i p_i + J_j p_j)
  S* M;    // (K,16)
  S* x;    // (K,4) each
  S* rr;
  S* z;
  S* p;
  S* Ap;
  int* cnt;  // (K,) list sizes, then fill cursors
  int* off;  // (K+1,)
  int* adj;  // (2E,) edge ends 2e + side, grouped by vertex in edge order
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <class S>
__host__ __device__ inline size_t carve(Ws<S>* w, uint8_t* base, int K, int E) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  const size_t k = (size_t)K, e = (size_t)E;
  uint8_t* q;
  q = take(sizeof(S) * 9 * k);  if (w) w->Rn = (S*)q;
  q = take(sizeof(S) * 3 * k);  if (w) w->tn = (S*)q;
  q = take(sizeof(S) * 6 * e);  if (w) w->r = (S*)q;
  q = take(sizeof(S) * 24 * e); if (w) w->Ji = (S*)q;
  q = take(sizeof(S) * 24 * e); if (w) w->Jj = (S*)q;
  q = take(sizeof(S) * 6 * e);  if (w) w->u = (S*)q;
  q = take(sizeof(S) * 16 * k); if (w) w->M = (S*)q;
  q = take(sizeof(S) * 4 * k);  if (w) w->x = (S*)q;
  q = take(sizeof(S) * 4 * k);  if (w) w->rr = (S*)q;
  q = take(sizeof(S) * 4 * k);  if (w) w->z = (S*)q;
  q = take(sizeof(S) * 4 * k);  if (w) w->p = (S*)q;
  q = take(sizeof(S) * 4 * k);  if (w) w->Ap = (S*)q;
  q = take(sizeof(int) * k);       if (w) w->cnt = (int*)q;
  q = take(sizeof(int) * (k + 1)); if (w) w->off = (int*)q;
  q = take(sizeof(int) * 2 * e);   if (w) w->adj = (int*)q;
  return o;
}

// the block's sum of one double per thread, in a fixed order: a xor-shuffle
// tree in each warp, then the warps in order.  All threads must call it;
// every thread gets the sum.
__device__ double block_sum(double v, double* red /* shared, kThreads / 32 + 1 */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
    red[kThreads / 32] = s;
  }
  __syncthreads();
  const double s = red[kThreads / 32];
  __syncthreads();
  return s;
}

// the world-frame update on a world->camera pose (ImuCamPose::UpdateW):
// T_cw' = T_cw [Exp((0, 0, d0)), d(1:4)]^-1
template <class T>
__device__ void apply_4dof(const T* R, const T* t, const T* d, T* Rn, T* tn) {
  const T w[3] = {cst<T>(0.f), cst<T>(0.f), d[0]};
  T dR[9], dRt[9];
  so3_exp_t(w, dR);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) dRt[3 * i + j] = dR[3 * j + i];
  mat3_mul(R, dRt, Rn);
  T v[3];
  mat3_vec(Rn, d + 1, v);
  for (int i = 0; i < 3; ++i) tn[i] = t[i] - v[i];
}

// r = log_se3(m (T_i <+ di) (T_j <+ dj)^-1), with T_i, T_j, m constants
template <class T, class S>
__device__ void edge_residual(const S* Ri, const S* ti, const S* Rj, const S* tj, const S* mR,
                              const S* mt, const T* di, const T* dj, T* out) {
  T Ri_[9], ti_[3], Rj_[9], tj_[3], mR_[9], mt_[3];
  for (int k = 0; k < 9; ++k) { Ri_[k] = cst<T>(Ri[k]); Rj_[k] = cst<T>(Rj[k]); mR_[k] = cst<T>(mR[k]); }
  for (int k = 0; k < 3; ++k) { ti_[k] = cst<T>(ti[k]); tj_[k] = cst<T>(tj[k]); mt_[k] = cst<T>(mt[k]); }
  T A[9], a[3], B[9], b[3], C[9], c[3];
  apply_4dof(Ri_, ti_, di, A, a);           // T_i'
  apply_4dof(Rj_, tj_, dj, B, b);           // T_j'
  se3_inverse_t(B, b, C, c);                // T_j'^-1
  se3_compose_t(A, a, C, c, B, b);          // T_i' T_j'^-1
  se3_compose_t(mR_, mt_, B, b, A, a);      // m (...)
  se3_log_t(A, a, out);
}

// y = M v for a row-major 4x4 M
template <class S>
__device__ __forceinline__ void mat4_vec(const S* M, const S* v, S* y) {
  for (int a = 0; a < 4; ++a)
    y[a] = M[4 * a] * v[0] + M[4 * a + 1] * v[1] + M[4 * a + 2] * v[2] + M[4 * a + 3] * v[3];
}

template <class S>
__device__ void invert4(S* A, S* I) {
  for (int i = 0; i < 16; ++i) I[i] = (i % 5 == 0) ? S(1) : S(0);
  for (int c = 0; c < 4; ++c) {
    int piv = c;
    for (int r = c + 1; r < 4; ++r)
      if (fabs(A[4 * r + c]) > fabs(A[4 * piv + c])) piv = r;
    if (piv != c)
      for (int k = 0; k < 4; ++k) {
        S tmp = A[4 * c + k]; A[4 * c + k] = A[4 * piv + k]; A[4 * piv + k] = tmp;
        tmp = I[4 * c + k]; I[4 * c + k] = I[4 * piv + k]; I[4 * piv + k] = tmp;
      }
    const S inv = S(1) / A[5 * c];
    for (int k = 0; k < 4; ++k) { A[4 * c + k] *= inv; I[4 * c + k] *= inv; }
    for (int r = 0; r < 4; ++r) {
      if (r == c) continue;
      const S f = A[4 * r + c];
      for (int k = 0; k < 4; ++k) {
        A[4 * r + k] -= f * A[4 * c + k];
        I[4 * r + k] -= f * I[4 * c + k];
      }
    }
  }
}

// each vertex's edge ends in edge order
template <class S>
__device__ void build_lists(const Graph<S>& q, const Ws<S>& w, int* sh) {
  const int tid = threadIdx.x, K = q.K, E = q.E;
  for (int k = tid; k < K; k += kThreads) w.cnt[k] = 0;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads)
    if (q.w[e] != S(0)) {
      atomicAdd(w.cnt + q.ei[e], 1);
      atomicAdd(w.cnt + q.ej[e], 1);
    }
  __syncthreads();
  // exclusive scan of cnt into off: a chunk per thread, the chunks' sums
  // scanned across the block (Hillis-Steele)
  const int chunk = (K + kThreads - 1) / kThreads;
  const int a = min(K, tid * chunk), b = min(K, a + chunk);
  int s = 0;
  for (int i = a; i < b; ++i) s += w.cnt[i];
  sh[tid] = s;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const int v = tid >= d ? sh[tid - d] : 0;
    __syncthreads();
    sh[tid] += v;
    __syncthreads();
  }
  int run = sh[tid] - s;
  for (int i = a; i < b; ++i) {
    w.off[i] = run;
    run += w.cnt[i];
    w.cnt[i] = 0;
  }
  if (tid == kThreads - 1) w.off[K] = sh[kThreads - 1];
  __syncthreads();
  for (int e = tid; e < E; e += kThreads)
    if (q.w[e] != S(0)) {
      const int i = q.ei[e], j = q.ej[e];
      w.adj[w.off[i] + atomicAdd(w.cnt + i, 1)] = 2 * e;
      w.adj[w.off[j] + atomicAdd(w.cnt + j, 1)] = 2 * e + 1;
    }
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    int* l = w.adj + w.off[k];
    const int n = w.off[k + 1] - w.off[k];
    for (int i = 1; i < n; ++i) {
      const int v = l[i];
      int j = i - 1;
      while (j >= 0 && l[j] > v) {
        l[j + 1] = l[j];
        --j;
      }
      l[j + 1] = v;
    }
  }
  __syncthreads();
}

template <class S>
__global__ void __launch_bounds__(kThreads)
solve_kernel(S* __restrict__ R, S* __restrict__ t, const Graph<S> q, const Ws<S> w, int n_iters,
             int cg_iters, S* __restrict__ cost_out) {
  using D = Dual<4, S>;
  __shared__ double red[kThreads / 32 + 1];
  __shared__ int sh[kThreads];
  const int tid = threadIdx.x, K = q.K, E = q.E;
  build_lists(q, w, sh);

  S lam = S(1e-4);
  double c_new = 0.0;
  for (int it = 0; it < n_iters; ++it) {
    // residuals and Jacobians at d = 0, and the cost
    double part = 0.0;
    for (int e = tid; e < E; e += kThreads) {
      const int i = q.ei[e], j = q.ej[e];
      D dv[4], dz[4], out[6];
      for (int k = 0; k < 4; ++k) {
        dv[k] = dconst<4, S>(S(0));
        dv[k].d[k] = S(1);
        dz[k] = dconst<4, S>(S(0));
      }
      S* re = w.r + 6 * (size_t)e;
      S* Jie = w.Ji + 24 * (size_t)e;
      S* Jje = w.Jj + 24 * (size_t)e;
      edge_residual<D, S>(R + 9 * i, t + 3 * i, R + 9 * j, t + 3 * j, q.mR + 9 * e, q.mt + 3 * e,
                          dv, dz, out);
      for (int a = 0; a < 6; ++a) {
        re[a] = out[a].v;
        for (int f = 0; f < 4; ++f) Jie[4 * a + f] = out[a].d[f];
      }
      edge_residual<D, S>(R + 9 * i, t + 3 * i, R + 9 * j, t + 3 * j, q.mR + 9 * e, q.mt + 3 * e,
                          dz, dv, out);
      for (int a = 0; a < 6; ++a)
        for (int f = 0; f < 4; ++f) Jje[4 * a + f] = out[a].d[f];
      if (q.w[e] != S(0)) {
        S c = S(0);
        for (int a = 0; a < 6; ++a) c += re[a] * re[a];
        part += (double)(c * q.w[e]);
      }
    }
    const double c_old = block_sum(part, red);

    // gradient and diagonal blocks over each vertex's list; M = (H + lam I)^-1;
    // x = 0, r = g, z = p = M r, r.z
    part = 0.0;
    for (int k = tid; k < K; k += kThreads) {
      S g[4] = {S(0), S(0), S(0), S(0)}, H[16], Mi[16];
      for (int i = 0; i < 16; ++i) H[i] = S(0);
      for (int l = w.off[k]; l < w.off[k + 1]; ++l) {
        const int e = w.adj[l] >> 1;
        const S* J = ((w.adj[l] & 1) ? w.Jj : w.Ji) + 24 * (size_t)e;
        const S* re = w.r + 6 * (size_t)e;
        const S we = q.w[e];
        for (int f = 0; f < 4; ++f) {
          S gf = S(0);
          for (int a = 0; a < 6; ++a) gf += J[4 * a + f] * we * re[a];
          g[f] += gf;
          for (int h = 0; h < 4; ++h) {
            S hf = S(0);
            for (int a = 0; a < 6; ++a) hf += J[4 * a + f] * we * J[4 * a + h];
            H[4 * f + h] += hf;
          }
        }
      }
      const S fr = q.fixed[k] ? S(0) : S(1);
      for (int i = 0; i < 16; ++i) H[i] += (i % 5 == 0) ? lam : S(0);
      invert4(H, Mi);
      S z[4];
      for (int f = 0; f < 4; ++f) g[f] *= fr;
      mat4_vec(Mi, g, z);
      for (int f = 0; f < 4; ++f) {
        z[f] *= fr;
        w.x[4 * k + f] = S(0);
        w.rr[4 * k + f] = g[f];
        w.z[4 * k + f] = z[f];
        w.p[4 * k + f] = z[f];
        part += (double)(g[f] * z[f]);
      }
      for (int i = 0; i < 16; ++i) w.M[16 * k + i] = Mi[i];
    }
    double rz = block_sum(part, red);

    for (int c = 0; c < cg_iters; ++c) {
      // u_e = w_e (J_i p_i + J_j p_j), p masked
      for (int e = tid; e < E; e += kThreads) {
        const S we = q.w[e];
        if (we == S(0)) continue;
        const int i = q.ei[e], j = q.ej[e];
        const S fi = q.fixed[i] ? S(0) : S(1), fj = q.fixed[j] ? S(0) : S(1);
        const S* Ji = w.Ji + 24 * (size_t)e;
        const S* Jj = w.Jj + 24 * (size_t)e;
        for (int a = 0; a < 6; ++a) {
          S si = S(0), sj = S(0);
          for (int f = 0; f < 4; ++f) {
            si += Ji[4 * a + f] * (w.p[4 * i + f] * fi);
            sj += Jj[4 * a + f] * (w.p[4 * j + f] * fj);
          }
          w.u[6 * (size_t)e + a] = (si + sj) * we;
        }
      }
      __syncthreads();
      // Ap = (sum J^T u) masked + lam p, and p.Ap
      part = 0.0;
      for (int k = tid; k < K; k += kThreads) {
        S h[4] = {S(0), S(0), S(0), S(0)};
        for (int l = w.off[k]; l < w.off[k + 1]; ++l) {
          const int e = w.adj[l] >> 1;
          const S* J = ((w.adj[l] & 1) ? w.Jj : w.Ji) + 24 * (size_t)e;
          const S* ue = w.u + 6 * (size_t)e;
          for (int f = 0; f < 4; ++f) {
            S hf = S(0);
            for (int a = 0; a < 6; ++a) hf += J[4 * a + f] * ue[a];
            h[f] += hf;
          }
        }
        const S fr = q.fixed[k] ? S(0) : S(1);
        for (int f = 0; f < 4; ++f) {
          const S pf = w.p[4 * k + f];
          const S ap = h[f] * fr + lam * (pf * fr);
          w.Ap[4 * k + f] = ap;
          part += (double)(pf * ap);
        }
      }
      const double pAp = block_sum(part, red);
      const S alpha = (S)(rz / fmax(pAp, 1e-20));
      // x += alpha p, r -= alpha Ap, z = M r masked, r.z
      part = 0.0;
      for (int k = tid; k < K; k += kThreads) {
        const S fr = q.fixed[k] ? S(0) : S(1);
        S rb[4], z[4];
        for (int f = 0; f < 4; ++f) {
          w.x[4 * k + f] += alpha * w.p[4 * k + f];
          rb[f] = w.rr[4 * k + f] - alpha * w.Ap[4 * k + f];
          w.rr[4 * k + f] = rb[f];
        }
        mat4_vec(w.M + 16 * k, rb, z);
        for (int f = 0; f < 4; ++f) {
          z[f] *= fr;
          w.z[4 * k + f] = z[f];
          part += (double)(rb[f] * z[f]);
        }
      }
      const double rz2 = block_sum(part, red);
      const S beta = (S)(rz2 / fmax(rz, 1e-20));
      for (int k = tid; k < K; k += kThreads)
        for (int f = 0; f < 4; ++f) w.p[4 * k + f] = w.z[4 * k + f] + beta * w.p[4 * k + f];
      rz = rz2;
      __syncthreads();
    }

    // candidates: the masked step -x, the rotation re-projected by its SVD
    for (int k = tid; k < K; k += kThreads) {
      const S fr = q.fixed[k] ? S(0) : S(1);
      S d[4], Rn[9], tn[3];
      for (int f = 0; f < 4; ++f) d[f] = -w.x[4 * k + f] * fr;
      apply_4dof<S>(R + 9 * k, t + 3 * k, d, Rn, tn);
      double A[9], U[9], sv[3], V[9], UVt[9];
      for (int i = 0; i < 9; ++i) A[i] = (double)Rn[i];
      svd3(A, U, sv, V);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          UVt[3 * i + j] = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] +
                           U[3 * i + 2] * V[3 * j + 2];
      const double ds = det3(UVt) < 0.0 ? -1.0 : 1.0;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          w.Rn[9 * k + 3 * i + j] = (S)(U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] +
                                        ds * U[3 * i + 2] * V[3 * j + 2]);
      for (int i = 0; i < 3; ++i) w.tn[3 * k + i] = tn[i];
    }
    __syncthreads();
    part = 0.0;
    for (int e = tid; e < E; e += kThreads) {
      if (q.w[e] == S(0)) continue;
      const int i = q.ei[e], j = q.ej[e];
      const S zero[4] = {S(0), S(0), S(0), S(0)};
      S r[6];
      edge_residual<S, S>(w.Rn + 9 * i, w.tn + 3 * i, w.Rn + 9 * j, w.tn + 3 * j, q.mR + 9 * e,
                          q.mt + 3 * e, zero, zero, r);
      S c = S(0);
      for (int a = 0; a < 6; ++a) c += r[a] * r[a];
      part += (double)(c * q.w[e]);
    }
    c_new = block_sum(part, red);
    const bool better = c_new < c_old;
    if (better)
      for (int k = tid; k < K; k += kThreads) {
        for (int i = 0; i < 9; ++i) R[9 * k + i] = w.Rn[9 * k + i];
        for (int i = 0; i < 3; ++i) t[3 * k + i] = w.tn[3 * k + i];
      }
    lam = better ? lam * S(0.5) : lam * S(4);
    __syncthreads();
  }
  if (tid == 0) *cost_out = (S)c_new;
}

}  // namespace

extern "C" long long pose_graph_4dof_workspace_bytes(int K, int E) {
  return (long long)carve<float>(nullptr, nullptr, K, E);
}

// R (K,9), t (K,3): the start state, overwritten with the result; edges
// ei, ej (E,) i32, mR (E,9), mt (E,3), w (E,) weight x valid, fixed (K,)
// bool; every real array and cost_out float32
extern "C" int pose_graph_4dof_launch(void* R, void* t, const void* ei, const void* ej,
                                      const void* mR, const void* mt, const void* wt,
                                      const void* fixed, int K, int E, int n_iters, int cg_iters,
                                      void* ws, void* cost_out, void* stream) {
  if (K <= 0 || E < 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  Ws<float> w;
  carve<float>(&w, static_cast<uint8_t*>(ws), K, E);
  const Graph<float> q{(const int*)ei, (const int*)ej, (const float*)mR, (const float*)mt,
                       (const float*)wt, (const bool*)fixed, K, E};
  solve_kernel<float><<<1, kThreads, 0, (cudaStream_t)stream>>>((float*)R, (float*)t, q, w,
                                                                 n_iters, cg_iters,
                                                                 (float*)cost_out);
  return (int)cudaGetLastError();
}
