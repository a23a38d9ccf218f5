// K21 inertial_init: the inertial-only optimisation of the IMU
// initialisation, one CTA per solve.
//
// Replaces extractorb_tpu/solver/inertial.py:inertial_only
// (InertialOptimization, reference src/Optimizer.cc:5142): with every body
// pose fixed, dense Levenberg-Marquardt over x = (gravity direction 2-DoF
// about the seed Rwg0, log-scale, one shared gyro and acc bias, the K
// velocities), n = 9 + 3K unknowns.  The TPU builds the dense Jacobian with
// jacfwd and solves with an LU.  Here each edge's 9 whitened residuals
// depend on 15 of the unknowns (gravity, scale, biases, its two
// velocities): one thread per edge takes their Jacobian by one Dual<15>
// forward pass of imu_t.cuh's inertial residual; the CTA assembles
// H = J^T J and b = J^T r in float64 (one thread per entry, the edges summed
// in order), adds the bias priors, and solves (H + lambda I + 1e-9 I) dx =
// -b by a float64 Cholesky.  The accept rule is the JAX module's: keep the
// step if the cost fell, lambda x0.5, else x5.  Residuals are float32 as in
// the JAX module; the normal equations and the solve are float64 (a
// recorded divergence from the JAX module's float32 LU, held by
// inertial_only_plain(..., solve_dtype=float64)).  The normal equations
// live in a float64 workspace in device memory, so K is not bounded by
// shared memory.
//
// Bound on the H100: latency.  30 iterations of a serial forward pass per
// edge, an O(n^2 K) assembly and an n-step Cholesky (n ~ 40-130): tens of
// microseconds of arithmetic per iteration, dominated by the CTA's syncs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

#include "dual.cuh"
#include "lie_t.cuh"
#include "imu_t.cuh"

struct Prob {
  const float* Rwb;     // (K,9)
  const float* twb;     // (K,3)
  const float* chain;   // (K,292)
  const bool* valid;    // (K,)
  const float* Rseed;   // (9,)
  int K, n;
  float sg, sa;         // sqrt of the bias prior informations
  bool fix_scale;
};

struct Ws {
  float* Lr;     // (K,81)
  float* J;      // (K,9,15)
  float* r;      // (K,9)
  double* H;     // (n,n) then its Cholesky factor
  double* b;     // (n,)
  double* y;     // (n,)
};

// the edge's whitened 9 residuals at the 15 local unknowns loc = (theta 2,
// log-scale, bg 3, ba 3, v_i 3, v_j 3)
template <class T>
__device__ void edge_r9(const Prob& q, const float* Lr, int k, const T* loc, T* out) {
  const int i = k > 0 ? k - 1 : 0;
  const Pk pk{q.chain + (size_t)kPk * k};
  T w[3] = {loc[0], loc[1], cst<T>(0.f)};
  T E[9], Rs[9], Rwg[9];
  so3_exp_t(w, E);
  for (int a = 0; a < 9; ++a) Rs[a] = cst<T>(q.Rseed[a]);
  mat3_mul(Rs, E, Rwg);
  T g0[3] = {cst<T>(0.f), cst<T>(0.f), cst<T>(-9.81f)}, g[3];
  mat3_vec(Rwg, g0, g);
  const T s = q.fix_scale ? cst<T>(1.f) : texp(loc[2]);
  T R1[9], R2[9], t1[3], t2[3];
  for (int a = 0; a < 9; ++a) {
    R1[a] = cst<T>(q.Rwb[9 * i + a]);
    R2[a] = cst<T>(q.Rwb[9 * k + a]);
  }
  for (int a = 0; a < 3; ++a) {
    t1[a] = cst<T>(q.twb[3 * i + a]);
    t2[a] = cst<T>(q.twb[3 * k + a]);
  }
  T r9[9];
  inertial_r9(pk, R1, t1, loc + 9, R2, t2, loc + 12, loc + 3, g, s, r9);
  for (int a = 0; a < 9; ++a) {
    T acc = cst<T>(0.f);
    for (int c = 0; c < 9; ++c) acc = acc + Lr[9 * c + a] * r9[c];
    out[a] = acc;
  }
}

// the global index of local unknown l of edge k
__device__ __forceinline__ int gidx(int k, int l) {
  if (l < 9) return l;
  const int node = l < 12 ? (k > 0 ? k - 1 : 0) : k;
  return 9 + 3 * node + (l - 9) % 3;
}

__device__ void gather_loc(const float* x, int k, float* loc) {
  for (int l = 0; l < 15; ++l) loc[l] = x[gidx(k, l)];
}

// the cost at x (edges in order, then the priors), by thread 0 after the
// edge threads stored their squared norms in sq
__device__ double cost_at(const Prob& q, const float* Lr, const float* x, float* sq) {
  for (int k = threadIdx.x; k < q.K; k += kThreads) {
    float c = 0.f;
    if (q.valid[k]) {
      float loc[15], r[9];
      gather_loc(x, k, loc);
      edge_r9(q, Lr + 81 * k, k, loc, r);
      for (int a = 0; a < 9; ++a) c += r[a] * r[a];
    }
    sq[k] = c;
  }
  __syncthreads();
  double c = 0.0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < q.K; ++k) c += sq[k];
    for (int a = 0; a < 3; ++a) {
      const float pg = q.sg * x[3 + a], pa = q.sa * x[6 + a];
      c += (double)(pg * pg) + (double)(pa * pa);
    }
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
inertial_init_kernel(const Prob q, Ws w, const float* __restrict__ v0,
                     const float* __restrict__ bias0, int n_iters, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int n = q.n;
  float* x = sh;            // (n,)
  float* xn = x + n;        // (n,)
  float* sq = xn + n;       // (K,)
  __shared__ double c_old, c_new, lam;
  __shared__ bool better;
  for (int a = threadIdx.x; a < n; a += kThreads)
    x[a] = a < 3 ? 0.f : (a < 9 ? bias0[a - 3] : v0[a - 9]);
  for (int k = threadIdx.x; k < q.K; k += kThreads) {
    const float* C = q.chain + (size_t)kPk * k + 61;
    info_sqrt_blk<9>(C, 0, w.Lr + 81 * k);
  }
  if (threadIdx.x == 0) lam = 1e-2;
  __syncthreads();
  float cost_out = INFINITY;
  for (int it = 0; it < n_iters; ++it) {
    // residuals and Jacobians at x
    for (int k = threadIdx.x; k < q.K; k += kThreads) {
      float* J = w.J + 135 * k;
      float* r = w.r + 9 * k;
      if (q.valid[k]) {
        D15 loc[15], rr[9];
        for (int l = 0; l < 15; ++l) {
          loc[l] = dconst<15, float>(x[gidx(k, l)]);
          loc[l].d[l] = 1.f;
        }
        edge_r9(q, w.Lr + 81 * k, k, loc, rr);
        for (int a = 0; a < 9; ++a) {
          r[a] = rr[a].v;
          for (int l = 0; l < 15; ++l) J[15 * a + l] = rr[a].d[l];
        }
      } else {
        for (int a = 0; a < 9; ++a) r[a] = 0.f;
        for (int a = 0; a < 135; ++a) J[a] = 0.f;
      }
    }
    __syncthreads();
    // H = J^T J + priors + (lambda + 1e-9) I and b = J^T r, float64
    for (int e = threadIdx.x; e < n * (n + 1); e += kThreads) {
      const int p = e / (n + 1), c = e % (n + 1);
      double acc = 0.0;
      for (int k = 0; k < q.K; ++k) {
        if (!q.valid[k]) continue;
        const float* J = w.J + 135 * k;
        for (int la = 0; la < 15; ++la) {
          if (gidx(k, la) != p) continue;
          if (c == n) {
            for (int rr = 0; rr < 9; ++rr) acc += (double)J[15 * rr + la] * w.r[9 * k + rr];
          } else {
            for (int lb = 0; lb < 15; ++lb) {
              if (gidx(k, lb) != c) continue;
              for (int rr = 0; rr < 9; ++rr) acc += (double)J[15 * rr + la] * J[15 * rr + lb];
            }
          }
        }
      }
      const bool prior = p >= 3 && p < 9;
      const float sp = p < 6 ? q.sg : q.sa;
      if (c == n) {
        if (prior) acc += (double)sp * (double)(sp * x[p]);
        w.b[p] = acc;
      } else {
        if (prior && c == p) acc += (double)sp * sp;
        if (c == p) acc += lam + 1e-9;
        w.H[(size_t)n * p + c] = acc;
      }
    }
    __syncthreads();
    // Cholesky, left-looking: column j by the CTA
    for (int j = 0; j < n; ++j) {
      if (threadIdx.x == 0) {
        double d = w.H[(size_t)n * j + j];
        for (int k = 0; k < j; ++k) d -= w.H[(size_t)n * j + k] * w.H[(size_t)n * j + k];
        w.H[(size_t)n * j + j] = sqrt(fmax(d, 1e-300));
      }
      __syncthreads();
      const double ljj = w.H[(size_t)n * j + j];
      for (int r = j + 1 + threadIdx.x; r < n; r += kThreads) {
        double s = w.H[(size_t)n * r + j];
        for (int k = 0; k < j; ++k) s -= w.H[(size_t)n * r + k] * w.H[(size_t)n * j + k];
        w.H[(size_t)n * r + j] = s / ljj;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      for (int r = 0; r < n; ++r) {  // L y = -b
        double s = -w.b[r];
        for (int k = 0; k < r; ++k) s -= w.H[(size_t)n * r + k] * w.y[k];
        w.y[r] = s / w.H[(size_t)n * r + r];
      }
      for (int r = n - 1; r >= 0; --r) {  // L^T dx = y
        double s = w.y[r];
        for (int k = r + 1; k < n; ++k) s -= w.H[(size_t)n * k + r] * w.y[k];
        w.y[r] = s / w.H[(size_t)n * r + r];
      }
    }
    __syncthreads();
    for (int a = threadIdx.x; a < n; a += kThreads) xn[a] = x[a] + (float)w.y[a];
    __syncthreads();
    const double cn = cost_at(q, w.Lr, xn, sq);
    __syncthreads();
    const double co = cost_at(q, w.Lr, x, sq);
    if (threadIdx.x == 0) {
      c_new = cn;
      c_old = co;
      better = (float)cn < (float)co;
      lam = better ? lam * 0.5 : lam * 5.0;
    }
    __syncthreads();
    if (better)
      for (int a = threadIdx.x; a < n; a += kThreads) x[a] = xn[a];
    cost_out = fminf((float)c_new, (float)c_old);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float w3[3] = {x[0], x[1], 0.f}, E[9], Rwg[9];
    so3_exp_t(w3, E);
    float Rs[9];
    for (int a = 0; a < 9; ++a) Rs[a] = q.Rseed[a];
    mat3_mul(Rs, E, Rwg);
    for (int a = 0; a < 9; ++a) out[a] = Rwg[a];
    out[9] = q.fix_scale ? 1.f : expf(x[2]);
    for (int a = 0; a < 6; ++a) out[10 + a] = x[3 + a];
    for (int a = 0; a < 3 * q.K; ++a) out[16 + a] = x[9 + a];
    out[16 + 3 * q.K] = cost_out;
  }
}

__host__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ inline size_t carve(Ws* w, uint8_t* base, int K, int n) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return q;
  };
  uint8_t* q;
  q = take(sizeof(float) * 81 * K);  if (w) w->Lr = (float*)q;
  q = take(sizeof(float) * 135 * K); if (w) w->J = (float*)q;
  q = take(sizeof(float) * 9 * K);   if (w) w->r = (float*)q;
  q = take(sizeof(double) * n * n);  if (w) w->H = (double*)q;
  q = take(sizeof(double) * n);      if (w) w->b = (double*)q;
  q = take(sizeof(double) * n);      if (w) w->y = (double*)q;
  return o;
}

}  // namespace

extern "C" long long inertial_init_workspace_bytes(int K) {
  return (long long)carve(nullptr, nullptr, K, 9 + 3 * K);
}

// Rwb (K,9), twb (K,3), chain (K,292), valid (K,), v0 (3K,), bias0 (6,),
// Rwg_seed (9,); out: Rwg 9, scale, bg 3, ba 3, v 3K, cost
extern "C" int inertial_init_launch(const void* Rwb, const void* twb, const void* chain,
                                    const void* valid, const void* v0, const void* bias0,
                                    const void* Rwg_seed, int K, float prior_g, float prior_a,
                                    int fix_scale, int n_iters, void* ws, void* out,
                                    void* stream) {
  if (K <= 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
  Ws w;
  carve(&w, static_cast<uint8_t*>(ws), K, 9 + 3 * K);
  const Prob q{(const float*)Rwb, (const float*)twb, (const float*)chain, (const bool*)valid,
               (const float*)Rwg_seed, K, 9 + 3 * K, sqrtf(prior_g), sqrtf(prior_a),
               fix_scale != 0};
  const size_t smem = sizeof(float) * (2 * (size_t)q.n + (size_t)K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        inertial_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  inertial_init_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      q, w, (const float*)v0, (const float*)bias0, n_iters, (float*)out);
  return (int)cudaGetLastError();
}
