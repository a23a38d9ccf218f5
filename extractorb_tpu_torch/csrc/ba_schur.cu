// K14 ba_schur: the global bundle adjustment, Levenberg-Marquardt on the
// reduced camera system (Schur complement) with block-Jacobi PCG.
//
// Replaces extractorb_tpu/dist/sharded_ba.py:optimize_schur_sharded on one
// shard (the program the JAX package runs on a single device,
// dist/global_ba.py:212-219): a lax.scan of LM steps, each eliminating the
// landmarks with batched 3x3 inverses and running lax.scan PCG sweeps on
// (Hpp + lam - W (Hll + lam)^-1 W^T) dp = bp - W (Hll + lam)^-1 bl.  Here
// each LM iteration is:
//   build:   one thread per observation: residual and Jacobians (ba_obs.cuh,
//            K6's code), the Huber weight at delta_mono, the gradients bp,
//            bl and the 6x6 / 3x3 diagonal blocks with atomics, the cost;
//   invert:  one thread per pose (6x6 Gauss-Jordan of Hpp + lam) or point
//            (3x3 adjugate of Hll + lam; y = Ml bl);
//   reduce:  W y over the observations, then per pose the reduced
//            right-hand side b_red = bp - W y and the start of PCG;
//   cg_iters x five launches: W^T p over the observations into the points
//            (p = z + beta p built on the fly), y = Ml (W^T p) per point,
//            W y over the observations into the poses, per pose
//            Ap = Hpp p + lam p - W y with p.Ap, then the alpha step with the
//            preconditioner and r.z;
//   back-substitution dl = -Ml (bl - W^T x), the retraction, the candidate
//            cost and the accept with lambda x0.5 or x4.
// Scalars (alpha, beta, costs, lambda) stay on the card in float64; the
// rotations are re-orthonormalized at the end and observations classified
// by chi2 <= chi2_mono; the returned cost is the final sum of chi2.
//
// Bound on the H100: launch latency.  A map of ~24 keyframes and ~10k
// observations is microseconds of arithmetic per pass; the ~5 dependent
// launches per PCG step and ~10 per LM iteration set the time.  Float
// atomics make the summation order (and the last bits) vary from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "ba_obs.cuh"

constexpr int kThreads = 256;

struct Ws {
  float* Rn;    // (K,9) candidates
  float* tn;    // (K,3)
  float* pn;    // (P,3)
  float* J;     // (O,18) pose 2x6 then point 2x3
  float* w;     // (O,)
  // zeroed at every LM iteration, contiguous: bp, bl, Hpp, Hll, hp, tl
  float* bp;    // (K,6)
  float* bl;    // (P,3)
  float* Hpp;   // (K,21)
  float* Hll;   // (P,6)
  float* hp;    // (K,6) W y accumulator
  float* tl;    // (P,3) W^T v accumulator
  float* Mp;    // (K,36)
  float* Ml;    // (P,9)
  float* y;     // (P,3)
  float* x;     // (K,6) CG vectors
  float* r;
  float* z;
  float* p;
  double* lam;
  double* sc;   // [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
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
  const size_t zero_floats = (size_t)6 * K + 3 * (size_t)P + 21 * (size_t)K + 6 * (size_t)P +
                             6 * (size_t)K + 3 * (size_t)P;
  q = take(sizeof(float) * zero_floats);
  if (w) {
    w->bp = (float*)q;
    w->bl = w->bp + (size_t)6 * K;
    w->Hpp = w->bl + (size_t)3 * P;
    w->Hll = w->Hpp + (size_t)21 * K;
    w->hp = w->Hll + (size_t)6 * P;
    w->tl = w->hp + (size_t)6 * K;
  }
  q = take(sizeof(float) * 36 * K); if (w) w->Mp = (float*)q;
  q = take(sizeof(float) * 9 * P);  if (w) w->Ml = (float*)q;
  q = take(sizeof(float) * 3 * P);  if (w) w->y = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->x = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->r = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->z = (float*)q;
  q = take(sizeof(float) * 6 * K);  if (w) w->p = (float*)q;
  q = take(sizeof(double));         if (w) w->lam = (double*)q;
  q = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)q;
  return o;
}

inline size_t zero_bytes(int K, int P) {
  return sizeof(float) * ((size_t)6 * K + 3 * (size_t)P + 21 * (size_t)K + 6 * (size_t)P +
                          6 * (size_t)K + 3 * (size_t)P);
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

__device__ __forceinline__ void add_block_sum(double v, double* dst) {
  v = warp_sum_d(v);
  if ((threadIdx.x & 31) == 0 && v != 0.0) atomicAdd(dst, v);
}

__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ pts,
             const Prob q, const Cam cam, bool huber, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float cost = 0.f;
  if (o < q.O) {
    if (!q.valid[o]) {
      w.w[o] = 0.f;
    } else {
      const int kf = q.obs_kf[o], m = q.obs_mp[o];
      float r0, r1, J[2][9], wt;
      obs_linearize(R + 9 * kf, t + 3 * kf, pts, q, cam, huber, o, w.J, w.w, r0, r1, J, wt, cost);
      int k = 0;
      for (int a = 0; a < 6; ++a) {
        atomicAdd(w.bp + 6 * kf + a, wt * (J[0][a] * r0 + J[1][a] * r1));
        for (int b = a; b < 6; ++b)
          atomicAdd(w.Hpp + 21 * kf + k++, wt * (J[0][a] * J[0][b] + J[1][a] * J[1][b]));
      }
      k = 0;
      for (int a = 0; a < 3; ++a) {
        atomicAdd(w.bl + (size_t)3 * m + a, wt * (J[0][6 + a] * r0 + J[1][6 + a] * r1));
        for (int b = a; b < 3; ++b)
          atomicAdd(w.Hll + (size_t)6 * m + k++, wt * (J[0][6 + a] * J[0][6 + b] + J[1][6 + a] * J[1][6 + b]));
      }
    }
  }
  add_block_sum((double)cost, cost_old(w));
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

// hp[kf] += Jp^T (w Jl y[mp]) over the observations (W y)
__global__ void __launch_bounds__(kThreads)
w_y_kernel(const Prob q, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= q.O || !q.valid[o]) return;
  const int kf = q.obs_kf[o], m = q.obs_mp[o];
  const float* J = w.J + (size_t)18 * o;
  const float* y = w.y + 3 * m;
  float u[2];
  for (int rr = 0; rr < 2; ++rr)
    u[rr] = (J[12 + 3 * rr] * y[0] + J[13 + 3 * rr] * y[1] + J[14 + 3 * rr] * y[2]) * w.w[o];
  for (int i = 0; i < 6; ++i) atomicAdd(w.hp + 6 * kf + i, J[i] * u[0] + J[6 + i] * u[1]);
}

// per pose: b_red = (bp - W y) masked; x = 0, r = b_red, z = Mp r, r.z; clear hp
__global__ void __launch_bounds__(kThreads)
reduce_rhs_kernel(const Prob q, Ws w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (k < q.K) {
    const bool fr = !q.fixed_kf[k];
    float rb[6];
    for (int a = 0; a < 6; ++a) {
      rb[a] = fr ? w.bp[6 * k + a] - w.hp[6 * k + a] : 0.f;
      w.r[6 * k + a] = rb[a];
      w.x[6 * k + a] = 0.f;
      w.p[6 * k + a] = 0.f;
      w.hp[6 * k + a] = 0.f;
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
  add_block_sum(part, rz(w, 0));
}

__device__ __forceinline__ float beta_of(const Ws& w, int it) {
  return it == 0 ? 0.f : (float)(*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// tl[mp] += Jl^T (w Jp v[kf]) over the observations (W^T v), with v the
// direction p = z + beta p built on the fly (it >= 0) or x (it < 0)
__global__ void __launch_bounds__(kThreads)
wt_v_kernel(const Prob q, Ws w, int it) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= q.O || !q.valid[o]) return;
  const int kf = q.obs_kf[o], m = q.obs_mp[o];
  if (q.fixed_kf[kf] || q.fixed_mp[m]) return;
  float v[6];
  if (it >= 0) {
    const float beta = beta_of(w, it);
    for (int i = 0; i < 6; ++i) v[i] = w.z[6 * kf + i] + beta * w.p[6 * kf + i];
  } else {
    for (int i = 0; i < 6; ++i) v[i] = w.x[6 * kf + i];
  }
  const float* J = w.J + (size_t)18 * o;
  float u[2];
  for (int rr = 0; rr < 2; ++rr) {
    float s = 0.f;
    for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * v[i];
    u[rr] = s * w.w[o];
  }
  for (int i = 0; i < 3; ++i) atomicAdd(w.tl + 3 * m + i, J[12 + i] * u[0] + J[15 + i] * u[1]);
}

// per point: y = Ml (tl masked); clear tl
__global__ void __launch_bounds__(kThreads)
point_solve_kernel(const Prob q, Ws w) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= q.P) return;
  const bool fr = !q.fixed_mp[m];
  float b[3];
  for (int a = 0; a < 3; ++a) {
    b[a] = fr ? w.tl[3 * m + a] : 0.f;
    w.tl[3 * m + a] = 0.f;
  }
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
  add_block_sum(part, pAp(w, it, cg));
}

// per pose: x += alpha p, r -= alpha Ap, z = Mp r, r.z; clear hp
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
      rb[a] = w.r[6 * k + a] - alpha * w.hp[6 * k + a];
      w.r[6 * k + a] = rb[a];
      w.hp[6 * k + a] = 0.f;
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
  add_block_sum(part, rz(w, it + 1));
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
    for (int a = 0; a < 3; ++a) {
      b[a] = fr ? w.bl[3 * m + a] - w.tl[3 * m + a] : 0.f;
      w.tl[3 * m + a] = 0.f;
    }
    const float* Mi = w.Ml + 9 * m;
    for (int a = 0; a < 3; ++a) {
      const float dl = fr ? -(Mi[3 * a] * b[0] + Mi[3 * a + 1] * b[1] + Mi[3 * a + 2] * b[2]) : 0.f;
      w.pn[3 * m + a] = pts[3 * m + a] + dl;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cost_kernel(const Prob q, const Cam cam, bool huber, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float cost = 0.f;
  if (o < q.O && q.valid[o]) {
    const int kf = q.obs_kf[o];
    cost = rho(obs_chi2(w.Rn + 9 * kf, w.tn + 3 * kf, w.pn, q, cam, o), huber, huber_delta());
  }
  add_block_sum((double)cost, cost_new(w));
}

__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ R, float* __restrict__ t, float* __restrict__ pts, const Prob q,
              Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  lm_accept(w.sc, w.lam, e, q.K, q.P, w.Rn, w.tn, w.pn, R, t, pts);
}

// inliers (chi2 <= chi2_th) and the final sum of chi2 over valid observations
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ R, const float* __restrict__ t,
                const float* __restrict__ pts, const Prob q, const Cam cam, float chi2_th,
                bool* __restrict__ inl, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float c = 0.f;
  if (o < q.O) {
    if (!q.valid[o]) {
      inl[o] = false;
    } else {
      const int kf = q.obs_kf[o];
      c = obs_chi2(R + 9 * kf, t + 3 * kf, pts, q, cam, o);
      inl[o] = c <= chi2_th;
    }
  }
  add_block_sum((double)c, cost_new(w));
}

__global__ void init_kernel(Ws w) { *w.lam = 1e-4; }

__global__ void final_cost_kernel(Ws w, float* cost_out) { *cost_out = (float)*cost_new(w); }

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" long long ba_schur_workspace_bytes(int K, int P, int O, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters);
}

// R (K,9), t (K,3), pts (P,3): the start state, overwritten with the result.
extern "C" int ba_schur_launch(void* R, void* t, void* pts, const void* obs_kf, const void* obs_mp,
                               const void* obs_uv, const void* isig, const void* valid,
                               const void* fixed_kf, const void* fixed_mp, int K, int P, int O,
                               float fx, float fy, float cx, float cy, int n_iters, int cg_iters,
                               int use_huber, float chi2_th, void* ws, void* inliers,
                               void* cost_out, void* stream) {
  if (K <= 0 || P <= 0 || O <= 0 || n_iters < 0 || cg_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Ws w;
  carve(&w, static_cast<uint8_t*>(ws), K, P, O, cg_iters);
  const Prob q{(const int*)obs_kf, (const int*)obs_mp, (const float*)obs_uv, (const float*)isig,
               (const bool*)valid, (const bool*)fixed_kf, (const bool*)fixed_mp, K, P, O};
  const Cam cam{fx, fy, cx, cy};
  const bool huber = use_huber != 0;
  float* Rf = (float*)R;
  float* tf = (float*)t;
  float* pf = (float*)pts;
  const size_t sc_bytes = sizeof(double) * (3 + 2 * (size_t)cg_iters);
  cudaError_t e;
  init_kernel<<<1, 1, 0, st>>>(w);
  for (int it = 0; it < n_iters; ++it) {
    if ((e = cudaMemsetAsync(w.bp, 0, zero_bytes(K, P), st)) != cudaSuccess) return (int)e;
    if ((e = cudaMemsetAsync(w.sc, 0, sc_bytes, st)) != cudaSuccess) return (int)e;
    build_kernel<<<blocks(O), kThreads, 0, st>>>(Rf, tf, pf, q, cam, huber, w);
    invert_kernel<<<blocks(K + P), kThreads, 0, st>>>(q, w);
    w_y_kernel<<<blocks(O), kThreads, 0, st>>>(q, w);
    reduce_rhs_kernel<<<blocks(K), kThreads, 0, st>>>(q, w);
    for (int c = 0; c < cg_iters; ++c) {
      wt_v_kernel<<<blocks(O), kThreads, 0, st>>>(q, w, c);
      point_solve_kernel<<<blocks(P), kThreads, 0, st>>>(q, w);
      w_y_kernel<<<blocks(O), kThreads, 0, st>>>(q, w);
      cg_a_kernel<<<blocks(K), kThreads, 0, st>>>(q, w, c, cg_iters);
      cg_b_kernel<<<blocks(K), kThreads, 0, st>>>(q, w, c, cg_iters);
    }
    wt_v_kernel<<<blocks(O), kThreads, 0, st>>>(q, w, -1);
    retract_kernel<<<blocks(K + P), kThreads, 0, st>>>(Rf, tf, pf, q, w);
    cost_kernel<<<blocks(O), kThreads, 0, st>>>(q, cam, huber, w);
    accept_kernel<<<blocks(K + P), kThreads, 0, st>>>(Rf, tf, pf, q, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  orthonormalize_kernel<<<blocks(K), kThreads, 0, st>>>(Rf, K);
  if ((e = cudaMemsetAsync(w.sc, 0, sc_bytes, st)) != cudaSuccess) return (int)e;
  classify_kernel<<<blocks(O), kThreads, 0, st>>>(Rf, tf, pf, q, cam, chi2_th, (bool*)inliers, w);
  final_cost_kernel<<<1, 1, 0, st>>>(w, (float*)cost_out);
  return (int)cudaGetLastError();
}
