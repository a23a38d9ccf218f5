// K6 ba_pcg: Levenberg-Marquardt bundle adjustment with matrix-free PCG
// (poses + points, mono reprojection edges, Huber kernel).
//
// Replaces extractorb_tpu/solver/ba.py:optimize (solver "cg"), which the TPU
// runs as a lax.scan of LM steps, each a lax.scan of PCG sweeps over
// jacfwd Jacobians, gathers and segment sums.  Here each LM iteration is:
//   build:   one thread per observation computes the residual and the
//            analytic Jacobians (2x6 for R Exp(delta), 2x3 for the point),
//            the Huber weight, and adds the gradient and the 6x6 / 3x3
//            diagonal blocks with atomics (a warp whose observations share a
//            keyframe reduces its pose terms first: run_ba lists them by
//            keyframe), plus the current cost;
//   invert:  one thread per block inverts the damped block (6x6 Gauss-Jordan,
//            3x3 adjugate) and starts PCG (x = 0, r = b, z = M r, p = z);
//   cg_iters x three launches: the Hessian-vector product over the
//            observations (p built on the fly as z + beta p), the damped and
//            masked product with the p.Ap dot, and the alpha step with the
//            preconditioner and the r.z dot;
//   retract, cost, accept: the candidate poses (R Exp(-x)) and points, their
//            cost, and the accept/reject with the lambda update.
// alpha, beta, the costs and lambda live in a small float64 block on the card:
// nothing waits on the host.  At the end the rotations are re-orthonormalized
// (two Newton-Schulz steps) and observations classified by chi2.
//
// Bound on the H100: launch latency.  An init problem (2 keyframes, ~2k
// observations) and a window problem (~10 keyframes, ~10k observations) are
// microseconds of arithmetic per pass; the 3 x cg_iters + 7 dependent
// launches per LM iteration set the time.  Float atomics make the summation
// order (and the last bits) vary from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

#include "ba_obs.cuh"

struct Ws {
  float* Rn;    // (K,9) candidate poses / points
  float* tn;    // (K,3)
  float* pn;    // (P,3)
  float* J;     // (O,18): pose Jacobian 2x6, then point Jacobian 2x3
  float* w;     // (O,)
  // zeroed at every LM iteration, in this order and contiguous:
  float* g;     // (6K+3P) gradient b = J^T W r
  float* Hpp;   // (K,21) upper triangles
  float* Hll;   // (P,6)
  float* h;     // (6K+3P) Hessian-vector product accumulator
  float* Mp;    // (K,36)
  float* Ml;    // (P,9)
  float* x;     // (6K+3P) CG vectors
  float* r;
  float* z;
  float* p;
  float* Ap;
  double* lam;  // (1,)
  double* sc;   // scalars zeroed every LM iteration:
                // [cost_old, cost_new, rz[0..cg], pAp[0..cg-1]]
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t carve(Ws* w, uint8_t* base, int K, int P, int O, int cg) {
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
  q = take(sizeof(float) * 18 * (size_t)O); if (w) w->J = (float*)q;
  q = take(sizeof(float) * (size_t)O); if (w) w->w = (float*)q;
  // one contiguous zeroed region: g, Hpp, Hll, h (no padding between them)
  const size_t zero_floats = nv + (size_t)21 * K + (size_t)6 * P + nv;
  q = take(sizeof(float) * zero_floats);
  if (w) {
    w->g = (float*)q;
    w->Hpp = w->g + nv;
    w->Hll = w->Hpp + (size_t)21 * K;
    w->h = w->Hll + (size_t)6 * P;
  }
  q = take(sizeof(float) * 36 * K); if (w) w->Mp = (float*)q;
  q = take(sizeof(float) * 9 * P);  if (w) w->Ml = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->x = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->r = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->z = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->p = (float*)q;
  q = take(sizeof(float) * nv);     if (w) w->Ap = (float*)q;
  q = take(sizeof(double));         if (w) w->lam = (double*)q;
  q = take(sizeof(double) * (3 + 2 * (size_t)cg)); if (w) w->sc = (double*)q;
  return o;
}

__device__ __forceinline__ double* cost_old(const Ws& w) { return w.sc; }
__device__ __forceinline__ double* cost_new(const Ws& w) { return w.sc + 1; }
__device__ __forceinline__ double* rz(const Ws& w, int it) { return w.sc + 2 + it; }
__device__ __forceinline__ double* pAp(const Ws& w, int it, int cg) { return w.sc + 3 + cg + it; }

// Add n values per lane into dst + kf*stride; a warp whose active lanes all
// share one keyframe reduces first and adds once.  All 32 lanes must call.
template <int n>
__device__ void add_pose(float* dst, int stride, int kf, bool active, float (&v)[n]) {
  const unsigned full = 0xffffffffu;
  const unsigned act = __ballot_sync(full, active);
  if (act == 0) return;
  const int ref = __shfl_sync(full, kf, __ffs(act) - 1);
  const bool uniform = __all_sync(full, !active || kf == ref);
  if (uniform) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float s = active ? v[i] : 0.f;
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
      v[i] = s;
    }
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < n; ++i) atomicAdd(dst + (size_t)ref * stride + i, v[i]);
  } else if (active) {
    for (int i = 0; i < n; ++i) atomicAdd(dst + (size_t)kf * stride + i, v[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
build_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ pts,
             const Prob q, const Cam cam, bool huber, Ws w) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = o < q.O;
  const bool act = in && q.valid[o];
  const int kf = in ? q.obs_kf[o] : 0;
  float gp[6], Hp[21], gl[3], Hl[6];
  float cost = 0.f;
  for (int i = 0; i < 6; ++i) gp[i] = 0.f;
  for (int i = 0; i < 21; ++i) Hp[i] = 0.f;
  for (int i = 0; i < 3; ++i) gl[i] = 0.f;
  for (int i = 0; i < 6; ++i) Hl[i] = 0.f;
  if (act) {
    float r0, r1, J[2][9], wt;  // J: [pose 6 | point 3]
    obs_linearize(R + 9 * kf, t + 3 * kf, pts, q, cam, huber, o, w.J, w.w, r0, r1, J, wt, cost);
    int k = 0;
    for (int a = 0; a < 6; ++a) {
      gp[a] = wt * (J[0][a] * r0 + J[1][a] * r1);
      for (int b = a; b < 6; ++b) Hp[k++] = wt * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
    }
    k = 0;
    for (int a = 0; a < 3; ++a) {
      gl[a] = wt * (J[0][6 + a] * r0 + J[1][6 + a] * r1);
      for (int b = a; b < 3; ++b) Hl[k++] = wt * (J[0][6 + a] * J[0][6 + b] + J[1][6 + a] * J[1][6 + b]);
    }
  } else if (in) {
    w.w[o] = 0.f;
  }
  add_pose<6>(w.g, 6, kf, act, gp);
  add_pose<21>(w.Hpp, 21, kf, act, Hp);
  if (act) {
    const int m = q.obs_mp[o];
    float* gpt = w.g + (size_t)6 * q.K + (size_t)3 * m;
    for (int i = 0; i < 3; ++i) atomicAdd(gpt + i, gl[i]);
    for (int i = 0; i < 6; ++i) atomicAdd(w.Hll + (size_t)6 * m + i, Hl[i]);
  }
  const double c = warp_sum_d((double)cost);
  if ((threadIdx.x & 31) == 0 && c != 0.0) atomicAdd(cost_old(w), c);
}

__device__ __forceinline__ bool free_entry(const Prob& q, int e) {
  return e < 6 * q.K ? !q.fixed_kf[e / 6] : !q.fixed_mp[(e - 6 * q.K) / 3];
}

// one thread per pose block (e < K) or point block: invert the damped block
// and start PCG on it
__global__ void __launch_bounds__(kThreads)
invert_kernel(const Prob q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nb = q.K + q.P;
  double part = 0.0;
  if (e < nb) {
    const float lam = (float)*w.lam;
    if (e < q.K) {
      float* M = w.Mp + 36 * e;
      inv6_damped(w.Hpp + 21 * e, lam, M);
      const bool fr = !q.fixed_kf[e];
      float rb[6];
      for (int a = 0; a < 6; ++a) {
        rb[a] = fr ? w.g[6 * e + a] : 0.f;
        w.r[6 * e + a] = rb[a];
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
        w.r[base + a] = rb[a];
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
  }
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(rz(w, 0), part);
}

__device__ __forceinline__ float beta_of(const Ws& w, int it) {
  return it == 0 ? 0.f : (float)(*rz(w, it) / fmax(*rz(w, it - 1), 1e-20));
}

// h += J^T W J p over the observations, p = z + beta p_prev built on the fly
__global__ void __launch_bounds__(kThreads)
hv_kernel(const Prob q, Ws w, int it) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = o < q.O && q.valid[o];
  const int kf = o < q.O ? q.obs_kf[o] : 0;
  const float beta = beta_of(w, it);
  float hp[6];
  for (int i = 0; i < 6; ++i) hp[i] = 0.f;
  float hl[3] = {0.f, 0.f, 0.f};
  int m = 0;
  if (act) {
    m = q.obs_mp[o];
    const bool fk = !q.fixed_kf[kf], fm = !q.fixed_mp[m];
    const size_t pb = (size_t)6 * kf, lb = (size_t)6 * q.K + (size_t)3 * m;
    float vp[6], vl[3];
    for (int i = 0; i < 6; ++i) vp[i] = fk ? w.z[pb + i] + beta * w.p[pb + i] : 0.f;
    for (int i = 0; i < 3; ++i) vl[i] = fm ? w.z[lb + i] + beta * w.p[lb + i] : 0.f;
    const float* J = w.J + (size_t)18 * o;
    float u[2];
    for (int rr = 0; rr < 2; ++rr) {
      float s = 0.f;
      for (int i = 0; i < 6; ++i) s += J[6 * rr + i] * vp[i];
      for (int i = 0; i < 3; ++i) s += J[12 + 3 * rr + i] * vl[i];
      u[rr] = s * w.w[o];
    }
    for (int i = 0; i < 6; ++i) hp[i] = J[i] * u[0] + J[6 + i] * u[1];
    for (int i = 0; i < 3; ++i) hl[i] = J[12 + i] * u[0] + J[15 + i] * u[1];
  }
  add_pose<6>(w.h, 6, kf, act, hp);
  if (act) {
    float* dst = w.h + (size_t)6 * q.K + (size_t)3 * m;
    for (int i = 0; i < 3; ++i) atomicAdd(dst + i, hl[i]);
  }
}

// per scalar: p = z + beta p, Ap = (h + lam p) masked, p.Ap partial
__global__ void __launch_bounds__(kThreads)
cg_a_kernel(const Prob q, Ws w, int it, int cg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = 6 * q.K + 3 * q.P;
  double part = 0.0;
  if (e < nv) {
    const bool fr = free_entry(q, e);
    const float pe = fr ? w.z[e] + beta_of(w, it) * w.p[e] : 0.f;
    const float ap = fr ? w.h[e] + (float)*w.lam * pe : 0.f;
    w.p[e] = pe;
    w.Ap[e] = ap;
    part = (double)(pe * ap);
  }
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(pAp(w, it, cg), part);
}

// per block: x += alpha p, r -= alpha Ap, z = M r, r.z partial; clear h
__global__ void __launch_bounds__(kThreads)
cg_b_kernel(const Prob q, Ws w, int it, int cg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (e < q.K + q.P) {
    const float alpha = (float)(*rz(w, it) / fmax(*pAp(w, it, cg), 1e-20));
    const bool pose = e < q.K;
    const int n = pose ? 6 : 3;
    const size_t base = pose ? (size_t)6 * e : (size_t)6 * q.K + (size_t)3 * (e - q.K);
    const bool fr = pose ? !q.fixed_kf[e] : !q.fixed_mp[e - q.K];
    const float* M = pose ? w.Mp + 36 * e : w.Ml + 9 * (e - q.K);
    float rb[6];
    for (int a = 0; a < n; ++a) {
      w.x[base + a] += alpha * w.p[base + a];
      rb[a] = w.r[base + a] - alpha * w.Ap[base + a];
      w.r[base + a] = rb[a];
      w.h[base + a] = 0.f;
    }
    for (int a = 0; a < n; ++a) {
      float s = 0.f;
      for (int b = 0; b < n; ++b) s += M[n * a + b] * rb[b];
      s = fr ? s : 0.f;
      w.z[base + a] = s;
      part += (double)(rb[a] * s);
    }
  }
  part = warp_sum_d(part);
  if ((threadIdx.x & 31) == 0 && part != 0.0) atomicAdd(rz(w, it + 1), part);
}

__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* __restrict__ R, const float* __restrict__ t,
               const float* __restrict__ pts, const Prob q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < q.K) {
    float xi[6];
    for (int i = 0; i < 6; ++i) xi[i] = -w.x[6 * e + i];
    retract_pose(R + 9 * e, t + 3 * e, xi, w.Rn + 9 * e, w.tn + 3 * e);
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    const size_t base = (size_t)6 * q.K + (size_t)3 * m;
    for (int i = 0; i < 3; ++i) w.pn[3 * m + i] = pts[3 * m + i] - w.x[base + i];
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
  const double c = warp_sum_d((double)cost);
  if ((threadIdx.x & 31) == 0 && c != 0.0) atomicAdd(cost_new(w), c);
}

// keep the candidate only if the cost fell; lambda x0.5 or x4
__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ R, float* __restrict__ t, float* __restrict__ pts,
              const Prob q, Ws w, float* __restrict__ cost_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) *cost_out = fminf((float)*cost_new(w), (float)*cost_old(w));
  lm_accept(w.sc, w.lam, e, q.K, q.P, w.Rn, w.tn, w.pn, R, t, pts);
}

__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ R, const float* __restrict__ t,
                const float* __restrict__ pts, const Prob q, const Cam cam, float chi2_th,
                bool* __restrict__ inl) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= q.O) return;
  if (!q.valid[o]) { inl[o] = false; return; }
  const int kf = q.obs_kf[o];
  inl[o] = obs_chi2(R + 9 * kf, t + 3 * kf, pts, q, cam, o) <= chi2_th;
}

__global__ void init_kernel(Ws w, float* cost_out) {
  *w.lam = 1e-4;
  *cost_out = INFINITY;
}

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" long long ba_workspace_bytes(int K, int P, int O, int cg_iters) {
  return (long long)carve(nullptr, nullptr, K, P, O, cg_iters);
}

// R (K,9), t (K,3), pts (P,3): the start state, overwritten with the result.
extern "C" int ba_pcg_launch(void* R, void* t, void* pts, const void* obs_kf, const void* obs_mp,
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
  const size_t nv = (size_t)6 * K + (size_t)3 * P;
  const size_t zero_bytes = sizeof(float) * (nv + (size_t)21 * K + (size_t)6 * P + nv);
  const size_t sc_bytes = sizeof(double) * (3 + 2 * (size_t)cg_iters);
  init_kernel<<<1, 1, 0, st>>>(w, (float*)cost_out);
  cudaError_t e;
  for (int it = 0; it < n_iters; ++it) {
    if ((e = cudaMemsetAsync(w.g, 0, zero_bytes, st)) != cudaSuccess) return (int)e;
    if ((e = cudaMemsetAsync(w.sc, 0, sc_bytes, st)) != cudaSuccess) return (int)e;
    build_kernel<<<blocks(O), kThreads, 0, st>>>(Rf, tf, pf, q, cam, huber, w);
    invert_kernel<<<blocks(K + P), kThreads, 0, st>>>(q, w);
    for (int c = 0; c < cg_iters; ++c) {
      hv_kernel<<<blocks(O), kThreads, 0, st>>>(q, w, c);
      cg_a_kernel<<<blocks(nv), kThreads, 0, st>>>(q, w, c, cg_iters);
      cg_b_kernel<<<blocks(K + P), kThreads, 0, st>>>(q, w, c, cg_iters);
    }
    retract_kernel<<<blocks(K + P), kThreads, 0, st>>>(Rf, tf, pf, q, w);
    cost_kernel<<<blocks(O), kThreads, 0, st>>>(q, cam, huber, w);
    accept_kernel<<<blocks(K + P), kThreads, 0, st>>>(Rf, tf, pf, q, w, (float*)cost_out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  orthonormalize_kernel<<<blocks(K), kThreads, 0, st>>>(Rf, K);
  classify_kernel<<<blocks(O), kThreads, 0, st>>>(Rf, tf, pf, q, cam, chi2_th, (bool*)inliers);
  return (int)cudaGetLastError();
}
