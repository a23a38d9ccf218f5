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

struct Cam { float fx, fy, cx, cy; };

struct Prob {
  const int* obs_kf;
  const int* obs_mp;
  const float* obs_uv;
  const float* isig;
  const bool* valid;
  const bool* fixed_kf;
  const bool* fixed_mp;
  int K, P, O;
};

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

// the per-observation point and its camera-frame coordinates; invalid slots
// get a point 1 m in front of their camera (as the plain version)
__device__ void obs_point(const float* R, const float* t, const float* pts, const Prob& q, int o,
                          float* pw, float* pc) {
  if (q.valid[o]) {
    const int m = q.obs_mp[o];
    pw[0] = pts[3 * m];
    pw[1] = pts[3 * m + 1];
    pw[2] = pts[3 * m + 2];
  } else {
    const float d0 = 0.f - t[0], d1 = 0.f - t[1], d2 = 1.f - t[2];
    for (int i = 0; i < 3; ++i) pw[i] = R[i] * d0 + R[3 + i] * d1 + R[6 + i] * d2;
  }
  for (int i = 0; i < 3; ++i)
    pc[i] = R[3 * i] * pw[0] + R[3 * i + 1] * pw[1] + R[3 * i + 2] * pw[2] + t[i];
}

__device__ __forceinline__ float rho(float c2, bool huber, float delta) {
  if (!huber) return c2;
  const float d2 = delta * delta;
  return c2 <= d2 ? c2 : 2.f * delta * sqrtf(c2) - d2;
}

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

__device__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
    const float* Rk = R + 9 * kf;
    float pw[3], pc[3];
    obs_point(Rk, t + 3 * kf, pts, q, o, pw, pc);
    const float x = pc[0], y = pc[1], zc = pc[2];
    const float r0 = q.obs_uv[2 * o] - (cam.fx * x / zc + cam.cx);
    const float r1 = q.obs_uv[2 * o + 1] - (cam.fy * y / zc + cam.cy);
    const float is = q.isig[o];
    const float chi2 = (r0 * r0 + r1 * r1) * is;
    const float delta = sqrtf(5.991f);
    const float wt = (huber ? fminf(delta / sqrtf(fmaxf(chi2, 1e-12f)), 1.f) : 1.f) * is;
    cost = rho(chi2, huber, delta);
    const float iz = 1.f / zc;
    const float j00 = cam.fx * iz, j02 = -cam.fx * x * iz * iz;
    const float j11 = cam.fy * iz, j12 = -cam.fy * y * iz * iz;
    float J[2][9];  // [pose 6 | point 3]
    for (int c = 0; c < 3; ++c) {
      const float a0 = j00 * Rk[c] + j02 * Rk[6 + c];
      const float a1 = j11 * Rk[3 + c] + j12 * Rk[6 + c];
      J[0][c] = -a0;
      J[1][c] = -a1;
      J[0][6 + c] = -a0;
      J[1][6 + c] = -a1;
    }
    for (int rr = 0; rr < 2; ++rr) {  // A x p with a = -J[rr][0..2]
      const float a0 = -J[rr][0], a1 = -J[rr][1], a2 = -J[rr][2];
      J[rr][3] = a1 * pw[2] - a2 * pw[1];
      J[rr][4] = a2 * pw[0] - a0 * pw[2];
      J[rr][5] = a0 * pw[1] - a1 * pw[0];
    }
    float* Jo = w.J + (size_t)18 * o;
    for (int c = 0; c < 6; ++c) { Jo[c] = J[0][c]; Jo[6 + c] = J[1][c]; }
    for (int c = 0; c < 3; ++c) { Jo[12 + c] = J[0][6 + c]; Jo[15 + c] = J[1][6 + c]; }
    w.w[o] = wt;
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
      float A[36], I[36];
      const float* H = w.Hpp + 21 * e;
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          A[6 * a + b] = H[k];
          A[6 * b + a] = H[k];
          ++k;
        }
      for (int i = 0; i < 36; ++i) I[i] = (i % 7 == 0) ? 1.f : 0.f;
      for (int a = 0; a < 6; ++a) A[7 * a] += lam;
      // Gauss-Jordan with partial pivoting
      for (int c = 0; c < 6; ++c) {
        int piv = c;
        for (int r = c + 1; r < 6; ++r)
          if (fabsf(A[6 * r + c]) > fabsf(A[6 * piv + c])) piv = r;
        if (piv != c)
          for (int k2 = 0; k2 < 6; ++k2) {
            float tmp = A[6 * c + k2]; A[6 * c + k2] = A[6 * piv + k2]; A[6 * piv + k2] = tmp;
            tmp = I[6 * c + k2]; I[6 * c + k2] = I[6 * piv + k2]; I[6 * piv + k2] = tmp;
          }
        const float inv = 1.f / A[7 * c];
        for (int k2 = 0; k2 < 6; ++k2) { A[6 * c + k2] *= inv; I[6 * c + k2] *= inv; }
        for (int r = 0; r < 6; ++r) {
          if (r == c) continue;
          const float f = A[6 * r + c];
          for (int k2 = 0; k2 < 6; ++k2) {
            A[6 * r + k2] -= f * A[6 * c + k2];
            I[6 * r + k2] -= f * I[6 * c + k2];
          }
        }
      }
      float* M = w.Mp + 36 * e;
      for (int i = 0; i < 36; ++i) M[i] = I[i];
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
        for (int b = 0; b < 6; ++b) s += I[6 * a + b] * rb[b];
        s = fr ? s : 0.f;
        w.z[6 * e + a] = s;
        part += (double)(rb[a] * s);
      }
    } else {
      const int m = e - q.K;
      const float* H = w.Hll + 6 * m;
      const float m00 = H[0] + lam, m01 = H[1], m02 = H[2];
      const float m11 = H[3] + lam, m12 = H[4], m22 = H[5] + lam;
      const float m10 = m01, m20 = m02, m21 = m12;
      const float c00 = m11 * m22 - m12 * m21;
      const float c01 = m12 * m20 - m10 * m22;
      const float c02 = m10 * m21 - m11 * m20;
      const float det = m00 * c00 + m01 * c01 + m02 * c02;
      const float inv_det = 1.f / (fabsf(det) < 1e-20f ? 1e-20f : det);
      const float c10 = m02 * m21 - m01 * m22;
      const float c11 = m00 * m22 - m02 * m20;
      const float c12 = m01 * m20 - m00 * m21;
      const float c20 = m01 * m12 - m02 * m11;
      const float c21 = m02 * m10 - m00 * m12;
      const float c22 = m00 * m11 - m01 * m10;
      const float Mi[9] = {c00 * inv_det, c10 * inv_det, c20 * inv_det,
                           c01 * inv_det, c11 * inv_det, c21 * inv_det,
                           c02 * inv_det, c12 * inv_det, c22 * inv_det};
      float* M = w.Ml + 9 * m;
      for (int i = 0; i < 9; ++i) M[i] = Mi[i];
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

// Exp of se(3) in float: R = I + a W + b W^2, t = (I + b W + c W^2) rho
__device__ void se3_exp(const float* xi, float* dR, float* dt) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th2 * th);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  float V[9];
  for (int i = 0; i < 9; ++i) {
    const float I = (i % 4 == 0) ? 1.f : 0.f;
    dR[i] = I + a * W[i] + b * W2[i];
    V[i] = I + b * W[i] + c * W2[i];
  }
  for (int i = 0; i < 3; ++i) dt[i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
}

__global__ void __launch_bounds__(kThreads)
retract_kernel(const float* __restrict__ R, const float* __restrict__ t,
               const float* __restrict__ pts, const Prob q, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < q.K) {
    float xi[6], dR[9], dt[3];
    for (int i = 0; i < 6; ++i) xi[i] = -w.x[6 * e + i];
    se3_exp(xi, dR, dt);
    const float* Rk = R + 9 * e;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        w.Rn[9 * e + 3 * i + j] = Rk[3 * i] * dR[j] + Rk[3 * i + 1] * dR[3 + j] + Rk[3 * i + 2] * dR[6 + j];
      w.tn[3 * e + i] = Rk[3 * i] * dt[0] + Rk[3 * i + 1] * dt[1] + Rk[3 * i + 2] * dt[2] + t[3 * e + i];
    }
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
    float pw[3], pc[3];
    obs_point(w.Rn + 9 * kf, w.tn + 3 * kf, w.pn, q, o, pw, pc);
    const float r0 = q.obs_uv[2 * o] - (cam.fx * pc[0] / pc[2] + cam.cx);
    const float r1 = q.obs_uv[2 * o + 1] - (cam.fy * pc[1] / pc[2] + cam.cy);
    cost = rho((r0 * r0 + r1 * r1) * q.isig[o], huber, sqrtf(5.991f));
  }
  const double c = warp_sum_d((double)cost);
  if ((threadIdx.x & 31) == 0 && c != 0.0) atomicAdd(cost_new(w), c);
}

// keep the candidate only if the cost fell; lambda x0.5 or x4
__global__ void __launch_bounds__(kThreads)
accept_kernel(float* __restrict__ R, float* __restrict__ t, float* __restrict__ pts,
              const Prob q, Ws w, float* __restrict__ cost_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const float cn = (float)*cost_new(w), co = (float)*cost_old(w);
  const bool better = cn < co;
  if (e == 0) {
    *w.lam = better ? *w.lam * 0.5 : *w.lam * 4.0;
    *cost_out = fminf(cn, co);
  }
  if (!better) return;
  if (e < q.K) {
    for (int i = 0; i < 9; ++i) R[9 * e + i] = w.Rn[9 * e + i];
    for (int i = 0; i < 3; ++i) t[3 * e + i] = w.tn[3 * e + i];
  } else if (e < q.K + q.P) {
    const int m = e - q.K;
    for (int i = 0; i < 3; ++i) pts[3 * m + i] = w.pn[3 * m + i];
  }
}

// two Newton-Schulz steps R <- R (1.5 I - 0.5 R^T R)
__global__ void orthonormalize_kernel(float* __restrict__ R, int K) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= K) return;
  float Rm[9];
  for (int k = 0; k < 9; ++k) Rm[k] = R[9 * e + k];
  for (int rep = 0; rep < 2; ++rep) {
    float RtR[9], M[9], Rn[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        RtR[3 * i + j] = Rm[i] * Rm[j] + Rm[3 + i] * Rm[3 + j] + Rm[6 + i] * Rm[6 + j];
    for (int k = 0; k < 9; ++k) M[k] = ((k % 4 == 0) ? 1.5f : 0.f) - 0.5f * RtR[k];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = Rm[3 * i] * M[j] + Rm[3 * i + 1] * M[3 + j] + Rm[3 * i + 2] * M[6 + j];
    for (int k = 0; k < 9; ++k) Rm[k] = Rn[k];
  }
  for (int k = 0; k < 9; ++k) R[9 * e + k] = Rm[k];
}

__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ R, const float* __restrict__ t,
                const float* __restrict__ pts, const Prob q, const Cam cam, float chi2_th,
                bool* __restrict__ inl) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= q.O) return;
  if (!q.valid[o]) { inl[o] = false; return; }
  const int kf = q.obs_kf[o];
  float pw[3], pc[3];
  obs_point(R + 9 * kf, t + 3 * kf, pts, q, o, pw, pc);
  const float r0 = q.obs_uv[2 * o] - (cam.fx * pc[0] / pc[2] + cam.cx);
  const float r1 = q.obs_uv[2 * o + 1] - (cam.fy * pc[1] / pc[2] + cam.cy);
  inl[o] = (r0 * r0 + r1 * r1) * q.isig[o] <= chi2_th;
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
