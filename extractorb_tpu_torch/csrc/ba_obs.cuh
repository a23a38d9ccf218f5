// Device code shared by K6 (ba_pcg.cu, the window BA), K14 (ba_schur.cu,
// the global BA) and K35 (ba_schur_dense.cu): the reprojection observation
// -- the residual r = obs - pi(R p + t) and its Jacobians for the right
// perturbation R Exp(delta), delta = (rho, phi): with A = J_pi R (the
// camera's a_rows, camera_t.cuh), J_pose = [-A | A hat(p)] and
// J_point = -A (the JAX package's solver/ba.py:_obs_residual_jac takes
// them with jacfwd) -- its chi2 and Huber weight, the damped block
// inverses, the pose retraction, the LM accept rule and the final
// re-orthonormalization.  The observation functions take the camera as a
// template parameter (Cam: pinhole; CamKB8).  The stereo variants (kS, K6
// <stereo>) add the third row of an observation with ur >= 0,
// r2 = ur - (u - bf / z) (reference EdgeStereo, JAX ba.py:82-84), whose
// row of A is A's first row plus (bf / z^2) times R's third row (K4's
// stereo row, pose_lm.cu, through any camera); a mono observation (ur < 0)
// keeps a zero third row.  Each file includes it inside its own anonymous
// namespace, after dual.cuh.
#pragma once

#include "camera_t.cuh"

struct Prob {
  const int* obs_kf;
  const int* obs_mp;
  const float* obs_uv;
  const float* isig;
  const bool* valid;
  const bool* fixed_kf;
  const bool* fixed_mp;
  int K, P, O;
  const float* ur = nullptr;  // (O,) right-image u (< 0: mono); read by the stereo variants
  float bf = 0.f;             // fx * baseline
};

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

// the Huber cost of a chi2 at delta (or the chi2 itself)
__device__ __forceinline__ float rho(float c2, bool huber, float delta) {
  if (!huber) return c2;
  const float d2 = delta * delta;
  return c2 <= d2 ? c2 : 2.f * delta * sqrtf(c2) - d2;
}

// the Huber threshold on chi2 of a mono observation (sqrt of chi2_mono)
__device__ __forceinline__ float huber_delta() { return sqrtf(5.991f); }

// rows of an observation's residual: 2, or 3 with the stereo row
template <bool kS>
constexpr int kRows = kS ? 3 : 2;

// the Huber delta and chi2 gate of observation o: the stereo ones
// (sqrt(7.815), 7.815) on a stereo row, else the mono delta and chi2_th
template <bool kS>
__device__ __forceinline__ bool stereo_row(const Prob& q, int o) {
  if constexpr (kS) return q.ur[o] >= 0.f;
  return false;
}
template <bool kS>
__device__ __forceinline__ float obs_delta(const Prob& q, int o) {
  return stereo_row<kS>(q, o) ? sqrtf(7.815f) : huber_delta();
}
template <bool kS>
__device__ __forceinline__ float obs_gate(const Prob& q, int o, float chi2_th) {
  return stereo_row<kS>(q, o) ? 7.815f : chi2_th;
}

// residual r[kRows] and Jacobian rows J[row] = [pose 6 | point 3] of
// observation o with the pose (Rk, tk)
template <bool kS, class C>
__device__ void obs_rows(const float* Rk, const float* tk, const float* pts, const Prob& q,
                         const C& cam, int o, float* r, float (*J)[9]) {
  constexpr int kR = kRows<kS>;
  float pw[3], pc[3];
  obs_point(Rk, tk, pts, q, o, pw, pc);
  float u, v;
  cam.project(pc[0], pc[1], pc[2], u, v);
  r[0] = q.obs_uv[2 * o] - u;
  r[1] = q.obs_uv[2 * o + 1] - v;
  float a[3][3];
  cam.a_rows(pc[0], pc[1], pc[2], Rk, a[0], a[1]);
  if constexpr (kS) {
    const bool st = q.ur[o] >= 0.f;
    r[2] = st ? q.ur[o] - (u - q.bf / pc[2]) : 0.f;
    const float s = q.bf / (pc[2] * pc[2]);
    for (int c = 0; c < 3; ++c) a[2][c] = st ? a[0][c] + s * Rk[6 + c] : 0.f;
  }
  for (int rr = 0; rr < kR; ++rr)
    for (int c = 0; c < 3; ++c) {
      J[rr][c] = -a[rr][c];
      J[rr][6 + c] = -a[rr][c];
    }
  for (int rr = 0; rr < kR; ++rr) {  // A x p with a = -J[rr][0..2]
    const float a0 = -J[rr][0], a1 = -J[rr][1], a2 = -J[rr][2];
    J[rr][3] = a1 * pw[2] - a2 * pw[1];
    J[rr][4] = a2 * pw[0] - a0 * pw[2];
    J[rr][5] = a0 * pw[1] - a1 * pw[0];
  }
}

// chi2 of observation o with the pose (Rk, tk), its stereo row included
template <bool kS, class C>
__device__ __forceinline__ float obs_chi2_rows(const float* Rk, const float* tk, const float* pts,
                                               const Prob& q, const C& cam, int o) {
  float pw[3], pc[3];
  obs_point(Rk, tk, pts, q, o, pw, pc);
  float u, v;
  cam.project(pc[0], pc[1], pc[2], u, v);
  const float r0 = q.obs_uv[2 * o] - u;
  const float r1 = q.obs_uv[2 * o + 1] - v;
  if constexpr (kS) {
    const float r2 = q.ur[o] >= 0.f ? q.ur[o] - (u - q.bf / pc[2]) : 0.f;
    return (r0 * r0 + r1 * r1 + r2 * r2) * q.isig[o];
  }
  return (r0 * r0 + r1 * r1) * q.isig[o];
}

// one valid observation's linearization with kRows rows: residual (stored
// as (O, kR)), Jacobian rows (stored as (O, 9 kR): pose kR x 6, then point
// kR x 3), IRLS weight (stored as (O,)) and its robust cost
template <bool kS, class C>
__device__ void obs_linearize_rows(const float* Rk, const float* tk, const float* pts,
                                   const Prob& q, const C& cam, bool huber, int o, float* Jstore,
                                   float* wstore, float* rstore, float& cost) {
  constexpr int kR = kRows<kS>;
  float r[3], J[3][9];
  obs_rows<kS>(Rk, tk, pts, q, cam, o, r, J);
  const float is = q.isig[o];
  float chi2 = r[0] * r[0] + r[1] * r[1];
  if constexpr (kS) chi2 += r[2] * r[2];
  chi2 *= is;
  const float delta = obs_delta<kS>(q, o);
  const float wt = (huber ? fminf(delta / sqrtf(fmaxf(chi2, 1e-12f)), 1.f) : 1.f) * is;
  cost = rho(chi2, huber, delta);
  float* Jo = Jstore + (size_t)9 * kR * o;
  for (int rr = 0; rr < kR; ++rr) {
    for (int c = 0; c < 6; ++c) Jo[6 * rr + c] = J[rr][c];
    for (int c = 0; c < 3; ++c) Jo[6 * kR + 3 * rr + c] = J[rr][6 + c];
    rstore[(size_t)kR * o + rr] = r[rr];
  }
  wstore[o] = wt;
}

__device__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// M = (H + lam I)^-1 of a 6x6 pose block given by its upper triangle
// (21 floats), Gauss-Jordan with partial pivoting
__device__ void inv6_damped(const float* H, float lam, float* M) {
  float A[36], I[36];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      A[6 * a + b] = H[k];
      A[6 * b + a] = H[k];
      ++k;
    }
  for (int i = 0; i < 36; ++i) I[i] = (i % 7 == 0) ? 1.f : 0.f;
  for (int a = 0; a < 6; ++a) A[7 * a] += lam;
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
  for (int i = 0; i < 36; ++i) M[i] = I[i];
}

// M = (H + lam I)^-1 of a 3x3 point block given by its upper triangle
// (6 floats), by the adjugate
__device__ void inv3_damped(const float* H, float lam, float* M) {
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
  M[0] = c00 * inv_det; M[1] = c10 * inv_det; M[2] = c20 * inv_det;
  M[3] = c01 * inv_det; M[4] = c11 * inv_det; M[5] = c21 * inv_det;
  M[6] = c02 * inv_det; M[7] = c12 * inv_det; M[8] = c22 * inv_det;
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

// the candidate pose (R Exp(xi), R dt + t) for the step xi
__device__ void retract_pose(const float* Rk, const float* tk, const float* xi, float* Rn,
                             float* tn) {
  float dR[9], dt[3];
  se3_exp(xi, dR, dt);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = Rk[3 * i] * dR[j] + Rk[3 * i + 1] * dR[3 + j] + Rk[3 * i + 2] * dR[6 + j];
    tn[i] = Rk[3 * i] * dt[0] + Rk[3 * i + 1] * dt[1] + Rk[3 * i + 2] * dt[2] + tk[i];
  }
}

// the LM accept rule: keep the candidate when its cost, compared in float,
// fell (sc = [cost_old, cost_new, ...]); thread 0 moves lambda x0.5 or x4;
// thread e < K copies pose e, K <= e < K + P point e - K
__device__ bool lm_accept(const double* sc, double* lam, int e, int K, int P, const float* Rn,
                          const float* tn, const float* pn, float* R, float* t, float* pts) {
  const bool better = (float)sc[1] < (float)sc[0];
  if (e == 0) *lam = better ? *lam * 0.5 : *lam * 4.0;
  if (!better) return false;
  if (e < K) {
    for (int i = 0; i < 9; ++i) R[9 * e + i] = Rn[9 * e + i];
    for (int i = 0; i < 3; ++i) t[3 * e + i] = tn[3 * e + i];
  } else if (e < K + P) {
    const int m = e - K;
    for (int i = 0; i < 3; ++i) pts[3 * m + i] = pn[3 * m + i];
  }
  return true;
}

// two Newton-Schulz steps R <- R (1.5 I - 0.5 R^T R) of one rotation, Rin
// into Rout (which may be Rin)
__device__ void orthonormalize_rot(const float* Rin, float* Rout) {
  float Rm[9];
  for (int k = 0; k < 9; ++k) Rm[k] = Rin[k];
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
  for (int k = 0; k < 9; ++k) Rout[k] = Rm[k];
}

__global__ void orthonormalize_kernel(float* __restrict__ R, int K) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < K) orthonormalize_rot(R + 9 * e, R + 9 * e);
}
