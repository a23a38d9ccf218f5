// Inertial residuals for a generic scalar T (float, or Dual<15> from
// dual.cuh for forward-mode Jacobians), shared by K20 (vi_ba.cu), K21
// (inertial_init.cu) and K22 (pose_inertial.cu): the 15-dim state
// retraction, the bias-corrected preintegrated deltas, the 9-dim
// EdgeInertial residual and its whitened 15-dim form with the bias walk --
// extractorb_tpu/solver/inertial.py (_apply_delta, _edge_resid15) and
// imu/preintegration.py (delta_*, inertial_residual) in the same order of
// operations.  Also the whitening factor L = chol((C + 1e-8 I)^-1)
// (inertial.py:_info_sqrt), in float64, rounded to float.  The visual
// residual (vis_rj) takes the camera as a template parameter
// (camera_t.cuh).  Include after dual.cuh and lie_t.cuh, inside the same
// anonymous namespace.
#pragma once

#include "camera_t.cuh"

using D15 = Dual<15, float>;
template <>
__device__ __forceinline__ D15 cst<D15>(double v) { return dconst<15, float>((float)v); }

// a preintegration in the packed layout of solver/inertial.py (292 floats):
// dR 9, dV 3, dP 3, JRg 9, JVg 9, JVa 9, JPg 9, JPa 9, dT 1, C 225, bias 6
constexpr int kPk = 292;
struct Pk {
  const float* p;
  __device__ const float* dR() const { return p; }
  __device__ const float* dV() const { return p + 9; }
  __device__ const float* dP() const { return p + 12; }
  __device__ const float* JRg() const { return p + 15; }
  __device__ const float* JVg() const { return p + 24; }
  __device__ const float* JVa() const { return p + 33; }
  __device__ const float* JPg() const { return p + 42; }
  __device__ const float* JPa() const { return p + 51; }
  __device__ float dT() const { return p[60]; }
  __device__ const float* C() const { return p + 61; }
  __device__ const float* bias() const { return p + 286; }
};

// a state of 21 floats: R 9, t 3, v 3, bg 3, ba 3
template <class T>
struct St {
  T R[9], t[3], v[3], bg[3], ba[3];
};

template <class T>
__device__ __forceinline__ void load_state(const float* s, St<T>& o) {
  for (int i = 0; i < 9; ++i) o.R[i] = cst<T>(s[i]);
  for (int i = 0; i < 3; ++i) {
    o.t[i] = cst<T>(s[9 + i]);
    o.v[i] = cst<T>(s[12 + i]);
    o.bg[i] = cst<T>(s[15 + i]);
    o.ba[i] = cst<T>(s[18 + i]);
  }
}

// (R Exp(d[0:3]), t + R d[3:6], v + d[6:9], bg + d[9:12], ba + d[12:15]) of
// the float state s
template <class T>
__device__ void apply_delta_t(const float* s, const T* d, St<T>& o) {
  T E[9], R[9];
  so3_exp_t(d, E);
  for (int i = 0; i < 9; ++i) R[i] = cst<T>(s[i]);
  mat3_mul(R, E, o.R);
  T Rd[3];
  mat3_vec(R, d + 3, Rd);
  for (int i = 0; i < 3; ++i) {
    o.t[i] = s[9 + i] + Rd[i];
    o.v[i] = s[12 + i] + d[6 + i];
    o.bg[i] = s[15 + i] + d[9 + i];
    o.ba[i] = s[18 + i] + d[12 + i];
  }
}

// M (float 3x3) @ v (T)
template <class T>
__device__ __forceinline__ void fmat_vec(const float* M, const T* v, T* o) {
  for (int i = 0; i < 3; ++i) o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

// R^T v
template <class T>
__device__ __forceinline__ void matT_vec(const T* R, const T* v, T* o) {
  for (int i = 0; i < 3; ++i) o[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

// A^T B
template <class T>
__device__ __forceinline__ void matT_mul(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

// the 9-dim EdgeInertial residual with the bias b (6) and gravity g (3);
// scale s multiplies the visual displacements (1 outside InertialOptimization)
template <class T>
__device__ void inertial_r9(const Pk& p, const T* R1, const T* t1, const T* v1, const T* R2,
                            const T* t2, const T* v2, const T* b, const T* g, const T& s, T* r) {
  T dbg[3], dba[3];
  for (int i = 0; i < 3; ++i) {
    dbg[i] = b[i] - p.bias()[i];
    dba[i] = b[3 + i] - p.bias()[3 + i];
  }
  // delta rotation dR Exp(JRg dbg)
  T w[3], E[9], dRf[9], dRb[9];
  fmat_vec(p.JRg(), dbg, w);
  so3_exp_t(w, E);
  for (int i = 0; i < 9; ++i) dRf[i] = cst<T>(p.dR()[i]);
  mat3_mul(dRf, E, dRb);
  T R12[9], M[9];
  matT_mul(R1, R2, R12);
  matT_mul(dRb, R12, M);
  so3_log_t(M, r);
  const float dT = p.dT();
  T jg[3], ja[3], dv[3], dp[3];
  fmat_vec(p.JVg(), dbg, jg);
  fmat_vec(p.JVa(), dba, ja);
  for (int i = 0; i < 3; ++i) dv[i] = p.dV()[i] + jg[i] + ja[i];
  fmat_vec(p.JPg(), dbg, jg);
  fmat_vec(p.JPa(), dba, ja);
  for (int i = 0; i < 3; ++i) dp[i] = p.dP()[i] + jg[i] + ja[i];
  T a[3], c[3], o[3];
  for (int i = 0; i < 3; ++i) {
    a[i] = s * (v2[i] - v1[i]) - g[i] * dT;
    c[i] = s * (t2[i] - t1[i] - v1[i] * dT) - 0.5f * g[i] * dT * dT;
  }
  matT_vec(R1, a, o);
  for (int i = 0; i < 3; ++i) r[3 + i] = o[i] - dv[i];
  matT_vec(R1, c, o);
  for (int i = 0; i < 3; ++i) r[6 + i] = o[i] - dp[i];
}

// the whitened 15-dim chain-edge residual [Lr^T r9; Lb^T (b_j - b_i)]; the
// inertial part takes the first state's bias
template <class T>
__device__ void edge_r15(const Pk& p, const float* Lr, const float* Lb, const St<T>& a,
                         const St<T>& b, T* r) {
  T bi[6], g[3], r9[9];
  for (int i = 0; i < 3; ++i) {
    bi[i] = a.bg[i];
    bi[3 + i] = a.ba[i];
  }
  g[0] = cst<T>(0.f);
  g[1] = cst<T>(0.f);
  g[2] = cst<T>(-9.81f);
  inertial_r9(p, a.R, a.t, a.v, b.R, b.t, b.v, bi, g, cst<T>(1.f), r9);
  for (int i = 0; i < 9; ++i) {
    T acc = cst<T>(0.f);
    for (int k = 0; k < 9; ++k) acc = acc + Lr[9 * k + i] * r9[k];
    r[i] = acc;
  }
  T r6[6];
  for (int i = 0; i < 3; ++i) {
    r6[i] = b.bg[i] - a.bg[i];
    r6[3 + i] = b.ba[i] - a.ba[i];
  }
  for (int i = 0; i < 6; ++i) {
    T acc = cst<T>(0.f);
    for (int k = 0; k < 6; ++k) acc = acc + Lb[6 * k + i] * r6[k];
    r[9 + i] = acc;
  }
}

// L (n x n, row-major, lower) = chol(sym(inv(C_blk + 1e-8 I))) of the block
// [off, off + n) of a 15x15 covariance, in float64
template <int n>
__device__ void info_sqrt_blk(const float* C, int off, float* L) {
  double A[n * n], I[n * n];
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) {
      A[n * r + c] = (double)C[15 * (off + r) + off + c] + (r == c ? 1e-8 : 0.0);
      I[n * r + c] = r == c ? 1.0 : 0.0;
    }
  for (int c = 0; c < n; ++c) {
    int piv = c;
    for (int r = c + 1; r < n; ++r)
      if (fabs(A[n * r + c]) > fabs(A[n * piv + c])) piv = r;
    if (piv != c)
      for (int k = 0; k < n; ++k) {
        double t = A[n * c + k]; A[n * c + k] = A[n * piv + k]; A[n * piv + k] = t;
        t = I[n * c + k]; I[n * c + k] = I[n * piv + k]; I[n * piv + k] = t;
      }
    const double inv = 1.0 / A[n * c + c];
    for (int k = 0; k < n; ++k) { A[n * c + k] *= inv; I[n * c + k] *= inv; }
    for (int r = 0; r < n; ++r) {
      if (r == c) continue;
      const double f = A[n * r + c];
      for (int k = 0; k < n; ++k) { A[n * r + k] -= f * A[n * c + k]; I[n * r + k] -= f * I[n * c + k]; }
    }
  }
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) A[n * r + c] = 0.5 * (I[n * r + c] + I[n * c + r]);
  for (int j = 0; j < n; ++j) {
    double d = A[n * j + j];
    for (int k = 0; k < j; ++k) d -= I[n * j + k] * I[n * j + k];
    const double ljj = sqrt(fmax(d, 0.0));
    I[n * j + j] = ljj;
    for (int r = j + 1; r < n; ++r) {
      double s = A[n * r + j];
      for (int k = 0; k < j; ++k) s -= I[n * r + k] * I[n * j + k];
      I[n * r + j] = ljj > 0.0 ? s / ljj : 0.0;
    }
    for (int c = j + 1; c < n; ++c) I[n * j + c] = 0.0;
  }
  for (int i = 0; i < n * n; ++i) L[i] = (float)I[i];
}

// two Newton-Schulz steps R <- R (1.5 I - 0.5 R^T R) (lie.orthonormalize)
__device__ void orthonormalize3(float* Rm) {
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
}

// the residual uv - pi(pc) of a camera-frame point and, with `jac`, the rows
// A = (d pi / d pc) Rcb, through the camera's project and a_rows
// (camera_t.cuh: the pinhole in closed form, CamKB8 in Dual<3>)
template <class C>
__device__ __forceinline__ void vis_proj(const C& cam, float x, float y, float z, const float* uv,
                                         const float* Rcb, bool jac, float* r, float (*A)[3]) {
  float u, v;
  cam.project(x, y, z, u, v);
  r[0] = uv[0] - u;
  r[1] = uv[1] - v;
  if (jac) cam.a_rows(x, y, z, Rcb, A[0], A[1]);
}

// the visual residual of a world point pw in the camera `cam` of body state
// (R, t) (pc = Rcb R^T (pw - t) + tcb) and its Jacobians: wrt the body's
// (phi, rho) (Jp, 2x6) and wrt the point (Jl, 2x3), as the JAX module's
// jacfwd of inertial.py:_vis_residual_jac gives them
template <class C>
__device__ void vis_rj(const float* R, const float* t, const float* pw, const float* uv,
                       const float* Rcb, const float* tcb, const C& cam, float* r,
                       float (*Jp)[6], float (*Jl)[3]) {
  float d[3], pb[3], pc[3];
  for (int i = 0; i < 3; ++i) d[i] = pw[i] - t[i];
  for (int i = 0; i < 3; ++i) pb[i] = R[i] * d[0] + R[3 + i] * d[1] + R[6 + i] * d[2];
  for (int i = 0; i < 3; ++i)
    pc[i] = Rcb[3 * i] * pb[0] + Rcb[3 * i + 1] * pb[1] + Rcb[3 * i + 2] * pb[2] + tcb[i];
  float A[2][3];  // (J_pi Rcb) rows
  vis_proj(cam, pc[0], pc[1], pc[2], uv, Rcb, Jp != nullptr, r, A);
  if (Jp == nullptr) return;
  for (int rr = 0; rr < 2; ++rr) {
    const float* a = A[rr];
    // d pb / d phi = hat(pb), d pb / d rho = -I, d pb / d pw = R^T
    Jp[rr][0] = -(a[1] * pb[2] - a[2] * pb[1]);
    Jp[rr][1] = -(a[2] * pb[0] - a[0] * pb[2]);
    Jp[rr][2] = -(a[0] * pb[1] - a[1] * pb[0]);
    for (int c = 0; c < 3; ++c) Jp[rr][3 + c] = a[c];
    if (Jl != nullptr)
      for (int c = 0; c < 3; ++c) Jl[rr][c] = -(a[0] * R[3 * c] + a[1] * R[3 * c + 1] + a[2] * R[3 * c + 2]);
  }
}
