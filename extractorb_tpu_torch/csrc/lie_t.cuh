// SO(3) / SE(3) / Sim(3) maps for a generic scalar T (float or double, or
// Dual<7, S> / Dual<4, S> from dual.cuh) for K12 (sim3.cu, float), K13
// (pose_graph.cu, double) and K23 (pose_graph_4dof.cu, float or double): the
// same functions, branches and guards as extractorb_tpu/core/lie.py
// (so3_exp, rot_to_quat, so3_log, so3_right_jacobian_inv, se3_log,
// se3_inverse, se3_compose, sim3_exp, sim3_log, sim3_compose,
// sim3_inverse), so a residual written once gives its value and its
// forward-mode Jacobian.  Matrices are row-major T[9].  Include after
// dual.cuh, inside the same anonymous namespace.
#pragma once

template <class T>
__device__ __forceinline__ T cst(double v);
template <>
__device__ __forceinline__ float cst<float>(double v) { return (float)v; }
template <>
__device__ __forceinline__ double cst<double>(double v) { return v; }
template <>
__device__ __forceinline__ Dual<7> cst<Dual<7>>(double v) { return dconst<7, float>((float)v); }
template <>
__device__ __forceinline__ Dual<7, double> cst<Dual<7, double>>(double v) {
  return dconst<7, double>(v);
}
template <>
__device__ __forceinline__ Dual<4> cst<Dual<4>>(double v) { return dconst<4, float>((float)v); }
template <>
__device__ __forceinline__ Dual<4, double> cst<Dual<4, double>>(double v) {
  return dconst<4, double>(v);
}

template <class T>
__device__ __forceinline__ void mat3_mul(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <class T>
__device__ __forceinline__ void mat3_vec(const T* A, const T* v, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

template <class T>
__device__ __forceinline__ void hat3(const T* w, T* W) {
  const T z = cst<T>(0.f);
  W[0] = z;     W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = z;     W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = z;
}

// I + a W + b W^2 with the Taylor branch at theta^2 < 1e-8
template <class T>
__device__ void so3_exp_t(const T* w, T* R) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = val(th2) < 1e-8f;
  const T one = cst<T>(1.f);
  const T th = tsqrt(sel(small, one, th2));
  const T a = small ? one - th2 / 6.f : tsin(th) / th;
  const T b = small ? cst<T>(0.5f) - th2 / 24.f : (one - tcos(th)) / sel(small, one, th2);
  T W[9], W2[9];
  hat3(w, W);
  mat3_mul(W, W, W2);
  for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0 ? one : cst<T>(0.f)) + a * W[i] + b * W2[i];
}

// Shepperd quaternion (w, x, y, z), w >= 0: the pivot is chosen on values
template <class T>
__device__ void rot_to_quat_t(const T* R, T* q) {
  const T one = cst<T>(1.f);
  const T tr = R[0] + R[4] + R[8];
  T cand[4][4] = {
      {one + tr, R[7] - R[5], R[2] - R[6], R[3] - R[1]},
      {R[7] - R[5], one + R[0] - R[4] - R[8], R[1] + R[3], R[2] + R[6]},
      {R[2] - R[6], R[1] + R[3], one - R[0] + R[4] - R[8], R[5] + R[7]},
      {R[3] - R[1], R[2] + R[6], R[5] + R[7], one - R[0] - R[4] + R[8]},
  };
  // cand[c][p] is component c of pivot p's candidate; pivots are the diagonal
  int k = 0;
  for (int p = 1; p < 4; ++p)
    if (val(cand[p][p]) > val(cand[k][k])) k = p;
  T n2 = cand[0][k] * cand[0][k] + cand[1][k] * cand[1][k] + cand[2][k] * cand[2][k] +
         cand[3][k] * cand[3][k];
  T nrm = tsqrt(n2);
  if (val(nrm) < 1e-8f) nrm = cst<T>(1e-8f);
  const float sg = val(cand[0][k]) / val(nrm) < 0.f ? -1.f : 1.f;
  for (int c = 0; c < 4; ++c) q[c] = cand[c][k] / nrm * sg;
}

template <class T>
__device__ void so3_log_t(const T* R, T* w) {
  T q[4];
  rot_to_quat_t(R, q);
  const T qw = q[0];
  const T nv2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const bool small = val(nv2) < 1e-12f;
  const T one = cst<T>(1.f);
  const T safe_nv = tsqrt(sel(small, one, nv2));
  const T theta = 2.f * tatan2(safe_nv, qw);
  const T safe_qw = val(qw) < 1e-8f ? cst<T>(1e-8f) : qw;
  const T factor = small ? 2.f / safe_qw * (one - nv2 / (3.f * safe_qw * safe_qw))
                         : theta / safe_nv;
  for (int i = 0; i < 3; ++i) w[i] = factor * q[1 + i];
}

// (1 - cos x) / x^2 with the Taylor branch at |x| < 1e-4
template <class T>
__device__ T one_minus_cos_over_x2(const T& x) {
  const T x2 = x * x;
  const bool small = fabs(val(x)) < 1e-4f;
  return small ? cst<T>(0.5f) - x2 / 24.f + x2 * x2 / 720.f
               : (cst<T>(1.f) - tcos(x)) / sel(small, cst<T>(1.f), x2);
}

// V = A I + B hat(phi) + C hat(phi)^2 of Sophus' Sim3 exp (JAX lie.sim3_exp)
template <class T>
__device__ void sim3_V(const T* phi, const T& sigma, T* V, T& s) {
  const T one = cst<T>(1.f);
  s = texp(sigma);
  const T th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool t_small = val(th2) < 1e-10f;
  const T theta = t_small ? cst<T>(0.f) : tsqrt(th2);
  const bool s_small = fabs(val(sigma)) < 1e-5f;
  const T safe_sigma = sel(s_small, one, sigma);
  const T safe_theta = sel(t_small, one, theta);
  const T theta2 = theta * theta;
  const T A = s_small ? one + 0.5f * sigma : (s - one) / safe_sigma;
  T B, C;
  if (t_small) {
    B = s_small ? cst<T>(0.5f) : ((sigma - one) * s + one) / (safe_sigma * safe_sigma);
    C = s_small ? one / 6.f
                : ((0.5f * sigma * sigma - sigma + one) * s - one) /
                      (safe_sigma * safe_sigma * safe_sigma);
  } else if (s_small) {
    B = one_minus_cos_over_x2(theta);
    C = (theta - tsin(theta)) / (theta2 * safe_theta);
  } else {
    const T a_gen = s * tsin(theta), b_gen = s * tcos(theta);
    const T denom = sigma * sigma + theta2;
    B = (a_gen * sigma + (one - b_gen) * theta) / (safe_theta * denom);
    C = (A - (b_gen - one) * sigma / denom - a_gen * theta / denom) / theta2;
  }
  T W[9], W2[9];
  hat3(phi, W);
  mat3_mul(W, W, W2);
  for (int i = 0; i < 9; ++i) V[i] = (i % 4 == 0 ? A : cst<T>(0.f)) + B * W[i] + C * W2[i];
}

template <class T>
__device__ void sim3_exp_t(const T* xi, T* R, T* t, T& s) {
  so3_exp_t(xi + 3, R);
  T V[9];
  sim3_V(xi + 3, xi[6], V, s);
  mat3_vec(V, xi, t);
}

// x = A^-1 b for a 3x3 A, Gaussian elimination with partial pivoting on values
template <class T>
__device__ void solve3(T* A, T* b, T* x) {
  for (int c = 0; c < 3; ++c) {
    int p = c;
    for (int r = c + 1; r < 3; ++r)
      if (fabs(val(A[3 * r + c])) > fabs(val(A[3 * p + c]))) p = r;
    if (p != c) {
      for (int k = 0; k < 3; ++k) {
        const T tmp = A[3 * c + k]; A[3 * c + k] = A[3 * p + k]; A[3 * p + k] = tmp;
      }
      const T tmp = b[c]; b[c] = b[p]; b[p] = tmp;
    }
    for (int r = c + 1; r < 3; ++r) {
      const T f = A[3 * r + c] / A[3 * c + c];
      for (int k = c; k < 3; ++k) A[3 * r + k] = A[3 * r + k] - f * A[3 * c + k];
      b[r] = b[r] - f * b[c];
    }
  }
  for (int r = 2; r >= 0; --r) {
    T acc = b[r];
    for (int k = r + 1; k < 3; ++k) acc = acc - A[3 * r + k] * x[k];
    x[r] = acc / A[3 * r + r];
  }
}

// (rho, phi, sigma) = log(R, t, s), rho = V^-1 t
template <class T>
__device__ void sim3_log_t(const T* R, const T* t, const T& s, T* xi) {
  so3_log_t(R, xi + 3);
  xi[6] = tlog(s);
  T V[9], sv, tb[3];
  sim3_V(xi + 3, xi[6], V, sv);
  for (int i = 0; i < 3; ++i) tb[i] = t[i];
  solve3(V, tb, xi);
}

// (Ra,ta,sa) * (Rb,tb,sb)
template <class T>
__device__ void sim3_compose_t(const T* Ra, const T* ta, const T& sa, const T* Rb, const T* tb,
                               const T& sb, T* R, T* t, T& s) {
  mat3_mul(Ra, Rb, R);
  T v[3];
  mat3_vec(Ra, tb, v);
  for (int i = 0; i < 3; ++i) t[i] = sa * v[i] + ta[i];
  s = sa * sb;
}

template <class T>
__device__ void sim3_inverse_t(const T* R, const T* t, const T& s, T* Ri, T* ti, T& si) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
  si = cst<T>(1.f) / s;
  T v[3];
  mat3_vec(Ri, t, v);
  for (int i = 0; i < 3; ++i) ti[i] = -si * v[i];
}

// I + 0.5 W + c W^2, W = hat(w), with the Taylor branch at theta^2 < 1e-8
// (lie.so3_right_jacobian_inv)
template <class T>
__device__ void so3_right_jacobian_inv_t(const T* w, T* J) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = val(th2) < 1e-8f;
  const T one = cst<T>(1.f);
  const T th = tsqrt(sel(small, one, th2));
  T c;
  if (small) {
    c = cst<T>(1.0 / 12.0) + th2 / 720.f;
  } else {
    c = one / th2 - (one + tcos(th)) / (2.f * (th * tsin(th)));
  }
  T W[9], W2[9];
  hat3(w, W);
  mat3_mul(W, W, W2);
  for (int i = 0; i < 9; ++i) J[i] = (i % 4 == 0 ? one : cst<T>(0.f)) + 0.5f * W[i] + c * W2[i];
}

// (rho, phi) = log(R, t): phi = so3_log(R), rho = J_l(phi)^-1 t with
// J_l(phi)^-1 = J_r(-phi)^-1
template <class T>
__device__ void se3_log_t(const T* R, const T* t, T* xi) {
  so3_log_t(R, xi + 3);
  const T mphi[3] = {-xi[3], -xi[4], -xi[5]};
  T J[9];
  so3_right_jacobian_inv_t(mphi, J);
  mat3_vec(J, t, xi);
}

template <class T>
__device__ void se3_inverse_t(const T* R, const T* t, T* Ri, T* ti) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
  T v[3];
  mat3_vec(Ri, t, v);
  for (int i = 0; i < 3; ++i) ti[i] = -v[i];
}

// (Ra,ta) * (Rb,tb)
template <class T>
__device__ void se3_compose_t(const T* Ra, const T* ta, const T* Rb, const T* tb, T* R, T* t) {
  mat3_mul(Ra, Rb, R);
  T v[3];
  mat3_vec(Ra, tb, v);
  for (int i = 0; i < 3; ++i) t[i] = v[i] + ta[i];
}
