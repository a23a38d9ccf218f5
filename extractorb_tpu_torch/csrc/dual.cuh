// Forward-mode dual numbers for K12 (sim3.cu) and K13 (pose_graph.cu).
//
// Dual<n, S> carries a value and n tangents of scalar type S (float for K12,
// double for K13), so one evaluation of a residual written for a generic
// scalar T gives the residual (T = S) or its Jacobian in n directions
// (T = Dual<n, S>), as jax.jacfwd does in the JAX package.  A branch on a
// value (a Taylor guard, a pivot choice) takes the tangents of the branch
// taken, as jnp.where and jnp.argmax do.  Each file includes it inside its
// own anonymous namespace.
//
// The generic elementary functions are tsqrt, texp, tlog, tsin, tcos and
// tatan2, with float, double and Dual overloads.  They do not reuse the
// names sqrt, exp, ...: overloads of those in this namespace would hide the
// global float64 ones from small_linalg.cuh's routines (a double argument
// then rounds to float) or make CUDA's own math headers' calls ambiguous.
#pragma once

#include <math.h>

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ float tlog(float x) { return logf(x); }
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ float tatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double tsqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ double texp(double x) { return ::exp(x); }
__device__ __forceinline__ double tlog(double x) { return ::log(x); }
__device__ __forceinline__ double tsin(double x) { return ::sin(x); }
__device__ __forceinline__ double tcos(double x) { return ::cos(x); }
__device__ __forceinline__ double tatan2(double y, double x) { return ::atan2(y, x); }

template <int n, class S = float>
struct Dual {
  using scalar = S;
  S v;
  S d[n];
};

template <int n, class S = float>
__device__ __forceinline__ Dual<n, S> dconst(S v) {
  Dual<n, S> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = S(0);
  return r;
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <int n, class S>
__device__ __forceinline__ S val(const Dual<n, S>& x) { return x.v; }

// a scalar operand converts to the dual's scalar type (float literals included)
template <int n, class S>
using scal = typename Dual<n, S>::scalar;

template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator+(const Dual<n, S>& a, const Dual<n, S>& b) {
  Dual<n, S> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator-(const Dual<n, S>& a, const Dual<n, S>& b) {
  Dual<n, S> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator-(const Dual<n, S>& a) {
  Dual<n, S> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator*(const Dual<n, S>& a, const Dual<n, S>& b) {
  Dual<n, S> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator/(const Dual<n, S>& a, const Dual<n, S>& b) {
  Dual<n, S> r;
  r.v = a.v / b.v;
  const S ib = S(1) / b.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * ib;
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator+(const Dual<n, S>& a, scal<n, S> b) {
  Dual<n, S> r = a;
  r.v += b;
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator+(scal<n, S> a, const Dual<n, S>& b) { return b + a; }
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator-(const Dual<n, S>& a, scal<n, S> b) {
  Dual<n, S> r = a;
  r.v -= b;
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator-(scal<n, S> a, const Dual<n, S>& b) {
  Dual<n, S> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = -b.d[i];
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator*(const Dual<n, S>& a, scal<n, S> b) {
  Dual<n, S> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator*(scal<n, S> a, const Dual<n, S>& b) { return b * a; }
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator/(const Dual<n, S>& a, scal<n, S> b) {
  Dual<n, S> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> operator/(scal<n, S> a, const Dual<n, S>& b) {
  return dconst<n, S>(a) / b;
}

// f(x) with f' given at x's value
template <int n, class S>
__device__ __forceinline__ Dual<n, S> chain(const Dual<n, S>& x, S fv, S dfv) {
  Dual<n, S> r;
  r.v = fv;
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = dfv * x.d[i];
  return r;
}

template <int n, class S>
__device__ __forceinline__ Dual<n, S> tsqrt(const Dual<n, S>& x) {
  const S s = tsqrt(x.v);
  return chain(x, s, S(0.5) / s);
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> texp(const Dual<n, S>& x) {
  const S e = texp(x.v);
  return chain(x, e, e);
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> tlog(const Dual<n, S>& x) {
  return chain(x, tlog(x.v), S(1) / x.v);
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> tsin(const Dual<n, S>& x) {
  return chain(x, tsin(x.v), tcos(x.v));
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> tcos(const Dual<n, S>& x) {
  return chain(x, tcos(x.v), -tsin(x.v));
}
template <int n, class S>
__device__ __forceinline__ Dual<n, S> tatan2(const Dual<n, S>& y, const Dual<n, S>& x) {
  Dual<n, S> r;
  r.v = tatan2(y.v, x.v);
  const S den = S(1) / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int i = 0; i < n; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) * den;
  return r;
}

// jnp.where for a value condition: the branch taken, tangents included
template <class T>
__device__ __forceinline__ T sel(bool c, const T& a, const T& b) { return c ? a : b; }
