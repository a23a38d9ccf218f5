// Device cameras for K4 (pose_lm.cu), K6 (ba_pcg.cu), K20 (vi_ba.cu) and K22
// (pose_inertial.cu), taken as a template parameter: the projection (u, v) =
// pi(x, y, z) for a generic scalar T (float, or Dual<n> from dual.cuh) and
// A = (d pi / d pc) R, the rows the Jacobians of a right perturbation
// R Exp(delta) are built from.  CamKB8 also unprojects a pixel to a unit
// bearing for K26 (stereo_fisheye.cu).
//
// The JAX package hands its solvers a projection closure and takes these
// Jacobians with jax.jacfwd through it (extractorb_tpu/slam/track_device.py
// :55-86, solver/pose_opt.py:35-57, solver/ba.py:55-92).  Cam (the pinhole
// camera) keeps the closed-form Jacobian the kernels had before the camera
// became a parameter, so its instantiations are that code; CamKB8 takes
// d pi / d pc in forward mode (Dual<3>) through the same projection it
// evaluates, with the JAX function's branches: theta = atan2(r, z) and the
// r < 1e-8 guard, where the scale is the constant 0 (its tangents too, as
// jnp.where gives them).  Include after dual.cuh, inside the file's
// anonymous namespace.
#pragma once

struct Cam {  // pinhole
  float fx, fy, cx, cy;

  template <class T>
  __device__ __forceinline__ void project(const T& x, const T& y, const T& z, T& u, T& v) const {
    u = fx * x / z + cx;
    v = fy * y / z + cy;
  }

  // a0, a1: the rows of (d pi / d pc) R
  __device__ __forceinline__ void a_rows(float x, float y, float z, const float* R, float* a0,
                                         float* a1) const {
    const float iz = 1.f / z;
    const float j00 = fx * iz, j02 = -fx * x * iz * iz;
    const float j11 = fy * iz, j12 = -fy * y * iz * iz;
    for (int c = 0; c < 3; ++c) {
      a0[c] = j00 * R[c] + j02 * R[6 + c];
      a1[c] = j11 * R[3 + c] + j12 * R[6 + c];
    }
  }
};

struct CamKB8 {  // Kannala-Brandt 8, extractorb_tpu/core/camera.py:113
  float fx, fy, cx, cy, k1, k2, k3, k4;

  template <class T>
  __device__ __forceinline__ void project(const T& x, const T& y, const T& z, T& u, T& v) const {
    const T r = tsqrt(x * x + y * y);
    const T theta = tatan2(r, z);
    const T t2 = theta * theta;
    const T d = theta * (1.f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
    // the guard's branch, tangents included (none through r at 0)
    const T scale = val(r) < 1e-8f ? zero_of(r) : d / r;
    u = fx * scale * x + cx;
    v = fy * scale * y + cy;
  }

  __device__ __forceinline__ void a_rows(float x, float y, float z, const float* R, float* a0,
                                         float* a1) const {
    Dual<3> X = dconst<3, float>(x), Y = dconst<3, float>(y), Z = dconst<3, float>(z), U, V;
    X.d[0] = 1.f;
    Y.d[1] = 1.f;
    Z.d[2] = 1.f;
    project(X, Y, Z, U, V);
    for (int c = 0; c < 3; ++c) {
      a0[c] = U.d[0] * R[c] + U.d[1] * R[3 + c] + U.d[2] * R[6 + c];
      a1[c] = V.d[0] * R[c] + V.d[1] * R[3 + c] + V.d[2] * R[6 + c];
    }
  }

  // pixel -> unit bearing b, in core/camera.py:KannalaBrandt8.unproject's
  // float32 operation order as PyTorch runs it on the card (a division by
  // the scalar fx is a product with its float32 reciprocal): 10 Newton
  // steps on theta from r_d (clamped to pi), then (sin(theta) x / r_d,
  // sin(theta) y / r_d, cos(theta)), which holds rays past 90 degrees
  __device__ __forceinline__ void unproject(float u, float v, float* b) const {
    const float c3 = 3.f * k1, c5 = 5.f * k2, c7 = 7.f * k3, c9 = 9.f * k4;
    const float wx = (u - cx) * (1.f / fx), wy = (v - cy) * (1.f / fy);
    const float r_d = fminf(sqrtf(wx * wx + wy * wy), 3.14159274f);
    float theta = r_d;
    for (int it = 0; it < 10; ++it) {
      const float t2 = theta * theta;
      const float t4 = t2 * t2, t6 = t2 * t2 * t2, t8 = t2 * t2 * t2 * t2;
      const float f = theta * (1.f + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - r_d;
      const float fp = 1.f + c3 * t2 + c5 * t4 + c7 * t6 + c9 * t8;
      theta = theta - f / (fabsf(fp) < 1e-8f ? 1.f : fp);
    }
    const float s = r_d < 1e-8f ? 1.f : sinf(theta) / r_d;
    b[0] = wx * s;
    b[1] = wy * s;
    b[2] = cosf(theta);
  }

  // a constant 0 of T's kind, tangents 0
  __device__ __forceinline__ static float zero_of(float) { return 0.f; }
  template <int n, class S>
  __device__ __forceinline__ static Dual<n, S> zero_of(const Dual<n, S>&) {
    return dconst<n, S>(S(0));
  }
};
