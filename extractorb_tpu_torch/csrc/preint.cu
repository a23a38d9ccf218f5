// K19 preint: on-manifold IMU preintegration of a batch of padded windows,
// one thread per window.
//
// Replaces extractorb_tpu/imu/preintegration.py:integrate (the lax.scan that
// slam/imu_frontend.py:_integrate_jit runs over a bucketed window), which
// the TPU runs as a sequential scan of 3x3 and 9x9 matrix updates.  The scan
// is sequential by nature (each step rotates by the rotation so far), so a
// thread walks its window's samples in order with the whole state in
// registers and local memory: dR, dV, dP, the five bias Jacobians, the 9x9
// covariance block and the bias-walk diagonal.  Each step follows the
// reference's IntegrateNewMeasurement (src/ImuTypes.cc:255-311) in the JAX
// module's order: position first with the old rotation, covariance
// propagation A C A^T + B N B^T, rotation last, re-normalised onto SO(3).
// The re-normalisation (the JAX module's SVD polar factor U diag(1,1,det) V^T)
// is the polar factor by three Newton steps R <- (R + R^-T) / 2 in float64,
// rounded to float.  A padding step (valid false) leaves the state as it is.
//
// Bound on the H100: latency.  A frame window is ~10 samples and a keyframe's
// ~25-100; each step is ~3000 dependent float operations of one thread, so a
// launch takes microseconds however many windows it carries.
//
// Output per window (floats): dR 9, dV 3, dP 3, C 225, JRg 9, JVg 9, JVa 9,
// JPg 9, JPa 9, dT 1 (imu/preintegration.py's _LAYOUT).

#include <cuda_runtime.h>
#include <math.h>

namespace {

#include "dual.cuh"
#include "lie_t.cuh"

constexpr int kOut = 286;

__device__ void mm3(const float* A, const float* B, float* C) { mat3_mul(A, B, C); }

// the right Jacobian of SO(3), lie.so3_right_jacobian
__device__ void right_jacobian(const float* w, float* J) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  const float st2 = small ? 1.f : th2;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / st2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (st2 * th);
  float W[9], W2[9];
  hat3(w, W);
  mat3_mul(W, W, W2);
  for (int i = 0; i < 9; ++i) J[i] = (i % 4 == 0 ? 1.f : 0.f) - b * W[i] + c * W2[i];
}

// the polar factor of a near-rotation: three Newton steps in float64
__device__ void polar(const float* M, float* R) {
  double X[9];
  for (int i = 0; i < 9; ++i) X[i] = M[i];
  for (int it = 0; it < 3; ++it) {
    // cofactor matrix = det * inv(X)^T
    double Cf[9];
    Cf[0] = X[4] * X[8] - X[5] * X[7];
    Cf[1] = X[5] * X[6] - X[3] * X[8];
    Cf[2] = X[3] * X[7] - X[4] * X[6];
    Cf[3] = X[2] * X[7] - X[1] * X[8];
    Cf[4] = X[0] * X[8] - X[2] * X[6];
    Cf[5] = X[1] * X[6] - X[0] * X[7];
    Cf[6] = X[1] * X[5] - X[2] * X[4];
    Cf[7] = X[2] * X[3] - X[0] * X[5];
    Cf[8] = X[0] * X[4] - X[1] * X[3];
    const double det = X[0] * Cf[0] + X[1] * Cf[1] + X[2] * Cf[2];
    for (int i = 0; i < 9; ++i) X[i] = 0.5 * (X[i] + Cf[i] / det);
  }
  for (int i = 0; i < 9; ++i) R[i] = (float)X[i];
}

__global__ void preint_kernel(const float* __restrict__ gyro, const float* __restrict__ acc,
                              const float* __restrict__ dts, const bool* __restrict__ valid,
                              const float* __restrict__ bias, int B, int T, float ng2, float na2,
                              float wg2, float wa2, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float dR[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float dV[3] = {0.f, 0.f, 0.f}, dP[3] = {0.f, 0.f, 0.f};
  float JRg[9], JVg[9], JVa[9], JPg[9], JPa[9];
  for (int i = 0; i < 9; ++i) JRg[i] = JVg[i] = JVa[i] = JPg[i] = JPa[i] = 0.f;
  float C[81];
  for (int i = 0; i < 81; ++i) C[i] = 0.f;
  float Cw[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float dT = 0.f;
  const float* bg = bias + 6 * b;
  const float* ba = bg + 3;
  const float noise[6] = {ng2, ng2, ng2, na2, na2, na2};
  const float walk[6] = {wg2, wg2, wg2, wa2, wa2, wa2};
  for (int k = 0; k < T; ++k) {
    const size_t s = (size_t)b * T + k;
    if (!valid[s]) continue;
    const float dt = dts[s];
    float a_c[3], w_c[3];
    for (int i = 0; i < 3; ++i) {
      a_c[i] = acc[3 * s + i] - ba[i];
      w_c[i] = gyro[3 * s + i] - bg[i];
    }
    // dP, dV with the old rotation
    float hR[9], ra[3], hra[3];
    for (int i = 0; i < 9; ++i) hR[i] = 0.5f * dR[i];
    mat3_vec(hR, a_c, hra);
    mat3_vec(dR, a_c, ra);
    float nP[3], nV[3];
    for (int i = 0; i < 3; ++i) {
      nP[i] = dP[i] + dV[i] * dt + hra[i] * dt * dt;
      nV[i] = dV[i] + ra[i] * dt;
    }
    float Wacc[9], dRdt[9], hdRdt2[9];
    hat3(a_c, Wacc);
    for (int i = 0; i < 9; ++i) {
      dRdt[i] = dR[i] * dt;
      hdRdt2[i] = 0.5f * dRdt[i] * dt;
    }
    float RW[9], hRW[9], RWJ[9], hRWJ[9];
    mm3(dRdt, Wacc, RW);
    mm3(hdRdt2, Wacc, hRW);
    mm3(RW, JRg, RWJ);
    mm3(hRW, JRg, hRWJ);
    float nJPa[9], nJPg[9], nJVa[9], nJVg[9];
    for (int i = 0; i < 9; ++i) {
      nJPa[i] = JPa[i] + JVa[i] * dt - hdRdt2[i];
      nJPg[i] = JPg[i] + JVg[i] * dt - hRWJ[i];
      nJVa[i] = JVa[i] - dRdt[i];
      nJVg[i] = JVg[i] - RWJ[i];
    }
    float wdt[3] = {w_c[0] * dt, w_c[1] * dt, w_c[2] * dt};
    float dRi[9], rJ[9], Rm[9];
    so3_exp_t(wdt, dRi);
    right_jacobian(wdt, rJ);
    mm3(dR, dRi, Rm);
    // covariance: A (9x9), B (9x6)
    float A[81], Bm[54];
    for (int i = 0; i < 81; ++i) A[i] = (i % 10 == 0) ? 1.f : 0.f;
    for (int i = 0; i < 54; ++i) Bm[i] = 0.f;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        A[9 * r + c] = dRi[3 * c + r];
        A[9 * (3 + r) + c] = -RW[3 * r + c];
        A[9 * (6 + r) + c] = -hRW[3 * r + c];
        A[9 * (6 + r) + 3 + c] = (r == c ? 1.f : 0.f) * dt;
        Bm[6 * r + c] = rJ[3 * r + c] * dt;
        Bm[6 * (3 + r) + 3 + c] = dRdt[3 * r + c];
        Bm[6 * (6 + r) + 3 + c] = hdRdt2[3 * r + c];
      }
    float AC[81];
    for (int r = 0; r < 9; ++r)
      for (int c = 0; c < 9; ++c) {
        float acc_ = 0.f;
        for (int k2 = 0; k2 < 9; ++k2) acc_ += A[9 * r + k2] * C[9 * k2 + c];
        AC[9 * r + c] = acc_;
      }
    for (int r = 0; r < 9; ++r)
      for (int c = 0; c < 9; ++c) {
        float acc_ = 0.f;
        for (int k2 = 0; k2 < 9; ++k2) acc_ += AC[9 * r + k2] * A[9 * c + k2];
        float bnb = 0.f;
        for (int k2 = 0; k2 < 6; ++k2) bnb += Bm[6 * r + k2] * noise[k2] * Bm[6 * c + k2];
        C[9 * r + c] = acc_ + bnb;
      }
    for (int i = 0; i < 6; ++i) Cw[i] += walk[i];
    // JRg = dRi^T JRg - rJ dt
    float dRiT[9], t9[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) dRiT[3 * r + c] = dRi[3 * c + r];
    mm3(dRiT, JRg, t9);
    for (int i = 0; i < 9; ++i) JRg[i] = t9[i] - rJ[i] * dt;
    polar(Rm, dR);
    for (int i = 0; i < 3; ++i) {
      dP[i] = nP[i];
      dV[i] = nV[i];
    }
    for (int i = 0; i < 9; ++i) {
      JPa[i] = nJPa[i];
      JPg[i] = nJPg[i];
      JVa[i] = nJVa[i];
      JVg[i] = nJVg[i];
    }
    dT = dT + dt;
  }
  float* o = out + (size_t)kOut * b;
  for (int i = 0; i < 9; ++i) o[i] = dR[i];
  for (int i = 0; i < 3; ++i) {
    o[9 + i] = dV[i];
    o[12 + i] = dP[i];
  }
  float* Co = o + 15;
  for (int r = 0; r < 15; ++r)
    for (int c = 0; c < 15; ++c)
      Co[15 * r + c] = (r < 9 && c < 9) ? C[9 * r + c] : (r >= 9 && r == c ? Cw[r - 9] : 0.f);
  float* J = o + 240;
  for (int i = 0; i < 9; ++i) {
    J[i] = JRg[i];
    J[9 + i] = JVg[i];
    J[18 + i] = JVa[i];
    J[27 + i] = JPg[i];
    J[36 + i] = JPa[i];
  }
  o[285] = dT;
}

}  // namespace

// gyro, acc (B,T,3), dts (B,T), valid (B,T) bool, bias (B,6); ng2, na2, wg2,
// wa2 the squared discrete noise and walk sigmas; out (B,286)
extern "C" int preint_launch(const void* gyro, const void* acc, const void* dts, const void* valid,
                             const void* bias, int B, int T, float ng2, float na2, float wg2,
                             float wa2, void* out, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  preint_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)gyro, (const float*)acc, (const float*)dts, (const bool*)valid,
      (const float*)bias, B, T, ng2, na2, wg2, wa2, (float*)out);
  return (int)cudaGetLastError();
}
