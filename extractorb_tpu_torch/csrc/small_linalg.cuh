// Small dense float64 algebra shared by K5 (two_view.cu) and K10
// (pnp_ransac.cu): one thread runs each routine on matrices in registers or
// local memory.  Each file includes it inside its own anonymous namespace.
#pragma once

#include <math.h>

// Cyclic Jacobi on a symmetric n x n matrix A (row-major, destroyed): the
// eigenvalues end on A's diagonal, the eigenvectors in V's columns.
template <int n>
__device__ void jacobi_eig(double* A, double* V) {
  for (int i = 0; i < n * n; ++i) V[i] = (i % (n + 1) == 0) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 30; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int p = 0; p < n; ++p) {
      diag += A[p * n + p] * A[p * n + p];
      for (int q = p + 1; q < n; ++q) off += A[p * n + q] * A[p * n + q];
    }
    if (off <= 1e-30 * diag || off == 0.0) break;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = A[p * n + q];
        if (apq == 0.0) continue;
        const double theta = (A[q * n + q] - A[p * n + p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < n; ++k) {  // columns p, q
          const double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - s * akq;
          A[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {  // rows p, q
          const double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - s * aqk;
          A[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          const double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

__device__ inline void matmul3(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ inline double det3(const double* M) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) - M[1] * (M[3] * M[8] - M[5] * M[6]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

// SVD of a 3x3 (float64) from the eigenvectors of A^T A, as
// geometry/two_view.py:_svd3: V's columns by descending singular value,
// u_i = A v_i / s_i, u_2 = u_0 x u_1 with the sign of A v_2.
__device__ inline void svd3(const double* A, double* U, double* s, double* V) {
  double AtA[9], E[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      AtA[3 * i + j] = A[i] * A[j] + A[3 + i] * A[3 + j] + A[6 + i] * A[6 + j];
  jacobi_eig<3>(AtA, E);
  int order[3] = {0, 1, 2};  // descending eigenvalue
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (AtA[order[b] * 4] > AtA[order[a] * 4]) { const int t = order[a]; order[a] = order[b]; order[b] = t; }
  for (int c = 0; c < 3; ++c) {
    s[c] = sqrt(fmax(AtA[order[c] * 4], 0.0));
    for (int r = 0; r < 3; ++r) V[3 * r + c] = E[3 * r + order[c]];
  }
  double AV[9];
  matmul3(A, V, AV);
  for (int r = 0; r < 3; ++r) {
    U[3 * r] = AV[3 * r] / s[0];
    U[3 * r + 1] = AV[3 * r + 1] / s[1];
  }
  double u2[3] = {U[3] * U[7] - U[6] * U[4], U[6] * U[1] - U[0] * U[7], U[0] * U[4] - U[3] * U[1]};
  const double d = u2[0] * AV[2] + u2[1] * AV[5] + u2[2] * AV[8];
  for (int r = 0; r < 3; ++r) U[3 * r + 2] = d < 0.0 ? -u2[r] : u2[r];
}
