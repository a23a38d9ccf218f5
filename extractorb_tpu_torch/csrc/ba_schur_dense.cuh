// The interface between K6 (ba_pcg.cu) and K35 (ba_schur_dense.cu): K6's
// linearization of one LM step, which K35 turns into the step x.  Included
// outside any namespace.
#pragma once

#include <cuda_runtime.h>

struct SchurDenseArgs {
  const float* J;         // (O, 9 kR): K6's pose rows kR x 6, then point rows kR x 3
  const float* w;         // (O,) IRLS weights (0 on an invalid observation)
  const float* g;         // (6K + 3P) gradient J^T W r, unmasked
  const float* Hpp;       // (K, 21) upper triangles of the pose blocks
  const float* Hll;       // (P, 6) upper triangles of the point blocks
  const double* lam;      // LM damping
  const int* off_kf;      // K6's observation lists (det_reduce.cuh): valid ones only
  const int* list_kf;
  const int* off_mp;
  const int* list_mp;
  const int* obs_kf;
  const int* obs_mp;
  const bool* fixed_kf;
  const bool* fixed_mp;
  int K, P, O, kR;
  void* ws;               // ba_schur_dense_workspace_bytes(K, P, O)
  float* x;               // (6K + 3P) out: the step (xp, xl), retracted as R Exp(-xp), p - xl
};

// enqueue K35's passes of one LM step on st; returns cudaGetLastError()
int ba_schur_dense_step(const SchurDenseArgs& a, cudaStream_t st);
