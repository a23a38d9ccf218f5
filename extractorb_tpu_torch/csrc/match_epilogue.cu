// K18 match_epilogue: the conflict resolution and the rotation-histogram
// filter that turn K3's best matches and a search's accept mask into the
// search's final matches, in one launch after each K3 search.
//
// Replaces extractorb_tpu/frontend/matcher.py:_first_claim,
// :rotation_consistency_mask and the distance-major claims inside
// :search_for_initialization and :search_by_bow (scatter-mins, a 30-bin
// scatter-add and a top_k that XLA fuses into each jitted search).
//
// One CTA of 1024 threads:
//   1. every accepted row claims its keypoint with an atomicMin in shared
//      memory: the row index (first-come: the smallest map-point index wins)
//      or (distance, row) as one 64-bit key (the smaller distance, then the
//      earlier row); with the rotation filter, every accepted row adds one to
//      its bin of the histogram of angle1 - angle2[best_idx], binned as the
//      reference does, rint(rot * float32(1/30)) in float32 with round-half-
//      even, 30 -> 0;
//   2. one thread takes the three largest bins (the lower bin on equal
//      counts, as top_k) and drops bins 2 and 3 below 0.1x the largest,
//      compared in float32;
//   3. a row keeps its match when it is accepted, won its claim and (with the
//      filter) falls in a kept bin; else -1.
// Integer atomics make the claims and the counts independent of the order
// the threads run in.
//
// Bound on the H100: latency.  A search has M <= 4096 rows and N = 1128
// keypoints: ~30 KB in and out, three syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 30;

__device__ __forceinline__ int rot_bin(float a1, float a2) {
  float rot = a1 - a2;
  if (rot < 0.0f) rot = rot + 360.0f;
  int b = (int)rintf(rot * (float)(1.0 / kBins));  // the reference's 1/HISTO_LENGTH
  if (b == kBins) b = 0;
  return min(max(b, 0), kBins - 1);
}

__global__ void __launch_bounds__(kThreads)
match_epilogue_kernel(const int* __restrict__ best, const int* __restrict__ best_idx,
                      const bool* __restrict__ accept, int M, int N, int by_distance,
                      const float* __restrict__ angle1, const float* __restrict__ angle2,
                      int* __restrict__ out) {
  extern __shared__ unsigned long long s_win[];  // N claims
  __shared__ int s_hist[kBins];
  __shared__ int s_keep[3], s_bin[3];  // s_keep[0] unused: the largest bin is always kept
  const int tid = threadIdx.x;
  const bool rot = angle1 != nullptr;
  for (int j = tid; j < N; j += kThreads) s_win[j] = ~0ull;
  if (tid < kBins) s_hist[tid] = 0;
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    const int j = best_idx[i];
    if (!accept[i] || j < 0 || j >= N) continue;  // a column outside [0, N) claims nothing
    const unsigned long long key =
        by_distance ? (unsigned long long)(unsigned)best[i] * (unsigned)M + (unsigned)i
                    : (unsigned long long)i;
    atomicMin(&s_win[j], key);
    if (rot) atomicAdd(&s_hist[rot_bin(angle1[i], angle2[j])], 1);
  }
  __syncthreads();
  if (rot && tid == 0) {
    int cnt[3], bin[3];
    for (int r = 0; r < 3; ++r) {
      int bb = -1, bc = -1;
      for (int b = 0; b < kBins; ++b) {
        const bool used = (r > 0 && bin[0] == b) || (r > 1 && bin[1] == b);
        if (!used && s_hist[b] > bc) {
          bc = s_hist[b];
          bb = b;
        }
      }
      cnt[r] = bc;
      bin[r] = bb;
    }
    s_bin[0] = bin[0];
    s_bin[1] = bin[1];
    s_bin[2] = bin[2];
    s_keep[1] = (float)cnt[1] >= 0.1f * (float)cnt[0];
    s_keep[2] = (float)cnt[2] >= 0.1f * (float)cnt[0];
  }
  __syncthreads();
  for (int i = tid; i < M; i += kThreads) {
    const int j = best_idx[i];
    bool ok = accept[i] && j >= 0 && j < N;
    if (ok) {
      const unsigned long long key =
          by_distance ? (unsigned long long)(unsigned)best[i] * (unsigned)M + (unsigned)i
                      : (unsigned long long)i;
      ok = s_win[j] == key;
    }
    if (ok && rot) {
      const int b = rot_bin(angle1[i], angle2[j]);
      ok = (b == s_bin[0]) || (s_keep[1] && b == s_bin[1]) || (s_keep[2] && b == s_bin[2]);
    }
    out[i] = ok ? j : -1;
  }
}

}  // namespace

// angle1/angle2 null: no rotation filter
extern "C" int match_epilogue_launch(const void* best, const void* best_idx, const void* accept,
                                     int M, int N, int by_distance, const void* angle1,
                                     const void* angle2, void* out, void* stream) {
  const int smem = N * (int)sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  match_epilogue_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)best, (const int*)best_idx, (const bool*)accept, M, N, by_distance,
      (const float*)angle1, (const float*)angle2, (int*)out);
  return (int)cudaGetLastError();
}
