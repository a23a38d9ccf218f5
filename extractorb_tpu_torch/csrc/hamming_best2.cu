// K3 hamming_best2: gated best / second-best 256-bit Hamming match per query.
//
// Replaces extractorb_tpu/frontend/matcher.py:hamming_matrix (+ unpack_bits)
// and the masked min / argmin / second-best of search_for_initialization,
// mutual_best_match, search_by_projection_last_frame and
// search_by_projection_local_map.  The TPU builds the dense (M, N) distance
// matrix as bf16 bit-plane matmuls on the MXU; here one warp owns one query
// row, tests each candidate's gate (strict box |u-x| < r, |v-y| < r, level in
// [lo, hi], row and column validity) and only then XORs two 16-byte halves
// of the descriptors and popcounts.  The matrix is never stored.
//
// Each lane keeps the two smallest keys (distance << 22 | column) of the
// columns it visits; the keys are unique, so a shuffle merge of top-2 lists
// gives the row's lowest-index best and, for the second, the minimum with
// only the best column removed -- jnp.argmin's tie rule.  A missing best or
// second is reported as distance 1<<20 with index 0, as the JAX code's
// all-masked rows are.
//
// Bound on the H100: gate reads.  Every (row, column) pair reads 13 bytes of
// column geometry (x, y, octave, ok) from L1/L2; descriptors are read only for
// pairs inside the window, which in the projection searches is a few percent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kIdxBits = 22;
constexpr unsigned kNone = 0xffffffffu;  // larger than any real key
constexpr int kInf = 1 << 20;

__device__ __forceinline__ void insert(unsigned key, unsigned& k1, unsigned& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
hamming_best2_kernel(const uint4* __restrict__ q_desc, const float* __restrict__ q_u,
                     const float* __restrict__ q_v, const float* __restrict__ q_r,
                     const int* __restrict__ q_lo, const int* __restrict__ q_hi,
                     const bool* __restrict__ q_ok, int M,
                     const uint4* __restrict__ c_desc, const float* __restrict__ c_x,
                     const float* __restrict__ c_y, const int* __restrict__ c_oct,
                     const bool* __restrict__ c_ok, int N,
                     int* __restrict__ best, int* __restrict__ second,
                     int* __restrict__ best_idx, int* __restrict__ second_idx) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  unsigned k1 = kNone, k2 = kNone;
  if (q_ok[row]) {
    const float u = q_u[row], v = q_v[row], r = q_r[row];
    const int lo = q_lo[row], hi = q_hi[row];
    const uint4 a0 = q_desc[2 * row], a1 = q_desc[2 * row + 1];
    for (int j = lane; j < N; j += 32) {
      if (!c_ok[j]) continue;
      const int o = c_oct[j];
      if (o < lo || o > hi) continue;
      if (!(fabsf(u - c_x[j]) < r) || !(fabsf(v - c_y[j]) < r)) continue;
      const uint4 b0 = c_desc[2 * j], b1 = c_desc[2 * j + 1];
      const unsigned d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      insert((d << kIdxBits) | (unsigned)j, k1, k2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    // top-2 of the union of two sorted pairs of distinct keys
    const unsigned n1 = min(k1, o1);
    const unsigned n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
  if (lane == 0) {
    const unsigned mask = (1u << kIdxBits) - 1u;
    best[row] = k1 == kNone ? kInf : (int)(k1 >> kIdxBits);
    best_idx[row] = k1 == kNone ? 0 : (int)(k1 & mask);
    second[row] = k2 == kNone ? kInf : (int)(k2 >> kIdxBits);
    second_idx[row] = k2 == kNone ? 0 : (int)(k2 & mask);
  }
}

}  // namespace

extern "C" int hamming_best2_launch(const void* q_desc, const void* q_u, const void* q_v,
                                    const void* q_r, const void* q_lo, const void* q_hi,
                                    const void* q_ok, int M, const void* c_desc,
                                    const void* c_x, const void* c_y, const void* c_oct,
                                    const void* c_ok, int N, void* best, void* second,
                                    void* best_idx, void* second_idx, void* stream) {
  if (N >= (1 << kIdxBits) || M < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const int blocks = (M + kWarps - 1) / kWarps;
  hamming_best2_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)q_desc, (const float*)q_u, (const float*)q_v, (const float*)q_r,
      (const int*)q_lo, (const int*)q_hi, (const bool*)q_ok, M, (const uint4*)c_desc,
      (const float*)c_x, (const float*)c_y, (const int*)c_oct, (const bool*)c_ok, N,
      (int*)best, (int*)second, (int*)best_idx, (int*)second_idx);
  return (int)cudaGetLastError();
}
