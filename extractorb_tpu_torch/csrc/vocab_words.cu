// K11 vocab_words: vocabulary-tree descent of binary descriptors to words.
//
// Replaces extractorb_tpu/place/vocab.py:transform_words_device, which the
// TPU runs as L batched Hamming argmins: per level it gathers each
// descriptor's k child descriptors, unpacks both to 256 bit-planes and takes
// the distances as a bf16 einsum on the MXU.  Here one warp descends for one
// descriptor: at each level lane c (< k) reads child c's 32 bytes as eight
// 32-bit words, XORs them with the descriptor and popcounts; a shuffle
// min-reduction of the key (distance << 5 | c) picks the closest child, the
// lowest index on a tie (jnp.argmin's rule; padded slots repeat child 0, so
// their ties resolve to the real child).  A -1 id met on the way down
// indexes the level's last row, as the JAX gather wraps negative indices.
//
// Tables: all levels stacked, desc (R, k, 32) u8 and id (R, k) int32, with
// meta = [first row of each level (L), rows of each level (L)].
//
// Bound on the H100: latency of the L dependent table reads per descriptor
// (each ~k x 32 bytes from L2 or HBM); 1000 descriptors are 32 warps of
// work, a fraction of one wave, so the kernel time is the chain of L reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
vocab_words_kernel(const uint32_t* __restrict__ q, int N, const uint32_t* __restrict__ desc,
                   const int* __restrict__ ids, const int* __restrict__ meta, int k, int L,
                   int* __restrict__ out) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = q[8 * n + i];
  int node = 0;
  for (int lvl = 0; lvl < L; ++lvl) {
    const int first = meta[lvl], rows = meta[L + lvl];
    int r = node % rows;
    if (r < 0) r += rows;
    const long long row = (long long)first + r;
    unsigned key = 0xffffffffu;
    if (lane < k) {
      const uint32_t* b = desc + (row * k + lane) * 8;
      unsigned d = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) d += __popc(a[i] ^ b[i]);
      key = (d << 5) | (unsigned)lane;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
    node = ids[row * k + (key & 31u)];
  }
  if (lane == 0) out[n] = node;
}

}  // namespace

extern "C" int vocab_words_launch(const void* q, int N, const void* desc, const void* ids,
                                  const void* meta, int k, int L, void* out, void* stream) {
  if (N < 0 || k <= 0 || k > 32 || L <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  vocab_words_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, N, (const uint32_t*)desc, (const int*)ids, (const int*)meta, k, L,
      (int*)out);
  return (int)cudaGetLastError();
}
