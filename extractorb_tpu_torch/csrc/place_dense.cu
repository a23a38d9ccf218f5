// K29 place_dense: dense BoW place scoring of one shard's keyframe block.
//
// Replaces extractorb_tpu/dist/kf_blocks.py:sharded_place_scores, one shard
// of its shard_map (the TPU runs it as one MXU-shaped pass over the shard's
// dense histograms).  For each keyframe row k of the block:
//   score[k]  = valid[k] ? 1 - 0.5 sum_w |h[k,w] - q[w]| : -inf
//   common[k] = sum_w (has[k,w] && q[w] > 0)
// with q the query's dense histogram, replicated on every shard.
//
// One CTA per row: each thread walks the row with a stride of the block
// (float4 / uchar4 loads when W is a multiple of 4 and the rows are 16-byte
// aligned), then the threads' sums go through a fixed xor tree in each warp
// and the warps in order, so a score depends only on its inputs.
//
// Bound on the H100: bytes.  A query reads the block once (W floats and W
// bools a row, 5 bytes a word) and q from L2; at K = 1024, W = 65536 that is
// 335 MB, 0.10 ms at 3.35 TB/s.  The 1024 rows keep ~8 CTAs on each SM in
// flight, enough loads outstanding to stream the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void acc1(float h, bool has, float q, float& d, int& c) {
  d += fabsf(h - q);
  c += (has && q > 0.f) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
place_dense_kernel(const float* __restrict__ h, const bool* __restrict__ has,
                   const bool* __restrict__ valid, const float* __restrict__ q, int W, bool vec,
                   float* __restrict__ scores, int* __restrict__ common) {
  __shared__ float red_d[kThreads / 32];
  __shared__ int red_c[kThreads / 32];
  const int k = blockIdx.x;
  const float* hr = h + (size_t)k * W;
  const bool* mr = has + (size_t)k * W;
  float d = 0.f;
  int c = 0;
  if (vec) {
    const float4* h4 = reinterpret_cast<const float4*>(hr);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mr);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = threadIdx.x; i < W / 4; i += kThreads) {
      const float4 a = h4[i], b = q4[i];
      const uchar4 m = m4[i];
      acc1(a.x, m.x != 0, b.x, d, c);
      acc1(a.y, m.y != 0, b.y, d, c);
      acc1(a.z, m.z != 0, b.z, d, c);
      acc1(a.w, m.w != 0, b.w, d, c);
    }
  } else {
    for (int i = threadIdx.x; i < W; i += kThreads) acc1(hr[i], mr[i], q[i], d, c);
  }
  for (int o = 16; o > 0; o >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_d[warp] = d;
    red_c[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sd = 0.f;
    int sc = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      sd += red_d[w];
      sc += red_c[w];
    }
    scores[k] = valid[k] ? 1.f - 0.5f * sd : -INFINITY;
    common[k] = sc;
  }
}

}  // namespace

// hists (K,W) float32, has (K,W) bool, valid (K,) bool, q (W,) float32 on
// one device; scores (K,) float32, common (K,) int32
extern "C" int place_dense_launch(const void* hists, const void* has, const void* valid,
                                  const void* q, int K, int W, void* scores, void* common,
                                  void* stream) {
  if (K < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  const bool vec = (W % 4) == 0 && ((uintptr_t)hists % 16) == 0 && ((uintptr_t)has % 4) == 0 &&
                   ((uintptr_t)q % 16) == 0;
  place_dense_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hists, (const bool*)has, (const bool*)valid, (const float*)q, W, vec,
      (float*)scores, (int*)common);
  return (int)cudaGetLastError();
}
