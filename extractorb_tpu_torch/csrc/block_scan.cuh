// Block-wide exclusive prefix sum of one int per thread, for the selection
// kernels K16 and K17 and K3's grid.  Every thread of the block must call
// it; it returns the sum of the values of the threads with a lower index
// and writes the block's total to *total.  `scratch` holds 33 ints of
// shared memory.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    scratch[lane] = s;  // inclusive sums of the warps
    if (lane == 31) scratch[32] = s;
  }
  __syncthreads();
  const int out = x - v + (warp ? scratch[warp - 1] : 0);
  *total = scratch[32];
  __syncthreads();  // scratch may be reused by the next call
  return out;
}

}  // namespace
