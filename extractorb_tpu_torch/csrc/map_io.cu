// K8 map_io: the two data-movement kernels between the host map and the card.
//
// pack_i32 replaces extractorb_tpu/utils/packed_fetch.py:_pack_prog: it packs
// a list of device arrays into one int32 buffer, so that the host fetches
// everything a decision needs with one copy.  float32/int32/uint32 words are
// copied bit for bit; uint8, int8 and bool are widened to int32; int64 counts
// are narrowed to int32.  The segment
// table (pointers, start offsets, kinds) travels in the kernel's parameter
// space, up to kMaxSeg segments per launch; longer lists take more launches.
// Each thread finds its segment by binary search over the start offsets.
//
// mirror_scatter replaces extractorb_tpu/slam/track_device.py:_mirror_update_prog:
// rows[i] of the (cap,3) f32 positions and (cap,) bool validity take
// new_pos[i] / new_valid[i]; rows outside [0, cap) are dropped (the padding
// of the row bucket).  It writes in place: every reader of the mirror runs
// on the same stream, so stream order keeps earlier readers correct.
//
// Bound on the H100: launch latency.  The payloads are kilobytes (a few
// thousand words per fetch, at most 16384 rows per scatter), far below what
// moves memory bandwidth; one launch each keeps the cost at one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 128;
constexpr int kThreads = 256;

enum Kind : int { kWord = 0, kU8 = 1, kI8 = 2, kBool = 3, kI64 = 4 };

struct Segments {
  const void* ptr[kMaxSeg];
  long long start[kMaxSeg + 1];  // start[n] is the total length
  int kind[kMaxSeg];
  int n;
};

__global__ void __launch_bounds__(kThreads)
pack_kernel(const Segments s, int* __restrict__ out) {
  const long long total = s.start[s.n];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    // the last segment whose start is <= i (empty segments are skipped)
    int lo = 0, hi = s.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s.start[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const long long j = i - s.start[lo];
    int v;
    switch (s.kind[lo]) {
      case kWord: v = static_cast<const int*>(s.ptr[lo])[j]; break;
      case kU8: v = static_cast<const uint8_t*>(s.ptr[lo])[j]; break;
      case kI8: v = static_cast<const int8_t*>(s.ptr[lo])[j]; break;
      case kI64: v = (int)static_cast<const long long*>(s.ptr[lo])[j]; break;
      default: v = static_cast<const uint8_t*>(s.ptr[lo])[j] != 0; break;
    }
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
mirror_scatter_kernel(float* __restrict__ pos, bool* __restrict__ valid, int cap,
                      const int* __restrict__ rows, const float* __restrict__ new_pos,
                      const bool* __restrict__ new_valid, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int r = rows[i];
  if (r < 0 || r >= cap) return;  // padding rows are dropped
  pos[3 * r] = new_pos[3 * i];
  pos[3 * r + 1] = new_pos[3 * i + 1];
  pos[3 * r + 2] = new_pos[3 * i + 2];
  valid[r] = new_valid[i];
}

}  // namespace

// ptrs/counts/kinds are host arrays of n entries; out holds sum(counts) int32.
extern "C" int pack_i32_launch(const void* const* ptrs, const long long* counts,
                               const int* kinds, int n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  int* dst = static_cast<int*>(out);
  for (int first = 0; first < n; first += kMaxSeg) {
    Segments s;
    s.n = n - first < kMaxSeg ? n - first : kMaxSeg;
    long long total = 0;
    for (int k = 0; k < s.n; ++k) {
      s.ptr[k] = ptrs[first + k];
      s.kind[k] = kinds[first + k];
      s.start[k] = total;
      total += counts[first + k];
    }
    s.start[s.n] = total;
    if (total > 0) {
      long long blocks = (total + kThreads - 1) / kThreads;
      if (blocks > 4096) blocks = 4096;
      pack_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(s, dst);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    dst += total;
  }
  return (int)cudaGetLastError();
}

extern "C" int mirror_scatter_launch(void* pos, void* valid, int cap, const void* rows,
                                     const void* new_pos, const void* new_valid, int b,
                                     void* stream) {
  if (b < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (b > 0) {
    mirror_scatter_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<float*>(pos), static_cast<bool*>(valid), cap, static_cast<const int*>(rows),
        static_cast<const float*>(new_pos), static_cast<const bool*>(new_valid), b);
  }
  return (int)cudaGetLastError();
}
