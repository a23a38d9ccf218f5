// K17 octree_select: quadtree distribution, per-level compaction and the
// cross-level front-pack of the collected keypoints, every level in one
// launch (one CTA per level), then one small launch for the pack.
//
// Replaces extractorb_tpu/frontend/octree.py:distribute_device,
// extractor.py:_compact, :_truncate_key and :_truncate.  On the TPU these
// are two K-element sorts per level (the path codes, then (cell, -response)
// stably), a top_k per level and an argsort over the merged slots.
//
// Per level (K <= 4096 candidates, all in shared memory):
//   1. each valid candidate's quadtree path code (top-level x cell, then one
//      (by, bx) child-bit pair per depth) from the plan's depth-7 edges and
//      path-bit tables; the depth-d cell of a keypoint is the code's prefix
//      p >> 2(7-d), so one ascending bitonic sort of (path, index) makes
//      every depth's cells contiguous runs;
//   2. the occupied cells at each depth are the run heads; the depth used is
//      the first whose count reaches the budget, else 7;
//   3. a block prefix sum over the heads at that depth numbers the cells;
//      an atomicMax of resp * K + (K - 1 - i) per cell keeps the
//      argmax-response keypoint with the earliest index on ties -- the
//      stable sort's winner, without the second sort;
//   4. the kept keypoints' keys resp * K - i (taken when >= 0, as top_k's
//      valid test) are sorted descending and the first cap_l written: the
//      level's compacted slots, zeros after them.
// The pack kernel then front-packs the valid slots of all levels in level
// order (the caps sum to the merged capacity, so this is _truncate's
// stable argsort) and writes the merged Features' fields: level-0
// coordinates (x * scale in float32), response, octave (-1 when invalid),
// size 31 * scale, valid, and the integer inner coordinates K2 reads.
//
// Bound on the H100: latency of the in-CTA sorts (78 bitonic stages of
// 4096 keys at level 0) and syncs; the data are 13,824 candidates (~150 KB)
// in and 1128 slots out.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 1024;
constexpr int kDMax = 7;
constexpr unsigned kSent = 1u << 30;

struct SelLevel {
  int k, k_off, cap, cap_off, budget, min_x, min_y;
  int nxe, nye, t_xe, t_ye, t_bx, t_by, t_topx;
  float scale;
};

struct SelTab {
  int n_levels, sort_n, n_out;
  SelLevel lv[kMaxLevels];
};

__device__ __forceinline__ int upper_bound(const int* e, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
octree_level_kernel(const int* __restrict__ cxy, const int* __restrict__ cresp,
                    const uint8_t* __restrict__ cvalid, const int* __restrict__ tables,
                    const SelTab tab, int* __restrict__ lxy, int* __restrict__ lresp,
                    uint8_t* __restrict__ lvalid, int* __restrict__ depth_out,
                    int* __restrict__ n_out) {
  extern __shared__ unsigned long long s_key[];  // sort_n keys, then two int arrays
  int* s_best = reinterpret_cast<int*>(s_key + tab.sort_n);
  int* s_grp = s_best + tab.sort_n;
  __shared__ int s_scan[33];
  __shared__ int s_cnt[kDMax + 1];
  __shared__ int s_n;
  const SelLevel L = tab.lv[blockIdx.x];
  const int K = L.k, tid = threadIdx.x, n = tab.sort_n;
  const int* xy = cxy + 2 * L.k_off;
  const int* resp = cresp + L.k_off;
  const uint8_t* valid = cvalid + L.k_off;

  // 1. path codes, sorted with the candidate index
  for (int i = tid; i < n; i += kThreads) {
    unsigned path = 0xffffffffu;  // padding sorts last
    if (i < K) {
      path = kSent;
      if (valid[i]) {
        const int cx = upper_bound(tables + L.t_xe, L.nxe, xy[2 * i] - L.min_x);
        const int cy = upper_bound(tables + L.t_ye, L.nye, xy[2 * i + 1] - L.min_y);
        const int kx = tables[L.t_bx + cx], ky = tables[L.t_by + cy];
        unsigned morton = 0;
        for (int b = 0; b < kDMax; ++b)
          morton |= (unsigned)(((kx >> b) & 1) | (((ky >> b) & 1) << 1)) << (2 * b);
        path = ((unsigned)tables[L.t_topx + cx] << (2 * kDMax)) | morton;
      }
    }
    s_key[i] = ((unsigned long long)path << 32) | (unsigned)i;
    s_best[i] = -1;
  }
  if (tid <= kDMax) s_cnt[tid] = 0;
  if (tid == 0) s_n = 0;
  __syncthreads();
  block_bitonic_sort(s_key, n, false);

  // 2. occupied cells per depth, and the depth used
  int cnt[kDMax + 1] = {0};
  for (int j = tid; j < K; j += kThreads) {
    const unsigned p = (unsigned)(s_key[j] >> 32);
    if (p >= kSent) continue;
    const unsigned q = j ? (unsigned)(s_key[j - 1] >> 32) : 0u;
#pragma unroll
    for (int d = 0; d <= kDMax; ++d) {
      const int sh = 2 * (kDMax - d);
      cnt[d] += j == 0 || (p >> sh) != (q >> sh);
    }
  }
#pragma unroll
  for (int d = 0; d <= kDMax; ++d)
    if (cnt[d]) atomicAdd(&s_cnt[d], cnt[d]);
  __syncthreads();
  int depth = kDMax;
  for (int d = kDMax; d >= 0; --d)
    if (s_cnt[d] >= L.budget) depth = d;
  const int sh = 2 * (kDMax - depth);

  // 3. number the cells at that depth (runs of equal prefix) and keep each
  //    cell's best keypoint
  const int per = (K + kThreads - 1) / kThreads;
  const int j0 = min(K, tid * per), j1 = min(K, j0 + per);
  auto head = [&](int j) {
    const unsigned p = (unsigned)(s_key[j] >> 32);
    if (p >= kSent) return false;
    return j == 0 || (p >> sh) != ((unsigned)(s_key[j - 1] >> 32) >> sh);
  };
  int heads = 0;
  for (int j = j0; j < j1; ++j) heads += head(j);
  int total;
  int g = block_exclusive_scan(heads, s_scan, &total) - 1;
  for (int j = j0; j < j1; ++j) {
    g += head(j);
    const unsigned p = (unsigned)(s_key[j] >> 32);
    s_grp[j] = p < kSent ? g : -1;
    if (p < kSent) {
      const int i = (int)(s_key[j] & 0xffffffffu);
      atomicMax(&s_best[g], resp[i] * K + (K - 1 - i));
    }
  }
  __syncthreads();
  // the kept keypoints (one a cell), keyed resp * K - i as _compact's top_k
  unsigned long long kept_key[8];
  int n_kept = 0;
  for (int j = j0; j < j1; ++j) {
    const int gj = s_grp[j];
    if (gj < 0) continue;
    const int i = (int)(s_key[j] & 0xffffffffu);
    const int r = resp[i];
    if (s_best[gj] == r * K + (K - 1 - i) && r * K - i >= 0)
      kept_key[n_kept++] = ((unsigned long long)(unsigned)(r * K - i) << 32) | (unsigned)i;
  }
  __syncthreads();  // s_key is rewritten below
  for (int m = 0; m < n_kept; ++m) s_key[atomicAdd(&s_n, 1)] = kept_key[m];
  __syncthreads();
  const int n_taken = s_n;
  for (int j = n_taken + tid; j < n; j += kThreads) s_key[j] = 0ull;
  __syncthreads();

  // 4. the top cap_l by key, descending
  block_bitonic_sort(s_key, n, true);
  const int n_write = min(n_taken, L.cap);
  for (int j = tid; j < L.cap; j += kThreads) {
    const int slot = L.cap_off + j;
    if (j < n_write) {
      const int i = (int)(s_key[j] & 0xffffffffu);
      lxy[2 * slot] = xy[2 * i];
      lxy[2 * slot + 1] = xy[2 * i + 1];
      lresp[slot] = resp[i];
      lvalid[slot] = 1;
    } else {
      lxy[2 * slot] = 0;
      lxy[2 * slot + 1] = 0;
      lresp[slot] = 0;
      lvalid[slot] = 0;
    }
  }
  if (tid == 0) {
    depth_out[blockIdx.x] = depth;
    n_out[blockIdx.x] = n_write;
  }
}

__global__ void __launch_bounds__(kThreads)
octree_pack_kernel(const int* __restrict__ lxy, const int* __restrict__ lresp,
                   const int* __restrict__ n_lvl, const SelTab tab, int* __restrict__ xy,
                   int* __restrict__ octave, uint8_t* __restrict__ valid,
                   float* __restrict__ xy_f, float* __restrict__ response,
                   float* __restrict__ size) {
  __shared__ int s_pre[kMaxLevels + 1];
  if (threadIdx.x == 0) {
    s_pre[0] = 0;
    for (int l = 0; l < tab.n_levels; ++l) s_pre[l + 1] = s_pre[l] + n_lvl[l];
  }
  __syncthreads();
  const int total = s_pre[tab.n_levels];
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < tab.n_out; s += gridDim.x * kThreads) {
    if (s < total) {
      int l = 0;
      while (s >= s_pre[l + 1]) ++l;
      const int src = tab.lv[l].cap_off + (s - s_pre[l]);
      const float sc = tab.lv[l].scale;
      const int x = lxy[2 * src], y = lxy[2 * src + 1];
      xy[2 * s] = x;
      xy[2 * s + 1] = y;
      octave[s] = l;
      valid[s] = 1;
      xy_f[2 * s] = (float)x * sc;
      xy_f[2 * s + 1] = (float)y * sc;
      response[s] = (float)lresp[src];
      size[s] = 31.0f * sc;
    } else {
      xy[2 * s] = 0;
      xy[2 * s + 1] = 0;
      octave[s] = -1;
      valid[s] = 0;
      xy_f[2 * s] = 0.0f;
      xy_f[2 * s + 1] = 0.0f;
      response[s] = 0.0f;
      size[s] = 0.0f;
    }
  }
}

}  // namespace

// tab_host (int32 words): n_levels, sort_n, n_out, then per level k, k_off,
// cap, cap_off, budget, min_x, min_y, nxe, nye, t_xe, t_ye, t_bx, t_by,
// t_topx and the float32 scale's bits.  ws: n_levels ints (valid slots per
// level).
extern "C" int octree_select_launch(const void* cxy, const void* cresp, const void* cvalid,
                                    const void* tables, const int* tab_host, void* lxy,
                                    void* lresp, void* lvalid, void* depth, void* ws, void* xy,
                                    void* octave, void* valid, void* xy_f, void* response,
                                    void* size, void* stream) {
  SelTab tab;
  tab.n_levels = tab_host[0];
  tab.sort_n = tab_host[1];
  tab.n_out = tab_host[2];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (tab.sort_n > 8 * kThreads) return (int)cudaErrorInvalidValue;  // kept_key[8] a thread
  for (int l = 0; l < tab.n_levels; ++l) {
    const int* r = tab_host + 3 + 15 * l;
    SelLevel& L = tab.lv[l];
    L = SelLevel{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10], r[11],
                 r[12], r[13], 0.0f};
    memcpy(&L.scale, r + 14, sizeof(float));
    if (L.k > tab.sort_n) return (int)cudaErrorInvalidValue;
  }
  const int smem = tab.sort_n * (int)(sizeof(unsigned long long) + 2 * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        octree_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  octree_level_kernel<<<tab.n_levels, kThreads, smem, st>>>(
      (const int*)cxy, (const int*)cresp, (const uint8_t*)cvalid, (const int*)tables, tab,
      (int*)lxy, (int*)lresp, (uint8_t*)lvalid, (int*)depth, (int*)ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  octree_pack_kernel<<<1, kThreads, 0, st>>>((const int*)lxy, (const int*)lresp,
                                             (const int*)ws, tab, (int*)xy, (int*)octave,
                                             (uint8_t*)valid, (float*)xy_f, (float*)response,
                                             (float*)size);
  return (int)cudaGetLastError();
}
