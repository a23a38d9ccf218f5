// K17 octree_select: quadtree distribution, per-level compaction and the
// cross-level front-pack of the collected keypoints, all in one launch: one
// thread-block cluster with a CTA per level.
//
// Replaces extractorb_tpu/frontend/octree.py:distribute_device,
// extractor.py:_compact, :_truncate_key and :_truncate.  On the TPU these
// are two K-element sorts per level (the path codes, then (cell, -response)
// stably), a top_k per level and an argsort over the merged slots.  None of
// the sorts is needed for the result, and this kernel takes none.
//
// Per level (K <= 8192 candidates, at most 8 a thread, kept in registers):
//   1. each valid candidate's quadtree path code (top-level x cell, then one
//      (by, bx) child-bit pair per depth) as px[x] | py[y], the plan's
//      per-axis tables (octree.py:path_code_tables); the depth-d cell of a
//      keypoint is the code's prefix p >> 2(7-d), and the codes are below
//      n_ini * 4^7, so each candidate sets its bit in an occupancy bitmap of
//      the depth-7 cells in shared memory;
//   2. the occupied cells at each depth: groups of 4^(7-d) bits OR-folded
//      within a word (depths 7-5), over a warp's ballot of non-empty words
//      (depths 4-2) and over the warps' flags (depths 1 and 0), popcounted;
//      the depth used is the first whose count reaches the budget, else 7;
//   3. at that depth, an atomicMax of resp * K + (K - 1 - i) in a table
//      indexed by cell (n_ini * 4^d ints: in shared memory up to kTabCap,
//      else in the workspace) keeps each cell's argmax-response keypoint
//      with the earliest index on ties -- the stable sort's winner;
//   4. the kept keypoints' keys resp * K - i (taken when >= 0, as top_k's
//      valid test) are placed in descending order without sorting: a
//      256-bin histogram of their responses (the atomicAdd's return is the
//      key's place in its bin's list), a block scan of the bins from the
//      top, and each key's slot = the keys of the bins above + the larger
//      keys of its own bin (the keys are unique), as K16 places its keys;
//      the first cap_l are the level's compacted slots, zeros after them.
// Then a cluster barrier, and each CTA reads every level's slot count over
// DSMEM and writes its own keys into the merged Features at the lower
// levels' total (the caps sum to at least the merged capacity, so this is
// _truncate's stable front-pack): level-0 coordinates (x * scale in
// float32), response, octave, size 31 * scale, valid, and the integer inner
// coordinates K2 reads; the slots past the last key are zeroed (octave -1).
//
// Bound on the H100: latency.  The data are 13,824 candidates (~150 KB)
// in and 1128 slots out at 640x480.  Every level's CTA takes about the
// same ~18-20K cycles (chip_anatomy.py k17): the block barriers and the
// dependent shared-memory steps between them, not the candidates, set the
// time.  Level 0's 4096 candidates (four a thread) add ~2.5K cycles to its
// first phase over level 7's 512; spreading them over more CTAs would add
// cluster barriers between the phases, and the pack phase, with two of
// them, takes 4-8K cycles, so level 0 keeps one CTA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "block_scan.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 16;
constexpr int kThreads = 1024;
constexpr int kPer = 8;          // candidates a thread at most
constexpr int kDMax = 7;
constexpr int kBins = 256;
constexpr int kTabCap = 16384;   // ints of the cell table in shared memory (extractor.py)
constexpr int kMaxDevices = 64;
constexpr unsigned kNoPath = 0xffffffffu;

// the phase kinds of chip_anatomy.py's build, which stamps clock64() in
// each CTA's thread 0; nothing otherwise
#ifndef K17_STAMP
#define K17_STAMP(kind)
#endif
enum Phase : int { kPath = 0, kCount, kArgmax, kHist, kPlace, kPack, kPhases };

struct SelLevel {
  int k, k_off, cap, cap_off, budget, min_x, min_y, w, h, t_px, t_py, n_ini, ws_off;
  float scale;
};

struct SelTab {
  int n_levels, n_out, words, list_n;  // words: bitmap words (n_ini * 512) of the widest level
  SelLevel lv[kMaxLevels];
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
octree_select_kernel(const int* __restrict__ cxy, const int* __restrict__ cresp,
                     const uint8_t* __restrict__ cvalid, const int* __restrict__ tables,
                     const SelTab tab, int* __restrict__ ws, int* __restrict__ lxy,
                     int* __restrict__ lresp, uint8_t* __restrict__ lvalid,
                     int* __restrict__ depth_out, int* __restrict__ xy,
                     int* __restrict__ octave, uint8_t* __restrict__ valid,
                     float* __restrict__ xy_f, float* __restrict__ response,
                     float* __restrict__ size) {
  extern __shared__ int4 s_dyn[];
  int2* s_list = reinterpret_cast<int2*>(s_dyn);  // the kept (key, index), by bin
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_list + tab.list_n);  // depth-7 cells
  int* s_tab = reinterpret_cast<int*>(s_bits + tab.words);              // kTabCap
  int* s_flag = s_tab + kTabCap;                  // a non-empty word among 32, each
  __shared__ int s_hist[kBins];
  __shared__ int s_base[kBins];
  __shared__ int s_cnt[kDMax + 1];
  __shared__ int s_scan[33];
  __shared__ int s_pre[kMaxLevels + 1];
  __shared__ int s_n;  // this level's slots, read by the cluster
  cg::cluster_group cl = cg::this_cluster();
  const int lvl = (int)cl.block_rank();
  const SelLevel L = tab.lv[lvl];
  const int K = L.k, tid = threadIdx.x, lane = tid & 31;
  const int n_words = L.n_ini * 512;
  const int2* cand_xy = reinterpret_cast<const int2*>(cxy) + L.k_off;
  const int* resp = cresp + L.k_off;
  const uint8_t* cand_ok = cvalid + L.k_off;
  K17_STAMP(kPhases);  // the start

  // 1. path codes, and the occupancy bitmap of the depth-7 cells
  for (int w = tid; w < n_words; w += kThreads) s_bits[w] = 0;
  for (int b = tid; b < kBins; b += kThreads) s_hist[b] = 0;
  if (tid <= kDMax) s_cnt[tid] = 0;
  unsigned path[kPer];
  int rsp[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads;
    path[m] = kNoPath;
    rsp[m] = 0;
    if (i < K && cand_ok[i]) {
      const int2 p = cand_xy[i];
      const int x = min(max(p.x - L.min_x, 0), L.w - 1);
      const int y = min(max(p.y - L.min_y, 0), L.h - 1);
      path[m] = (unsigned)(tables[L.t_px + x] | tables[L.t_py + y]);
      rsp[m] = resp[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (path[m] != kNoPath) atomicOr(&s_bits[path[m] >> 5], 1u << (path[m] & 31));
  __syncthreads();
  K17_STAMP(kPath);

  // 2. occupied cells per depth, and the depth used
  {
    int c7 = 0, c6 = 0, c5 = 0, c4 = 0, c3 = 0, c2 = 0;
    for (int w = tid; w < n_words; w += kThreads) {  // whole warps: n_words % 32 == 0
      const unsigned b = s_bits[w];
      unsigned a = b | (b >> 1);
      a = (a | (a >> 2)) & 0x11111111u;         // a bit a depth-6 cell (4 bits)
      unsigned e = a | (a >> 4);
      e = (e | (e >> 8)) & 0x00010001u;         // a bit a depth-5 cell (16 bits)
      c7 += __popc(b);
      c6 += __popc(a);
      c5 += __popc(e);
      const unsigned nz = __ballot_sync(0xffffffffu, b != 0);
      if (lane == 0) {
        unsigned f = nz | (nz >> 1);
        c4 += __popc(f & 0x55555555u);          // 2 words a depth-4 cell
        f |= f >> 2;
        f |= f >> 4;
        c3 += __popc(f & 0x01010101u);          // 8 words a depth-3 cell
        c2 += nz != 0;                          // 32 words a depth-2 cell
        s_flag[w >> 5] = nz != 0;
      }
    }
    c7 = warp_sum(c7);
    c6 = warp_sum(c6);
    c5 = warp_sum(c5);
    if (lane == 0 && (c7 | c4 | c3 | c2)) {
      atomicAdd(&s_cnt[7], c7);
      atomicAdd(&s_cnt[6], c6);
      atomicAdd(&s_cnt[5], c5);
      atomicAdd(&s_cnt[4], c4);
      atomicAdd(&s_cnt[3], c3);
      atomicAdd(&s_cnt[2], c2);
    }
  }
  __syncthreads();
  {
    const int n_flags = n_words >> 5;  // 4 flags a depth-1 cell, 16 a depth-0 cell
    int any1 = 0, any0 = 0;
    if (tid < n_flags / 4)
      any1 = s_flag[4 * tid] | s_flag[4 * tid + 1] | s_flag[4 * tid + 2] | s_flag[4 * tid + 3];
    if (tid < n_flags / 16)
      for (int f = 16 * tid; f < 16 * tid + 16; ++f) any0 |= s_flag[f];
    if (any1) atomicAdd(&s_cnt[1], 1);
    if (any0) atomicAdd(&s_cnt[0], 1);
  }
  __syncthreads();
  int depth = kDMax;
  for (int d = kDMax; d >= 0; --d)
    if (s_cnt[d] >= L.budget) depth = d;
  const int sh = 2 * (kDMax - depth);
  K17_STAMP(kCount);

  // 3. each cell's best keypoint at that depth
  const int n_tab = L.n_ini << (2 * depth);
  int* cell_best = n_tab <= kTabCap ? s_tab : ws + L.ws_off;
  for (int c = tid; c < n_tab; c += kThreads) cell_best[c] = INT_MIN;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (path[m] != kNoPath) {
      const int i = tid + m * kThreads;
      atomicMax(&cell_best[path[m] >> sh], rsp[m] * K + (K - 1 - i));
    }
  __syncthreads();
  K17_STAMP(kArgmax);

  // 4. the kept keys, keyed resp * K - i as _compact's top_k, by response bin
  int pos[kPer];  // the key's place in its bin's list, -1 if not kept
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads;
    pos[m] = -1;
    if (path[m] != kNoPath && cell_best[path[m] >> sh] == rsp[m] * K + (K - 1 - i) &&
        rsp[m] * K - i >= 0)
      pos[m] = atomicAdd(&s_hist[min(max(rsp[m], 0), kBins - 1)], 1);
  }
  __syncthreads();
  {  // the keys of the bins above each bin: a scan from the top bin down
    const int b = kBins - 1 - tid;
    int total;
    const int excl = block_exclusive_scan(tid < kBins ? s_hist[b] : 0, s_scan, &total);
    if (tid < kBins) s_base[b] = excl;
    if (tid == 0) s_n = min(total, L.cap);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (pos[m] >= 0) {
      const int i = tid + m * kThreads;
      s_list[s_base[min(max(rsp[m], 0), kBins - 1)] + pos[m]] = make_int2(rsp[m] * K - i, i);
    }
  __syncthreads();
  K17_STAMP(kHist);

  // 5. the top cap_l keys in descending order: a key's slot is the keys of
  //    the bins above and the larger keys of its own bin
  const int n_write = s_n;
  int slot[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    slot[m] = -1;
    if (pos[m] < 0) continue;
    const int b = min(max(rsp[m], 0), kBins - 1), base = s_base[b];
    if (base >= n_write) continue;
    const int i = tid + m * kThreads, key = rsp[m] * K - i;
    int larger = 0;
    for (int e = base; e < base + s_hist[b]; ++e) larger += s_list[e].x > key;
    if (base + larger >= n_write) continue;
    slot[m] = base + larger;
    const int s = L.cap_off + slot[m];
    const int2 p = cand_xy[i];
    lxy[2 * s] = p.x;
    lxy[2 * s + 1] = p.y;
    lresp[s] = rsp[m];
    lvalid[s] = 1;
  }
  for (int j = n_write + tid; j < L.cap; j += kThreads) {
    const int s = L.cap_off + j;
    lxy[2 * s] = 0;
    lxy[2 * s + 1] = 0;
    lresp[s] = 0;
    lvalid[s] = 0;
  }
  if (tid == 0) depth_out[lvl] = depth;
  K17_STAMP(kPlace);

  // 6. the pack: every level's count over DSMEM behind a cluster barrier;
  //    the arrive after the reads and the wait at the end keep each CTA's
  //    shared memory alive until the last read
  cl.sync();
  if (tid < tab.n_levels) s_pre[tid + 1] = *cl.map_shared_rank(&s_n, tid);
  __syncthreads();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (tid == 0) {
    s_pre[0] = 0;
    for (int r = 0; r < tab.n_levels; ++r) s_pre[r + 1] += s_pre[r];
  }
  __syncthreads();
  const int pre = s_pre[lvl], n_packed = min(s_pre[tab.n_levels], tab.n_out);
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int s = pre + slot[m];
    if (slot[m] < 0 || s >= tab.n_out) continue;
    const int2 p = cand_xy[tid + m * kThreads];
    xy[2 * s] = p.x;
    xy[2 * s + 1] = p.y;
    octave[s] = lvl;
    valid[s] = 1;
    xy_f[2 * s] = (float)p.x * L.scale;
    xy_f[2 * s + 1] = (float)p.y * L.scale;
    response[s] = (float)rsp[m];
    size[s] = 31.0f * L.scale;
  }
  for (int s = n_packed + lvl * kThreads + tid; s < tab.n_out; s += tab.n_levels * kThreads) {
    xy[2 * s] = 0;
    xy[2 * s + 1] = 0;
    octave[s] = -1;
    valid[s] = 0;
    xy_f[2 * s] = 0.0f;
    xy_f[2 * s + 1] = 0.0f;
    response[s] = 0.0f;
    size[s] = 0.0f;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  K17_STAMP(kPack);
}

// the kernel's attributes on the current device: clusters of up to 16 CTAs,
// and the dynamic shared memory limit raised to the most asked for
cudaError_t prepare(int smem) {
  static int done[kMaxDevices] = {};  // the largest smem set + 1, 0 before the first call
  int dev;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] > smem) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(octree_select_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(octree_select_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return e;
  done[dev] = smem + 1;
  return cudaSuccess;
}

}  // namespace

// tab_host (int32 words): n_levels, n_out, words, list_n, then per level k,
// k_off, cap, cap_off, budget, min_x, min_y, w, h, t_px, t_py, n_ini, ws_off
// and the float32 scale's bits.  ws: the cell tables of the levels whose
// n_ini * 4^7 cells pass kTabCap (at ws_off), else unused (may be null).
extern "C" int octree_select_launch(const void* cxy, const void* cresp, const void* cvalid,
                                    const void* tables, const int* tab_host, void* ws,
                                    void* lxy, void* lresp, void* lvalid, void* depth,
                                    void* xy, void* octave, void* valid, void* xy_f,
                                    void* response, void* size, void* stream) {
  SelTab tab;
  tab.n_levels = tab_host[0];
  tab.n_out = tab_host[1];
  tab.words = tab_host[2];
  tab.list_n = tab_host[3];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels || tab.words % 512 != 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < tab.n_levels; ++l) {
    const int* r = tab_host + 4 + 14 * l;
    SelLevel& L = tab.lv[l];
    L = SelLevel{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10], r[11],
                 r[12], 0.0f};
    memcpy(&L.scale, r + 13, sizeof(float));
    if (L.k > kPer * kThreads || L.k > tab.list_n || L.n_ini * 512 > tab.words ||
        L.w < 1 || L.h < 1 || (L.n_ini * 16384 > kTabCap && (L.ws_off < 0 || ws == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = tab.list_n * 8 + tab.words * 4 + kTabCap * 4 + (tab.words / 32) * 4;
  cudaError_t e = prepare(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(tab.n_levels);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tab.n_levels;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, octree_select_kernel, (const int*)cxy, (const int*)cresp,
                         (const uint8_t*)cvalid, (const int*)tables, tab, (int*)ws, (int*)lxy,
                         (int*)lresp, (uint8_t*)lvalid, (int*)depth, (int*)xy, (int*)octave,
                         (uint8_t*)valid, (float*)xy_f, (float*)response, (float*)size);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
