// K16 kp_collect: per-level top-K collection of FAST keypoints, every level
// of the pyramid in one launch: a thread-block cluster of G CTAs per level.
//
// Replaces extractorb_tpu/frontend/fast.py:collect_keypoints: a top_k of the
// unique key score << 21 | (2^21 - 1 - idx) over the whole keep/score plane,
// which the TPU computes with a sort of the plane.  The output is the top k
// keys in descending order: score-major, row-major ties.  Invalid slots
// (fewer than k kept pixels) hold the first unkept pixels in row-major
// order, as top_k's order of their equal keys puts them.
//
// The host plan (frontend/fast.py CollectPlan.bands) cuts each level's
// plane into G bands of flat pixels, in row-major order, their inner
// boundaries on 16-pixel segments of K1's flat outputs, so that a thread
// reads a segment as one 16-byte load of `keep` and two of `score`.  CTA
// rank r of level l's cluster takes band r:
//   1. a 256-bin histogram of its kept scores and its count of unkept
//      pixels, in its shared memory; cluster barrier;
//   2. each CTA merges the cluster's histograms over DSMEM and finds the
//      cut c (every kept pixel above c is taken, and of those at c the first
//      `need` in row-major order) by a block scan of the bins, which also
//      gives each bin's base: the taken keys of the bins above it.  The
//      lower ranks' count of each bin and of unkept pixels come with it, as
//      bands lie in rank order;
//   3. a second pass numbers its pixels at c and its unkept ones in
//      row-major order (a block scan a chunk of segments), appends its taken
//      keys to a list in its shared memory and writes the fill pixels'
//      slots;
//   4. it places each of its keys: the keys are unique, so a key's slot is
//      the number of larger keys, its bin's base plus the lower ranks' keys
//      of its bin plus the larger keys of its bin in its own list (a warp a
//      key).  A cluster barrier keeps every CTA's histogram alive until the
//      last DSMEM read.
// Kept pixels always have a score >= the FAST threshold >= 0 (K1), so a
// kept pixel is a valid slot, as in the plain version.
//
// Bound on the H100: latency.  The work is 3 bytes read per pixel of the
// pyramid (1.1 MB of keep + score at 640x480), 0.3 us at 3.35 TB/s; two
// cluster barriers, two passes of a block scan a chunk of segments and the
// placing of a band's keys set the time.  CTAs of 512 threads: G = 16 where
// the card holds one such cluster per level at once
// (cudaOccupancyMaxActiveClusters), else 8.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

namespace cg = cooperative_groups;

#ifndef K16_THREADS
#define K16_THREADS 512
#endif
constexpr int kMaxLevels = 16;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kThreads = K16_THREADS;
static_assert(kThreads >= 257 && kThreads % 32 == 0, "a thread a bin and one more");
constexpr int kSeg = 16;  // pixels a thread reads at once
constexpr int kIdxBits = 21;
constexpr int kIdxMask = (1 << kIdxBits) - 1;

// the phase kinds of chip_anatomy.py's build, which stamps clock64() in the
// first CTA's thread 0; nothing otherwise
#ifndef K16_STAMP
#define K16_STAMP(kind)
#endif
enum Phase : int { kHist = 0, kCut, kNumber, kRank, kPhases };

struct CollectLevel {
  int plane_off, W, H, k, out_off;
  int band[kMaxCluster + 1];  // flat pixel bounds of each rank's band
};

struct CollectTab {
  int n_levels, cluster, list_n, total;  // list_n: ints of a key list (>= every k, % 4 == 0)
  CollectLevel lv[kMaxLevels];
};

// the 16 keep flags and scores of segment g (flat pixels [16 g, 16 g + 16)):
// vector loads inside the flat arrays, element loads for the last one
__device__ __forceinline__ void load_seg(const uint8_t* keep, const int16_t* score, int total,
                                         int g, uint8_t (&kp)[kSeg], int16_t (&sc)[kSeg]) {
  if (kSeg * g + kSeg <= total) {
    const uint4 k4 = reinterpret_cast<const uint4*>(keep)[g];
    const uint4 s0 = reinterpret_cast<const uint4*>(score)[2 * g];
    const uint4 s1 = reinterpret_cast<const uint4*>(score)[2 * g + 1];
    const uint32_t kw[4] = {k4.x, k4.y, k4.z, k4.w};
    const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      kp[j] = (uint8_t)(kw[j >> 2] >> (8 * (j & 3)));
      sc[j] = (int16_t)(sw[j >> 1] >> (16 * (j & 1)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int i = kSeg * g + j;
      kp[j] = i < total ? keep[i] : 0;
      sc[j] = i < total ? score[i] : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kp_collect_kernel(const uint8_t* __restrict__ keep, const int16_t* __restrict__ score,
                  const CollectTab tab, int* __restrict__ xy_out, int* __restrict__ resp_out,
                  uint8_t* __restrict__ valid_out) {
  extern __shared__ int4 s_dyn[];
  int* s_list = reinterpret_cast<int*>(s_dyn);  // this CTA's taken keys (tab.list_n)
  __shared__ int s_hist[257];          // kept scores per bin; [256] the unkept pixels
  __shared__ int s_scan[33];
  __shared__ int s_base[256];          // taken keys of the level above each bin
  __shared__ int s_low[257];           // each bin's kept pixels in the lower ranks' bands; [256] unkept
  __shared__ int s_cnt, s_cut, s_need, s_valid;
  cg::cluster_group cl = cg::this_cluster();
  const int G = tab.cluster;
  const int rank = (int)cl.block_rank();
  const CollectLevel& L = tab.lv[blockIdx.x / G];
  const int a = L.band[rank], b = L.band[rank + 1];
  const int g_lo = a / kSeg, n_seg = b > a ? (b + kSeg - 1) / kSeg - g_lo : 0;
  const int tid = threadIdx.x, lane = tid & 31;
  K16_STAMP(kPhases);  // the start

  // 1. this band's histogram and unkept count
  for (int i = tid; i < 257; i += kThreads) s_hist[i] = 0;
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  {
    int unkept = 0;
    for (int s = tid; s < n_seg; s += kThreads) {
      uint8_t kp[kSeg];
      int16_t sc[kSeg];
      const int g = g_lo + s;
      load_seg(keep, score, tab.total, g, kp, sc);
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int i = kSeg * g + j;
        if (i < a || i >= b) continue;
        if (kp[j])
          atomicAdd(&s_hist[min(max((int)sc[j], 0), 255)], 1);
        else
          ++unkept;
      }
    }
    for (int o = 16; o > 0; o >>= 1) unkept += __shfl_xor_sync(0xffffffffu, unkept, o);
    if (lane == 0 && unkept) atomicAdd(&s_hist[256], unkept);
  }
  cl.sync();
  K16_STAMP(kHist);

  // 2. the level's histogram, its cut, and this rank's bases: thread t <
  // 256 bin 255 - t's count over the cluster and over the lower ranks,
  // thread 256 the lower ranks' unkept pixels
  {
    int m = 0, low = 0;
    if (tid <= 256) {
      const int bin = tid < 256 ? 255 - tid : 256;
      for (int r = 0; r < G; ++r) {
        const int h = cl.map_shared_rank(s_hist, r)[bin];
        m += h;
        low += r < rank ? h : 0;
      }
      s_low[bin] = low;
      if (tid == 256) m = 0;
    }
    int total;
    const int excl = block_exclusive_scan(m, s_scan, &total);  // kept above bin 255 - tid
    if (tid < 256) s_base[255 - tid] = excl;
    const int below = __syncthreads_count(tid < 256 && excl + m < L.k);
    if (below < 256 && tid == below) {  // the cut: the first bin from the top reaching k
      s_cut = 255 - tid;
      s_need = L.k - excl;
      s_valid = L.k;
    }
    if (below == 256 && tid == 0) {  // fewer than k kept pixels, all of them taken
      s_cut = -1;
      s_need = 0;
      s_valid = total;
    }
    __syncthreads();
  }
  const int cut = s_cut, need = s_need, n_valid = s_valid;
  const int n_fill = L.k - n_valid;
  K16_STAMP(kCut);

  // 3. row-major numbering of the pixels at the cut and of the unkept ones
  {
    int eq_seen = cut >= 0 ? s_low[cut] : 0, fill_seen = s_low[256];
    for (int s0 = 0; s0 < n_seg; s0 += kThreads) {
      const int s = s0 + tid;
      uint8_t kp[kSeg];
      int16_t sc[kSeg];
      const int g = g_lo + s;
      int cnt = 0;  // at the cut in the low 16 bits, unkept in the high 16 (<= 16 a thread)
      if (s < n_seg) {
        load_seg(keep, score, tab.total, g, kp, sc);
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const int i = kSeg * g + j;
          if (i < a || i >= b) continue;
          cnt += kp[j] ? (sc[j] == cut) : 1 << 16;
        }
      }
      int total;
      const int pre = block_exclusive_scan(cnt, s_scan, &total);
      if (s < n_seg) {
        int eq_rank = eq_seen + (pre & 0xffff), fill = fill_seen + (pre >> 16);
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const int i = kSeg * g + j;
          if (i < a || i >= b) continue;
          const int idx = i - L.plane_off;
          if (kp[j]) {
            const int v = sc[j];
            bool take = v > cut;
            if (v == cut) take = eq_rank++ < need;
            if (take) s_list[atomicAdd(&s_cnt, 1)] = (v << kIdxBits) | (kIdxMask - idx);
          } else {
            if (fill < n_fill) {
              const int slot = L.out_off + n_valid + fill;
              xy_out[2 * slot] = idx % L.W;
              xy_out[2 * slot + 1] = idx / L.W;
              resp_out[slot] = 0;
              valid_out[slot] = 0;
            }
            ++fill;
          }
        }
      }
      eq_seen += total & 0xffff;
      fill_seen += total >> 16;
    }
  }
  __syncthreads();
  K16_STAMP(kNumber);

  // 4. this rank's keys placed: the taken keys above the key's bin, those of
  // its bin in the lower ranks' bands, and the larger ones of its bin here
  const int n_own = s_cnt;
  const int n_pad = (n_own + 3) & ~3;
  for (int j = n_own + tid; j < n_pad; j += kThreads) s_list[j] = -1;  // below every key
  __syncthreads();
  const int4* own4 = reinterpret_cast<const int4*>(s_list);
  for (int j = tid >> 5; j < n_own; j += kThreads / 32) {
    const int key = s_list[j];
    const int bin = min(max(key >> kIdxBits, 0), 255);
    const int lo = key, hi = bin == 255 ? INT_MAX : (bin + 1) << kIdxBits;  // its bin's keys above it
    int larger = 0;
    for (int u = lane; u < n_pad / 4; u += 32) {
      const int4 w = own4[u];
      larger += (w.x > lo && w.x < hi) + (w.y > lo && w.y < hi) + (w.z > lo && w.z < hi) +
                (w.w > lo && w.w < hi);
    }
    for (int o = 16; o > 0; o >>= 1) larger += __shfl_xor_sync(0xffffffffu, larger, o);
    if (lane == 0) {
      const int i = kIdxMask - (key & kIdxMask);
      const int slot = L.out_off + s_base[bin] + s_low[bin] + larger;
      xy_out[2 * slot] = i % L.W;
      xy_out[2 * slot + 1] = i / L.W;
      resp_out[slot] = key >> kIdxBits;
      valid_out[slot] = 1;
    }
  }
  cl.sync();  // no rank reads another's shared memory after this
  K16_STAMP(kRank);
}

// the kernel's attributes on the current device for smem bytes of dynamic
// shared memory: clusters of 16 CTAs allowed, and the dynamic shared memory
// limit raised to the most asked for (set once a device and size)
cudaError_t prepare(int smem) {
  static int done[kMaxDevices] = {};   // the largest smem set + 1, 0 before the first call
  int dev;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] > smem) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(kp_collect_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kp_collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess)
    return e;
  done[dev] = smem + 1;
  return cudaSuccess;
}

// the launch configuration of n_levels clusters of G CTAs
struct Cfg {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Cfg(int G, int n_levels, int smem, cudaStream_t st) {
    cfg.gridDim = dim3(G * n_levels);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

// the cluster size K16 takes for n_levels levels with key lists of list_n
// ints on the current device, asked once when the host plan cuts the bands
// for it: 16 CTAs where the card holds n_levels such clusters at once
// (cudaOccupancyMaxActiveClusters), else 8.  out[0] the size, out[1] the
// clusters of that size the card holds at once, out[2] those of 16.
extern "C" int kp_collect_cluster(int n_levels, int list_n, int* out) {
  if (n_levels < 1 || n_levels > kMaxLevels || list_n < 0) return (int)cudaErrorInvalidValue;
  const int smem = list_n * (int)sizeof(int);
  cudaError_t e = prepare(smem);
  if (e != cudaSuccess) return (int)e;
  for (int g = kMaxCluster; g >= 8; g /= 2) {
    Cfg c(g, n_levels, smem, nullptr);
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, kp_collect_kernel, &c.cfg)) != cudaSuccess)
      return (int)e;
    if (g == kMaxCluster) out[2] = n;
    out[0] = g;
    out[1] = n;
    if (n >= n_levels) break;
  }
  return out[1] >= 1 ? (int)cudaSuccess : (int)cudaErrorInvalidConfiguration;
}

// tab_host: n_levels, cluster G, list_n, total (flat pixels), then per level
// plane_off, W, H, k, out_off and the G + 1 band bounds; keep (16-byte
// aligned) and score (16-byte aligned) are K1's flat outputs
extern "C" int kp_collect_launch(const void* keep, const void* score, const int* tab_host,
                                 void* xy, void* resp, void* valid, void* stream) {
  CollectTab tab;
  tab.n_levels = tab_host[0];
  tab.cluster = tab_host[1];
  tab.list_n = tab_host[2];
  tab.total = tab_host[3];
  const int G = tab.cluster;
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels || G < 1 || G > kMaxCluster ||
      tab.list_n % 4 != 0 || ((uintptr_t)keep & 15) != 0 || ((uintptr_t)score & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int* row = tab_host + 4;
  for (int l = 0; l < tab.n_levels; ++l, row += 6 + G) {
    CollectLevel& L = tab.lv[l];
    L = CollectLevel{row[0], row[1], row[2], row[3], row[4], {}};
    for (int r = 0; r <= G; ++r) L.band[r] = row[5 + r];
    if (L.k > tab.list_n || L.W * L.H > (1 << kIdxBits) || L.band[0] != L.plane_off ||
        L.band[G] != L.plane_off + L.W * L.H || L.plane_off + L.W * L.H > tab.total)
      return (int)cudaErrorInvalidValue;
    for (int r = 0; r < G; ++r)
      if (L.band[r + 1] < L.band[r] || (r > 0 && L.band[r] % kSeg != 0))
        return (int)cudaErrorInvalidValue;
  }
  const int smem = tab.list_n * (int)sizeof(int);
  cudaError_t e = prepare(smem);
  if (e != cudaSuccess) return (int)e;
  Cfg c(G, tab.n_levels, smem, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&c.cfg, kp_collect_kernel, (const uint8_t*)keep, (const int16_t*)score,
                         tab, (int*)xy, (int*)resp, (uint8_t*)valid);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
