// K16 kp_collect: per-level top-K collection of FAST keypoints, every level
// of the pyramid in one launch (one CTA per level).
//
// Replaces extractorb_tpu/frontend/fast.py:collect_keypoints: a top_k of the
// unique key score << 21 | (2^21 - 1 - idx) over the whole keep/score plane,
// which the TPU computes with a sort of the plane.  The output is the top k
// keys in descending order: score-major, row-major ties.  Here a CTA makes
// three passes over its level's plane in row-major chunks of 16 pixels a
// thread:
//   1. a 256-bin histogram of the kept scores gives the cut score c: every
//      kept pixel above c is taken, and of those at c the first `need` in
//      row-major order;
//   2. per chunk, block prefix sums number the pixels at c in row-major
//      order (which of them are taken) and then the taken ones, so their
//      keys land in shared memory in row-major order; when fewer than k
//      pixels are kept, the same pass numbers the pixels that are not kept
//      and writes the first ones straight into the invalid slots, in
//      row-major order, as top_k's order of their equal keys puts them;
//   3. a bitonic sort of the <= k taken keys in shared memory puts them in
//      descending key order, and the CTA writes xy, response and valid.
// Kept pixels always have a score >= the FAST threshold >= 0 (K1), so a
// kept pixel is a valid slot, as in the plain version.
//
// Bound on the H100: latency.  The work is 3 bytes read per pixel of the
// 640x480 pyramid (1.1 MB of keep + score); the eight CTAs run their chunk
// loops side by side and level 0's (19 chunks, two block scans each) sets
// the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 1024;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kIdxBits = 21;
constexpr int kIdxMask = (1 << kIdxBits) - 1;

struct CollectLevel {
  int plane_off, W, H, k, out_off;
};

struct CollectTab {
  int n_levels, sort_n;  // sort_n: power of two >= every level's k
  CollectLevel lv[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
kp_collect_kernel(const uint8_t* __restrict__ keep, const int16_t* __restrict__ score,
                  const CollectTab tab, int* __restrict__ xy_out, int* __restrict__ resp_out,
                  uint8_t* __restrict__ valid_out) {
  extern __shared__ int s_keys[];  // tab.sort_n
  __shared__ int s_hist[256];
  __shared__ int s_scan[33];
  __shared__ int s_cut, s_need, s_valid;
  const CollectLevel L = tab.lv[blockIdx.x];
  const uint8_t* kp = keep + L.plane_off;
  const int16_t* sc = score + L.plane_off;
  const int n = L.W * L.H;
  const int tid = threadIdx.x;

  // 1. histogram of the kept scores and the cut
  for (int i = tid; i < 256; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads)
    if (kp[i]) atomicAdd(&s_hist[min(max((int)sc[i], 0), 255)], 1);
  __syncthreads();
  if (tid == 0) {
    int above = 0, c = -1, need = 0;
    for (int s = 255; s >= 0; --s) {
      if (above + s_hist[s] >= L.k) {
        c = s;
        need = L.k - above;
        break;
      }
      above += s_hist[s];
    }
    // c == -1: fewer than k kept pixels, all of them taken
    s_cut = c;
    s_need = need;
    s_valid = c < 0 ? above : L.k;
  }
  __syncthreads();
  const int cut = s_cut, need = s_need, n_valid = s_valid;
  const int n_fill = L.k - n_valid;  // invalid slots, filled in row-major order

  // 2. row-major numbering of the taken keys and of the fill pixels
  int eq_seen = 0, sel_seen = 0, inv_seen = 0, total;
  for (int base = 0; base < n; base += kChunk) {
    const int i0 = base + tid * kPerThread;
    int eq = 0;
    for (int j = 0; j < kPerThread; ++j) {
      const int i = i0 + j;
      eq += i < n && kp[i] && sc[i] == cut;
    }
    int eq_rank = eq_seen + block_exclusive_scan(eq, s_scan, &total);
    eq_seen += total;
    // taken in the low 16 bits, fill pixels in the high 16 (< 2^14 each a chunk)
    int cnt = 0;
    for (int j = 0; j < kPerThread; ++j) {
      const int i = i0 + j;
      if (i >= n) break;
      if (kp[i]) {
        const int s = sc[i];
        if (s > cut) {
          cnt += 1;
        } else if (s == cut) {
          cnt += eq_rank < need;
          ++eq_rank;
        }
      } else {
        cnt += 1 << 16;
      }
    }
    const int pre = block_exclusive_scan(cnt, s_scan, &total);
    int sel_pos = sel_seen + (pre & 0xffff), inv_pos = inv_seen + (pre >> 16);
    sel_seen += total & 0xffff;
    inv_seen += total >> 16;
    eq_rank -= eq;  // replay the chunk with the positions
    for (int j = 0; j < kPerThread; ++j) {
      const int i = i0 + j;
      if (i >= n) break;
      if (kp[i]) {
        const int s = sc[i];
        bool take = s > cut;
        if (s == cut) take = eq_rank++ < need;
        if (take) s_keys[sel_pos++] = (s << kIdxBits) | (kIdxMask - i);
      } else {
        if (inv_pos < n_fill) {
          const int slot = L.out_off + n_valid + inv_pos;
          xy_out[2 * slot] = i % L.W;
          xy_out[2 * slot + 1] = i / L.W;
          resp_out[slot] = 0;
          valid_out[slot] = 0;
        }
        ++inv_pos;
      }
    }
  }
  for (int i = n_valid + tid; i < tab.sort_n; i += kThreads) s_keys[i] = -1;
  __syncthreads();

  // 3. the taken keys in descending order
  block_bitonic_sort(s_keys, tab.sort_n, true);
  for (int j = tid; j < n_valid; j += kThreads) {
    const int key = s_keys[j];
    const int i = kIdxMask - (key & kIdxMask);
    const int slot = L.out_off + j;
    xy_out[2 * slot] = i % L.W;
    xy_out[2 * slot + 1] = i / L.W;
    resp_out[slot] = key >> kIdxBits;
    valid_out[slot] = 1;
  }
}

}  // namespace

// tab_host: n_levels, sort_n, then per level plane_off, W, H, k, out_off
extern "C" int kp_collect_launch(const void* keep, const void* score, const int* tab_host,
                                 void* xy, void* resp, void* valid, void* stream) {
  CollectTab tab;
  tab.n_levels = tab_host[0];
  tab.sort_n = tab_host[1];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < tab.n_levels; ++l) {
    const int* r = tab_host + 2 + 5 * l;
    tab.lv[l] = CollectLevel{r[0], r[1], r[2], r[3], r[4]};
    if (tab.lv[l].k > tab.sort_n || tab.lv[l].W * tab.lv[l].H > (1 << kIdxBits))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = tab.sort_n * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kp_collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kp_collect_kernel<<<tab.n_levels, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, (const int16_t*)score, tab, (int*)xy, (int*)resp, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
