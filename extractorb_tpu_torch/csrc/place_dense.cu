// K29 place_dense: dense BoW place scoring of the keyframe blocks that the
// shards of a mesh hold on one card, in one launch.
//
// Replaces extractorb_tpu/dist/kf_blocks.py:sharded_place_scores, the
// shards of its shard_map that live on one device (the TPU runs each as one
// MXU-shaped pass over the shard's dense histograms).  For each keyframe row
// k of each block:
//   score[k]  = valid[k] ? 1 - 0.5 sum_w |h[k,w] - q[w]| : -inf
//   common[k] = sum_w (has[k,w] && q[w] > 0)
// with q the query's dense histogram, one copy on the card.  The launch
// takes a table of the blocks (pointers and row offsets into one output
// allocation), so the rows of every shard on the card form one range.
//
// Bound on the H100: bytes.  A query reads the blocks once (W floats and W
// bools a row, 5 bytes a word) and q; at 1024 x 65536 that is 335 MB, 0.10
// ms at 3.35 TB/s.  So the design is a stream: one CTA per SM, each taking
// a contiguous range of rows in tiles of kRows.  For each tile it walks W
// in chunks of kChunk words: the q chunk goes once into shared memory
// (double-buffered), then each row's h and has chunks stream through a ring
// of kStages shared-memory stages, fed by one producer thread's bulk copies
// (cp.async.bulk, completion on an mbarrier: up to kStages x 20 KB in
// flight a CTA), while 8 consumer warps reduce them.  q is read from HBM or
// L2 once per tile, not once per row.  A row whose block is not 16-byte
// aligned, or any row when W % 16 != 0 (the bulk copy's address and size
// rule), is read by the consumers with plain loads in the same loop; so is
// every row, and q, when q itself breaks the rule (W % 4 != 0).
//
// Each consumer thread keeps the tile's partial sums in registers over the
// chunks (its words of a chunk in a fixed order, the chunks in order); a
// row's sums then go through a fixed xor tree in each warp and the warps in
// order.  The order depends on W alone, not on the path, the grid or the
// shards: one input gives one result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;               // words of a row chunk: 16 KB of h, 4 KB of has
constexpr int kStages = 6;                 // ring stages of (h, has) chunks
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRows = 8;                   // rows of a tile: their partials stay in registers
constexpr int kPer4 = kChunk / (4 * kConsumers);   // float4 groups of a chunk a consumer takes
constexpr int kMaxShards = 64;
constexpr int kMaxDevices = 64;
constexpr size_t kSmemBytes =
    sizeof(float) * 2 * kChunk + (sizeof(float) + 1) * (size_t)kStages * kChunk;

struct PlaceShards {
  const float* h[kMaxShards];
  const uint8_t* has[kMaxShards];
  const bool* valid[kMaxShards];
  int row0[kMaxShards + 1];   // shard s's rows are rows row0[s] .. row0[s+1] of the launch
  unsigned long long bulk;    // bit s: shard s's rows go through the bulk copies
  int n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(b)),
               "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ int shard_of(const PlaceShards& sh, int row) {
  int s = 0;
  while (row >= sh.row0[s + 1]) ++s;
  return s;
}

__device__ __forceinline__ void acc1(float h, bool has, float q, float& d, int& c) {
  d += fabsf(h - q);
  c += (has && q > 0.f) ? 1 : 0;
}

// one row chunk of len words: this thread's words 4 (t + m kConsumers) + e
__device__ __forceinline__ void chunk_staged(const float* hs, const uint8_t* ms, const float* qs,
                                             int len, int t, float& d, int& c) {
#pragma unroll
  for (int m = 0; m < kPer4; ++m) {
    const int i4 = t + m * kConsumers;
    if (4 * i4 >= len) break;
    const float4 a = reinterpret_cast<const float4*>(hs)[i4];
    const float4 b = reinterpret_cast<const float4*>(qs)[i4];
    const uchar4 k = reinterpret_cast<const uchar4*>(ms)[i4];
    acc1(a.x, k.x != 0, b.x, d, c);
    acc1(a.y, k.y != 0, b.y, d, c);
    acc1(a.z, k.z != 0, b.z, d, c);
    acc1(a.w, k.w != 0, b.w, d, c);
  }
}
__device__ __forceinline__ void chunk_plain(const float* hr, const uint8_t* mr, const float* qs,
                                            int len, int t, float& d, int& c) {
#pragma unroll
  for (int m = 0; m < kPer4; ++m) {
    const int w0 = 4 * (t + m * kConsumers);
    if (w0 >= len) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (w0 + e < len) acc1(hr[w0 + e], mr[w0 + e] != 0, qs[w0 + e], d, c);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
place_dense_kernel(const __grid_constant__ PlaceShards sh, const float* __restrict__ q, int W,
                   bool q_bulk, float* __restrict__ scores, int* __restrict__ common) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);                 // 2 x kChunk
  float* hbuf = qbuf + 2 * kChunk;                              // kStages x kChunk
  uint8_t* mbuf = reinterpret_cast<uint8_t*>(hbuf + (size_t)kStages * kChunk);
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull[2], qempty[2];
  __shared__ float red_d[kConsumerWarps][kRows];
  __shared__ int red_c[kConsumerWarps][kRows];

  const int K = sh.row0[sh.n];
  const int lo = (int)((long long)K * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)K * (blockIdx.x + 1) / gridDim.x);
  const int n_chunks = (W + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {   // the producer warp: lane 0 issues the bulk copies
    if (threadIdx.x != kConsumers) return;
    int stage = 0, qslot = 0;
    unsigned sphase = 0, qphase = 0;
    for (int r0 = lo; r0 < hi; r0 += kRows) {
      const int rn = min(kRows, hi - r0);
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int w0 = ch * kChunk, len = min(kChunk, W - w0);
        if (q_bulk) {
          mbar_wait(&qempty[qslot], qphase ^ 1);
          mbar_expect(&qfull[qslot], 4u * len);
          bulk_copy(qbuf + qslot * kChunk, q + w0, 4u * len, &qfull[qslot]);
          if (++qslot == 2) { qslot = 0; qphase ^= 1; }
        }
        for (int rr = 0; rr < rn; ++rr) {
          const int row = r0 + rr, s = shard_of(sh, row);
          if (!((sh.bulk >> s) & 1ull)) continue;
          const size_t off = (size_t)(row - sh.row0[s]) * W + w0;
          mbar_wait(&empty[stage], sphase ^ 1);
          mbar_expect(&full[stage], 5u * len);
          bulk_copy(hbuf + (size_t)stage * kChunk, sh.h[s] + off, 4u * len, &full[stage]);
          bulk_copy(mbuf + (size_t)stage * kChunk, sh.has[s] + off, (unsigned)len, &full[stage]);
          if (++stage == kStages) { stage = 0; sphase ^= 1; }
        }
      }
    }
    return;
  }

  // the consumers
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int stage = 0, qslot = 0;
  unsigned sphase = 0, qphase = 0;
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    const int rn = min(kRows, hi - r0);
    float d[kRows];
    int c[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      d[rr] = 0.f;
      c[rr] = 0;
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int w0 = ch * kChunk, len = min(kChunk, W - w0);
      const float* qs = q + w0;
      if (q_bulk) {
        mbar_wait(&qfull[qslot], qphase);
        qs = qbuf + qslot * kChunk;
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (rr >= rn) break;
        const int row = r0 + rr, s = shard_of(sh, row);
        const size_t off = (size_t)(row - sh.row0[s]) * W + w0;
        if ((sh.bulk >> s) & 1ull) {
          mbar_wait(&full[stage], sphase);
          chunk_staged(hbuf + (size_t)stage * kChunk, mbuf + (size_t)stage * kChunk, qs, len, t,
                       d[rr], c[rr]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == kStages) { stage = 0; sphase ^= 1; }
        } else {
          chunk_plain(sh.h[s] + off, sh.has[s] + off, qs, len, t, d[rr], c[rr]);
        }
      }
      if (q_bulk) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&qempty[qslot]);
        if (++qslot == 2) { qslot = 0; qphase ^= 1; }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float dv = d[rr];
      int cv = c[rr];
      for (int o = 16; o > 0; o >>= 1) {
        dv += __shfl_xor_sync(0xffffffffu, dv, o);
        cv += __shfl_xor_sync(0xffffffffu, cv, o);
      }
      if (lane == 0) {
        red_d[warp][rr] = dv;
        red_c[warp][rr] = cv;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (t < rn) {
      float sd = 0.f;
      int sc = 0;
      for (int w = 0; w < kConsumerWarps; ++w) {
        sd += red_d[w][t];
        sc += red_c[w][t];
      }
      const int row = r0 + t, s = shard_of(sh, row);
      scores[row] = sh.valid[s][row - sh.row0[s]] ? 1.f - 0.5f * sd : -INFINITY;
      common[row] = sc;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }
}

}  // namespace

// n blocks on one device, tab a host int64 (n, 4) table of (hists (K_s, W)
// float32, has (K_s, W) bool, valid (K_s,) bool, K_s); q (W,) float32 on the
// same device; scores (sum K_s,) float32 and common (sum K_s,) int32, block
// s's rows after those of blocks 0..s-1
extern "C" int place_dense_launch(int n, const long long* tab, int W, const void* q, void* scores,
                                  void* common, void* stream) {
  if (n < 1 || n > kMaxShards || W <= 0) return (int)cudaErrorInvalidValue;
  PlaceShards sh = {};
  sh.n = n;
  sh.row0[0] = 0;
  for (int s = 0; s < n; ++s) {
    const long long* e = tab + 4 * s;
    if (e[3] < 0) return (int)cudaErrorInvalidValue;
    sh.h[s] = reinterpret_cast<const float*>(e[0]);
    sh.has[s] = reinterpret_cast<const uint8_t*>(e[1]);
    sh.valid[s] = reinterpret_cast<const bool*>(e[2]);
    sh.row0[s + 1] = sh.row0[s] + (int)e[3];
    if (W % 16 == 0 && e[0] % 16 == 0 && e[1] % 16 == 0) sh.bulk |= 1ull << s;
  }
  const int K = sh.row0[n];
  if (K == 0) return (int)cudaSuccess;
  const bool q_bulk = W % 4 == 0 && (uintptr_t)q % 16 == 0;
  if (!q_bulk) sh.bulk = 0;   // a staged row is read against the staged q
  // each device's SM count, and the kernel's shared-memory limit set there
  // once (a call a query is host time the kernel waits for)
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(place_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n_sm;
  }
  const int n_sm = sms[dev];
  place_dense_kernel<<<K < n_sm ? K : n_sm, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      sh, (const float*)q, W, q_bulk, (float*)scores, (int*)common);
  return (int)cudaGetLastError();
}
