// K3 hamming_best2: gated best / second-best 256-bit Hamming match per query.
//
// Replaces extractorb_tpu/frontend/matcher.py:hamming_matrix (+ unpack_bits)
// and the masked min / argmin / second-best of search_for_initialization,
// mutual_best_match, search_by_projection_last_frame and
// search_by_projection_local_map.  The TPU builds the dense (M, N) distance
// matrix as bf16 bit-plane matmuls on the MXU; here the matrix is never
// stored: each row keeps the two smallest keys (distance << 22 | column) of
// the columns it visits.  The keys are unique, so the top-2 of a row does not
// depend on the order its columns are visited in, and a shuffle merge of
// top-2 lists gives the row's lowest-index best and, for the second, the
// minimum with only the best column removed -- jnp.argmin's tie rule.  A
// missing best or second is reported as distance 1<<20 with index 0, as the
// JAX code's all-masked rows are.
//
// One library entry, one launch a call, two routes:
//
// Box route (the box and level gate: the last-frame, local-map, reloc, fuse
// and Sim3 searches).  Each CTA buckets the columns once into a uniform grid
// in its shared memory: the bounding box of the columns that can pass (valid,
// finite x and y), gx x gy cells of about two columns each
// (matcher.py:bucket_grid is the plain mirror of the arithmetic), a counting
// sort of (x, y, octave, column) into the cells, numbered row-major, with
// each column's descriptor copied beside its entry in the same cell order.  Rows
// go to the CTA's warps in a strided loop over at most one CTA per SM, each
// row's inputs loaded a row ahead (the first while the grid is built); a
// warp walks only the cells its window [u - r, u + r] x [v - r, v + r]
// overlaps, widened by one cell on each side: one contiguous run of the
// sorted columns per cell row, the lanes carried over from run to run.  The
// exact per-pair test of the plain version (|u - x| < r and |v - y| < r in
// float32, the level range, row and column validity) decides every pair.
// Why the walk misses no admitted pair: fl(|u - x|) < r implies x > u - r
// exactly, so x >= fl(u - r), and the cell function floor((c - x0) * sx)
// clamped to [0, gx - 1] (NaN to 0) is monotone in c; likewise above.
// Columns with a non-finite x or y never pass, so they stay out of the grid;
// a row with r = inf walks every cell, one with a NaN centre finds nothing.
// Measured (chip_anatomy.py k3, PERF.md): copying the descriptors in cell
// order beat one cp.async of all of them before the build (0.0114 against
// 0.0130 device ms at the th-15 last-frame search) and reading them in
// global memory (0.0120); 16 warps a CTA beat 8 (0.0100); capping the grid
// at 66 CTAs lost (0.0137).  Where the grid and the descriptors (48 B a
// column) do not fit in shared memory, N above 4266, the box gate takes the
// dense route; every call site's columns are a frame's keypoints (~1.1-1.7K).
//
// Dense route (no box arguments: the open gate of mutual_best_match and the
// loop closer's, and the word gate of search_by_bow, where a column passes
// when word1[i] == word2[j], both >= 0 and both valid).  Column tiles are
// staged in shared memory (descriptors by cp.async, the validity and words
// beside them); a warp owns one row, its 32 bytes in registers, and its
// lanes stride the tile: XOR + __popc over shared memory.  The tensor cores'
// mma.sync m16n8k256 .b1 AND + popc (distance = popc(a) + popc(b) -
// 2 popc(a & b), 16 rows a CTA, the top-2 lists merged over the quad and
// the warps) was built and measured bit-equal but slower, 0.0165 against
// 0.0085 device ms a launch at 1128 x 1128: the product is cheap either
// way, and the per-pair top-2 insert, four pairs a lane an n8 tile, then
// runs on a quarter of the lanes' columns each with more shuffles.  The box
// gate also takes this route, testing every pair, above N = 4266.
//
// Bound on the H100: latency.  The bytes are each row's and column's
// descriptor and geometry once (~0.3 MB at 4096 x 1128); the box route's
// operations are the pairs inside the windows, a few percent of M x N, and
// the grid build in each CTA (three passes over the columns, a scan, four
// barriers) sets the time.  The dense route's 1.27 M pairs at 1128 x 1128
// are 10.2 M popcounts, ~4.5 us at 16 a clock on each of the 71 SMs its
// CTAs take: popcount throughput and the launch set its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kIdxBits = 22;
constexpr unsigned kNone = 0xffffffffu;  // larger than any real key
constexpr int kInf = 1 << 20;
// the box route's grid: about kColsPerCell columns a cell, at most kMaxCells
// cells (matcher.py BOX_COLS_PER_CELL, BOX_MAX_CELLS)
constexpr int kColsPerCell = 2;
constexpr int kMaxCells = 2048;
constexpr int kMaxDevices = 64;
// shared memory a CTA may take (the H100's 227 KB less the static arrays)
constexpr int kSmemLimit = 200 * 1024;
constexpr int kDenseTile = 2048;  // columns of a dense tile

// the phase kinds of chip_anatomy.py's build, which stamps clock64() in
// CTA 0's thread 0; nothing otherwise
#ifndef K3_STAMP
#define K3_STAMP(kind)
#endif
enum Phase : int { kBbox = 0, kCount, kScatter, kRows, kPhases };

enum Gate : int { kOpen = 0, kWords, kBox };

__device__ __forceinline__ void insert(unsigned key, unsigned& k1, unsigned& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

// top-2 of the union of two sorted pairs of distinct keys, merged over the
// lanes whose index differs in bit `from`, then in each lower bit to `to`
__device__ __forceinline__ void merge_top2(unsigned& k1, unsigned& k2, int from, int to) {
#pragma unroll
  for (int off = from; off >= to; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    const unsigned n1 = min(k1, o1);
    const unsigned n2 = min(max(k1, o1), min(k2, o2));
    k1 = n1;
    k2 = n2;
  }
}

__device__ __forceinline__ void write_row(int row, unsigned k1, unsigned k2, int* best,
                                          int* second, int* best_idx, int* second_idx) {
  const unsigned mask = (1u << kIdxBits) - 1u;
  best[row] = k1 == kNone ? kInf : (int)(k1 >> kIdxBits);
  best_idx[row] = k1 == kNone ? 0 : (int)(k1 & mask);
  second[row] = k2 == kNone ? kInf : (int)(k2 >> kIdxBits);
  second_idx[row] = k2 == kNone ? 0 : (int)(k2 & mask);
}

__device__ __forceinline__ unsigned hamming(const uint4& a0, const uint4& a1, const uint4& b0,
                                            const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the cell of coordinate c: floor((c - c0) * s) clamped to [0, g - 1], NaN
// to 0; monotone in c (matcher.py:grid_cell)
__device__ __forceinline__ int grid_cell(float c, float c0, float s, int g) {
  const float f = floorf((c - c0) * s);
  return (int)fminf(fmaxf(f, 0.0f), (float)(g - 1));
}

struct Args {
  const int *q_word, *c_word;
  const uint4* q_desc;
  const float *q_u, *q_v, *q_r;
  const int *q_lo, *q_hi;
  const bool* q_ok;
  int M;
  const uint4* c_desc;
  const float *c_x, *c_y;
  const int* c_oct;
  const bool* c_ok;
  int N;
  int *best, *second, *best_idx, *second_idx;
};

// ------------------------------------------------------------ box route

// a row's inputs, loaded a row ahead of its walk
struct RowIn {
  uint4 a0, a1;
  float u, v, r;
  int lo, hi;
  bool ok;
};

__device__ __forceinline__ RowIn load_row(const Args& a, int row) {
  RowIn q = {};
  q.ok = row < a.M && a.q_ok[row];
  if (row < a.M) {  // not behind q_ok: the loads go out together
    q.a0 = a.q_desc[2 * row];
    q.a1 = a.q_desc[2 * row + 1];
    q.u = a.q_u[row];
    q.v = a.q_v[row];
    q.r = a.q_r[row];
    q.lo = a.q_lo[row];
    q.hi = a.q_hi[row];
  }
  return q;
}

__global__ void __launch_bounds__(kThreads) hamming_best2_box_kernel(const Args a) {
  extern __shared__ uint4 s_dyn[];
  // the grid's entries' descriptors and the entries (x, y, octave, column),
  // both in cell order
  uint4* s_desc = s_dyn;
  float4* s_ent = reinterpret_cast<float4*>(s_dyn + 2 * a.N);
  __shared__ int s_start[kMaxCells + 1];
  __shared__ int s_cur[kMaxCells];
  __shared__ float s_red[4][kWarps];
  __shared__ int s_nin[kWarps];
  __shared__ int s_scan[33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  K3_STAMP(kPhases);  // the start
  RowIn cur = load_row(a, row);  // in flight while the grid is built

  for (int c = tid; c < kMaxCells; c += kThreads) s_cur[c] = 0;

  // 1. the bounding box of the columns that can pass
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
  int n_in = 0;
  for (int j = tid; j < N; j += kThreads) {
    const float x = a.c_x[j], y = a.c_y[j];
    if (a.c_ok[j] && isfinite(x) && isfinite(y)) {
      xmin = fminf(xmin, x);
      xmax = fmaxf(xmax, x);
      ymin = fminf(ymin, y);
      ymax = fmaxf(ymax, y);
      ++n_in;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
    n_in += __shfl_xor_sync(0xffffffffu, n_in, o);
  }
  if (lane == 0) {
    s_red[0][warp] = xmin;
    s_red[1][warp] = xmax;
    s_red[2][warp] = ymin;
    s_red[3][warp] = ymax;
    s_nin[warp] = n_in;
  }
  __syncthreads();
  xmin = s_red[0][0];
  xmax = s_red[1][0];
  ymin = s_red[2][0];
  ymax = s_red[3][0];
  n_in = s_nin[0];
  for (int w = 1; w < kWarps; ++w) {
    xmin = fminf(xmin, s_red[0][w]);
    xmax = fmaxf(xmax, s_red[1][w]);
    ymin = fminf(ymin, s_red[2][w]);
    ymax = fmaxf(ymax, s_red[3][w]);
    n_in += s_nin[w];
  }
  // the grid (every thread computes the same; matcher.py:bucket_grid)
  const int cells = min(max(n_in / kColsPerCell, 1), kMaxCells);
  const float gw = fmaxf(xmax - xmin, 1.0f), gh = fmaxf(ymax - ymin, 1.0f);
  const int gx = (int)fmaxf(fminf(sqrtf((float)cells * gw / gh), (float)cells), 1.0f);
  const int gy = max(cells / gx, 1);
  const float sx = (float)gx / gw, sy = (float)gy / gh;
  const int n_cells = gx * gy;
  K3_STAMP(kBbox);

  // 2. the columns of each cell
  for (int j = tid; j < N; j += kThreads) {
    const float x = a.c_x[j], y = a.c_y[j];
    if (a.c_ok[j] && isfinite(x) && isfinite(y))
      atomicAdd(&s_cur[grid_cell(y, ymin, sy, gy) * gx + grid_cell(x, xmin, sx, gx)], 1);
  }
  __syncthreads();
  {
    constexpr int kPer = (kMaxCells + kThreads - 1) / kThreads;
    const int c0 = tid * kPer;
    int cnt[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      cnt[k] = c0 + k < n_cells ? s_cur[c0 + k] : 0;
      sum += cnt[k];
    }
    int total;
    int run = block_exclusive_scan(sum, s_scan, &total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (c0 + k < n_cells) {
        s_start[c0 + k] = run;
        s_cur[c0 + k] = run;
      }
      run += cnt[k];
    }
    if (tid == 0) s_start[n_cells] = total;
  }
  __syncthreads();
  K3_STAMP(kCount);
  for (int j = tid; j < N; j += kThreads) {
    const float x = a.c_x[j], y = a.c_y[j];
    if (a.c_ok[j] && isfinite(x) && isfinite(y)) {
      const int c = grid_cell(y, ymin, sy, gy) * gx + grid_cell(x, xmin, sx, gx);
      const int e = atomicAdd(&s_cur[c], 1);
      s_ent[e] = make_float4(x, y, __int_as_float(a.c_oct[j]), __int_as_float(j));
      s_desc[2 * e] = a.c_desc[2 * j];
      s_desc[2 * e + 1] = a.c_desc[2 * j + 1];
    }
  }
  __syncthreads();
  K3_STAMP(kScatter);

  // 3. rows: a warp a row, over the cells its window overlaps (+1 a side)
  for (; row < a.M; row += stride) {
    const RowIn q = cur;
    cur = load_row(a, row + stride);
    unsigned k1 = kNone, k2 = kNone;
    if (q.ok) {
      const int cx0 = max(grid_cell(q.u - q.r, xmin, sx, gx) - 1, 0);
      const int cx1 = min(grid_cell(q.u + q.r, xmin, sx, gx) + 1, gx - 1);
      const int cy0 = max(grid_cell(q.v - q.r, ymin, sy, gy) - 1, 0);
      const int cy1 = min(grid_cell(q.v + q.r, ymin, sy, gy) + 1, gy - 1);
      int phase = 0;  // the lane that takes the next run's first column
      for (int cy = cy0; cy <= cy1; ++cy) {
        const int e0 = s_start[cy * gx + cx0], e1 = s_start[cy * gx + cx1 + 1];
        for (int e = e0 + ((lane - phase) & 31); e < e1; e += 32) {
          const float4 en = s_ent[e];
          const int o = __float_as_int(en.z);
          if (o < q.lo || o > q.hi) continue;
          if (!(fabsf(q.u - en.x) < q.r) || !(fabsf(q.v - en.y) < q.r)) continue;
          const int j = __float_as_int(en.w);
          const unsigned d = hamming(q.a0, q.a1, s_desc[2 * e], s_desc[2 * e + 1]);
          insert((d << kIdxBits) | (unsigned)j, k1, k2);
        }
        phase = (phase + (e1 - e0)) & 31;
      }
    }
    merge_top2(k1, k2, 16, 1);
    if (lane == 0) write_row(row, k1, k2, a.best, a.second, a.best_idx, a.second_idx);
  }
  K3_STAMP(kRows);
}

// ---------------------------------------------------------- dense route

// the gate of pair (row, j) beyond row validity: column validity, and the
// word or the box test
template <int kGate>
__device__ __forceinline__ bool pair_ok(const Args& a, int row, int j, bool c_ok, int wq,
                                        int wc) {
  if (!c_ok) return false;
  if (kGate == kWords) return wc == wq;
  if (kGate == kBox) {
    const int o = a.c_oct[j];
    if (o < a.q_lo[row] || o > a.q_hi[row]) return false;
    const float r = a.q_r[row];
    return fabsf(a.q_u[row] - a.c_x[j]) < r && fabsf(a.q_v[row] - a.c_y[j]) < r;
  }
  return true;
}

// the dense route's shared memory: a tile of `tile` columns' descriptors
// (cp.async) and their validity (and words)
struct DenseTile {
  uint4* desc;
  int* w;
  bool* ok;
  __device__ DenseTile(uint4* s, int tile)
      : desc(s), w(reinterpret_cast<int*>(s + 2 * tile)), ok(reinterpret_cast<bool*>(w + tile)) {}
};

// the bytes of a dense tile of `tile` columns
constexpr int dense_smem(int tile) { return tile * (32 + 4 + 1); }

// stage columns [j0, j0 + n) into the tile; the caller waits and syncs
template <int kGate>
__device__ __forceinline__ void stage_tile(const Args& a, int j0, int n, const DenseTile& s) {
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x)
    cp_async16(s.desc + e, a.c_desc + 2 * j0 + e);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int j = j0 + e;
    bool ok = a.c_ok[j];
    if (kGate == kWords) {
      s.w[e] = a.c_word[j];
      ok = ok && a.c_word[j] >= 0;
    }
    s.ok[e] = ok;
  }
}

// a warp a row, the lanes striding each staged tile
template <int kGate>
__global__ void __launch_bounds__(kThreads) hamming_best2_dense_kernel(const Args a) {
  extern __shared__ uint4 s_dyn[];
  const DenseTile s(s_dyn, min(a.N, kDenseTile));
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < a.M && a.q_ok[row] && (kGate != kWords || a.q_word[row] >= 0);
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
  int wq = 0;
  if (live) {
    a0 = a.q_desc[2 * row];
    a1 = a.q_desc[2 * row + 1];
    if (kGate == kWords) wq = a.q_word[row];
  }
  unsigned k1 = kNone, k2 = kNone;
  for (int j0 = 0; j0 < a.N; j0 += kDenseTile) {
    const int n = min(kDenseTile, a.N - j0);
    stage_tile<kGate>(a, j0, n, s);
    cp_async_wait_all();
    __syncthreads();
    if (live) {
      for (int e = lane; e < n; e += 32) {
        if (!pair_ok<kGate>(a, row, j0 + e, s.ok[e], wq, kGate == kWords ? s.w[e] : 0))
          continue;
        const unsigned d = hamming(a0, a1, s.desc[2 * e], s.desc[2 * e + 1]);
        insert((d << kIdxBits) | (unsigned)(j0 + e), k1, k2);
      }
    }
    __syncthreads();  // the tile is rewritten next
  }
  merge_top2(k1, k2, 16, 1);
  if (lane == 0 && row < a.M) write_row(row, k1, k2, a.best, a.second, a.best_idx, a.second_idx);
}

int sm_count() {
  static int n[kMaxDevices] = {};
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (!n[dev] && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) !=
                     cudaSuccess)
    n[dev] = 0;
  return n[dev];
}

// the dynamic shared memory limit of kernel `slot` raised to kSmemLimit,
// once a device
cudaError_t raise_smem(const void* kern, int slot) {
  static bool done[4][kMaxDevices] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[slot][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) done[slot][dev] = true;
  return e;
}

template <int kGate>
cudaError_t launch_dense(const Args& a, cudaStream_t st) {
  cudaError_t e = raise_smem((const void*)hamming_best2_dense_kernel<kGate>, kGate);
  if (e != cudaSuccess) return e;
  hamming_best2_dense_kernel<kGate><<<(a.M + kWarps - 1) / kWarps, kThreads,
                                      dense_smem(min(a.N, kDenseTile)), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q_word / c_word: the word gate (the box arguments are then not read and
// may be null); else q_u null: the open gate (q_u, q_v, q_r, q_lo, q_hi,
// c_x, c_y and c_oct not read); else the box and level gate.  q_desc and
// c_desc 16-byte aligned.
extern "C" int hamming_best2_launch(const void* q_word, const void* c_word, const void* q_desc,
                                    const void* q_u, const void* q_v,
                                    const void* q_r, const void* q_lo, const void* q_hi,
                                    const void* q_ok, int M, const void* c_desc,
                                    const void* c_x, const void* c_y, const void* c_oct,
                                    const void* c_ok, int N, void* best, void* second,
                                    void* best_idx, void* second_idx, void* stream) {
  if (N >= (1 << kIdxBits) || M < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const bool words = q_word != nullptr;
  if (words != (c_word != nullptr)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q_desc & 15) || ((uintptr_t)c_desc & 15)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const Args a{(const int*)q_word, (const int*)c_word, (const uint4*)q_desc, (const float*)q_u,
               (const float*)q_v, (const float*)q_r, (const int*)q_lo, (const int*)q_hi,
               (const bool*)q_ok, M, (const uint4*)c_desc, (const float*)c_x,
               (const float*)c_y, (const int*)c_oct, (const bool*)c_ok, N,
               (int*)best, (int*)second, (int*)best_idx, (int*)second_idx};
  cudaStream_t st = (cudaStream_t)stream;
  if (words) return (int)launch_dense<kWords>(a, st);
  if (q_u == nullptr) return (int)launch_dense<kOpen>(a, st);
  // the box route: the grid's entries (16 B a column) and their descriptors
  // (32 B) in shared memory where they fit; else every pair tested
  if (48 * N > kSmemLimit) return (int)launch_dense<kBox>(a, st);
  cudaError_t e = raise_smem((const void*)hamming_best2_box_kernel, 3);
  if (e != cudaSuccess) return (int)e;
  const int ctas = max(1, min((M + kWarps - 1) / kWarps, sm_count()));
  hamming_best2_box_kernel<<<ctas, kThreads, 48 * N, st>>>(a);
  return (int)cudaGetLastError();
}
