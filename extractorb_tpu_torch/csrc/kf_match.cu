// K34 kf_match: mutual-best Hamming matches of a query keyframe's
// descriptors against every keyframe of a database shard.
//
// Replaces extractorb_tpu/dist/kf_blocks.py:sharded_loop_candidate_match,
// whose shard_map vmaps, per keyframe, the bit-plane matmul Hamming matrix
// (Nq, N), masks the pairs with an invalid side to 2^20, takes the row and
// column argmins (jnp.argmin: the lowest index wins a tie, so a row or
// column with every pair masked picks index 0) and counts the query rows
// whose best keyframe descriptor has them as its best, at distance <=
// TH_LOW, and valid.  Here the distances are XOR + __popc of the packed
// 32-byte descriptors, exact integers, computed twice per pair and never
// stored:
//   rows:  a CTA per (keyframe, 256 query rows); the keyframe's descriptors
//          pass through shared memory in tiles of 256, each thread keeps its
//          row's running minimum and its first index;
//   cols:  a CTA per (keyframe, 256 keyframe descriptors); the query passes
//          through shared memory the same way;
//   count: a CTA per keyframe tests every query row against its best
//          column's best row and counts (an integer sum: one result in any
//          order).
// Scanning in index order with a strict < gives jnp.argmin's tie rule.
//
// Bound on the H100: integer operations.  1024 keyframes x 1024 descriptors
// against a 1000-descriptor query (~34 MB read) is 2 x 10^9 descriptor pairs
// of 8 XOR, 8 popcounts and 8 adds each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kInf = 1 << 20;

struct Desc {
  uint4 a, b;
};

__device__ __forceinline__ Desc load_desc(const uint8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return Desc{q[0], q[1]};
}

__device__ __forceinline__ int ham(const Desc& x, const Desc& y) {
  return __popc(x.a.x ^ y.a.x) + __popc(x.a.y ^ y.a.y) + __popc(x.a.z ^ y.a.z) +
         __popc(x.a.w ^ y.a.w) + __popc(x.b.x ^ y.b.x) + __popc(x.b.y ^ y.b.y) +
         __popc(x.b.z ^ y.b.z) + __popc(x.b.w ^ y.b.w);
}

// for each of `mine`'s entries (mine[k] when per_kf, else mine), the first
// index of its smallest masked distance to `theirs`' entries: rows (mine: the
// query, theirs: the keyframe's descriptors) or columns (the other way round)
__global__ void __launch_bounds__(kThreads)
argmin_kernel(const uint8_t* __restrict__ mine, const bool* __restrict__ mine_ok, int n_mine,
              bool mine_per_kf, const uint8_t* __restrict__ theirs,
              const bool* __restrict__ theirs_ok, int n_theirs, bool theirs_per_kf,
              int* __restrict__ arg, int* __restrict__ dmin) {
  __shared__ Desc tile[kTile];
  __shared__ bool tile_ok[kTile];
  const int k = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const uint8_t* me = mine + (mine_per_kf ? (size_t)k * n_mine * 32 : 0);
  const bool* me_ok = mine_ok + (mine_per_kf ? (size_t)k * n_mine : 0);
  const uint8_t* th = theirs + (theirs_per_kf ? (size_t)k * n_theirs * 32 : 0);
  const bool* th_ok = theirs_ok + (theirs_per_kf ? (size_t)k * n_theirs : 0);
  const bool live = i < n_mine;
  Desc d = live ? load_desc(me + (size_t)i * 32) : Desc{};
  const bool ok = live && me_ok[i];
  int best = 0x7fffffff, at = 0;
  for (int j0 = 0; j0 < n_theirs; j0 += kTile) {
    const int n = min(kTile, n_theirs - j0);
    __syncthreads();
    if (threadIdx.x < n) {
      tile[threadIdx.x] = load_desc(th + (size_t)(j0 + threadIdx.x) * 32);
      tile_ok[threadIdx.x] = th_ok[j0 + threadIdx.x];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const int dist = ok && tile_ok[j] ? ham(d, tile[j]) : kInf;
      if (dist < best) {
        best = dist;
        at = j0 + j;
      }
    }
  }
  if (live) {
    arg[(size_t)k * n_mine + i] = at;
    if (dmin) dmin[(size_t)k * n_mine + i] = best;
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ best12, const int* __restrict__ min12,
             const int* __restrict__ best21, const bool* __restrict__ q_ok, int Nq, int N,
             int th_low, int* __restrict__ counts) {
  const int k = blockIdx.x;
  int c = 0;
  for (int i = threadIdx.x; i < Nq; i += kThreads) {
    const size_t r = (size_t)k * Nq + i;
    c += q_ok[i] && min12[r] <= th_low && best21[(size_t)k * N + best12[r]] == i;
  }
  __shared__ int red[kThreads];
  red[threadIdx.x] = c;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[k] = red[0];
}

inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

}  // namespace

extern "C" long long kf_match_workspace_bytes(int Ks, int N, int Nq) {
  return (long long)(2 * align16(sizeof(int) * (size_t)Ks * Nq) +
                     align16(sizeof(int) * (size_t)Ks * N));
}

// kf_desc (Ks, N, 32) uint8, kf_valid (Ks, N) bool, q_desc (Nq, 32) uint8,
// q_valid (Nq,) bool; ws kf_match_workspace_bytes(Ks, N, Nq); counts (Ks,)
// int32 out
extern "C" int kf_match_launch(const void* kf_desc, const void* kf_valid, const void* q_desc,
                               const void* q_valid, int Ks, int N, int Nq, int th_low, void* ws,
                               void* counts, void* stream) {
  if (Ks < 0 || N <= 0 || Nq <= 0) return (int)cudaErrorInvalidValue;
  if (Ks == 0) return (int)cudaSuccess;
  if (((uintptr_t)kf_desc | (uintptr_t)q_desc) & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* base = (uint8_t*)ws;
  int* best12 = (int*)base;
  int* min12 = (int*)(base + align16(sizeof(int) * (size_t)Ks * Nq));
  int* best21 = (int*)(base + 2 * align16(sizeof(int) * (size_t)Ks * Nq));
  const uint8_t* kd = (const uint8_t*)kf_desc;
  const uint8_t* qd = (const uint8_t*)q_desc;
  const bool* kv = (const bool*)kf_valid;
  const bool* qv = (const bool*)q_valid;
  argmin_kernel<<<dim3(Ks, (Nq + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      qd, qv, Nq, false, kd, kv, N, true, best12, min12);
  argmin_kernel<<<dim3(Ks, (N + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      kd, kv, N, true, qd, qv, Nq, false, best21, nullptr);
  count_kernel<<<Ks, kThreads, 0, st>>>(best12, min12, best21, qv, Nq, N, th_low, (int*)counts);
  return (int)cudaGetLastError();
}
