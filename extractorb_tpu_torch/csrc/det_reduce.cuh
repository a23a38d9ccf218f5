// Fixed-order reductions for K6 (ba_pcg.cu) and K20 (vi_ba.cu): every sum
// runs in an order that does not depend on scheduling, so a solve gives one
// result per input.
//
// * Observation lists, built once per solve: each keyframe's observations
//   in index order (one CTA per keyframe compacts the observation list with
//   block prefix sums), and each point's (an integer counting sort, then
//   each point's few entries sorted by index).  Integer atomics only: their
//   results, unlike float sums, do not depend on order.
// * Block sums: a fixed xor-shuffle tree in each warp, then the warps in
//   order.
// * Scalars (costs, CG dots): each CTA stores its partial, and the last CTA
//   to finish (an integer ticket) sums the partials in block order.  K6's
//   cluster solve keeps each partial in its CTA's shared memory instead,
//   and every CTA sums them all in block order (ba_pcg.cu): the same sum.
//
// Each file includes it inside its own anonymous namespace, after
// ba_obs.cuh (for warp_sum_d), with kThreads defined.
#pragma once

struct Lists {
  int* cnt_kf;   // (K,) observations per keyframe
  int* cnt_mp;   // (P,) per point
  int* cur_mp;   // (P,) scatter cursors
  int* off_kf;   // (K+1,) list offsets
  int* off_mp;   // (P+1,)
  int* list_kf;  // (O,) observation indices grouped by keyframe, in index order
  int* list_mp;  // (O,) grouped by point, in index order
};

// Each pass is a device function of one observation, point or keyframe,
// launched by the kernels below (build_lists) or looped over by a
// persistent kernel (K6's cluster solve), which zeroes the counters itself.
__device__ __forceinline__ void lists_count_obs(const int* obs_kf, const int* obs_mp,
                                                const bool* valid, int O, Lists L, int o) {
  if (o >= O || !valid[o]) return;
  atomicAdd(L.cnt_kf + obs_kf[o], 1);
  atomicAdd(L.cnt_mp + obs_mp[o], 1);
}

__global__ void __launch_bounds__(kThreads)
lists_count(const int* __restrict__ obs_kf, const int* __restrict__ obs_mp,
            const bool* __restrict__ valid, int O, Lists L) {
  lists_count_obs(obs_kf, obs_mp, valid, O, L, blockIdx.x * blockDim.x + threadIdx.x);
}

// exclusive scan of cnt (n) into off (n+1) by one CTA of kN threads
constexpr int kScanThreads = 1024;

template <int kN = kScanThreads>
__device__ void block_scan_into(const int* cnt, int n, int* off, int* sh) {
  const int chunk = (n + kN - 1) / kN;
  const int a = min(n, (int)threadIdx.x * chunk), b = min(n, a + chunk);
  int s = 0;
  for (int i = a; i < b; ++i) s += cnt[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int d = 1; d < kN; d <<= 1) {  // Hillis-Steele inclusive scan
    const int v = threadIdx.x >= d ? sh[threadIdx.x - d] : 0;
    __syncthreads();
    sh[threadIdx.x] += v;
    __syncthreads();
  }
  int run = sh[threadIdx.x] - s;
  for (int i = a; i < b; ++i) {
    off[i] = run;
    run += cnt[i];
  }
  if (threadIdx.x == kN - 1) off[n] = sh[kN - 1];
  __syncthreads();
}

__global__ void __launch_bounds__(kScanThreads) lists_scan(int K, int P, Lists L) {
  __shared__ int sh[kScanThreads];
  block_scan_into(L.cnt_kf, K, L.off_kf, sh);
  block_scan_into(L.cnt_mp, P, L.off_mp, sh);
}

// one CTA per keyframe k: its valid observations, in index order.  All
// threads of the CTA must call it.
__device__ void lists_fill_kf_block(const int* obs_kf, const bool* valid, int O, Lists L, int k) {
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = L.off_kf[k];
  __syncthreads();
  for (int o0 = 0; o0 < O; o0 += kThreads) {
    const int o = o0 + threadIdx.x;
    const bool f = o < O && valid[o] && obs_kf[o] == k;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    if (f) L.list_kf[base + before + __popc(bal & ((1u << lane) - 1u))] = o;
    __syncthreads();
    if (threadIdx.x == 0) base += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
lists_fill_kf(const int* __restrict__ obs_kf, const bool* __restrict__ valid, int O, Lists L) {
  lists_fill_kf_block(obs_kf, valid, O, L, blockIdx.x);
}

__device__ __forceinline__ void lists_fill_mp_obs(const int* obs_mp, const bool* valid, int O,
                                                  Lists L, int o) {
  if (o >= O || !valid[o]) return;
  const int m = obs_mp[o];
  L.list_mp[L.off_mp[m] + atomicAdd(L.cur_mp + m, 1)] = o;
}

__global__ void __launch_bounds__(kThreads)
lists_fill_mp(const int* __restrict__ obs_mp, const bool* __restrict__ valid, int O, Lists L) {
  lists_fill_mp_obs(obs_mp, valid, O, L, blockIdx.x * blockDim.x + threadIdx.x);
}

// point m's few entries in index order (insertion sort)
__device__ __forceinline__ void lists_sort_mp_point(int P, Lists L, int m) {
  if (m >= P) return;
  int* a = L.list_mp + L.off_mp[m];
  const int n = L.off_mp[m + 1] - L.off_mp[m];
  for (int i = 1; i < n; ++i) {
    const int x = a[i];
    int j = i - 1;
    while (j >= 0 && a[j] > x) {
      a[j + 1] = a[j];
      --j;
    }
    a[j + 1] = x;
  }
}

__global__ void __launch_bounds__(kThreads) lists_sort_mp(int P, Lists L) {
  lists_sort_mp_point(P, L, blockIdx.x * blockDim.x + threadIdx.x);
}

__host__ __device__ inline int n_blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// the lists of a solve; cnt_kf, cnt_mp and cur_mp are contiguous
inline cudaError_t build_lists(const int* obs_kf, const int* obs_mp, const bool* valid, int K,
                               int P, int O, Lists L, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(L.cnt_kf, 0, sizeof(int) * ((size_t)K + 2 * (size_t)P), st);
  if (e != cudaSuccess) return e;
  lists_count<<<n_blocks(O), kThreads, 0, st>>>(obs_kf, obs_mp, valid, O, L);
  lists_scan<<<1, kScanThreads, 0, st>>>(K, P, L);
  lists_fill_kf<<<K, kThreads, 0, st>>>(obs_kf, valid, O, L);
  lists_fill_mp<<<n_blocks(O), kThreads, 0, st>>>(obs_mp, valid, O, L);
  lists_sort_mp<<<n_blocks(P), kThreads, 0, st>>>(P, L);
  return cudaGetLastError();
}

// sum n floats per thread over the block, in a fixed order; the result is
// valid in thread 0.  All threads must call it.
template <int n>
__device__ void block_sum_fixed(float (&v)[n], float* red /* shared, n * kThreads / 32 */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  __syncthreads();
  if (lane == 0)
    for (int i = 0; i < n; ++i) red[warp * n + i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < n; ++i) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w * n + i];
      v[i] = s;
    }
}

// the block's double sum into partials[blockIdx.x]; the last block to finish
// sums the partials in block order into *out and resets the ticket.  All
// threads must call it.
__device__ void reduce_store(double v, double* partials, unsigned* ticket, double* out) {
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile double* vp = partials;
    double s = 0.0;
    for (unsigned b = 0; b < gridDim.x; ++b) s += vp[b];
    *out = s;
    *ticket = 0u;
  }
}
