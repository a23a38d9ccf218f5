// The persistent cluster solves K6 (ba_pcg.cu) and K20 (vi_ba.cu) run a
// whole LM-PCG solve in one launch of one thread-block cluster of G CTAs.
// Pass by pass, CTA rank runs the multi-launch grid's CTAs as virtual blocks
// b = rank, rank + G, ..., and a cluster barrier stands where a kernel
// boundary stood.  A scalar's block partial (the same warp tree as
// det_reduce.cuh's reduce_store) is written through distributed shared
// memory into slot b of the scalar's region in every CTA, and after the
// barrier each CTA sums its copy in block order, as reduce_store's last CTA
// does: every CTA holds the same scalars, and a cluster solve is bit-equal
// to its multi-launch sequence whatever G is.
//
// Each file includes it inside its own anonymous namespace, after
// <cooperative_groups.h>, <atomic>, ba_obs.cuh (for warp_sum_d) and
// det_reduce.cuh, with kThreads defined.
#pragma once

// virtual block b's partial of v (the warp tree, then the warps in order,
// as reduce_store) into slot b of region in each of the cluster's G CTAs.
// All threads must call it.
__device__ void block_partial(cooperative_groups::cluster_group& cl, int G, double v,
                              double* region, int b) {
  __shared__ double red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w2 = 0; w2 < kThreads / 32; ++w2) s += red[w2];
    for (int r = 0; r < G; ++r) *cl.map_shared_rank(region + b, r) = s;
  }
  __syncthreads();
}

// A pass's block partials, pushed together (K20): each virtual block of
// the pass that the CTA runs adds its value through the warp tree as it is
// made, lane 0 keeping its warp's sum in red[j kWarps + warp] for the
// CTA's j-th block of the pass and thread 0 its block index in blk[j];
// push() sums each block's warps in order (as block_partial) and writes its
// slot of region in every CTA of the cluster, a thread a (block, CTA)
// pair, behind one CTA barrier where block_partial takes two a block.  The
// caller's cluster barrier follows each push.
struct PassPartials {
  double* red;   // shared: (the most virtual blocks of a CTA) x kWarps
  int* blk;      // shared: the block of each
  int n = 0;     // the pass's blocks added so far

  __device__ void add(double v, int b) {
    v = warp_sum_d(v);
    if ((threadIdx.x & 31) == 0) red[n * (kThreads / 32) + (threadIdx.x >> 5)] = v;
    if (threadIdx.x == 0) blk[n] = b;
    ++n;
  }
  // N blocks' values at once (their warp trees interleaved), the first
  // count of them kept, blocks b[0..count)
  template <int N>
  __device__ void add_n(double (&v)[N], int count, const int (&b)[N]) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int c = 0; c < N; ++c) v[c] += __shfl_xor_sync(0xffffffffu, v[c], o);
    if ((threadIdx.x & 31) == 0)
      for (int c = 0; c < count; ++c) red[(n + c) * (kThreads / 32) + (threadIdx.x >> 5)] = v[c];
    if (threadIdx.x == 0)
      for (int c = 0; c < count; ++c) blk[n + c] = b[c];
    n += count;
  }
  __device__ void push(cooperative_groups::cluster_group& cl, int G, double* region) {
    __syncthreads();
    for (int i = threadIdx.x; i < n * G; i += kThreads) {
      const int j = i / G, r = i % G;
      double s = 0.0;
      for (int w2 = 0; w2 < kThreads / 32; ++w2) s += red[j * (kThreads / 32) + w2];
      *cl.map_shared_rank(region + blk[j], r) = s;
    }
    n = 0;
  }
};

// the sum in block order of this CTA's copy of nb partials; every thread
// sums them itself (eight loads issued ahead of their adds)
__device__ double region_sum(const double* region, int nb) {
  double s = 0.0;
  int b = 0;
  for (; b + 8 <= nb; b += 8) {
    double x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = region[b + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += x[i];
  }
  for (; b < nb; ++b) s += region[b];
  return s;
}

// the launch configuration of a one-dimensional cluster of g CTAs
struct ClusterCfg {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterCfg(int g, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(g);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// the cluster size for dynamic shared memory smem: g_max CTAs where the
// card can place such a cluster, else 8; raises (an error) where neither
// fits.  Sets the kernel's dynamic shared memory limit to smem.  cache
// keeps the largest smem asked for and the answer.
template <class F>
cudaError_t pick_cluster(F kernel, size_t smem, int g_max, std::atomic<long long>& cache,
                         int* G) {
  cudaError_t e;
  if (g_max > 8 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  const long long c = cache.load();   // smem << 8 | G
  if ((c & 0xff) != 0 && (size_t)(c >> 8) >= smem) {
    *G = (int)(c & 0xff);
    return cudaSuccess;
  }
  *G = 0;
  for (int g = g_max; g >= 8 && *G == 0; g /= 2) {
    ClusterCfg lc(g, smem, nullptr);
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, kernel, &lc.cfg)) != cudaSuccess) return e;
    if (n >= 1) *G = g;
  }
  if (*G == 0) return cudaErrorInvalidConfiguration;  // not even 8 CTAs fit
  cache.store((long long)smem << 8 | *G);
  return cudaSuccess;
}
