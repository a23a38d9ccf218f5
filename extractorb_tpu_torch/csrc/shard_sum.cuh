// Cross-shard sums for the sharded solvers K30 (ba_schur.cu) and K31
// (pose_graph.cu): the counterpart of the JAX programs' psum.
//
// Each shard of a solve keeps its own workspace and its own copy of the
// replicated state (the poses), computes partial sums over its share of
// the data, and at each psum of the JAX program calls allreduce on those
// partials: afterwards every shard holds the same sum, taken in shard order
// (shard 0 first), so a solve gives one result per input whatever the
// number of devices.
//
// * Shards on one device (the one-card route): one small kernel reads every
//   shard's partial and writes the sum back to each, on the shared stream.
// * Shards on more than one device (the peer route): each shard's stream
//   records an event, shard 0's stream waits for all of them, the partials
//   come by cudaMemcpyPeerAsync into n slots on shard 0's device, the same
//   kernel sums them there and writes the sum to every slot, the slots go
//   back by peer copies, and every other shard's stream waits for shard 0's.
//
// Each file includes it inside its own anonymous namespace.
#pragma once

constexpr int kMaxShards = 64;

template <class T>
struct ShardPtrs {
  T* p[kMaxShards];
};

template <class T>
__global__ void shard_sum_kernel(ShardPtrs<T> ptrs, int n, long long count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  T acc = ptrs.p[0][i];
  for (int s = 1; s < n; ++s) acc += ptrs.p[s][i];
  for (int s = 0; s < n; ++s) ptrs.p[s][i] = acc;
}

struct ShardComm {
  int n = 1;
  int dev[kMaxShards];           // device of each shard
  cudaStream_t st[kMaxShards];   // its stream
  bool peer = false;             // shards on more than one device
  cudaEvent_t ev[kMaxShards];    // peer route: shard s's stream reached the sum
  uint8_t* gather = nullptr;     // peer route: n slots on shard 0's device
  size_t slot = 0;               // bytes per slot
};

// peer route: make the current device shard s's (the one-card route leaves
// the caller's current device, which is the shards' one)
inline cudaError_t use_shard(const ShardComm& c, int s) {
  return c.peer ? cudaSetDevice(c.dev[s]) : cudaSuccess;
}

// n shards on devs (host array) with their streams; gather: n slots of
// slot bytes on devs[0], used when the devices differ.  All shards of one
// device must share one stream.
inline cudaError_t comm_open(ShardComm& c, int n, const int* devs, const cudaStream_t* sts,
                             void* gather, size_t slot) {
  if (n < 1 || n > kMaxShards) return cudaErrorInvalidValue;
  c.n = n;
  c.peer = false;
  for (int s = 0; s < n; ++s) {
    c.dev[s] = devs[s];
    c.st[s] = sts[s];
    if (devs[s] != devs[0]) c.peer = true;
    for (int r = 0; r < s; ++r)
      if (devs[r] == devs[s] && sts[r] != sts[s]) return cudaErrorInvalidValue;
  }
  if (!c.peer) return cudaSuccess;
  if (gather == nullptr) return cudaErrorInvalidValue;
  c.gather = (uint8_t*)gather;
  c.slot = slot;
  for (int s = 0; s < n; ++s) {
    cudaError_t e = cudaSetDevice(c.dev[s]);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&c.ev[s], cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// events are released once the work enqueued on them completes
inline void comm_close(ShardComm& c) {
  if (!c.peer) return;
  for (int s = 0; s < c.n; ++s) cudaEventDestroy(c.ev[s]);
}

// every shard's ptrs[s][0:count) replaced by their sum in shard order
template <class T>
cudaError_t allreduce(ShardComm& c, T* const* ptrs, long long count) {
  if (c.n == 1 || count == 0) return cudaSuccess;
  const int threads = 256;
  const int nb = (int)((count + threads - 1) / threads);
  ShardPtrs<T> sp;
  cudaError_t e;
  if (!c.peer) {
    for (int s = 0; s < c.n; ++s) sp.p[s] = ptrs[s];
    shard_sum_kernel<T><<<nb, threads, 0, c.st[0]>>>(sp, c.n, count);
    return cudaGetLastError();
  }
  const size_t bytes = sizeof(T) * (size_t)count;
  if (bytes > c.slot) return cudaErrorInvalidValue;
  for (int s = 1; s < c.n; ++s) {
    if ((e = cudaSetDevice(c.dev[s])) != cudaSuccess) return e;
    if ((e = cudaEventRecord(c.ev[s], c.st[s])) != cudaSuccess) return e;
  }
  if ((e = cudaSetDevice(c.dev[0])) != cudaSuccess) return e;
  for (int s = 1; s < c.n; ++s)
    if ((e = cudaStreamWaitEvent(c.st[0], c.ev[s], 0)) != cudaSuccess) return e;
  for (int s = 0; s < c.n; ++s) {
    sp.p[s] = (T*)(c.gather + (size_t)s * c.slot);
    e = cudaMemcpyPeerAsync(sp.p[s], c.dev[0], ptrs[s], c.dev[s], bytes, c.st[0]);
    if (e != cudaSuccess) return e;
  }
  shard_sum_kernel<T><<<nb, threads, 0, c.st[0]>>>(sp, c.n, count);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int s = 0; s < c.n; ++s) {
    e = cudaMemcpyPeerAsync(ptrs[s], c.dev[s], sp.p[s], c.dev[0], bytes, c.st[0]);
    if (e != cudaSuccess) return e;
  }
  if ((e = cudaEventRecord(c.ev[0], c.st[0])) != cudaSuccess) return e;
  for (int s = 1; s < c.n; ++s) {
    if ((e = cudaSetDevice(c.dev[s])) != cudaSuccess) return e;
    if ((e = cudaStreamWaitEvent(c.st[s], c.ev[0], 0)) != cudaSuccess) return e;
  }
  return cudaSuccess;
}
