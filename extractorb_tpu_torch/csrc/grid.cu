// K28 grid: the frame's keypoint grid (Frame::PosInGrid,
// AssignFeaturesToGrid, GetFeaturesInArea), three entry points.
//
// Replaces extractorb_tpu/frontend/grid.py:pos_in_grid (:31),
// assign_features_to_grid (:59) and features_in_area_mask (:96).  The JAX
// package builds the grid by a stable argsort of the cell ids, a
// searchsorted for each keypoint's rank within its cell and one scatter.
// Here:
//
//  - grid_pos and grid_area: a thread per keypoint, in the float32 order of
//    the JAX functions (a difference, then a product: nothing to contract;
//    the library is built with -fmad=false anyway).
//  - grid_assign: one CTA.  Its threads fill the grid with -1 and clear the
//    cell counters in shared memory; then one warp walks the keypoints in
//    index-ordered chunks of 32.  A lane's rank within its cell is the
//    cell's running count plus the lanes below it with the same cell
//    (__match_any_sync); the lowest such lane adds the chunk's count to the
//    counter after every lane has read it.  The rank follows the keypoint
//    index, so no atomic decides a slot, and a cell keeps its first
//    cell_capacity keypoints while its count covers all of them.
//
// Bound on the H100: launch latency.  1500 keypoints are 18 KB in; the
// 48 x 64 x 16 grid is 196 KB out, written by one CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAssignThreads = 1024;

struct Cell {
  int cx, cy;
  bool ok;
};

__device__ __forceinline__ Cell cell_of(const float2 p, const float* __restrict__ bounds, bool v,
                                        int rows, int cols) {
  const float min_x = bounds[0], max_x = bounds[1], min_y = bounds[2], max_y = bounds[3];
  const float inv_w = (float)cols / (max_x - min_x);
  const float inv_h = (float)rows / (max_y - min_y);
  Cell c;
  c.cx = (int)floorf((p.x - min_x) * inv_w);
  c.cy = (int)floorf((p.y - min_y) * inv_h);
  c.ok = v && c.cx >= 0 && c.cx < cols && c.cy >= 0 && c.cy < rows;
  return c;
}

__global__ void __launch_bounds__(kThreads)
grid_pos_kernel(const float2* __restrict__ xy, const float* __restrict__ bounds,
                const bool* __restrict__ valid, int n, int rows, int cols, int strict,
                int2* __restrict__ cell, bool* __restrict__ ok) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cell c = cell_of(xy[i], bounds, valid[i], rows, cols);
  if (!strict) {
    c.cx = min(max(c.cx, 0), cols - 1);
    c.cy = min(max(c.cy, 0), rows - 1);
  }
  cell[i] = make_int2(c.cx, c.cy);
  ok[i] = c.ok;
}

__global__ void __launch_bounds__(kAssignThreads)
grid_assign_kernel(const float2* __restrict__ xy, const float* __restrict__ bounds,
                   const bool* __restrict__ valid, int n, int rows, int cols, int cap,
                   int* __restrict__ grid, int* __restrict__ counts) {
  extern __shared__ int count[];   // rows * cols + 1: the last one takes the rest
  const int n_cells = rows * cols;
  const size_t n_slots = (size_t)n_cells * cap;
  for (size_t s = threadIdx.x; s < n_slots; s += kAssignThreads) grid[s] = -1;
  for (int c = threadIdx.x; c <= n_cells; c += kAssignThreads) count[c] = 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < n; base += 32) {
      const int i = base + (int)lane;
      int cid = n_cells;
      if (i < n) {
        const Cell c = cell_of(xy[i], bounds, valid[i], rows, cols);
        if (c.ok) cid = c.cy * cols + c.cx;
      }
      const unsigned same = __match_any_sync(0xffffffffu, cid);
      const int rank = count[cid] + __popc(same & below);
      if (cid < n_cells && rank < cap) grid[(size_t)cid * cap + rank] = i;
      __syncwarp();
      if ((unsigned)(__ffs(same) - 1) == lane) count[cid] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cells; c += kAssignThreads) counts[c] = count[c];
}

__global__ void __launch_bounds__(kThreads)
grid_area_kernel(const float2* __restrict__ xy, const int* __restrict__ octave,
                 const bool* __restrict__ valid, int n, float x, float y, float r,
                 int min_level, int max_level, bool* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 p = xy[i];
  const float dx = fabsf(p.x - x), dy = fabsf(p.y - y);
  bool in = valid[i] && dx < r && dy < r;
  if (min_level > 0 || max_level >= 0) in = in && octave[i] >= min_level && octave[i] <= max_level;
  out[i] = in;
}

}  // namespace

// xy (n,2) float32, bounds (4,) float32 on the device, valid (n,) bool;
// cell (n,2) int32 and ok (n,) bool are written.
extern "C" int grid_pos_launch(const void* xy, const void* bounds, const void* valid, int n,
                               int rows, int cols, int strict, void* cell, void* ok,
                               void* stream) {
  if (n < 0 || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  grid_pos_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(xy), static_cast<const float*>(bounds),
      static_cast<const bool*>(valid), n, rows, cols, strict, static_cast<int2*>(cell),
      static_cast<bool*>(ok));
  return (int)cudaGetLastError();
}

// grid (rows, cols, cap) int32 and counts (rows, cols) int32 are written;
// rows * cols + 1 counters must fit 48 KB of shared memory.
extern "C" int grid_assign_launch(const void* xy, const void* bounds, const void* valid, int n,
                                  int rows, int cols, int cap, void* grid, void* counts,
                                  void* stream) {
  if (n < 0 || rows < 1 || cols < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(rows * cols + 1) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  grid_assign_kernel<<<1, kAssignThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(xy), static_cast<const float*>(bounds),
      static_cast<const bool*>(valid), n, rows, cols, cap, static_cast<int*>(grid),
      static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

// xy (n,2) float32, octave (n,) int32, valid (n,) bool; out (n,) bool.
extern "C" int grid_area_launch(const void* xy, const void* octave, const void* valid, int n,
                                float x, float y, float r, int min_level, int max_level,
                                void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  grid_area_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(xy), static_cast<const int*>(octave),
      static_cast<const bool*>(valid), n, x, y, r, min_level, max_level,
      static_cast<bool*>(out));
  return (int)cudaGetLastError();
}
