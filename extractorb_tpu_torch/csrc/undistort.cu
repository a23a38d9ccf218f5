// K24 undistort: radial-tangential undistortion of keypoint pixels, then
// re-projection through K; and a counter of a captured CUDA graph's nodes.
//
// Replaces extractorb_tpu/core/camera.py:undistort_points_pinhole (an
// 8-iteration fori_loop of elementwise jnp ops on the TPU).  Its plain
// PyTorch version (core/camera.py:undistort_points_pinhole_plain) runs
// ~170 elementwise launches a call on the card; here one thread carries one
// keypoint through the 8 fixed compensation iterations (cv::undistortPoints'
// default count) in registers.  The operation order is the plain version's,
// operation by operation, and the library is built with -fmad=false, so
// every product and sum rounds as PyTorch's elementwise kernels round them:
// the kernel is bit-equal to the plain version on the card.  The constants
// arrive as the float32 values the plain version multiplies by (1/fx and
// 1/fy included: the plain version multiplies by the rounded reciprocals).
//
// Bound on the H100: launch latency.  1128 keypoints are 9 KB in and 9 KB
// out; each does ~170 float operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Undist {
  float fx, fy, cx, cy, ifx, ify;  // K and the float32 reciprocals 1/fx, 1/fy
  float k1, k2, k3, p1, p2;        // distortion
  float tp1, tp2;                  // 2 * p1, 2 * p2 (exact in float32)
};

__global__ void __launch_bounds__(kThreads)
undistort_kernel(const float2* __restrict__ uv, int n, const Undist c, float2* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 p = uv[i];
  const float x0 = (p.x - c.cx) * c.ifx;
  const float y0 = (p.y - c.cy) * c.ify;
  float x = x0, y = y0;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const float r2 = x * x + y * y;
    const float icdist = 1.0f / (1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3)));
    const float dx = c.tp1 * x * y + c.p2 * (r2 + 2.0f * x * x);
    const float dy = c.p1 * (r2 + 2.0f * y * y) + c.tp2 * x * y;
    const float xn = (x0 - dx) * icdist;
    const float yn = (y0 - dy) * icdist;
    x = xn;
    y = yn;
  }
  out[i] = make_float2(x * c.fx + c.cx, y * c.fy + c.cy);
}

}  // namespace

// prm: fx, fy, cx, cy, 1/fx, 1/fy, k1, k2, k3, p1, p2 (float32, host)
extern "C" int undistort_launch(const void* uv, int n, const float* prm, void* out,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const Undist c{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6], prm[7], prm[8],
                 prm[9], prm[10], 2.0f * prm[9], 2.0f * prm[10]};
  undistort_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(uv), n, c, static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// The nodes of a captured graph (a cudaGraph_t kept after capture):
// returns the kernel nodes and writes the count of all nodes to *total;
// -1 if the graph cannot be read.
extern "C" int graph_kernel_nodes(void* graph, int* total) {
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  if (cudaGraphGetNodes(g, nullptr, &n) != cudaSuccess) return -1;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  int kernels = 0;
  if (cudaGraphGetNodes(g, nodes, &n) != cudaSuccess) {
    delete[] nodes;
    return -1;
  }
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) {
      delete[] nodes;
      return -1;
    }
    kernels += t == cudaGraphNodeTypeKernel;
  }
  delete[] nodes;
  *total = (int)n;
  return kernels;
}
