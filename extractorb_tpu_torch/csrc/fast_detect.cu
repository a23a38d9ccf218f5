// K1 fast_detect: FAST-9/16 corner score + cell-bounded 3x3 NMS with the
// per-cell threshold retry, for every level of a flat image pyramid in one
// launch.
//
// Replaces extractorb_tpu/frontend/fast.py:corner_score and
// :detect_keypoints (the dense shift-and-min/max planes the TPU runs on its
// vector unit).  One CTA owns one FAST cell of one level, so the reference's
// per-cell semantics map onto the block: NMS never looks outside the cell
// (shared memory only), and "retry at min_th when the cell kept nothing at
// ini_th" is one __syncthreads_count.  The first and last cells of a row or
// column also score the plane's margins, so the CTAs write the whole (H, W)
// score plane exactly as the JAX function returns it.
//
// Bound on the H100: memory and launch latency, not arithmetic.  A frame
// reads the 640x480 pyramid once (~0.9 MB with borders) and writes 3 bytes
// per inner pixel; the 16x2 arc min/max per pixel is integer ALU work on a
// tile held in shared memory.  Each CTA loads its tile plus a 3-px halo
// once and never touches global memory again until it writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

struct FastLevel {
  int b_off, b_stride, W, H, o_off;
  int n_cols, n_rows, w_cell, h_cell;
  int x_end, y_end, block0;
};

struct FastTab {
  int n_levels, border, x0, ini_th, min_th;
  FastLevel lv[kMaxLevels];
};

// Bresenham circle of radius 3 in OpenCV makeOffsets order (dx, dy)
__constant__ int kCircle[16][2] = {
    {0, 3}, {1, 3}, {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
    {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}, {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}};

__device__ __forceinline__ int corner_score(const uint8_t* raw, int rw, int r, int c) {
  // raw tile has a 3-px halo: pixel (r, c) of the tile is raw[(r+3)*rw + c+3]
  const int v = raw[(r + 3) * rw + c + 3];
  int d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    d[k] = v - raw[(r + 3 + kCircle[k][1]) * rw + (c + 3 + kCircle[k][0])];
  int s_bright = -32768, s_dark = 32767;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    int mn = d[s], mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const int e = d[(s + j) & 15];
      mn = min(mn, e);
      mx = max(mx, e);
    }
    s_bright = max(s_bright, mn);
    s_dark = min(s_dark, mx);
  }
  return max(s_bright, -s_dark) - 1;
}

__global__ void __launch_bounds__(kThreads)
fast_detect_kernel(const uint8_t* __restrict__ pyr, int16_t* __restrict__ score_out,
                   uint8_t* __restrict__ keep_out, const FastTab tab) {
  extern __shared__ unsigned char smem[];
  int l = 0;
  while (l + 1 < tab.n_levels && (int)blockIdx.x >= tab.lv[l + 1].block0) ++l;
  const FastLevel L = tab.lv[l];
  const int cell = blockIdx.x - L.block0;
  const int ci = cell / L.n_cols, cj = cell % L.n_cols;
  const int x0 = tab.x0;
  // tile of this CTA in inner coords; edge cells extend to the margins
  const int tx0 = cj == 0 ? 0 : x0 + cj * L.w_cell;
  const int tx1 = cj == L.n_cols - 1 ? L.W : min(L.W, x0 + (cj + 1) * L.w_cell);
  const int ty0 = ci == 0 ? 0 : x0 + ci * L.h_cell;
  const int ty1 = ci == L.n_rows - 1 ? L.H : min(L.H, x0 + (ci + 1) * L.h_cell);
  const int tw = tx1 - tx0, th = ty1 - ty0, n = tw * th;
  const int rw = tw + 6, rh = th + 6;

  int16_t* s_score = reinterpret_cast<int16_t*>(smem);
  uint8_t* s_raw = smem + 2 * n;
  uint8_t* s_keep = s_raw + rw * rh;

  // raw tile + 3-px halo from the bordered level (border >= 3 always)
  const uint8_t* src = pyr + L.b_off + (size_t)(ty0 - 3 + tab.border) * L.b_stride +
                       (tx0 - 3 + tab.border);
  for (int i = threadIdx.x; i < rw * rh; i += blockDim.x) {
    const int r = i / rw, c = i - r * rw;
    s_raw[i] = src[(size_t)r * L.b_stride + c];
  }
  __syncthreads();

  int16_t* out_s = score_out + L.o_off;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / tw, c = i - r * tw;
    const int s = corner_score(s_raw, rw, r, c);
    s_score[i] = (int16_t)s;
    out_s[(size_t)(ty0 + r) * L.W + tx0 + c] = (int16_t)s;
  }
  __syncthreads();

  // NMS at threshold th: a neighbour counts only when it is a candidate
  // of this cell (region pixels of the tile are exactly those of the
  // cell); every other neighbour counts as 0.
  auto nonmax = [&](int thr) {
    int any = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / tw, c = i - r * tw;
      const int y = ty0 + r, x = tx0 + c;
      const int s = s_score[i];
      bool keep = x >= x0 && x < L.x_end && y >= x0 && y < L.y_end && s >= thr;
      if (keep) {
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            if (dx == 0 && dy == 0) continue;
            const int rr = r + dy, cc = c + dx, yy = y + dy, xx = x + dx;
            int ns = 0;
            if (rr >= 0 && rr < th && cc >= 0 && cc < tw && xx >= x0 && xx < L.x_end &&
                yy >= x0 && yy < L.y_end) {
              const int q = s_score[rr * tw + cc];
              ns = q >= thr ? q : 0;
            }
            keep = keep && s > ns;
          }
      }
      s_keep[i] = keep;
      any |= keep;
    }
    return __syncthreads_count(any);
  };

  if (nonmax(tab.ini_th) == 0) nonmax(tab.min_th);

  uint8_t* out_k = keep_out + L.o_off;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / tw, c = i - r * tw;
    out_k[(size_t)(ty0 + r) * L.W + tx0 + c] = s_keep[i];
  }
}

}  // namespace

extern "C" int fast_detect_launch(const void* pyr, void* score, void* keep,
                                  const int* tab_host, int n_blocks, int smem_bytes,
                                  void* stream) {
  FastTab tab;
  tab.n_levels = tab_host[0];
  tab.border = tab_host[1];
  tab.x0 = tab_host[2];
  tab.ini_th = tab_host[3];
  tab.min_th = tab_host[4];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int* rows = tab_host + 5;
  for (int l = 0; l < tab.n_levels; ++l) {
    const int* r = rows + 12 * l;
    tab.lv[l] = FastLevel{r[0], r[1], r[2], r[3], r[4], r[5],
                          r[6], r[7], r[8], r[9], r[10], r[11]};
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fast_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  fast_detect_kernel<<<n_blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)pyr, (int16_t*)score, (uint8_t*)keep, tab);
  return (int)cudaGetLastError();
}
