// K27 clahe: contrast-limited adaptive histogram equalisation of a uint8
// image with tiles x tiles tiles, in two launches.
//
// Replaces extractorb_tpu/utils/clahe.py:clahe (one jitted program: the
// per-tile 256-bin histogram as a one-hot contraction on the TPU's matrix
// unit, the clip and redistribution, a cumulative sum per tile, then a
// bilinear blend of four gathered LUTs per pixel).  Here:
//
//  1. clahe_lut_kernel, one CTA of 256 threads per tile: the histogram by
//     integer atomics in shared memory (exact, free of order), then the clip
//     excess and the cumulative histogram in float32 in the order of
//     utils/clahe.py:clahe_lut_plain (the order XLA:CPU compiles the JAX
//     function to: the excess in 8 runs of 32 bins; the CDF as 16 runs of 16,
//     a prefix inside each run plus a prefix of the run totals), then the LUT
//     as uint8.
//  2. clahe_apply_kernel, one thread per pixel: the tile coordinates and the
//     blend of the four neighbouring tiles' LUT entries (read through the
//     read-only cache), with the plain version's three fused multiply-adds
//     taken in double and rounded once to float (the float product is exact
//     in double, so this is a float32 FMA); rintf rounds half to even as
//     torch.round.  Pixels past the last whole tile are copied.
//
// The library is built with -fmad=false, so no other product and sum are
// contracted: the kernel is bit-equal to clahe_plain on the card.
//
// Bound on the H100: memory.  The image is read twice (histogram, blend)
// and written once; at 640x480 that is ~0.9 MB, ~0.3 us at 3.35 TB/s, far
// below the two launches' latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kRunExcess = 32;   // 8 runs
constexpr int kRunCdf = 16;      // 16 runs

__global__ void __launch_bounds__(kBins)
clahe_lut_kernel(const uint8_t* __restrict__ img, int W, int tiles, int th, int tw, float limit,
                 float scale, uint8_t* __restrict__ lut) {
  __shared__ int hist[kBins];
  __shared__ float over[kBins];
  __shared__ float clip[kBins];
  __shared__ float run[kBins / kRunExcess];
  __shared__ float outer[kBins / kRunCdf];
  __shared__ float excess;
  const int t = threadIdx.x;
  const int ty = blockIdx.x / tiles, tx = blockIdx.x % tiles;
  hist[t] = 0;
  __syncthreads();
  const int n = th * tw;
  const uint8_t* base = img + (size_t)ty * th * W + (size_t)tx * tw;
  for (int p = t; p < n; p += kBins) {
    const int r = p / tw, c = p - r * tw;
    atomicAdd(&hist[base[(size_t)r * W + c]], 1);
  }
  __syncthreads();
  const float h = (float)hist[t];
  const float cl = fminf(h, limit);
  over[t] = h - cl;
  clip[t] = cl;
  __syncthreads();
  if (t < kBins / kRunExcess) {
    float s = 0.0f;
    for (int k = 0; k < kRunExcess; ++k) s = s + over[t * kRunExcess + k];
    run[t] = s;
  }
  __syncthreads();
  if (t == 0) {
    float e = 0.0f;
    for (int g = 0; g < kBins / kRunExcess; ++g) e = e + run[g];
    excess = e;
  }
  __syncthreads();
  clip[t] = clip[t] + excess * (1.0f / 256.0f);
  __syncthreads();
  if (t < kBins / kRunCdf) {   // the prefix inside run t, in place
    float s = 0.0f;
    for (int k = 0; k < kRunCdf; ++k) {
      s = s + clip[t * kRunCdf + k];
      clip[t * kRunCdf + k] = s;
    }
  }
  __syncthreads();
  if (t == 0) {                // the prefix of the run totals
    float s = 0.0f;
    for (int g = 0; g < kBins / kRunCdf; ++g) {
      outer[g] = s;
      s = s + clip[g * kRunCdf + kRunCdf - 1];
    }
  }
  __syncthreads();
  const float cdf = clip[t] + outer[t / kRunCdf];
  const float v = fminf(fmaxf(rintf(cdf * scale), 0.0f), 255.0f);
  lut[(size_t)blockIdx.x * kBins + t] = (uint8_t)v;
}

// a * b + c rounded once to float (the float product is exact in double)
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// the lower tile, upper tile and the upper one's weight of row or column i
__device__ __forceinline__ void axis(int i, float rcp, int tiles, int& lo, int& hi, float& w) {
  const float v = fma_once((float)i + 0.5f, rcp, -0.5f);
  const float f = fminf(fmaxf(floorf(v), 0.0f), (float)(tiles - 1));
  lo = (int)f;
  hi = min(lo + 1, tiles - 1);
  w = fminf(fmaxf(v - (float)lo, 0.0f), 1.0f);
}

__global__ void clahe_apply_kernel(const uint8_t* __restrict__ img, int H, int W, int tiles,
                                   int th, int tw, float rcp_h, float rcp_w,
                                   const uint8_t* __restrict__ lut, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t at = (size_t)y * W + x;
  const int p = img[at];
  if (y >= th * tiles || x >= tw * tiles) {
    out[at] = (uint8_t)p;
    return;
  }
  int y0, y1, x0, x1;
  float wy, wx;
  axis(y, rcp_h, tiles, y0, y1, wy);
  axis(x, rcp_w, tiles, x0, x1, wx);
  const float l00 = (float)__ldg(lut + ((size_t)(y0 * tiles + x0) * kBins + p));
  const float l01 = (float)__ldg(lut + ((size_t)(y0 * tiles + x1) * kBins + p));
  const float l10 = (float)__ldg(lut + ((size_t)(y1 * tiles + x0) * kBins + p));
  const float l11 = (float)__ldg(lut + ((size_t)(y1 * tiles + x1) * kBins + p));
  const float owy = 1.0f - wy, owx = 1.0f - wx;
  const float top = fma_once(wx, l01, owx * l00);
  const float bottom = fma_once(owx, l10, wx * l11);
  const float blend = fma_once(owy, top, wy * bottom);
  out[at] = (uint8_t)fminf(fmaxf(rintf(blend), 0.0f), 255.0f);
}

}  // namespace

// img (H, W) uint8; limit, scale, 1/th and 1/tw as the float32 constants of
// utils/clahe.py:_lut_constants and _reciprocals; lut (tiles, tiles, 256)
// uint8 and out (H, W) uint8 are written.
extern "C" int clahe_launch(const void* img, int H, int W, int tiles, float limit, float scale,
                            float rcp_h, float rcp_w, void* lut, void* out, void* stream) {
  if (tiles < 1 || H < tiles || W < tiles) return (int)cudaErrorInvalidValue;
  const int th = H / tiles, tw = W / tiles;
  cudaStream_t s = (cudaStream_t)stream;
  clahe_lut_kernel<<<tiles * tiles, kBins, 0, s>>>(static_cast<const uint8_t*>(img), W, tiles,
                                                    th, tw, limit, scale,
                                                    static_cast<uint8_t*>(lut));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  clahe_apply_kernel<<<grid, block, 0, s>>>(static_cast<const uint8_t*>(img), H, W, tiles, th,
                                            tw, rcp_h, rcp_w, static_cast<const uint8_t*>(lut),
                                            static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
