// K2 orb_describe: IC-angle orientation + 7x7 fixed-point Gaussian blur +
// rotated BRIEF, fused, for keypoints of every pyramid level in one launch.
//
// Replaces extractorb_tpu/frontend/orientation.py:ic_angle (+ gather_patches),
// blur.py:gaussian_blur7/blur_level and brief.py:compute_descriptors +
// pack_bits_u8.  On the TPU those are a batched patch gather, a whole-level
// blur and one-hot MXU contractions standing in for 512 irregular gathers
// per keypoint.  Here one warp owns one keypoint: it copies a 43x43 raw patch
// of the bordered level into shared memory, sums the int32 moments over the
// umax disc, blurs only the central 37x37 (every rotated sample lies within
// +-18 of the keypoint, and every keypoint lies >= 19 px inside the level, so
// all samples fall in the blurred inner region and the blur's +-3 reads land
// in the bordered level's reflect-101 ring), then reads the 512 samples
// straight from shared memory.  The blurred level never exists in memory.
//
// Rounding matches the plain PyTorch version op for op: the library is
// built with -fmad=false, and float32 arithmetic goes through
// __fmul_rn/__fadd_rn/__fsub_rn besides (never contracted into FMAs); the
// fused multiply-adds that XLA:CPU forms in the JAX function are computed
// in float64 (where the float32 product is exact) and rounded once, and
// cos/sin are taken in float64 and rounded to float32.
//
// Bound on the H100: latency of the per-warp patch copy (1.8 KB of scattered
// 43-byte rows from L2) and the shared-memory blur; ~1100 keypoints a frame
// fill only ~280 CTAs of 4 warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;
constexpr int kRaw = 43;    // raw patch side: 2 * (18 + 3) + 1
constexpr int kBlur = 37;   // blurred patch side: 2 * 18 + 1
constexpr int kR = 18;
constexpr int kHalf = 15;   // IC-angle disc radius
constexpr int kRawBytes = 1852;            // 43*43 rounded up to 4
constexpr int kRowBytes = kRaw * kBlur * 2;  // uint16 row-pass sums
constexpr int kBlurBytes = 1372;           // 37*37 rounded up to 4
constexpr int kWarpBytes = kRawBytes + kRowBytes + kBlurBytes;

struct DescTab {
  int n_levels, border;
  int off[kMaxLevels], stride[kMaxLevels];
};

__constant__ int kTaps[7] = {18, 34, 48, 56, 48, 34, 18};

// fastAtan2 constants (OpenCV mathfuncs.cpp, scaled to degrees), the exact
// float32 values of orientation.py's _P1.._P7
__constant__ float kP1 = 0x1.ca44dcp+5f;
__constant__ float kP3 = -0x1.2aaddcp+4f;
__constant__ float kP5 = 0x1.1d3f7ep+3f;
__constant__ float kP7 = -0x1.4515b2p+1f;
constexpr float kFltEps = 0x1p-23f;
constexpr float kDeg2Rad = 0x1.1df46ap-6f;  // float32(pi / 180)

__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

__device__ float fast_atan2_deg(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool big = ax >= ay;
  const float c = __fdiv_rn(big ? ay : ax, __fadd_rn(big ? ax : ay, kFltEps));
  const float c2 = __fmul_rn(c, c);
  float a = __fmul_rn(fma_f64(fma_f64(fma_f64(kP7, c2, kP5), c2, kP3), c2, kP1), c);
  if (!big) a = __fsub_rn(90.0f, a);
  if (x < 0) a = __fsub_rn(180.0f, a);
  if (y < 0) a = __fsub_rn(360.0f, a);
  return a;
}

__global__ void __launch_bounds__(kWarps * 32)
orb_describe_kernel(const uint8_t* __restrict__ pyr, const int* __restrict__ xy,
                    const int* __restrict__ level, const bool* __restrict__ valid, int K,
                    const int8_t* __restrict__ pattern, const int* __restrict__ umax,
                    float* __restrict__ angle_out, uint8_t* __restrict__ desc_out,
                    const DescTab tab) {
  __shared__ __align__(16) unsigned char smem[kWarps * kWarpBytes];
  __shared__ int8_t s_pat[256 * 4];
  __shared__ int s_umax[kHalf + 1];
  for (int i = threadIdx.x; i < 256 * 4; i += blockDim.x) s_pat[i] = pattern[i];
  if (threadIdx.x <= kHalf) s_umax[threadIdx.x] = umax[threadIdx.x];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;
  if (!valid[k]) {
    desc_out[(size_t)k * 32 + lane] = 0;
    if (lane == 0) angle_out[k] = 0.0f;
    return;
  }
  uint8_t* raw = smem + warp * kWarpBytes;
  uint16_t* rows = reinterpret_cast<uint16_t*>(raw + kRawBytes);
  uint8_t* blur = raw + kRawBytes + kRowBytes;

  const int l = level[k];
  const int x = xy[2 * k], y = xy[2 * k + 1];
  const int stride = tab.stride[l];
  const uint8_t* base = pyr + tab.off[l] +
                        (size_t)(y + tab.border - kR - 3) * stride + (x + tab.border - kR - 3);
  for (int i = lane; i < kRaw * kRaw; i += 32) {
    const int r = i / kRaw, c = i - r * kRaw;
    raw[i] = base[(size_t)r * stride + c];
  }
  __syncwarp();

  // intensity-centroid moments over the umax disc of the raw level
  const int ctr = kR + 3;
  int m10 = 0, m01 = 0;
  for (int i = lane; i < 31 * 31; i += 32) {
    const int v = i / 31 - kHalf, u = i % 31 - kHalf;
    if (abs(u) <= s_umax[abs(v)]) {
      const int val = raw[(ctr + v) * kRaw + ctr + u];
      m10 += u * val;
      m01 += v * val;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, o);
    m01 += __shfl_xor_sync(0xffffffffu, m01, o);
  }
  const float angle = fast_atan2_deg((float)m01, (float)m10);

  // separable fixed-point blur of the central 37x37; row sums <= 255*256
  for (int i = lane; i < kRaw * kBlur; i += 32) {
    const int r = i / kBlur, c = i - r * kBlur;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc += kTaps[t] * raw[r * kRaw + c + t];
    rows[i] = (uint16_t)acc;
  }
  __syncwarp();
  for (int i = lane; i < kBlur * kBlur; i += 32) {
    const int r = i / kBlur, c = i - r * kBlur;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) acc += kTaps[t] * (int)rows[(r + t) * kBlur + c];
    blur[i] = (uint8_t)min(255, (acc + 32768) >> 16);
  }
  __syncwarp();

  // rotated BRIEF: lane owns descriptor byte `lane`
  const float ar = __fmul_rn(angle, kDeg2Rad);
  const float a = (float)cos((double)ar), b = (float)sin((double)ar);
  auto sample = [&](int px_i, int py_i) {
    const float px = (float)px_i, py = (float)py_i;
    int dy = (int)rintf(fma_f64(px, b, __fmul_rn(py, a)));
    int dx = (int)rintf(fma_f64(px, a, -__fmul_rn(py, b)));
    dy = min(kR, max(-kR, dy));
    dx = min(kR, max(-kR, dx));
    return (int)blur[(kR + dy) * kBlur + kR + dx];
  };
  unsigned byte = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int8_t* p = s_pat + (lane * 8 + j) * 4;
    const int t0 = sample(p[0], p[1]);
    const int t1 = sample(p[2], p[3]);
    byte |= (unsigned)(t0 < t1) << j;
  }
  desc_out[(size_t)k * 32 + lane] = (uint8_t)byte;
  if (lane == 0) angle_out[k] = angle;
}

}  // namespace

extern "C" int orb_describe_launch(const void* pyr, const void* xy, const void* level,
                                   const void* valid, int K, const void* pattern,
                                   const void* umax, const int* tab_host, void* angle,
                                   void* desc, void* stream) {
  DescTab tab;
  tab.n_levels = tab_host[0];
  tab.border = tab_host[1];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < tab.n_levels; ++l) {
    tab.off[l] = tab_host[2 + 2 * l];
    tab.stride[l] = tab_host[3 + 2 * l];
  }
  if (K <= 0) return (int)cudaGetLastError();
  const int blocks = (K + kWarps - 1) / kWarps;
  orb_describe_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pyr, (const int*)xy, (const int*)level, (const bool*)valid, K,
      (const int8_t*)pattern, (const int*)umax, (float*)angle, (uint8_t*)desc, tab);
  return (int)cudaGetLastError();
}
