// K9 stereo_match: rectified stereo matching of the left keypoints
// (right-image u, disparity, depth).
//
// Replaces extractorb_tpu/frontend/stereo.py:compute_stereo_matches, which the
// TPU runs as a masked dense (NL, NR) Hamming matrix (bf16 bit-plane matmuls
// on the MXU), one flat gather of an 11x11 left window and an 11x21 right
// strip per keypoint, all 11 SAD shifts as one tensor op and a full sort for
// the median.  Here:
//
// Launch 1, one warp per left keypoint.  The lanes stride over the right
// keypoints and test the gates first (both valid, right octave within +-1 of
// the left one, |y_l - y_r| <= 2 scale[octave_r] + 1, 0 <= x_l - x_r <= bf/b);
// only a pair inside them reads the right descriptor, XORs 8 words and
// popcounts.  A packed (distance << 16 | j) minimum over the warp keeps the
// lowest index on ties, as jnp.argmin does.  Below TH_ORB the warp copies the
// left window and the right strip from the flat bordered pyramid into shared
// memory (start indices clamped as dynamic_slice clamps them), lanes 0-10 take
// the 11 centre-subtracted SADs, and lane 0 takes the first argmin, the
// parabola and the disparity.  The disparity x_l - scale * shift is one fmaf:
// XLA contracts that expression, and the plain version rounds it once too.
//
// Launch 2, one CTA: the median cut.  The SADs of the provisional matches
// (integers) go to shared memory; each thread ranks its own against all of
// them, and the one whose rank brackets n_ok / 2 is the median (the
// (n_ok/2)-th smallest, the JAX sort's pick).  Then the final flag
// sad < 2.1f * median, u_right and depth = bf / disparity.
//
// Bound on the H100: latency.  The work is ~1.3 M gate tests and a few
// thousand descriptor XORs and SAD windows per frame (about 1 ms of one SM's
// issue, spread over 282 CTAs); the two dependent launches and the serial
// parabola of lane 0 set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLevels = 32;
constexpr int kBorder = 19;  // EDGE_THRESHOLD of the bordered pyramid
constexpr int kW = 5;        // half window (11 x 11)
constexpr int kL = 5;        // shifts -5..5
constexpr int kWin = 2 * kW + 1;
constexpr int kStrip = kWin + 2 * kL;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kCutThreads = 1024;
constexpr float kCut = (float)(1.5 * 1.4);  // rounded once to float32

struct Levels {
  int off[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
  float scale[kMaxLevels], inv[kMaxLevels];
};

__global__ void __launch_bounds__(kWarps * 32)
stereo_search_kernel(const float2* __restrict__ xy_l, const int* __restrict__ oct_l,
                     const uint4* __restrict__ desc_l, const bool* __restrict__ valid_l, int NL,
                     const float2* __restrict__ xy_r, const int* __restrict__ oct_r,
                     const uint4* __restrict__ desc_r, const bool* __restrict__ valid_r, int NR,
                     const uint8_t* __restrict__ flat_l, const uint8_t* __restrict__ flat_r,
                     const Levels lv, int n_lvl, float max_d, int th_orb,
                     float* __restrict__ u_r_out, float* __restrict__ disp_out,
                     bool* __restrict__ ok_out, float* __restrict__ sad_out) {
  __shared__ uint8_t s_left[kWarps][kWin * kWin];
  __shared__ uint8_t s_right[kWarps][kWin * kStrip];
  __shared__ int s_sad[kWarps][kWin];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= NL) return;  // the whole warp leaves together

  unsigned key = kNone;
  const float2 pl = xy_l[i];
  const int ol = oct_l[i];
  if (valid_l[i]) {
    const uint4 a0 = desc_l[2 * i], a1 = desc_l[2 * i + 1];
    for (int j = lane; j < NR; j += 32) {
      if (!valid_r[j]) continue;
      const int o = oct_r[j];
      if (o < ol - 1 || o > ol + 1) continue;
      const float2 pr = xy_r[j];
      const float rowband = 2.0f * lv.scale[min(max(o, 0), n_lvl - 1)];
      if (!(fabsf(pl.y - pr.y) <= rowband + 1.0f)) continue;
      const float du = pl.x - pr.x;
      if (!(du >= 0.0f && du <= max_d)) continue;
      const uint4 b0 = desc_r[2 * j], b1 = desc_r[2 * j + 1];
      const unsigned d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      key = min(key, (d << 16) | (unsigned)j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, off));

  float u_r = 0.0f, disparity = 0.0f, sad = 0.0f;
  bool ok = false;
  if (key != kNone && (int)(key >> 16) < th_orb) {  // warp-uniform
    const int j = (int)(key & 0xffffu);
    const int lvl = min(max(ol, 0), n_lvl - 1);
    const float inv = lv.inv[lvl];
    const int uL = (int)rintf(pl.x * inv), vL = (int)rintf(pl.y * inv);
    const int uR0 = (int)rintf(xy_r[j].x * inv);
    const int hb = lv.h[lvl], wb = lv.w[lvl];
    const int v0 = min(max(vL - kW + kBorder, 0), hb - kWin);
    const int u0l = min(max(uL - kW + kBorder, 0), wb - kWin);
    const int u0r = min(max(uR0 - kL - kW + kBorder, 0), wb - kStrip);
    const uint8_t* L = flat_l + lv.off[lvl] + (size_t)v0 * wb + u0l;
    const uint8_t* R = flat_r + lv.off[lvl] + (size_t)v0 * wb + u0r;
    for (int t = lane; t < kWin * kWin; t += 32) s_left[warp][t] = L[(t / kWin) * wb + t % kWin];
    for (int t = lane; t < kWin * kStrip; t += 32)
      s_right[warp][t] = R[(t / kStrip) * wb + t % kStrip];
    __syncwarp();
    if (lane < kWin) {
      const int cl = s_left[warp][kW * kWin + kW];
      const int cr = s_right[warp][kW * kStrip + kW + lane];
      int acc = 0;
      for (int dy = 0; dy < kWin; ++dy)
        for (int dx = 0; dx < kWin; ++dx)
          acc += abs((s_left[warp][dy * kWin + dx] - cl) -
                     (s_right[warp][dy * kStrip + lane + dx] - cr));
      s_sad[warp][lane] = acc;
    }
    __syncwarp();
    if (lane == 0) {
      int best_inc = 0;
      for (int k = 1; k < kWin; ++k)
        if (s_sad[warp][k] < s_sad[warp][best_inc]) best_inc = k;
      const bool interior = best_inc > 0 && best_inc < 2 * kL;
      const int bi = min(max(best_inc, 1), 2 * kL - 1);
      const float d1 = (float)s_sad[warp][bi - 1], d2 = (float)s_sad[warp][bi],
                  d3 = (float)s_sad[warp][bi + 1];
      const float denom = 2.0f * (d1 + d3 - 2.0f * d2);
      const float delta = fabsf(denom) > 1e-9f ? (d1 - d3) / denom : 2.0f;
      const bool delta_ok = delta >= -1.0f && delta <= 1.0f;
      const float shift = (float)uR0 + (float)(bi - kL) + delta;
      const float s = lv.scale[lvl];
      u_r = s * shift;
      disparity = __fmaf_rn(-s, shift, pl.x);
      const bool disp_in = disparity >= 0.0f && disparity < max_d;
      if (disparity <= 0.0f) {
        u_r = pl.x - 0.01f;
        disparity = 0.01f;
      }
      ok = interior && delta_ok && disp_in;
      sad = d2;
    }
  }
  if (lane == 0) {
    u_r_out[i] = u_r;
    disp_out[i] = disparity;
    ok_out[i] = ok;
    sad_out[i] = sad;
  }
}

__global__ void __launch_bounds__(kCutThreads)
stereo_cut_kernel(int NL, float bf, float* __restrict__ u_right, float* __restrict__ depth,
                  bool* __restrict__ valid, const float* __restrict__ sad) {
  extern __shared__ unsigned char s_raw[];
  float* s_sad = reinterpret_cast<float*>(s_raw);
  bool* s_ok = reinterpret_cast<bool*>(s_sad + NL);
  __shared__ int s_n;
  __shared__ float s_median;
  if (threadIdx.x == 0) {
    s_n = 0;
    s_median = INFINITY;
  }
  __syncthreads();
  int n = 0;
  for (int i = threadIdx.x; i < NL; i += blockDim.x) {
    s_sad[i] = sad[i];
    s_ok[i] = valid[i];
    n += valid[i];
  }
  atomicAdd(&s_n, n);
  __syncthreads();
  const int k = s_n / 2;
  for (int i = threadIdx.x; i < NL; i += blockDim.x) {
    if (!s_ok[i]) continue;
    const float v = s_sad[i];
    int less = 0, le = 0;
    for (int j = 0; j < NL; ++j) {
      if (!s_ok[j]) continue;
      less += s_sad[j] < v;
      le += s_sad[j] <= v;
    }
    if (less <= k && k < le) s_median = v;  // every writer writes the same value
  }
  __syncthreads();
  const float cut = kCut * s_median;
  for (int i = threadIdx.x; i < NL; i += blockDim.x) {
    const bool ok = s_ok[i] && s_sad[i] < cut;
    valid[i] = ok;
    const float disparity = depth[i];
    depth[i] = ok ? bf / disparity : -1.0f;
    u_right[i] = ok ? u_right[i] : -1.0f;
  }
}

}  // namespace

// tab: host int32 (n_lvl, 3) rows (offset, h, w) of the bordered levels in the
// flat buffers; sc: host float32 [scales (n_lvl), 1/scales (n_lvl)].  u_right
// and depth first hold u_r and the disparity of launch 1; sad is scratch.
extern "C" int stereo_match_launch(const void* xy_l, const void* oct_l, const void* desc_l,
                                   const void* valid_l, const void* xy_r, const void* oct_r,
                                   const void* desc_r, const void* valid_r, const void* flat_l,
                                   const void* flat_r, int NL, int NR, const int* tab,
                                   const float* sc, int n_lvl, float bf, float max_d,
                                   int th_orb, void* u_right, void* depth, void* valid,
                                   void* sad, void* stream) {
  if (NL < 0 || NR < 0 || NR >= (1 << 16) || n_lvl < 1 || n_lvl > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (NL == 0) return (int)cudaGetLastError();
  Levels lv;
  for (int l = 0; l < n_lvl; ++l) {
    lv.off[l] = tab[3 * l];
    lv.h[l] = tab[3 * l + 1];
    lv.w[l] = tab[3 * l + 2];
    lv.scale[l] = sc[l];
    lv.inv[l] = sc[n_lvl + l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  stereo_search_kernel<<<(NL + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      (const float2*)xy_l, (const int*)oct_l, (const uint4*)desc_l, (const bool*)valid_l, NL,
      (const float2*)xy_r, (const int*)oct_r, (const uint4*)desc_r, (const bool*)valid_r, NR,
      (const uint8_t*)flat_l, (const uint8_t*)flat_r, lv, n_lvl, max_d, th_orb,
      (float*)u_right, (float*)depth, (bool*)valid, (float*)sad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = NL * (int)(sizeof(float) + sizeof(bool));
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(stereo_cut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  stereo_cut_kernel<<<1, kCutThreads, smem, s>>>(NL, bf, (float*)u_right, (float*)depth,
                                                 (bool*)valid, (const float*)sad);
  return (int)cudaGetLastError();
}
