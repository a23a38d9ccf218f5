// K15 pyramid: the bordered image pyramid, every level into one flat uint8
// buffer (Pyramid.flat), with OpenCV's bit-exact INTER_LINEAR resize and a
// BORDER_REFLECT_101 ring of `border` pixels.
//
// Replaces extractorb_tpu/frontend/pyramid.py:_resize_u8,
// :add_border_reflect101 and :compute_pyramid (a matmul for the horizontal
// taps, a gather for the vertical ones and a pad per level on the TPU).
// Here one thread writes one pixel of a bordered level: it maps its
// position through reflect-101 to an inner pixel and computes that pixel's
// INTER_LINEAR value straight from the previous level's inner image (read
// out of the bordered buffer), with the fixed-point taps of the plan's
// tables: the horizontal int32 two-tap sum x0*a0 + x1*a1, then OpenCV's
// uchar vertical rule (((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2.
// A border pixel recomputes its inner pixel rather than copying it, so a
// level is one pass with no second launch for the ring.  Level 0 copies
// the image.  Each level reads the level before, so the C entry point
// enqueues one launch per level on the stream.
//
// Bound on the H100: launch latency.  The 640x480 pyramid is 1.16 MB of
// output and reads ~0.6 MB; each pixel does ~20 integer operations on
// four source bytes that sit in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

struct PyrLevel {
  int b_off, b_stride, W, H;  // this level in the flat buffer, inner size
  int tab;                    // offset of sx0|sx1|a0|a1 (W each), sy0|sy1|b0|b1 (H each)
};

struct PyrTab {
  int n_levels, border;
  PyrLevel lv[kMaxLevels];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ flat,
                     const int* __restrict__ tables, const PyrTab tab, int l) {
  const PyrLevel L = tab.lv[l];
  const int wb = L.W + 2 * tab.border, hb = L.H + 2 * tab.border;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= wb * hb) return;
  const int by = i / wb, bx = i - by * wb;
  const int y = reflect101(by - tab.border, L.H), x = reflect101(bx - tab.border, L.W);
  int v;
  if (l == 0) {
    v = img[(size_t)y * L.W + x];
  } else {
    const PyrLevel P = tab.lv[l - 1];
    // the previous level's inner image inside its bordered buffer
    const uint8_t* src = flat + P.b_off + (size_t)tab.border * P.b_stride + tab.border;
    const int* tx = tables + L.tab;
    const int* ty = tx + 4 * L.W;
    const int sx0 = tx[x], sx1 = tx[L.W + x], a0 = tx[2 * L.W + x], a1 = tx[3 * L.W + x];
    const int sy0 = ty[y], sy1 = ty[L.H + y], b0 = ty[2 * L.H + y], b1 = ty[3 * L.H + y];
    const uint8_t* r0 = src + (size_t)sy0 * P.b_stride;
    const uint8_t* r1 = src + (size_t)sy1 * P.b_stride;
    const int S0 = r0[sx0] * a0 + r0[sx1] * a1;
    const int S1 = r1[sx0] * a0 + r1[sx1] * a1;
    v = (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2;
    v = min(max(v, 0), 255);
  }
  flat[L.b_off + (size_t)by * L.b_stride + bx] = (uint8_t)v;
}

}  // namespace

// tab_host: n_levels, border, then per level b_off, b_stride, W, H, tab
extern "C" int pyramid_launch(const void* img, void* flat, const void* tables,
                              const int* tab_host, void* stream) {
  PyrTab tab;
  tab.n_levels = tab_host[0];
  tab.border = tab_host[1];
  if (tab.n_levels < 1 || tab.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < tab.n_levels; ++l) {
    const int* r = tab_host + 2 + 5 * l;
    tab.lv[l] = PyrLevel{r[0], r[1], r[2], r[3], r[4]};
  }
  for (int l = 0; l < tab.n_levels; ++l) {
    const int n = (tab.lv[l].W + 2 * tab.border) * (tab.lv[l].H + 2 * tab.border);
    pyramid_level_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (uint8_t*)flat, (const int*)tables, tab, l);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
