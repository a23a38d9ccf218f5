// K12 sim3: RANSAC Sim3 (Horn) and the OptimizeSim3 LM of loop closing.
//
// Replaces extractorb_tpu/geometry/sim3.py:solve_sim3_ransac (+ horn_sim3)
// and :optimize_sim3.  The TPU runs the RANSAC as one vmapped batch (a
// batched 4x4 eigh per hypothesis, all hypotheses scored against all pairs)
// and the LM as two lax.scans over jacfwd Jacobians of the 4N residual.
//
// RANSAC, three launches and no host synchronisation:
//   sim3_hyp:    one thread per hypothesis: centroids and the cross-
//                dispersion in float32 in a fixed order, Horn's 4x4 N, its
//                largest eigenvector by cyclic Jacobi in float64
//                (small_linalg.cuh), R from the quaternion, Horn's
//                symmetric scale and t;
//   sim3_score:  one CTA per hypothesis counts the pairs that reproject
//                under th2 in both images with positive depth in both;
//   sim3_select: the first maximum by the packed key (count, H-1-h), as
//                K10, the winner's mask and count, success at
//                max(20, int(0.4 n_valid)).
// OptimizeSim3, one launch of one CTA: each thread evaluates its edges'
//   residuals and forward-mode Jacobians (Dual<7>, lie_t.cuh: the update is
//   Exp(phi) R, t + tau, s exp(dls), as the JAX function's jacfwd), adds the
//   Huber-weighted 7x7 normal equations, the block reduces them and one
//   thread solves in float64 with partial pivoting (a non-finite step is
//   dropped); 5 steps on every edge, the chi2 <= th2 re-selection, 10 more
//   on the inliers when at least 10 remain.  fix_scale freezes the scale.
//
// The camera is a template parameter (camera_t.cuh): the pinhole Cam, or
// CamKB8, the fisheye, projected in the JAX closure's order for float and
// for Dual<7> (its r < 1e-8 guard gives scale and tangents 0).  The JAX
// package hands both functions the camera's projection closure
// (extractorb_tpu/slam/track_device.py:project_for_camera).
//
// Bound on the H100: the RANSAC is ~128 x 512 pair tests plus 128 small
// eigenproblems, microseconds of arithmetic: launch latency bounds it.  The
// LM is 15 dependent block-wide reductions on one SM: latency again.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "dual.cuh"
#include "camera_t.cuh"
#include "lie_t.cuh"
#include "small_linalg.cuh"

constexpr int kThreads = 256;
constexpr int kHypThreads = 64;

__device__ int block_sum_i(int v, int* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += s_red[w];
  return s;
}

// hyp (H,13): R (9), t (3), s
__global__ void __launch_bounds__(kHypThreads)
sim3_hyp_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                const int* __restrict__ sets, int H, int N, bool fix_scale,
                float* __restrict__ hyp) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float a[3][3], b[3][3];
  bool bad = false;
  for (int j = 0; j < 3; ++j) {
    const int i = sets[3 * h + j];
    if (i < 0 || i >= N) { bad = true; continue; }
    for (int c = 0; c < 3; ++c) { a[j][c] = p1[3 * i + c]; b[j][c] = p2[3 * i + c]; }
  }
  float* out = hyp + 13 * h;
  if (bad) {
    for (int k = 0; k < 13; ++k) out[k] = NAN;
    return;
  }
  float c1[3], c2[3], x1[3][3], x2[3][3];
  for (int c = 0; c < 3; ++c) {
    c1[c] = (a[0][c] + a[1][c] + a[2][c]) / 3.0f;
    c2[c] = (b[0][c] + b[1][c] + b[2][c]) / 3.0f;
  }
  for (int j = 0; j < 3; ++j)
    for (int c = 0; c < 3; ++c) { x1[j][c] = a[j][c] - c1[c]; x2[j][c] = b[j][c] - c2[c]; }
  float M[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M[i][j] = x1[0][i] * x2[0][j] + x1[1][i] * x2[1][j] + x1[2][i] * x2[2][j];
  const float Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const float Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const float Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  const float Nf[16] = {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
                        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
                        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
                        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz};
  double Nd[16], V[16];
  for (int k = 0; k < 16; ++k) Nd[k] = (double)Nf[k];
  jacobi_eig<4>(Nd, V);
  int kmax = 0;
  for (int k = 1; k < 4; ++k)
    if (Nd[5 * k] > Nd[5 * kmax]) kmax = k;
  const float w = (float)V[kmax], x = (float)V[4 + kmax], y = (float)V[8 + kmax],
              z = (float)V[12 + kmax];
  float R[9] = {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)};
  auto sq = [](float (*m)[3]) {
    return (m[0][0] * m[0][0] + m[0][1] * m[0][1] + m[0][2] * m[0][2]) +
           (m[1][0] * m[1][0] + m[1][1] * m[1][1] + m[1][2] * m[1][2]) +
           (m[2][0] * m[2][0] + m[2][1] * m[2][1] + m[2][2] * m[2][2]);
  };
  const float s = fix_scale ? 1.0f : sqrtf(sq(x2) / fmaxf(sq(x1), 1e-12f));
  for (int k = 0; k < 9; ++k) out[k] = R[k];
  for (int i = 0; i < 3; ++i)
    out[9 + i] = c2[i] - s * (R[3 * i] * c1[0] + R[3 * i + 1] * c1[1] + R[3 * i + 2] * c1[2]);
  out[12] = s;
}

// pair i is an inlier of hypothesis S = hs (R, t, s): the plain version's order
template <class C>
__device__ bool sim3_inlier(const float* hs, const float* __restrict__ p1,
                            const float* __restrict__ p2, const float* __restrict__ uv1,
                            const float* __restrict__ uv2, const bool* __restrict__ valid, int i,
                            const C& cam, float th2) {
  const float* R = hs;
  const float* t = hs + 9;
  const float s = hs[12];
  float q2[3], q1[3], ti[3];
  for (int r = 0; r < 3; ++r)
    q2[r] = s * (R[3 * r] * p1[3 * i] + R[3 * r + 1] * p1[3 * i + 1] + R[3 * r + 2] * p1[3 * i + 2]) + t[r];
  const float si = 1.0f / s;
  for (int r = 0; r < 3; ++r) ti[r] = -si * (R[r] * t[0] + R[3 + r] * t[1] + R[6 + r] * t[2]);
  for (int r = 0; r < 3; ++r)
    q1[r] = si * (R[r] * p2[3 * i] + R[3 + r] * p2[3 * i + 1] + R[6 + r] * p2[3 * i + 2]) + ti[r];
  float u2, v2, u1, v1;
  cam.project(q2[0], q2[1], q2[2], u2, v2);
  cam.project(q1[0], q1[1], q1[2], u1, v1);
  const float du2 = u2 - uv2[2 * i], dv2 = v2 - uv2[2 * i + 1];
  const float du1 = u1 - uv1[2 * i], dv1 = v1 - uv1[2 * i + 1];
  const float e2 = du2 * du2 + dv2 * dv2, e1 = du1 * du1 + dv1 * dv1;
  return valid[i] && e1 < th2 && e2 < th2 && q2[2] > 0.f && q1[2] > 0.f;
}

template <class C>
__global__ void __launch_bounds__(kThreads)
sim3_score_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                  const float* __restrict__ uv1, const float* __restrict__ uv2,
                  const bool* __restrict__ valid, int N, const C cam, float th2,
                  const float* __restrict__ hyp, int* __restrict__ counts) {
  __shared__ float s_h[13];
  __shared__ int s_red[kThreads / 32];
  const int h = blockIdx.x;
  if (threadIdx.x < 13) s_h[threadIdx.x] = hyp[13 * h + threadIdx.x];
  __syncthreads();
  int c = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) c += sim3_inlier(s_h, p1, p2, uv1, uv2, valid, i, cam, th2);
  c = block_sum_i(c, s_red);
  if (threadIdx.x == 0) counts[h] = c;
}

template <class C>
__global__ void __launch_bounds__(kThreads)
sim3_select_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                   const float* __restrict__ uv1, const float* __restrict__ uv2,
                   const bool* __restrict__ valid, int N, int H, const C cam, float th2,
                   const float* __restrict__ hyp, const int* __restrict__ counts,
                   float* __restrict__ out, bool* __restrict__ inl, int* __restrict__ n_inl,
                   bool* __restrict__ ok) {
  __shared__ unsigned long long s_key[kThreads / 32];
  __shared__ int s_red[kThreads / 32];
  __shared__ float s_h[13];
  __shared__ int s_best;
  unsigned long long key = 0ull;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const unsigned long long k =
        ((unsigned long long)(unsigned)counts[h] << 32) | (unsigned long long)(unsigned)(H - 1 - h);
    key = k > key ? k : key;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
    key = other > key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long best = s_key[0];
    for (int w = 1; w < kThreads / 32; ++w) best = s_key[w] > best ? s_key[w] : best;
    s_best = H - 1 - (int)(best & 0xffffffffull);
  }
  __syncthreads();
  const int b = s_best;
  if (threadIdx.x < 13) s_h[threadIdx.x] = hyp[13 * b + threadIdx.x];
  __syncthreads();
  int nv = 0;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    inl[i] = sim3_inlier(s_h, p1, p2, uv1, uv2, valid, i, cam, th2);
    nv += valid[i];
  }
  nv = block_sum_i(nv, s_red);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 13; ++k) out[k] = s_h[k];
    const int n = counts[b];
    const int need = max(20, (int)(0.4f * (float)nv));
    *n_inl = n;
    *ok = n >= need;
  }
}

// ------------------------------------------------------------ OptimizeSim3

// residuals r12 (obs1 - pi(S p2)) and r21 (obs2 - pi(S^-1 p1)) of pair i at
// the update x = (phi, tau, dls) of (R, t, ls)
template <class T, class C>
__device__ void sim3_edge(const float* R0, const float* t0, float ls0, const T* x, bool fix_scale,
                          const float* __restrict__ p1, const float* __restrict__ p2,
                          const float* __restrict__ obs1, const float* __restrict__ obs2, int i,
                          const C& cam, T* r) {
  T E[9], Rc[9], R[9], t[3];
  so3_exp_t(x, E);
  for (int k = 0; k < 9; ++k) Rc[k] = cst<T>(R0[k]);
  mat3_mul(E, Rc, R);
  for (int k = 0; k < 3; ++k) t[k] = x[3 + k] + t0[k];
  const T s = texp(fix_scale ? cst<T>(ls0) : x[6] + ls0);
  T q[3], pp[3];
  for (int k = 0; k < 3; ++k) pp[k] = cst<T>(p2[3 * i + k]);
  mat3_vec(R, pp, q);
  for (int k = 0; k < 3; ++k) q[k] = s * q[k] + t[k];
  T u, v;
  cam.project(q[0], q[1], q[2], u, v);
  r[0] = obs1[2 * i] - u;
  r[1] = obs1[2 * i + 1] - v;
  T Ri[9], ti[3], si;
  sim3_inverse_t(R, t, s, Ri, ti, si);
  for (int k = 0; k < 3; ++k) pp[k] = cst<T>(p1[3 * i + k]);
  mat3_vec(Ri, pp, q);
  for (int k = 0; k < 3; ++k) q[k] = si * q[k] + ti[k];
  cam.project(q[0], q[1], q[2], u, v);
  r[2] = obs2[2 * i] - u;
  r[3] = obs2[2 * i + 1] - v;
}

constexpr int kNormal = 28 + 7;  // upper triangle of H, then b

__device__ void block_sum_f(float* v, int n, float* s_part) {
  // s_part: (kThreads / 32) x n
  for (int k = 0; k < n; ++k) {
    float a = v[k];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if ((threadIdx.x & 31) == 0) s_part[(threadIdx.x >> 5) * n + k] = a;
  }
  __syncthreads();
}

template <class C>
__global__ void __launch_bounds__(kThreads)
sim3_optimize_kernel(const float* __restrict__ state, const float* __restrict__ p1,
                     const float* __restrict__ p2, const float* __restrict__ obs1,
                     const float* __restrict__ obs2, const bool* __restrict__ valid, int N,
                     bool fix_scale, float th2, const C cam, float* __restrict__ out,
                     bool* __restrict__ inl_out, int* __restrict__ n_in_out) {
  __shared__ float s_R[9], s_t[3], s_ls;
  __shared__ float s_part[(kThreads / 32) * kNormal];
  __shared__ int s_red[kThreads / 32];
  __shared__ int s_enough;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) s_R[k] = state[k];
    for (int k = 0; k < 3; ++k) s_t[k] = state[9 + k];
    s_ls = logf(fmaxf(state[12], 1e-12f));
  }
  __syncthreads();
  const float delta = sqrtf(th2);
  auto chi2_inlier = [&](int i) {
    float x0[7] = {0, 0, 0, 0, 0, 0, 0}, r[4];
    sim3_edge<float, C>(s_R, s_t, s_ls, x0, false, p1, p2, obs1, obs2, i, cam, r);
    return valid[i] && (r[0] * r[0] + r[1] * r[1]) <= th2 && (r[2] * r[2] + r[3] * r[3]) <= th2;
  };
  for (int it = 0; it < 15; ++it) {
    if (it == 5) {
      // the chi2 re-selection: steps 6-15 use this mask (kept in inl_out)
      int c = 0;
      for (int i = threadIdx.x; i < N; i += kThreads) {
        const bool in = chi2_inlier(i);
        inl_out[i] = in;
        c += in;
      }
      c = block_sum_i(c, s_red);
      if (threadIdx.x == 0) s_enough = c >= 10;
      __syncthreads();
      if (!s_enough) break;
    }
    float acc[kNormal];
    for (int k = 0; k < kNormal; ++k) acc[k] = 0.f;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      if (!(it < 5 ? valid[i] : inl_out[i])) continue;
      Dual<7> x[7];
      for (int k = 0; k < 7; ++k) {
        x[k] = dconst<7>(0.f);
        x[k].d[k] = 1.f;
      }
      Dual<7> r[4];
      sim3_edge<Dual<7>, C>(s_R, s_t, s_ls, x, fix_scale, p1, p2, obs1, obs2, i, cam, r);
      for (int e = 0; e < 2; ++e) {
        const float c = r[2 * e].v * r[2 * e].v + r[2 * e + 1].v * r[2 * e + 1].v;
        const float en = sqrtf(fmaxf(c, 1e-12f));
        const float w = en <= delta ? 1.f : delta / en;
        for (int row = 2 * e; row < 2 * e + 2; ++row) {
          int k = 0;
          for (int a = 0; a < 7; ++a) {
            for (int b2 = a; b2 < 7; ++b2) acc[k++] += r[row].d[a] * (r[row].d[b2] * w);
          }
          for (int a = 0; a < 7; ++a) acc[28 + a] += r[row].d[a] * (r[row].v * w);
        }
      }
    }
    block_sum_f(acc, kNormal, s_part);
    if (threadIdx.x == 0) {
      double Hm[49], bv[7];
      for (int k = 0; k < kNormal; ++k) {
        float s = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) s += s_part[w * kNormal + k];
        acc[k] = s;
      }
      int k = 0;
      for (int a = 0; a < 7; ++a)
        for (int b2 = a; b2 < 7; ++b2) {
          Hm[7 * a + b2] = Hm[7 * b2 + a] = (double)acc[k++];
        }
      for (int a = 0; a < 7; ++a) {
        Hm[8 * a] += 1e-6;
        bv[a] = (double)acc[28 + a];
      }
      if (fix_scale) {
        for (int a = 0; a < 7; ++a) Hm[42 + a] = Hm[7 * a + 6] = 0.0;
        Hm[48] = 1.0;
        bv[6] = 0.0;
      }
      // Gaussian elimination with partial pivoting
      for (int c = 0; c < 7; ++c) {
        int p = c;
        for (int r2 = c + 1; r2 < 7; ++r2)
          if (fabs(Hm[7 * r2 + c]) > fabs(Hm[7 * p + c])) p = r2;
        if (p != c) {
          for (int q = 0; q < 7; ++q) { const double tmp = Hm[7 * c + q]; Hm[7 * c + q] = Hm[7 * p + q]; Hm[7 * p + q] = tmp; }
          const double tmp = bv[c]; bv[c] = bv[p]; bv[p] = tmp;
        }
        for (int r2 = c + 1; r2 < 7; ++r2) {
          const double f = Hm[7 * r2 + c] / Hm[8 * c];
          for (int q = c; q < 7; ++q) Hm[7 * r2 + q] -= f * Hm[7 * c + q];
          bv[r2] -= f * bv[c];
        }
      }
      double xs[7];
      float dx[7];
      bool finite = true;
      for (int r2 = 6; r2 >= 0; --r2) {
        double a = bv[r2];
        for (int q = r2 + 1; q < 7; ++q) a -= Hm[7 * r2 + q] * xs[q];
        xs[r2] = a / Hm[8 * r2];
        dx[r2] = (float)(-xs[r2]);
        finite = finite && isfinite(dx[r2]);
      }
      if (finite) {
        float E[9], Rn[9];
        so3_exp_t<float>(dx, E);
        mat3_mul<float>(E, s_R, Rn);
        for (int q = 0; q < 9; ++q) s_R[q] = Rn[q];
        for (int q = 0; q < 3; ++q) s_t[q] += dx[3 + q];
        if (!fix_scale) s_ls += dx[6];
      }
    }
    __syncthreads();
  }
  int c = 0;
  const bool enough = s_enough;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool in = enough && chi2_inlier(i);
    inl_out[i] = in;
    c += in;
  }
  c = block_sum_i(c, s_red);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) out[k] = s_R[k];
    for (int k = 0; k < 3; ++k) out[9 + k] = s_t[k];
    out[12] = expf(s_ls);
    *n_in_out = c;
  }
}

template <class C>
int ransac(const void* p1, const void* p2, const void* uv1, const void* uv2, const void* valid,
           const void* sets, int N, int H, int fix_scale, float th2, const C& cam, void* hyp,
           void* counts, void* out, void* inl, void* n_inl, void* ok, cudaStream_t st) {
  sim3_hyp_kernel<<<(H + kHypThreads - 1) / kHypThreads, kHypThreads, 0, st>>>(
      (const float*)p1, (const float*)p2, (const int*)sets, H, N, fix_scale != 0, (float*)hyp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sim3_score_kernel<C><<<H, kThreads, 0, st>>>((const float*)p1, (const float*)p2,
                                                (const float*)uv1, (const float*)uv2,
                                                (const bool*)valid, N, cam, th2,
                                                (const float*)hyp, (int*)counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sim3_select_kernel<C><<<1, kThreads, 0, st>>>((const float*)p1, (const float*)p2,
                                                 (const float*)uv1, (const float*)uv2,
                                                 (const bool*)valid, N, H, cam, th2,
                                                 (const float*)hyp, (const int*)counts,
                                                 (float*)out, (bool*)inl, (int*)n_inl, (bool*)ok);
  return (int)cudaGetLastError();
}

template <class C>
int optimize(const void* state, const void* p1, const void* p2, const void* obs1,
             const void* obs2, const void* valid, int N, int fix_scale, float th2, const C& cam,
             void* out, void* inl, void* n_in, cudaStream_t st) {
  sim3_optimize_kernel<C><<<1, kThreads, 0, st>>>(
      (const float*)state, (const float*)p1, (const float*)p2, (const float*)obs1,
      (const float*)obs2, (const bool*)valid, N, fix_scale != 0, th2, cam, (float*)out,
      (bool*)inl, (int*)n_in);
  return (int)cudaGetLastError();
}

}  // namespace

// p1, p2 (N,3), uv1, uv2 (N,2) f32, valid (N,) bool, sets (H,3) i32; workspace
// hyp (H,13) f32, counts (H,) i32; out (13,) = R, t, s of the winner, inl
// (N,) bool, n_inl () i32, ok () bool.  kb8 null: the pinhole camera; else a
// host array k1..k4 of the KB8 camera.
extern "C" int sim3_ransac_launch(const void* p1, const void* p2, const void* uv1, const void* uv2,
                                  const void* valid, const void* sets, int N, int H, int fix_scale,
                                  float th2, float fx, float fy, float cx, float cy,
                                  const float* kb8, void* hyp, void* counts, void* out, void* inl,
                                  void* n_inl, void* ok, void* stream) {
  if (H <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kb8 != nullptr)
    return ransac(p1, p2, uv1, uv2, valid, sets, N, H, fix_scale, th2,
                  CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, hyp, counts, out, inl,
                  n_inl, ok, st);
  return ransac(p1, p2, uv1, uv2, valid, sets, N, H, fix_scale, th2, Cam{fx, fy, cx, cy}, hyp,
                counts, out, inl, n_inl, ok, st);
}

// state (13,) = R, t, s start; p1, p2 (N,3), obs1, obs2 (N,2), valid (N,);
// out (13,), inl (N,) bool, n_in () i32; kb8 as sim3_ransac_launch's
extern "C" int sim3_optimize_launch(const void* state, const void* p1, const void* p2,
                                    const void* obs1, const void* obs2, const void* valid, int N,
                                    int fix_scale, float th2, float fx, float fy, float cx,
                                    float cy, const float* kb8, void* out, void* inl, void* n_in,
                                    void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kb8 != nullptr)
    return optimize(state, p1, p2, obs1, obs2, valid, N, fix_scale, th2,
                    CamKB8{fx, fy, cx, cy, kb8[0], kb8[1], kb8[2], kb8[3]}, out, inl, n_in, st);
  return optimize(state, p1, p2, obs1, obs2, valid, N, fix_scale, th2, Cam{fx, fy, cx, cy}, out,
                  inl, n_in, st);
}
