// K35 ba_schur_dense: the landmark elimination and the dense reduced camera
// solve of one LM step of the window BA (solver "schur_dense").
//
// Replaces extractorb_tpu/solver/ba.py:215-244 (optimize's schur_dense
// branch), which the TPU runs as dense (K, P, 6, 3) scatters of W C and W,
// one (6K, 3P) x (3P, 6K) matmul and jnp.linalg.solve.  K6 (ba_pcg.cu)
// linearizes (r, J, the Hpp and Hll blocks, the gradient) and, after this
// step, retracts, costs and accepts, as in its cg branch.  Between them,
// four launches:
//   point:   one thread per point: Ml = (Hll + lam I)^-1 (the adjugate with
//            the 1e-20 det guard), and over the point's observation list
//            W_o = sum_rows (w J_pose)^T J_point (6x3) and A_o = W_o Ml;
//   schur:   one CTA per keyframe pair k >= j:
//            S_kj = [k == j] (Hpp_k + lam I) - sum_p A_ip W_jp^T, summed over
//            keyframe k's observation list and, for each, its point's list
//            (the observations of keyframe j): the JAX G1 G2^T without the
//            dense G; mirrored to S_jk; a fixed keyframe's rows and columns
//            are identity.  A fixed point still adds its W C W^T, as in JAX
//            (W_o has no free mask there; ROADMAP C.2).  One more CTA per
//            keyframe: b_k = bp_k - sum A_o bl_p (bl zero on a fixed point),
//            zero on a fixed keyframe;
//   solve:   one CTA of 1024 threads: Cholesky of S (right-looking, two
//            block barriers a column, the column staged contiguously, the
//            trailing update split over warps), then the two triangular
//            solves in one warp on L's rows, into xp; S lives in shared
//            memory up to 6K = 226, else in the workspace (L2-resident at
//            the window sizes); K <= 256;
//   back:    one thread per point: xl = Ml (bl - sum_o W_o^T xp_k), zero on
//            a fixed point.
// Float32 throughout, as the JAX function.  Every sum runs in a fixed order
// (the lists in index order, block_sum_fixed), no float atomics, so one
// input gives one result.  The plain version (solver/ba.py) solves S by LU
// (torch.linalg.solve): the two agree to float32 rounding of S's condition.
//
// Bound on the H100: latency.  The solve is n^3 / 3 operations at n = 6K
// (K <= 64: 19 MFLOP) in one CTA, with 2n block barriers; the assembly is
// microseconds.  The solve's shared-memory traffic is what its design
// keeps conflict-free: rows are read along lanes, the pivot column through
// the contiguous copy.  The step adds four launches to K6's seven per LM
// iteration and removes its 3 x cg_iters PCG launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ba_schur_dense.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSolveThreads = 1024;
constexpr size_t kMaxSmem = 200 * 1024;   // S in shared memory up to 6K = 226
constexpr int kMaxN = 6 * 256;             // K <= 256, the window BA's largest padding

#include "dual.cuh"
#include "ba_obs.cuh"      // inv3_damped, warp_sum_d
#include "det_reduce.cuh"  // block_sum_fixed, n_blocks

struct DWs {
  float* W;    // (O,18) W_o, row-major 6x3
  float* A;    // (O,18) A_o = W_o Ml
  float* Ml;   // (P,9)
  float* S;    // (6K, 6K)
  float* b;    // (6K) reduced right-hand side, then the solution
};

inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

size_t carve_d(DWs* d, uint8_t* base, int K, int P, int O) {
  const size_t n = 6 * (size_t)K;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    uint8_t* q = base ? base + o : nullptr;
    o += align16(bytes);
    return (float*)q;
  };
  float* p;
  p = take(sizeof(float) * 18 * (size_t)O); if (d) d->W = p;
  p = take(sizeof(float) * 18 * (size_t)O); if (d) d->A = p;
  p = take(sizeof(float) * 9 * (size_t)P);  if (d) d->Ml = p;
  p = take(sizeof(float) * n * n);          if (d) d->S = p;
  p = take(sizeof(float) * n);              if (d) d->b = p;
  return o;
}

__global__ void __launch_bounds__(kThreads) point_kernel(const SchurDenseArgs a, const DWs d) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= a.P) return;
  float Ml[9];
  inv3_damped(a.Hll + 6 * m, (float)*a.lam, Ml);
  for (int i = 0; i < 9; ++i) d.Ml[9 * m + i] = Ml[i];
  const int kR = a.kR;
  for (int j = a.off_mp[m]; j < a.off_mp[m + 1]; ++j) {
    const int o = a.list_mp[j];
    const float* J = a.J + (size_t)9 * kR * o;
    const float wt = a.w[o];
    float W[18];
    for (int f = 0; f < 6; ++f)
      for (int g = 0; g < 3; ++g) {
        float s = 0.f;
        for (int rr = 0; rr < kR; ++rr) s += (J[6 * rr + f] * wt) * J[6 * kR + 3 * rr + g];
        W[3 * f + g] = s;
      }
    float* Wo = d.W + (size_t)18 * o;
    float* Ao = d.A + (size_t)18 * o;
    for (int f = 0; f < 6; ++f)
      for (int h = 0; h < 3; ++h) {
        Wo[3 * f + h] = W[3 * f + h];
        Ao[3 * f + h] = W[3 * f] * Ml[h] + W[3 * f + 1] * Ml[3 + h] + W[3 * f + 2] * Ml[6 + h];
      }
  }
}

// entry (f, h) of pose block k's 6x6 from its upper triangle
__device__ __forceinline__ float hpp_at(const float* H, int f, int h) {
  const int a = f < h ? f : h, b = f < h ? h : f;
  return H[a * 6 - a * (a - 1) / 2 + (b - a)];
}

__global__ void __launch_bounds__(kThreads) schur_kernel(const SchurDenseArgs a, const DWs d) {
  __shared__ float red[36 * kThreads / 32];
  const int K = a.K, n = 6 * K;
  const int npairs = K * (K + 1) / 2;
  const int idx = blockIdx.x;
  const float lam = (float)*a.lam;
  if (idx < npairs) {
    int k = (int)((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
    while (k * (k + 1) / 2 > idx) --k;
    while ((k + 1) * (k + 2) / 2 <= idx) ++k;
    const int j = idx - k * (k + 1) / 2;   // j <= k
    const bool fr = !a.fixed_kf[k] && !a.fixed_kf[j];
    float v[36];
    for (int i = 0; i < 36; ++i) v[i] = 0.f;
    if (fr) {
      for (int q = a.off_kf[k] + threadIdx.x; q < a.off_kf[k + 1]; q += kThreads) {
        const int o = a.list_kf[q];
        const int m = a.obs_mp[o];
        const float* Ao = d.A + (size_t)18 * o;
        for (int q2 = a.off_mp[m]; q2 < a.off_mp[m + 1]; ++q2) {
          const int o2 = a.list_mp[q2];
          if (a.obs_kf[o2] != j) continue;
          const float* W2 = d.W + (size_t)18 * o2;
          for (int f = 0; f < 6; ++f)
            for (int h = 0; h < 6; ++h)
              v[6 * f + h] += Ao[3 * f] * W2[3 * h] + Ao[3 * f + 1] * W2[3 * h + 1] +
                              Ao[3 * f + 2] * W2[3 * h + 2];
        }
      }
    }
    block_sum_fixed<36>(v, red);
    if (threadIdx.x == 0)
      for (int f = 0; f < 6; ++f)
        for (int h = 0; h < 6; ++h) {
          float s;
          if (!fr) {
            s = (k == j && f == h) ? 1.f : 0.f;
          } else {
            s = -v[6 * f + h];
            if (k == j) s += hpp_at(a.Hpp + 21 * k, f, h) + (f == h ? lam : 0.f);
          }
          d.S[(size_t)(6 * k + f) * n + 6 * j + h] = s;
          d.S[(size_t)(6 * j + h) * n + 6 * k + f] = s;
        }
    return;
  }
  // b_k = bp_k - sum_o A_o bl_p over keyframe k's observations
  const int k = idx - npairs;
  const bool fk = !a.fixed_kf[k];
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (fk) {
    for (int q = a.off_kf[k] + threadIdx.x; q < a.off_kf[k + 1]; q += kThreads) {
      const int o = a.list_kf[q];
      const int m = a.obs_mp[o];
      if (a.fixed_mp[m]) continue;
      const float* bl = a.g + (size_t)6 * K + 3 * (size_t)m;
      const float* Ao = d.A + (size_t)18 * o;
      for (int f = 0; f < 6; ++f) v[f] += Ao[3 * f] * bl[0] + Ao[3 * f + 1] * bl[1] + Ao[3 * f + 2] * bl[2];
    }
  }
  block_sum_fixed<6>(v, red);
  if (threadIdx.x == 0)
    for (int f = 0; f < 6; ++f) d.b[6 * k + f] = fk ? a.g[6 * k + f] - v[f] : 0.f;
}

// Cholesky S = L L^T in place (lower triangle), L y = b, L^T x = y; x into
// a.x[0, 6K), zero on a fixed keyframe.  Two block barriers a column: every
// thread reads the pivot and scales its entries of the column, also into
// the contiguous col (a strided column read would put a warp's 32 lanes on
// one shared-memory bank, or on 32 sectors in the workspace), then the warps
// update the trailing lower triangle row by row from col.  The triangular
// solves run in warp 0 alone on L's rows: y_c = (b_c - L_c. y) / L_cc with a
// fixed shuffle tree, then x by columns of L^T (rows of L).  A non-positive
// pivot (S is the Schur complement of a damped positive definite system, so
// only rounding makes one) is clamped at 1e-30.
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const SchurDenseArgs a, const DWs d,
                                                              int use_smem) {
  extern __shared__ float sm[];
  __shared__ float col[kMaxN];
  const int n = 6 * a.K;
  float* A = use_smem ? sm : d.S;
  float* b = d.b;
  if (use_smem)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) sm[i] = d.S[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int c = 0; c < n; ++c) {
    const float dd = A[(size_t)c * n + c];
    const float l = sqrtf(dd > 1e-30f ? dd : 1e-30f);
    for (int i = c + 1 + threadIdx.x; i < n; i += blockDim.x) {
      const float v = A[(size_t)i * n + c] / l;
      A[(size_t)i * n + c] = v;
      col[i] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) A[(size_t)c * n + c] = l;
    for (int i = c + 1 + warp; i < n; i += nw) {
      const float lic = col[i];
      float* row = A + (size_t)i * n;
      for (int jj = c + 1 + lane; jj <= i; jj += 32) row[jj] -= lic * col[jj];
    }
    __syncthreads();
  }
  if (warp != 0) return;
  for (int c = 0; c < n; ++c) {   // forward: L y = b, by rows
    const float* row = A + (size_t)c * n;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += row[k] * b[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float y = (b[c] - s) / row[c];
    __syncwarp();
    if (lane == 0) b[c] = y;
    __syncwarp();
  }
  for (int c = n - 1; c >= 0; --c) {   // back: L^T x = y, by rows of L
    const float xc = b[c] / A[(size_t)c * n + c];
    for (int i = lane; i < c; i += 32) b[i] -= A[(size_t)c * n + i] * xc;
    __syncwarp();
    if (lane == 0) b[c] = xc;
    __syncwarp();
  }
  for (int e = lane; e < n; e += 32) a.x[e] = a.fixed_kf[e / 6] ? 0.f : b[e];
}

__global__ void __launch_bounds__(kThreads) back_kernel(const SchurDenseArgs a, const DWs d) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= a.P) return;
  const size_t base = (size_t)6 * a.K + 3 * (size_t)m;
  const bool fm = !a.fixed_mp[m];
  float wtd[3] = {0.f, 0.f, 0.f};
  for (int j = a.off_mp[m]; j < a.off_mp[m + 1]; ++j) {
    const int o = a.list_mp[j];
    const float* W = d.W + (size_t)18 * o;
    const float* xp = a.x + (size_t)6 * a.obs_kf[o];
    for (int g = 0; g < 3; ++g) {
      float s = 0.f;
      for (int f = 0; f < 6; ++f) s += W[3 * f + g] * xp[f];
      wtd[g] += s;
    }
  }
  float r[3];
  for (int g = 0; g < 3; ++g) r[g] = (fm ? a.g[base + g] : 0.f) - wtd[g];
  const float* Ml = d.Ml + 9 * (size_t)m;
  for (int f = 0; f < 3; ++f)
    a.x[base + f] = fm ? Ml[3 * f] * r[0] + Ml[3 * f + 1] * r[1] + Ml[3 * f + 2] * r[2] : 0.f;
}

}  // namespace

int ba_schur_dense_step(const SchurDenseArgs& a, cudaStream_t st) {
  DWs d;
  carve_d(&d, static_cast<uint8_t*>(a.ws), a.K, a.P, a.O);
  const int n = 6 * a.K;
  point_kernel<<<n_blocks(a.P), kThreads, 0, st>>>(a, d);
  schur_kernel<<<a.K * (a.K + 1) / 2 + a.K, kThreads, 0, st>>>(a, d);
  const size_t smem = sizeof(float) * (size_t)n * n;
  const bool use_smem = smem <= kMaxSmem;
  if (use_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  solve_kernel<<<1, kSolveThreads, use_smem ? smem : 0, st>>>(a, d, use_smem ? 1 : 0);
  back_kernel<<<n_blocks(a.P), kThreads, 0, st>>>(a, d);
  return (int)cudaGetLastError();
}

extern "C" long long ba_schur_dense_workspace_bytes(int K, int P, int O) {
  return (long long)carve_d(nullptr, nullptr, K, P, O);
}
