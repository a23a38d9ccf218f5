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
//   solve:   one thread-block cluster of kCluster CTAs: a blocked
//            right-looking Cholesky of S in 32 x 32 tiles (the last tile
//            padded with identity), b appended as one more tile row so
//            that the factorisation also runs the forward solve, then the
//            backward solve by tiles in CTA 0, into xp; K <= 256;
//   back:    one thread per point: xl = Ml (bl - sum_o W_o^T xp_k), zero on
//            a fixed point.
// Float32 throughout, as the JAX function.  Every sum runs in a fixed order
// (the lists in index order, block_sum_fixed), no float atomics, so one
// input gives one result.  The plain version (solver/ba.py) solves S by LU
// (torch.linalg.solve): the two agree to float32 rounding of S's condition.
//
// Bound on the H100: latency.  The solve is n^3 / 3 operations at n = 6K
// (K <= 64: 19 MFLOP) over a chain of n / 32 dependent panels, one cluster
// barrier each; the assembly is microseconds.  The solve's design (at the
// kernel) spreads each panel's tiles over the cluster's SMs and keeps S in
// their shared memory up to n = 640.  The step adds four launches to K6's
// seven per LM iteration and removes its 3 x cg_iters PCG launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ba_schur_dense.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxN = 6 * 256;             // K <= 256, the window BA's largest padding

// The solve's tiles: 32 x 32 floats stored with a row stride of 36 (rows
// are float4-aligned, and float4 rows at a stride of 36 spread a quarter
// warp over all 32 banks); column 32 of a diagonal tile holds 1 / L_rr.
constexpr int kT = 32;
constexpr int kLd = 36;
constexpr int kTileF = kT * kLd;                       // 1152 floats, 4608 bytes
constexpr int kMaxNt = kMaxN / kT;                     // 48 tile rows of S
constexpr int kCluster = 8;                            // CTAs in the solve's cluster
constexpr int kSolveWarps = 16;
constexpr int kSolveThreads = 32 * kSolveWarps;
// tiles of the lower triangle of [S; b^T] at nt tile rows of S
__host__ __device__ constexpr int n_tiles(int nt) { return nt * (nt + 3) / 2; }
constexpr int kMaxSlots = (n_tiles(kMaxNt) + kCluster - 1) / kCluster;
// dynamic shared memory a CTA may take (227 KB less the static tables)
constexpr size_t kSmemCap = 225 * 1024;
constexpr unsigned kFull = 0xffffffffu;

#include "dual.cuh"
#include "ba_obs.cuh"      // inv3_damped, warp_sum_d
#include "det_reduce.cuh"  // block_sum_fixed, n_blocks

struct DWs {
  float* W;    // (O,18) W_o, row-major 6x3
  float* A;    // (O,18) A_o = W_o Ml
  float* Ml;   // (P,9)
  float* S;    // (6K, 6K)
  float* b;    // (6K) reduced right-hand side
  float* T;    // the solve's tiles, by tile index, where they outgrow the cluster's shared memory
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
  p = take(sizeof(float) * kTileF * (size_t)n_tiles((int)((n + kT - 1) / kT)));
  if (d) d->T = p;
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

// The solve: S = L L^T by a blocked right-looking Cholesky in one cluster of
// kCluster CTAs, then L^T x = y.  S is cut into nt x nt tiles of 32 (the
// last padded with identity) and b^T is appended as tile row nt (row 0 of
// each of its tiles), so the factorisation's last row is y = L^-1 b: the
// forward solve costs no barrier of its own.  Tile (i, j), j <= i, j < nt,
// has index t = i (i + 1) / 2 + j and lives with CTA t % kCluster, in its
// shared memory (kSmem) or in the workspace (d.T, L2-resident); remote
// tiles are read through distributed shared memory (map_shared_rank) or
// from L2 (ld.cg).  Panel p, between two cluster barriers:
//   1. each CTA writes back the panel p-1 tiles it owns (their L, kept in
//      its staging area since the last panel: the raw tiles were being read
//      by the other CTAs until the barrier);
//   2. each CTA copies L_pp and the raw tiles (i, p), i > p, into its own
//      staging area and solves every one of them against L_pp^T (a warp a
//      tile, a lane a row: forward substitution by rows of L_pp), so that
//      it holds the whole panel without a second barrier;
//   3. each CTA updates the tiles (i, j), p < j <= i, that it owns:
//      A_ij -= L_ip L_jp^T (a warp a tile, a lane 8 x 4 of its entries);
//      the owner of the next diagonal tile updates it first and factors it
//      in the same warp.
// nt + 3 cluster barriers in all.  Then CTA 0 solves L^T x = y tile column
// by tile column from the bottom: the products with the solved tiles over
// its warps (summed in warp order), the 32 unknowns of the diagonal tile in
// one warp.  Each entry of S is updated by one thread in panel order with
// its products in k order, and every sum has a fixed order, so one input
// gives one result.  A non-positive pivot (S is the Schur complement of a
// damped positive definite system, so only rounding makes one) is clamped
// at 1e-30.  Explicit FMAs (__fmaf_rn) under the library's -fmad=false.

template <bool kSmem>
__device__ __forceinline__ float4 ld4(const float* p) {
  if (kSmem) return *reinterpret_cast<const float4*>(p);
  return __ldcg(reinterpret_cast<const float4*>(p));
}
template <bool kSmem>
__device__ __forceinline__ float ld1(const float* p) {
  return kSmem ? *p : __ldcg(p);
}
template <bool kSmem>
__device__ __forceinline__ void st4(float* p, float4 v) {
  if (kSmem) *reinterpret_cast<float4*>(p) = v;
  else __stcg(reinterpret_cast<float4*>(p), v);
}
template <bool kSmem>
__device__ __forceinline__ void st1(float* p, float v) {
  if (kSmem) *p = v;
  else __stcg(p, v);
}

__device__ __forceinline__ int tile_index(int i, int j) { return i * (i + 1) / 2 + j; }

// store(e, load(e)) for e in [0, n) over the CTA, kBatch loads in flight per
// thread before their stores (a load from L2 or another SM waits ~1 us)
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int n, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * blockDim.x) {
    decltype(load(0)) v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * (int)blockDim.x < n) v[u] = load(e0 + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * (int)blockDim.x < n) store(e0 + u * blockDim.x, v[u]);
  }
}

// the tile (i, j) wherever it lives: own is this CTA's first slot (kSmem) or d.T
template <bool kSmem>
__device__ __forceinline__ float* tile_at(cg::cluster_group& cl, float* own, int i, int j) {
  const int t = tile_index(i, j);
  if (kSmem) return cl.map_shared_rank(own + (size_t)(t / kCluster) * kTileF, t % kCluster);
  return own + (size_t)t * kTileF;
}

// lane c of a warp holds column c of a symmetric 32 x 32 tile in a[] (=
// row c); factor it in place: afterwards lane r holds row r of L (zeros
// above the diagonal) and inv = 1 / L_rr.  The 32 columns are the solve's
// critical path (each panel waits for its diagonal tile), so a column
// takes one hardware reciprocal square root (rsqrtf, within 2 ulp) and
// L_cc = d / sqrt(d) from it.
__device__ __forceinline__ void factor_rows(float (&a)[kT], int lane, float& inv) {
#pragma unroll
  for (int c = 0; c < kT; ++c) {
    const float dm = fmaxf(__shfl_sync(kFull, a[c], c), 1e-30f);
    const float il = rsqrtf(dm), l = dm * il;
    if (lane == c) {
      a[c] = l;
      inv = il;
    } else if (lane > c) {
      a[c] *= il;
    }
#pragma unroll
    for (int j = c + 1; j < kT; ++j) a[j] = __fmaf_rn(-a[c], __shfl_sync(kFull, a[c], j), a[j]);
  }
#pragma unroll
  for (int c = 0; c < kT; ++c)
    if (c > lane) a[c] = 0.f;
}

template <bool kSmem>
__device__ __forceinline__ void store_rows(float* T, const float (&a)[kT], float inv, int lane) {
  float* row = T + lane * kLd;
#pragma unroll
  for (int k = 0; k < kT; k += 4) st4<kSmem>(row + k, make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]));
  st1<kSmem>(row + kT, inv);
}

// X = A L^-T for the staged tile P (in place; lane r solves row r against
// the rows of L in Lb, by forward substitution with 1 / L_cc from column 32)
__device__ __forceinline__ void trsm_rows(float* P, const float* Lb, int lane) {
  float x[kT];
  float* row = P + lane * kLd;
#pragma unroll
  for (int k = 0; k < kT; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    x[k] = v.x; x[k + 1] = v.y; x[k + 2] = v.z; x[k + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) {
    const float* Lc = Lb + c * kLd;
    float s = x[c];
#pragma unroll
    for (int k = 0; k < c; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(Lc + k);
      s = __fmaf_rn(-l.x, x[k], s);
      if (k + 1 < c) s = __fmaf_rn(-l.y, x[k + 1], s);
      if (k + 2 < c) s = __fmaf_rn(-l.z, x[k + 2], s);
      if (k + 3 < c) s = __fmaf_rn(-l.w, x[k + 3], s);
    }
    x[c] = s * Lc[kT];
  }
#pragma unroll
  for (int k = 0; k < kT; k += 4)
    *reinterpret_cast<float4*>(row + k) = make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
}

// C -= Pi Pj^T for an owned tile C.  Lane (g, h) = (lane / 8, lane % 8)
// computes C[g + 4a][h + 8b], a < 8, b < 4, from float4 runs of k: the 8
// lanes of a quarter warp read one row of Pi (a broadcast) and 8 rows of Pj
// that the stride of 36 puts on distinct banks, 12 loads for 128 FMAs.
// With factor, C is the next diagonal tile (Pi = Pj): stored, read back by
// columns (lane c: column c = row c of the symmetric tile), factored and
// stored as rows of L.  Each entry sums its products in k order.
template <bool kSmem>
__device__ __forceinline__ void update_tile(float* C, const float* Pi, const float* Pj, bool factor,
                                            int lane) {
  const int g = lane >> 3, h = lane & 7;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = ld1<kSmem>(C + (g + 4 * a) * kLd + h + 8 * b);
#pragma unroll
  for (int k = 0; k < kT; k += 4) {
    float4 pi[8], pj[4];
#pragma unroll
    for (int a = 0; a < 8; ++a) pi[a] = *reinterpret_cast<const float4*>(Pi + (g + 4 * a) * kLd + k);
#pragma unroll
    for (int b = 0; b < 4; ++b) pj[b] = *reinterpret_cast<const float4*>(Pj + (h + 8 * b) * kLd + k);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b] = __fmaf_rn(-pi[a].x, pj[b].x, acc[a][b]);
        acc[a][b] = __fmaf_rn(-pi[a].y, pj[b].y, acc[a][b]);
        acc[a][b] = __fmaf_rn(-pi[a].z, pj[b].z, acc[a][b]);
        acc[a][b] = __fmaf_rn(-pi[a].w, pj[b].w, acc[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) st1<kSmem>(C + (g + 4 * a) * kLd + h + 8 * b, acc[a][b]);
  if (!factor) return;
  __syncwarp();
  float col[kT], inv;
#pragma unroll
  for (int r = 0; r < kT; ++r) col[r] = ld1<kSmem>(C + r * kLd + lane);
  factor_rows(col, lane, inv);
  __syncwarp();   // every column read before a row is written
  store_rows<kSmem>(C, col, inv, lane);
}

// Shared memory: L_pp's copy (one tile), the staging area (nt tiles: the
// panel's rows p+1..nt), then with kSmem this CTA's tiles, slot q holding
// tile rank + q * kCluster.
template <bool kSmem>
__global__ void __launch_bounds__(kSolveThreads, 1)
solve_cluster_kernel(const SchurDenseArgs a, const DWs d, int nt) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned char slot_i[kMaxSlots], slot_j[kMaxSlots];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 6 * a.K;
  float* Lb = sm;
  float* stage = sm + kTileF;
  float* own = kSmem ? stage + (size_t)nt * kTileF : d.T;
  const int n_slots = (n_tiles(nt) - rank + kCluster - 1) / kCluster;
  auto mine = [&](int q) {
    return kSmem ? own + (size_t)q * kTileF : own + (size_t)(rank + q * kCluster) * kTileF;
  };

  // this CTA's tiles: their coordinates, then S, b^T and the identity padding
  for (int q = threadIdx.x; q < n_slots; q += blockDim.x) {
    const int t = rank + q * kCluster;
    int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (i * (i + 1) / 2 > t) --i;
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    slot_i[q] = (unsigned char)i;
    slot_j[q] = (unsigned char)(t - i * (i + 1) / 2);
  }
  __syncthreads();
  copy_batched<8>(
      n_slots * kT * kT,
      [&](int e) {
        const int q = e / (kT * kT), r = (e / kT) % kT;
        const int i = slot_i[q], R = kT * i + r, C = kT * slot_j[q] + e % kT;
        if (i < nt) return R < n && C < n ? d.S[(size_t)R * n + C] : (R == C ? 1.f : 0.f);
        return r == 0 && C < n ? d.b[C] : 0.f;
      },
      [&](int e, float v) {
        st1<kSmem>(mine(e / (kT * kT)) + (e / kT) % kT * kLd + e % kT, v);
      });
  __syncthreads();
  if (rank == 0 && warp == 0) {   // tile (0, 0) is slot 0 of CTA 0
    float col[kT], inv;
#pragma unroll
    for (int r = 0; r < kT; ++r) col[r] = ld1<kSmem>(mine(0) + r * kLd + lane);
    factor_rows(col, lane, inv);
    store_rows<kSmem>(mine(0), col, inv, lane);
  }
  cl.sync();

  for (int p = 0; p <= nt; ++p) {
    if (p > 0) {   // 1. this CTA's tiles of panel p-1, from the staging area
      for (int q = 0; q < n_slots; ++q) {
        if (slot_j[q] != p - 1 || slot_i[q] == p - 1) continue;
        const float* src = stage + (size_t)(slot_i[q] - p) * kTileF;
        for (int f = threadIdx.x; f < kTileF / 4; f += blockDim.x)
          st4<kSmem>(mine(q) + 4 * f, *reinterpret_cast<const float4*>(src + 4 * f));
      }
      __syncthreads();
    }
    if (p == nt) break;
    // 2. L_pp and the raw panel tiles (i, p), i = p+1..nt, into Lb and the staging area
    const int n_panel = nt - p;
    copy_batched<8>(
        (n_panel + 1) * (kTileF / 4),
        [&](int e) {
          return ld4<kSmem>(tile_at<kSmem>(cl, own, p + e / (kTileF / 4), p) +
                            4 * (e % (kTileF / 4)));
        },
        [&](int e, float4 v) {   // Lb and the staging area are contiguous
          *reinterpret_cast<float4*>(Lb + 4 * (size_t)e) = v;
        });
    __syncthreads();
    for (int s = warp; s < n_panel; s += kSolveWarps) trsm_rows(stage + (size_t)s * kTileF, Lb, lane);
    __syncthreads();
    // 3. the trailing tiles this CTA owns, a warp a tile; the next diagonal first
    for (int q = 0, m = 0; q < n_slots; ++q) {
      const int i = slot_i[q], j = slot_j[q];
      if (j <= p) continue;
      if (m++ % kSolveWarps != warp) continue;
      update_tile<kSmem>(mine(q), stage + (size_t)(i - p - 1) * kTileF,
                         stage + (size_t)(j - p - 1) * kTileF, i == j && j == p + 1, lane);
    }
    cl.sync();
  }
  cl.sync();   // every tile of L and y written back

  if (rank == 0) {   // L^T x = y in CTA 0; x and the warps' partials over the staging area
    float* x = stage;
    float* red = stage + kT * nt;
    for (int e = threadIdx.x; e < kT * nt; e += blockDim.x)
      x[e] = ld1<kSmem>(tile_at<kSmem>(cl, own, nt, e / kT) + e % kT);
    __syncthreads();
    for (int p = nt - 1; p >= 0; --p) {
      float lc[kT], inv = 0.f;   // warp 0: column lane of L_pp and 1 / L_pp[lane][lane]
      if (warp == 0) {
        const float* D = tile_at<kSmem>(cl, own, p, p);
#pragma unroll
        for (int k = 0; k < kT; ++k) lc[k] = ld1<kSmem>(D + k * kLd + lane);
        inv = ld1<kSmem>(D + lane * kLd + kT);
      }
      float s = 0.f;
      for (int i = p + 1 + warp; i < nt; i += kSolveWarps) {
        const float* Li = tile_at<kSmem>(cl, own, i, p);
        const float* xi = x + kT * i;
        float li[kT];   // column lane of L_ip, every load in flight at once
#pragma unroll
        for (int k = 0; k < kT; ++k) li[k] = ld1<kSmem>(Li + k * kLd + lane);
#pragma unroll
        for (int k = 0; k < kT; ++k) s = __fmaf_rn(li[k], xi[k], s);
      }
      red[warp * kT + lane] = s;
      __syncthreads();
      if (warp == 0) {
        float r = x[kT * p + lane];
        for (int w = 0; w < kSolveWarps; ++w) r -= red[w * kT + lane];
#pragma unroll
        for (int k = kT - 1; k >= 0; --k) {
          const float xk = __shfl_sync(kFull, r * inv, k);
          if (lane == k) r = xk;
          else if (lane < k) r = __fmaf_rn(-lc[k], xk, r);
        }
        x[kT * p + lane] = r;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < n; e += blockDim.x) a.x[e] = a.fixed_kf[e / 6] ? 0.f : x[e];
  }
  cl.sync();   // no CTA leaves while CTA 0 may read its tiles
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
  // the solve's cluster: the tiles in its shared memory where they fit
  const int nt = (n + kT - 1) / kT;
  const size_t tile_bytes = sizeof(float) * kTileF;
  const size_t smem_all = tile_bytes * (1 + nt + (n_tiles(nt) + kCluster - 1) / kCluster);
  const bool in_smem = smem_all <= kSmemCap;
  const size_t smem = in_smem ? smem_all : tile_bytes * (1 + nt);
  void (*solve)(const SchurDenseArgs, const DWs, int) =
      in_smem ? solve_cluster_kernel<true> : solve_cluster_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(solve, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kSolveThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, solve, a, d, nt)) != cudaSuccess) return (int)e;
  back_kernel<<<n_blocks(a.P), kThreads, 0, st>>>(a, d);
  return (int)cudaGetLastError();
}

extern "C" long long ba_schur_dense_workspace_bytes(int K, int P, int O) {
  return (long long)carve_d(nullptr, nullptr, K, P, O);
}
