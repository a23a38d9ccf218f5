"""Where the time of K3's Hamming search, K17's quadtree selection, K22's
pose-inertial solves, K16's keypoint collection, K4's pose LM, K20's and
K6's cluster solves, K8's map update, K29's query and K35's dense solve
goes, on the card.

    python3 chip_anatomy.py [k3,k17,k22,k16,k4,k20,k6,k8,k29,k35]

K3 and K17 against the parent commit's kernels (from ``build/parent/``,
built with the current ones into ``build/k3_k17/``, the current ones
stamping ``clock64()`` per phase).  K3 on the five calls of [system]'s
last ordinary frame, recorded by a spy on ``matcher.hamming_best2`` in an
eager run (a child process; ``build/k3_sites.pt``), and [parity]'s word
gate: bit-equal to the parent and to the plain version, the CUDA-event ms
of a launch in turns, the device ms from a profiler trace and in a
captured graph of 20 launches, and CTA 0's cycles per phase of the box
route (bounding box, count and scan, scatter, rows).  K17 on K16's output
for a rendered, a noise and a black frame at 640x480 / 1000 features and
512x512 / 1500: bit-equal, the times as K3's, and each level's CTA's
cycles per phase.

K22, K16, K4 and K20 against the parent commit's kernels: their sources
from ``build/parent/`` (``git archive <parent> extractorb_tpu_torch/csrc``
unpacked there), built with the current ones (K22 and K16 into
``build/k22_k16/``, K4 and K20 into ``build/k20_cluster/``), the current
ones stamping ``clock64()`` per phase.  K16 (the first CTA's thread 0:
histogram, merge and cut, numbering, place; also built at 1024
threads a CTA) at 640x480 / 1000 features and 512x512 / 1500 on a
rendered, a noise and a black frame: bit-equal to the parent and to the
plain version, the cluster size, the CUDA-event ms in turns and the device
ms.  K22 (thread 0: setup, visual, the wait for the Jacobian warps,
assemble, solve, apply, classify, final, marginalise; warp 8's and warp 9's
forward passes timed alone) on the largest calls of each variant in [vi]'s,
[vi-kb8]'s and [vi-stereo]'s runs and on [vi]'s joint problem tiled above
the staging limit: bit-equal to the parent, the ms in turns and the device
ms.  K4 (CTA 0's thread 0: linearise,
reduction, solve, candidate, classify) on [parity]'s mono problems, with the
stereo rows and through KB8: the CUDA-event ms of a call, its device ms
from a ``torch.profiler`` trace, the outputs of the two bit-equal and the
global route bit-equal to the staged one; then above the staging limit,
mono and stereo, against the plain version.
K20 on the [vi-loop] map's local window (6 x 40), its FullInertialBA at 25 x
40 and at 7 x 40 with the one-view points fixed, and the [vi-loop-kb8]
map's at 25 x 40, as the engine builds them: the parent's kernels one by
one (device ms per kernel name), the library's call against the parent and
the passes one by one on one shard (bit-equal), and copies at 8 and 16 CTAs
with each CTA adding up its cycles per phase kind (barrier waits and
cluster sums apart).

K29 first, while the process's profiler traces every kernel: a query of
[parity-mesh]'s 1024 x 65536 block on 4 shards of the card, through
``sharded_place_scores``: its CUDA-event time with q's host copy and with q
on the card, the host time to enqueue one (no synchronise), the kernel's
device time from a ``torch.profiler`` trace, q's host copy alone, and
``torch.cdist`` with a matvec on the same block.

Then K35: the kernel library and, into ``build/k35_solve/``, a copy of
``csrc/ba_schur_dense.cu`` with a C entry that runs the cluster solve alone
on a given S and b, its CTA 0 stamping ``clock64()`` at each phase. For the
reduced systems S of ``chip_smoke.ba_problem``'s problems ([ba-stereo]'s
Kp 32 and Kp 64, and the ``-m gpu`` test's Kp 64 and K 256 with and without
five fixed points; S from the plain version's arithmetic, symmetrised) it
prints S's condition, the relative error against a float64 solve of the
same S of K35's solve and of ``torch.linalg.solve`` (float32 LU) with their
CUDA-event times, and the mean cycles of each phase of a panel in CTA 0
(write-back, copy, triangular solves, trailing update, cluster barrier
wait). Then, for the test's problems, ``ba.optimize`` through K35 and the
plain version (float32 and float64) after 1, 2 and 10 LM steps: the largest
pose difference between each pair.

Then K6's cluster solve: copies of ``csrc/ba_pcg.cu`` built into
``build/k6_cluster/``, one per cluster size (8 and 16 CTAs), CTA 0 adding up
``clock64()`` per phase kind (the lists, build, reduce, invert, the Hessian
product, the two CG updates, retract, cost, accept, the final pass) with
the cluster-barrier wait apart. On [parity]'s problems (Kp 32 / Pp 2048 /
Op 8192 at 12 x 40 and 5 x 25) and run_ba's largest bucket (Pp 8192, Op
32768, 10 x 40) it prints each copy's CUDA-event time, the cycles per phase
kind and per barrier, and the library's own call. Last K8's map update:
the record scatter that ``MapMirror.sync`` launches (the kernel reading its
page-locked record in place) against one ``cudaMemcpyAsync`` of the record
to the card before the launch, ``mirror_scatter`` on device inputs against
two ``index_put_`` calls, and the host time to enqueue each. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.dist import kf_blocks as kfb
from extractorb_tpu_torch.dist import mesh as dmesh
from extractorb_tpu_torch.solver import ba, pose_opt
from extractorb_tpu_torch.solver import inertial as sin

OUT = Path(__file__).resolve().parent / "build" / "k35_solve"
# the phases CTA 0 stamps: after the prologue, its barrier, and per panel p
# at slots 8 + 8 p + (0 write-back, 1 copy, 2 triangular solves, 3 trailing
# update, 4 cluster barrier); 3 and 4 before and after the backward solve
STAMPS = (
    ("  const int rank = (int)cl.block_rank();\n", "TS(0);\n"),
    ("    store_rows<kSmem>(mine(0), col, inv, lane);\n  }\n", "TS(1);\n"),
    ("    if (p == nt) break;\n", "TS(8 + 8 * p + 0);\n"),
    ("            4 * (e % (kTileF / 4)));\n        },\n        [&](int e, float4 v) {   "
     "// Lb and the staging area are contiguous\n          *reinterpret_cast<float4*>(Lb + 4 * "
     "(size_t)e) = v;\n        });\n    __syncthreads();\n", "TS(8 + 8 * p + 1);\n"),
    ("trsm_rows(stage + (size_t)s * kTileF, Lb, lane);\n    __syncthreads();\n",
     "TS(8 + 8 * p + 2);\n"),
    ("i == j && j == p + 1, lane);\n    }\n", "TS(8 + 8 * p + 3);\n"),
    ("i == j && j == p + 1, lane);\n    }\n    TS(8 + 8 * p + 3);\n    cl.sync();\n",
     "TS(8 + 8 * p + 4);\n"),
    ("  cl.sync();   // every tile of L and y written back\n", "TS(3);\n"),
    ("x[e] = a.fixed_kf[e / 6] ? 0.f : x[e];\n  }\n", "TS(4);\n"),
)
ENTRY = r'''
extern "C" int k35_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_t, &p, sizeof(p)); }
extern "C" long long k35_ws(int K) { return (long long)carve_d(nullptr, nullptr, K, 1, 1); }
// the solve of ba_schur_dense_step on S (6K x 6K) and b, into x
extern "C" int k35_solve(const float* S, const float* b, const bool* fixed_kf, int K, float* x,
                         void* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SchurDenseArgs a = {};
  a.K = K; a.P = 1; a.O = 1; a.fixed_kf = fixed_kf; a.x = x; a.ws = ws;
  DWs d;
  carve_d(&d, static_cast<uint8_t*>(ws), K, 1, 1);
  const int n = 6 * K;
  cudaMemcpyAsync(d.S, S, sizeof(float) * n * n, cudaMemcpyDeviceToDevice, st);
  cudaMemcpyAsync(d.b, b, sizeof(float) * n, cudaMemcpyDeviceToDevice, st);
'''


def build_solve() -> ctypes.CDLL:
    """The instrumented copy of K35 with its solve-only entry, built by nvcc."""
    src = (kernels.CSRC / "ba_schur_dense.cu").read_text()
    src = src.replace('#include "ba_schur_dense.cuh"', '#include "ba_schur_dense.cuh"\n'
                      '__device__ long long* g_t;\n#define TS(slot) do { if (rank == 0 && '
                      'threadIdx.x == 0) g_t[(slot)] = clock64(); } while (0)')
    for anchor, stamp in STAMPS:
        if anchor not in src:
            raise RuntimeError(f"chip_anatomy: no anchor for {stamp.strip()} in K35's source")
        src = src.replace(anchor, anchor + "    " + stamp, 1)
    # the launch of ba_schur_dense_step's solve, after its two assembly passes
    launch = re.search(r"  // the solve's cluster.*?cudaLaunchKernelEx\(&cfg, solve, a, d, nt\)\) "
                       r"!= cudaSuccess\) return \(int\)e;\n", src, re.S)
    if launch is None:
        raise RuntimeError("chip_anatomy: the solve's launch is not in K35's source")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "k35_solve.cu").write_text(src + ENTRY + launch.group(0) +
                                      "  return (int)cudaGetLastError();\n}\n")
    lib_path = OUT / "k35_solve.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                        str(lib_path), str(OUT / "k35_solve.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"chip_anatomy: nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.k35_solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.k35_ws.argtypes = [ctypes.c_int]
    lib.k35_ws.restype = ctypes.c_longlong
    lib.k35_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


K6_OUT = Path(__file__).resolve().parent / "build" / "k6_cluster"
# K6's phase kinds (ba_pcg.cu's Phase), the stamp slots CTA 0 adds to
K6_PHASES = ("lists", "build", "reduce", "invert", "hv keyframes", "cg_a", "cg_b", "retract",
             "cost", "accept", "final", "barrier wait", "cluster sums", "hv points")
K6_WRAP = r'''
__device__ long long* g_k6;   // [0, 16) cycles, [16, 32) counts per phase kind, [40] the last clock
#define K6_STAMP(k) do { if (rank == 0 && threadIdx.x == 0) { const long long now_ = clock64(); \
  g_k6[(k)] += now_ - g_k6[40]; g_k6[16 + (k)] += 1; g_k6[40] = now_; } } while (0)
#define K6_CLUSTER %d
#include "ba_pcg.cu"
extern "C" int k6_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k6, &p, sizeof(p)); }
'''


def build_k6(clusters):
    """Copies of K6 (with K35's source, which it links), one per cluster
    size, CTA 0 stamping its phases; built by nvcc, all at once."""
    K6_OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cluster in clusters:
        src = K6_OUT / f"k6_c{cluster}.cu"
        src.write_text(K6_WRAP % cluster)
        procs[cluster] = (src.with_suffix(".so"), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
             str(src.with_suffix(".so")), str(src), str(kernels.CSRC / "ba_schur_dense.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"chip_anatomy: nvcc failed on {path.name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for name in ("ba_pcg_launch", "ba_workspace_bytes"):
            getattr(lib, name).argtypes = list(kernels._SIGNATURES[name])
        lib.ba_workspace_bytes.restype = ctypes.c_longlong
        lib.k6_set_stamps.argtypes = [ctypes.c_void_p]
        libs[key] = lib
    return libs


def k6_call(lib, p, cam, n_iters, cg_iters):
    """``ba.optimize``'s launch of K6 through ``lib`` (the mono pinhole
    problem p): returns a function that solves p afresh."""
    dev = p.points.device
    K, P, O = p.R.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    ws = torch.empty(int(lib.ba_workspace_bytes(K, P, O, cg_iters, 0)), dtype=torch.uint8,
                     device=dev)
    args = [a.contiguous() for a in (p.obs_kf, p.obs_mp, p.obs_uv, p.inv_sigma2, p.obs_valid,
                                     p.fixed_kf, p.fixed_mp)]
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)

    def call():
        R, t, pts = p.R.clone(), p.t.clone(), p.points.clone()
        err = lib.ba_pcg_launch(R.data_ptr(), t.data_ptr(), pts.data_ptr(),
                                *[a.data_ptr() for a in args], None, 0.0, K, P, O, cam.fx,
                                cam.fy, cam.cx, cam.cy, None, n_iters, cg_iters, 1, 5.991,
                                ws.data_ptr(), None, inl.data_ptr(), cost.data_ptr(),
                                kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K6 did not launch ({err})")
        return R, t, pts, inl
    return call


def k6_anatomy(dev) -> None:
    """K6's cluster solve per phase kind, for 8 and 16 CTAs."""
    K = cs.pf.camera_matrix(cs.WIDTH, cs.HEIGHT)
    cam = cs.track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    init = cs.ba_problem(np.random.default_rng(1), dev)
    big = cs.ba_problem(np.random.default_rng(6), dev, n_kf=10, n_pts=3000, Pp=8192, Op=32768)
    cases = (("[parity] 12 x 40", init, 12, 40), ("[parity] 5 x 25", init, 5, 25),
             ("Pp 8192 / Op 32768, 10 x 40", big, 10, 40))
    stamps = torch.zeros(64, dtype=torch.int64, device=dev)
    for cluster, lib in build_k6((8, 16)).items():
        if lib.k6_set_stamps(stamps.data_ptr()):
            raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
        for name, p, n_iters, cg_iters in cases:
            call = k6_call(lib, p, cam, n_iters, cg_iters)
            ref = ba.optimize(p, cam, n_iters, cg_iters)
            stamps.zero_()
            out = call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, (ref.R, ref.t, ref.points,
                                                               ref.inliers)))
            t = stamps.cpu().numpy()
            total = int(t[:len(K6_PHASES)].sum())
            parts = ", ".join(f"{k} {int(t[i])} ({int(t[16 + i])}x)"
                              for i, k in enumerate(K6_PHASES) if t[16 + i])
            ms = cs.cuda_ms(call, reps=10)
            lib_ms = cs.cuda_ms(lambda: ba.optimize(p, cam, n_iters, cg_iters), reps=10)
            print(f"K6 {cluster} CTAs, {name}: {ms:.4f} ms (the library's call {lib_ms:.4f}), "
                  f"bit-equal to it {same}; CTA 0 cycles {total}: {parts}; a barrier wait "
                  f"{t[11] / max(t[27], 1):.0f} cycles", flush=True)


PARENT = Path(__file__).resolve().parent / "build" / "parent"
PARENT_CSRC = PARENT / "extractorb_tpu_torch" / "csrc"
V20_OUT = Path(__file__).resolve().parent / "build" / "k20_cluster"
# K20's phase kinds (vi_ba.cu's Phase), the stamp slots each CTA adds to
V20_PHASES = ("setup and lists", "build rows", "build edges", "reduce", "invert",
              "hv keyframes", "hv points", "cg_a", "cg_b", "retract", "cost", "accept", "final",
              "barrier wait", "cluster sums", "hv observations")
V20_WRAP = r"""
__device__ long long* g_v20;   // CTA r: [64 r, 64 r + 20) cycles, [64 r + 20, 64 r + 40) counts, 64 r + 60 the last clock
#define V20_STAMP(k) do { if (threadIdx.x == 0) { long long* g_ = g_v20 + 64 * rank; \
  const long long now_ = clock64(); g_[(k)] += now_ - g_[60]; g_[20 + (k)] += 1; \
  g_[60] = now_; } } while (0)
#define V20_CLUSTER %d
#include "vi_ba.cu"
extern "C" int v20_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_v20, &p, sizeof(p)); }
"""
K4_PHASES = ("linearise", "reduction", "solve", "candidate", "classify")
K4_STAMP_DEF = r"""
__device__ long long* g_k4;   // [0, 8) cycles, [8, 16) counts per phase kind, [20] the last clock
#define K4_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const long long now_ = \
  clock64(); g_k4[(k)] += now_ - g_k4[20]; g_k4[8 + (k)] += 1; g_k4[20] = now_; } } while (0)
"""
K4_SET = r"""
extern "C" int k4_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k4, &p, sizeof(p)); }
"""
def _nvcc_all(jobs):
    """Build each (source, output .so, include dir) with nvcc, all at once."""
    procs = [(out, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(inc), "-o",
                                     str(out), str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for src, out, inc in jobs]
    for out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"chip_anatomy: nvcc failed on {out.name}:\n{log}")
    return [ctypes.CDLL(str(out)) for out, _ in procs]


def build_k20_k4():
    """The parent's K20 and K4 (from ``build/parent/``, a ``git archive`` of
    the parent commit's csrc), K20 clusters of 8 and 16 CTAs and K4, each
    stamping its phases; all built at once.  Returns (parent K20, {G: K20},
    parent K4, K4)."""
    if not (PARENT_CSRC / "vi_ba.cu").exists():
        raise RuntimeError(f"chip_anatomy: no parent sources in {PARENT_CSRC}")
    V20_OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(PARENT_CSRC / "vi_ba.cu", V20_OUT / "k20_parent.so", PARENT_CSRC)]
    for cluster in (8, 16):
        src = V20_OUT / f"k20_c{cluster}.cu"
        src.write_text(V20_WRAP % cluster)
        jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    src = V20_OUT / "k4_parent.cu"
    src.write_text(K4_STAMP_DEF + '#include "pose_lm.cu"\n' + K4_SET)
    jobs.append((src, src.with_suffix(".so"), PARENT_CSRC))
    src = V20_OUT / "k4_new.cu"
    src.write_text(K4_STAMP_DEF + '#include "pose_lm.cu"\n' + K4_SET)
    jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    libs = _nvcc_all(jobs)
    for lib in libs[:3]:
        for name in ("vi_ba_launch", "vi_ba_workspace_bytes"):
            getattr(lib, name).argtypes = list(kernels._SIGNATURES[name])
        lib.vi_ba_workspace_bytes.restype = ctypes.c_longlong
    for lib in libs[1:3]:
        lib.v20_set_stamps.argtypes = [ctypes.c_void_p]
    # the parent's pose_lm_launch has no workspace argument
    libs[3].pose_lm_launch.argtypes = list(kernels._SIGNATURES["pose_lm_launch"][:-2]) + [
        ctypes.c_void_p]
    for name in ("pose_lm_launch", "pose_lm_global_launch", "pose_lm_global_bytes"):
        getattr(libs[4], name).argtypes = list(kernels._SIGNATURES[name])
    libs[4].pose_lm_global_bytes.restype = ctypes.c_longlong
    for lib in libs[3:]:
        lib.k4_set_stamps.argtypes = [ctypes.c_void_p]
    return libs[0], {8: libs[1], 16: libs[2]}, libs[3], libs[4]


def vi_call(lib, p, cam, n_iters, cg_iters):
    """``optimize_vi_ba``'s launch of K20 through ``lib`` on problem p:
    returns a function that solves p afresh."""
    dev = p.points.device
    K, P, O = p.Rwb.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    f32 = lambda a: a.to(torch.float32)
    state0 = torch.cat([f32(p.Rwb).reshape(-1, 9), f32(p.twb), f32(p.v), f32(p.bg), f32(p.ba)],
                       1).contiguous()
    chain = sin.pack_preint(p.chain, dev)
    obs = [p.obs_kf.int().contiguous(), p.obs_mp.int().contiguous(), f32(p.obs_uv).contiguous(),
           f32(p.inv_sigma2).contiguous(), p.obs_valid.contiguous()]
    masks = [p.chain.valid.contiguous(), p.fixed_kf.contiguous(), p.fixed_mp.contiguous()]
    ext = torch.cat([p.Rcb.reshape(-1), p.tcb.reshape(-1)]).float().contiguous()
    ws = torch.empty(int(lib.vi_ba_workspace_bytes(K, P, O, cg_iters)), dtype=torch.uint8,
                     device=dev)
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    kb8 = cam.kernel_params()

    def call():
        state, pts = state0.clone(), f32(p.points).clone().contiguous()
        err = lib.vi_ba_launch(
            state.data_ptr(), pts.data_ptr(), chain.data_ptr(), *[a.data_ptr() for a in obs],
            *[a.data_ptr() for a in masks], ext.data_ptr(), K, P, O, cam.fx, cam.fy, cam.cx,
            cam.cy, None if kb8 is None else kb8.ctypes.data, float(p.prior_g),
            float(p.prior_a), n_iters, cg_iters, 1, float(sin.CHI2_MONO), ws.data_ptr(),
            inl.data_ptr(), cost.data_ptr(), kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K20 did not launch ({err})")
        return state, pts, inl.clone(), cost.clone()
    return call


def vi_problems(dev):
    """(name, problem, camera, n_iters, cg_iters) of the VI BA probe: the
    [vi-loop] map's local window (6 x 40), its FullInertialBA at the init's
    25 x 40 and the post-loop 7 x 40 (the one-view points fixed), and the
    [vi-loop-kb8] map's FullInertialBA at 25 x 40, each problem as the
    engine builds it (``imu_frontend``)."""
    calib = cs.ImuCalib.from_config(cs.vi_config().imu)
    out = []
    for kb8 in (False, True):
        mp = cs.inertial_looped_map(dev, calib, kb8=kb8)[0]
        cam = cs.loop_camera(kb8)
        probs, real = [], sin.optimize_vi_ba

        def spy(prob, cam_, **kw):
            probs.append(prob)
            return real(prob, cam_, **kw)
        sin.optimize_vi_ba = spy
        try:
            if not kb8:
                cs.imu_frontend.local_inertial_ba(mp, calib, cam, max(mp.keyframes), device=dev)
            cs.imu_frontend.full_inertial_ba(mp, calib, cam, n_iters=1, device=dev)
        finally:
            sin.optimize_vi_ba = real
        tag = "[vi-loop-kb8] map" if kb8 else "[vi-loop] map"
        if not kb8:
            out.append((f"{tag} local window", probs[0], cam, 6, 40))
            full = probs[1]
            out.append((f"{tag} FullInertialBA", full, cam, 25, 40))
            out.append((f"{tag} FullInertialBA, one-view points fixed", cs.one_view_fixed(full),
                        cam, 7, 40))
        else:
            out.append((f"{tag} FullInertialBA", probs[0], cam, 25, 40))
    return out


def _device_kernels(fn):
    """{kernel name: (device ms, count)} of one call of fn, from a profiler
    trace (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (t / 1e3, e.count)
    return out


def k20_anatomy(dev, parent, clusters) -> None:
    """K20 per pass: the parent's kernels one by one (device ms per kernel
    from a profiler trace), and the cluster at 8 and 16 CTAs (each CTA's
    clock64 per phase kind, barrier wait and cluster sums apart), bit-equal
    to the parent and to the library's call."""
    stamps = torch.zeros(64 * 16, dtype=torch.int64, device=dev)
    for lib in clusters.values():
        if lib.v20_set_stamps(stamps.data_ptr()):
            raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    for name, p, cam, n_iters, cg_iters in vi_problems(dev):
        K, P, O = p.Rwb.shape[0], p.points.shape[0], p.obs_kf.shape[0]
        head = f"K20 {name} K={K} P={P} O={O} ({int(p.obs_valid.sum())} valid), {n_iters} x {cg_iters}"
        pc = vi_call(parent, p, cam, n_iters, cg_iters)
        ref = pc()
        ker = _device_kernels(pc)
        tot = sum(v[0] for v in ker.values())
        launches = sum(v[1] for v in ker.values())
        parts = ", ".join(f"{k.split('(')[0]} {v[0]:.3f} ms ({v[1]}x)" for k, v in
                          sorted(ker.items(), key=lambda kv: -kv[1][0]))
        print(f"{head}: the parent {cs.cuda_ms(pc, reps=5):.3f} ms, {launches} device kernels "
              f"a call, {tot:.3f} device ms in all: {parts}", flush=True)
        lib_call = lambda: sin.optimize_vi_ba(p, cam, n_iters=n_iters, cg_iters=cg_iters)
        lk = lib_call()
        got = (lk.Rwb.reshape(K, 9), lk.twb, lk.v, lk.bg, lk.ba, lk.points, lk.inliers, lk.cost)
        want = (ref[0][:, :9], ref[0][:, 9:12], ref[0][:, 12:15], ref[0][:, 15:18],
                ref[0][:, 18:21], ref[1], ref[2], ref[3])
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        dmax = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got[:6], want[:6]))
        one = cs.sharded_ba.optimize_vi_sharded(cs.dmesh.Mesh([dev]), p, cam, n_iters=n_iters,
                                                cg_iters=cg_iters)
        same1 = all(torch.equal(getattr(one, f), getattr(lk, f)) for f in sin.VIBAResult._fields)
        print(f"{head}: the library's call {cs.cuda_ms(lib_call, reps=5):.3f} ms "
              f"({len(_device_kernels(lib_call))} device kernel), bit-equal to the parent "
              f"{same} (largest difference {dmax:.3e}), to the passes one by one on one shard "
              f"{same1}", flush=True)
        for cluster, lib in clusters.items():
            call = vi_call(lib, p, cam, n_iters, cg_iters)
            stamps.zero_()
            out = call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            t = stamps.cpu().numpy().reshape(16, 64)
            rows = []
            for r in range(cluster):
                total = int(t[r, :len(V20_PHASES)].sum())
                ph = ", ".join(f"{k} {int(t[r, i])} ({int(t[r, 20 + i])}x)"
                               for i, k in enumerate(V20_PHASES) if t[r, 20 + i])
                rows.append(f"CTA {r} cycles {total}, barrier wait {int(t[r, 13])}: {ph}")
            ms = cs.cuda_ms(call, reps=5)
            print(f"{head}, {cluster} CTAs: {ms:.3f} ms, bit-equal to the parent {same}; "
                  f"a barrier wait {t[0, 13] / max(t[0, 33], 1):.0f} cycles in CTA 0", flush=True)
            # CTA 0, the CTA with the edges' block, and the CTA that waited least
            least = int(np.argmin(t[:cluster, 13]))
            for row in (rows[:1] + [r_ for r_ in rows[1:] if "build edges" in r_][:1]
                        + [rows[least]]):
                print("  " + row, flush=True)


def k4_call(lib, args, cam, obs_ur=None, bf=0.0, route=None):
    """``optimize_pose``'s launch of K4 through ``lib``: route None the
    parent's entry (no workspace), "auto" the new one (the global route
    above the staging limit), "global" the new global route at any N."""
    R0, t0, pts, obs, isig, val = args
    B, N = pts.shape[0], pts.shape[1]
    dev = R0.device
    R = torch.empty(B, 3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(B, 3, dtype=torch.float32, device=dev)
    inl = torch.empty(B, N, dtype=torch.bool, device=dev)
    n_inl = torch.empty(B, dtype=torch.int32, device=dev)
    kb8 = cam.kernel_params()
    ws = None if route is None else torch.empty(
        int(lib.pose_lm_global_bytes(B, N, int(obs_ur is not None))), dtype=torch.uint8,
        device=dev)
    fn = lib.pose_lm_global_launch if route == "global" else lib.pose_lm_launch

    def call():
        head = (R0.data_ptr(), t0.data_ptr(), pts.data_ptr(), obs.data_ptr(),
                None if obs_ur is None else obs_ur.data_ptr(), isig.data_ptr(), val.data_ptr(),
                B, N, cam.fx, cam.fy, cam.cx, cam.cy, None if kb8 is None else kb8.ctypes.data,
                float(bf), 4, 10, R.data_ptr(), t.data_ptr(), inl.data_ptr(), n_inl.data_ptr())
        err = fn(*head, kernels.stream()) if route is None else fn(*head, ws.data_ptr(),
                                                                   kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K4 did not launch ({err})")
        return R.clone(), t.clone(), inl.clone(), n_inl.clone()
    return call


def k4_anatomy(dev, parent, new) -> None:
    """K4, the parent's and this one's: CTA 0's thread 0 clock64 per phase
    (linearise, reduction, solve, candidate, classify), the device ms of a
    call from a profiler trace and the CUDA-event ms of the call (parent and
    new timed in turns), and the outputs of the two bit-equal, on
    [parity]'s mono problems, stereo rows and [parity-kb8]'s KB8 problems;
    there the global route (the problem staged in device memory) bit-equal
    to the staged one.  Then one problem above the staging limit, mono and
    stereo: the global route against the plain version."""
    rng = np.random.default_rng(0)
    K = cs.pf.camera_matrix(cs.WIDTH, cs.HEIGHT)
    pin = cs.track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt).contiguous()
    cases = []
    R0, t0, pts, obs, isig, val, (Rt, tt) = cs.pf.synthetic_pose_problems(
        rng, 2, 1128, pin.fx, pin.fy, pin.cx, pin.cy)
    mono = [T(a) for a in (R0, t0, pts, obs, isig)] + [T(val, torch.bool)]
    cases.append(("mono B=2 N=1128", mono, pin, None, 0.0))
    # two of three observations with a right u at a 0.1 m baseline
    bf = float(pin.fx) * cs.STEREO_BASELINE
    z = np.einsum("bij,bnj->bni", Rt, pts)[..., 2] + tt[:, None, 2]
    ur = np.where(np.arange(1128) % 3 != 0, obs[..., 0] - bf / z, -1.0)
    cases.append(("stereo rows B=2 N=1128", mono, pin, T(ur), bf))
    kb8 = cs.pf.kb8_camera()
    kb = cs.KannalaBrandt8(*kb8)
    R0, t0, pts, obs, isig, val, _ = cs.pf.synthetic_pose_problems(rng, 2, 1628, *kb8[:4],
                                                                   kb8=kb8)
    cases.append(("KB8 B=2 N=1628", [T(a) for a in (R0, t0, pts, obs, isig)] +
                  [T(val, torch.bool)], kb, None, 0.0))
    stamps = torch.zeros(32, dtype=torch.int64, device=dev)
    for lib in (parent, new):
        if lib.k4_set_stamps(stamps.data_ptr()):
            raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    for name, args, cam, ur_t, bf in cases:
        res, calls = {}, {}
        for tag, lib, route in (("parent", parent, None), ("new", new, "auto")):
            call = calls[tag] = k4_call(lib, args, cam, ur_t, bf, route)
            stamps.zero_()
            res[tag] = call()
            torch.cuda.synchronize()
            t = stamps.cpu().numpy()
            ph = ", ".join(f"{k} {int(t[i])} ({int(t[8 + i])}x)" for i, k in enumerate(K4_PHASES))
            ker = _device_kernels(call)
            dms = sum(v[0] for v in ker.values())
            print(f"K4 {name} {tag}: {dms:.4f} device ms ({sum(v[1] for v in ker.values())} "
                  f"kernel); CTA 0 thread 0 cycles {int(t[:5].sum())}: {ph}", flush=True)
        ms_p, ms_n = cs.paired_ms(calls["parent"], calls["new"], reps=20)
        glob = k4_call(new, args, cam, ur_t, bf, "global")
        same = all(torch.equal(a, b) for a, b in zip(res["parent"], res["new"]))
        same_g = all(torch.equal(a, b) for a, b in zip(glob(), res["new"]))
        ms_g = cs.cuda_ms(glob, reps=20)
        lib_call = lambda: pose_opt.optimize_pose(*args, cam, obs_ur=ur_t, bf=bf)
        lk = lib_call()
        same_lib = all(torch.equal(a, b) for a, b in zip(
            (lk.R, lk.t, lk.inliers, lk.n_inliers), res["new"]))
        print(f"K4 {name}: parent {ms_p:.4f} ms, new {ms_n:.4f} ms a call (CUDA events, in "
              f"turns); bit-equal to the parent {same}; the global route bit-equal to the "
              f"staged {same_g} ({ms_g:.4f} ms); the library's call the same {same_lib}",
              flush=True)
    for stereo in (False, True):
        limit = pose_opt.pose_lm_max_n(stereo, dev)
        n = limit + 500
        R0, t0, pts, obs, isig, val, (Rt, tt) = cs.pf.synthetic_pose_problems(
            np.random.default_rng(6), 1, n, pin.fx, pin.fy, pin.cx, pin.cy)
        args = [T(a) for a in (R0, t0, pts, obs, isig)] + [T(val, torch.bool)]
        kw = {}
        if stereo:
            z = np.einsum("bij,bnj->bni", Rt, pts)[..., 2] + tt[:, None, 2]
            kw = dict(obs_ur=T(np.where(np.arange(n) % 3 != 0, obs[..., 0] - bf / z, -1.0)),
                      bf=bf)
        before = kernels.LAUNCHES["pose_lm_global"]
        got = pose_opt.optimize_pose(*args, pin, **kw)
        want = pose_opt.optimize_pose_plain(*args, pin, **kw)
        d = max(float((got.R - want.R).abs().max()), float((got.t - want.t).abs().max()))
        ms = cs.cuda_ms(lambda: pose_opt.optimize_pose(*args, pin, **kw), reps=10)
        print(f"K4 {'stereo' if stereo else 'mono'} N={n} (staging limit {limit}): the global "
              f"route ({kernels.LAUNCHES['pose_lm_global'] - before} launch) within {d:.2e} of "
              f"plain, inliers equal {torch.equal(got.inliers, want.inliers)}; {ms:.4f} ms a "
              f"call", flush=True)


# K22's phase kinds (pose_inertial.cu's Phase): thread 0's timeline, then
# warp 8's and warp 9's forward passes timed alone
K22_PHASES = ("setup", "visual", "join wait", "assemble", "elimination", "apply", "classify",
              "final", "marginalise", "edge Jacobians (warp 8)", "prior Jacobian (warp 9)",
              "back substitution", "elimination: pivot", "swap", "factors",
              "update and barriers")
K22_STAMP_DEF = r"""
__device__ long long* g_k22;   // [0, 20) cycles, [20, 40) counts per phase kind, [60] the last clock
#define K22_STAMP(k) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \
  g_k22[(k)] += now_ - g_k22[60]; g_k22[20 + (k)] += 1; g_k22[60] = now_; } } while (0)
#define K22_CLOCK() clock64()
#define K22_SPAN(k, t0) do { g_k22[(k)] += clock64() - (t0); g_k22[20 + (k)] += 1; } while (0)
// the elimination's column parts, kept in thread 0's registers and added once a solve
#define K22_LAP_INIT() long long lap_[4] = {0, 0, 0, 0}, lt_ = clock64()
#define K22_LAP(i) do { const long long t_ = clock64(); lap_[i] += t_ - lt_; lt_ = t_; } while (0)
#define K22_LAP_DONE() do { if (threadIdx.x == 0) for (int i_ = 0; i_ < 4; ++i_) { \
  g_k22[12 + i_] += lap_[i_]; g_k22[32 + i_] += 1; } } while (0)
#include "pose_inertial.cu"
extern "C" int k22_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k22, &p, sizeof(p)); }
"""
K16_PHASES = ("histogram + barrier", "merge and cut", "numbering", "place + barrier")
K16_STAMP_DEF = r"""
__device__ long long* g_k16;   // [0, 8) cycles, [8, 16) counts per phase kind, [20] the last clock
#define K16_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const long long now_ = \
  clock64(); g_k16[(k)] += now_ - g_k16[20]; g_k16[8 + (k)] += 1; g_k16[20] = now_; } } while (0)
%s
#include "kp_collect.cu"
extern "C" int k16_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k16, &p, sizeof(p)); }
"""
K22K16_OUT = Path(__file__).resolve().parent / "build" / "k22_k16"


def build_k22_k16():
    """The parent's K22 and K16 (from ``build/parent/``) and this tree's, the
    latter stamping their phases, K16 also at 1024 threads a CTA; all built
    at once.  Returns (parent K22, K22, parent K16, K16, K16 at 1024)."""
    if not (PARENT_CSRC / "pose_inertial.cu").exists():
        raise RuntimeError(f"chip_anatomy: no parent sources in {PARENT_CSRC}")
    K22K16_OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(PARENT_CSRC / "pose_inertial.cu", K22K16_OUT / "k22_parent.so", PARENT_CSRC)]
    src = K22K16_OUT / "k22_new.cu"
    src.write_text(K22_STAMP_DEF)
    jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    jobs.append((PARENT_CSRC / "kp_collect.cu", K22K16_OUT / "k16_parent.so", PARENT_CSRC))
    for name, extra in (("k16_new", ""), ("k16_1024", "#define K16_THREADS 1024")):
        src = K22K16_OUT / f"{name}.cu"
        src.write_text(K16_STAMP_DEF % extra)
        jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    libs = _nvcc_all(jobs)
    for lib in libs[:2]:
        lib.pose_inertial_launch.argtypes = list(kernels._SIGNATURES["pose_inertial_launch"])
    libs[1].k22_set_stamps.argtypes = [ctypes.c_void_p]
    for lib in libs[2:]:
        lib.kp_collect_launch.argtypes = list(kernels._SIGNATURES["kp_collect_launch"])
    for lib in libs[3:]:
        lib.kp_collect_cluster.argtypes = list(kernels._SIGNATURES["kp_collect_cluster"])
        lib.k16_set_stamps.argtypes = [ctypes.c_void_p]
    return tuple(libs)


def k22_call(lib, joint, args, kw):
    """K22's launch through ``lib`` on a recorded wrapper call (args, kw):
    returns a function that solves it afresh."""
    (R0, t0, v0, bg0, ba0, prev, preint, pts, uv, isig, valid, Rcb, tcb, cam) = args[:14]
    n_rounds, n_iters = kw.get("n_rounds", 4), kw.get("n_iters", 10)
    state, obs = sin.pose_inertial_inputs(joint, R0, t0, v0, bg0, ba0, prev, preint, pts, uv,
                                          isig, valid, Rcb, tcb, kw.get("prior"))
    dev, N = t0.device, pts.shape[0]
    out = torch.empty(246, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    kb8 = cam.kernel_params()

    def call():
        err = lib.pose_inertial_launch(
            state.data_ptr(), *[a.data_ptr() for a in obs], N, cam.fx, cam.fy, cam.cx, cam.cy,
            None if kb8 is None else kb8.ctypes.data, int(joint), n_rounds, n_iters,
            out.data_ptr(), inl.data_ptr(), n_inl.data_ptr(), kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K22 did not launch ({err})")
        return out.clone(), inl.clone(), n_inl.clone()
    return call


K22_CACHE = Path(__file__).resolve().parent / "build" / "k22_problems.pt"


def k22_problems(dev):
    """(name, joint, args, kw) of the largest K22 call of each kind in
    [vi]'s, [vi-kb8]'s and [vi-stereo]'s runs (recorded as chip_smoke.py
    does), and [vi]'s joint problem with its points tiled 8 times: above
    the staging limit.  Read from ``build/k22_problems.pt`` where an earlier
    run left them (it saves them to ``chiprun_out/k22_problems.pt``)."""
    if K22_CACHE.exists():
        return [(name, joint, tuple(a.to(dev) if torch.is_tensor(a) else a for a in args), kw)
                for name, joint, args, kw in torch.load(K22_CACHE, map_location=dev,
                                                        weights_only=False)]
    vi_frames, _ = cs.vi_frames()
    vi_left, vi_right = cs.vi_stereo_frames()
    vk_l, _, _ = cs.vi_rig_frames()
    out = []
    for tag, cfg, frames, rights in (("[vi]", cs.vi_config(), vi_frames, None),
                                     ("[vi-kb8]", cs.vi_kb8_config(), vk_l, None),
                                     ("[vi-stereo]", cs.vi_stereo_config(), vi_left, vi_right)):
        with cs._InertialRecorder() as rec:
            cs.run_vi(frames, dev, cfg=cfg, rights=rights)[0].flush()
        torch.cuda.synchronize()
        for key, joint in (("pose_inertial_joint", True), ("pose_inertial", False)):
            if rec.calls[key]:
                args, kw = cs._largest(rec.calls[key], lambda c: int(c[0][10].sum()))
                out.append((f"{tag} {'<true>' if joint else '<false>'} N={args[7].shape[0]} "
                            f"({int(args[10].sum())} valid)", joint, args, kw))
    name, joint, args, kw = next(c for c in out if c[1])
    tile = lambda a: torch.cat([a] * 8)
    big = args[:7] + tuple(tile(a) for a in args[7:11]) + args[11:]
    out.append((f"[vi] <true> tiled 8x N={big[7].shape[0]}", True, big, kw))
    save = Path(__file__).resolve().parent / "chiprun_out" / "k22_problems.pt"
    save.parent.mkdir(exist_ok=True)
    torch.save(out, save)
    return out


def k22_anatomy(dev, parent, new) -> None:
    """K22, the parent's and this one's, on [vi]'s, [vi-kb8]'s and
    [vi-stereo]'s largest calls and above the staging limit: bit-equal,
    the CUDA-event ms of a call in turns and the device ms from a profiler
    trace, and the new kernel's thread 0 cycles per phase."""
    stamps = torch.zeros(64, dtype=torch.int64, device=dev)
    if new.k22_set_stamps(stamps.data_ptr()):
        raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    for name, joint, args, kw in k22_problems(dev):
        cp, cn = k22_call(parent, joint, args, kw), k22_call(new, joint, args, kw)
        rp = cp()
        stamps.zero_()
        rn = cn()
        torch.cuda.synchronize()
        t = stamps.cpu().numpy()
        same = all(torch.equal(a, b) for a, b in zip(rp, rn))
        dmax = float((rp[0] - rn[0]).abs().max())
        fn = sin.optimize_pose_inertial_last_frame if joint else sin.optimize_pose_inertial
        lk = fn(*args, **kw)
        lib_same = torch.equal(lk.H.reshape(-1), rn[0][21:]) and torch.equal(lk.inliers, rn[1])
        ms_p, ms_n = cs.paired_ms(cp, cn, reps=10)
        dp = sum(v[0] for v in _device_kernels(cp).values())
        dn = sum(v[0] for v in _device_kernels(cn).values())
        total = int(t[:9].sum() + t[11])
        ph = ", ".join(f"{k} {int(t[i])} ({int(t[20 + i])}x)" for i, k in enumerate(K22_PHASES)
                       if t[20 + i])
        print(f"K22 {name}: parent {ms_p:.4f} ms, new {ms_n:.4f} ms a call (CUDA events, in "
              f"turns); device ms parent {dp:.4f}, new {dn:.4f}; bit-equal to the parent {same} "
              f"(largest difference {dmax:.3e}); the library's call the same {lib_same}",
              flush=True)
        print(f"  new thread 0 cycles {total}: {ph}", flush=True)


def k16_parent_table(plan) -> np.ndarray:
    """The parent K16's launch table: n_levels, sort_n, then per level
    plane_off, W, H, k, out_off."""
    sort_n = 1 << (max(plan.k_levels) - 1).bit_length()
    rows = [[off, W, H, k, o] for off, (H, W), k, o in
            zip(plan.plane_offsets, plan.inner, plan.k_levels, plan.slot_offsets)]
    return np.ascontiguousarray(np.concatenate([[len(rows), sort_n], np.asarray(rows).reshape(-1)]
                                               ).astype(np.int32))


def k16_call(lib, keeps, scores, plan, table):
    dev = keeps[0].device
    xy = torch.empty(plan.total, 2, dtype=torch.int32, device=dev)
    resp = torch.empty(plan.total, dtype=torch.int32, device=dev)
    valid = torch.empty(plan.total, dtype=torch.bool, device=dev)

    def call():
        err = lib.kp_collect_launch(keeps[0].data_ptr(), scores[0].data_ptr(), table.ctypes.data,
                                    xy.data_ptr(), resp.data_ptr(), valid.data_ptr(),
                                    kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K16 did not launch ({err})")
        return xy.clone(), resp.clone(), valid.clone()
    return call


def k16_anatomy(dev, parent, new, new1024) -> None:
    """K16, the parent's and this one's (512 and 1024 threads a CTA), at
    640x480 / 1000 features and 512x512 / 1500 on a rendered, a noise and a
    black frame: bit-equal to each other and to the plain version; the
    CUDA-event ms in turns and the device ms from a profiler trace on the
    rendered frame; the cluster size and the first CTA's cycles per phase."""
    from extractorb_tpu_torch.frontend import fast
    from extractorb_tpu_torch.frontend.extractor import ORBExtractor
    from extractorb_tpu_torch.frontend.pyramid import compute_pyramid
    stamps = torch.zeros(32, dtype=torch.int64, device=dev)
    for lib in (new, new1024):
        if lib.k16_set_stamps(stamps.data_ptr()):
            raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    rng = np.random.default_rng(5)
    for (W, H), cfg in (((cs.WIDTH, cs.HEIGHT), cs.system_config()),
                        ((cs.KB8_SIZE, cs.KB8_SIZE), cs.kb8_config())):
        ex = ORBExtractor(cfg.orb, (H, W), dev)
        plan = ex.collect_plan
        frame = cs.pf.render_sequence(cs.pf.procedural_texture(), 1, width=W, height=H)[0][0]
        images = {"rendered": frame, "noise": rng.integers(0, 256, (H, W)).astype(np.uint8),
                  "black": np.zeros((H, W), np.uint8)}
        ptab = k16_parent_table(plan)
        G = {}
        for tag, lib in (("new", new), ("1024", new1024)):
            out = np.zeros(3, np.int32)
            if lib.kp_collect_cluster(len(plan.k_levels), plan.list_n, out.ctypes.data):
                raise RuntimeError("chip_anatomy: kp_collect_cluster failed")
            G[tag] = tuple(int(v) for v in out)
        for name, im in images.items():
            pyr = compute_pyramid(torch.from_numpy(im).to(dev), ex.pyr_plan)
            keeps, scores = fast.fast_detect(pyr, ex.fast_plan)
            plain = fast.collect_levels_plain(keeps, scores, plan)
            cp = k16_call(parent, keeps, scores, plan, ptab)
            cn = k16_call(new, keeps, scores, plan, plan.table(G["new"][0]))
            c5 = k16_call(new1024, keeps, scores, plan, plan.table(G["1024"][0]))
            rp = cp()
            stamps.zero_()
            rn = cn()
            torch.cuda.synchronize()
            t = stamps.cpu().numpy()
            r5 = c5()
            eq = lambda x: all(torch.equal(a, b) for a, b in zip(x, plain))
            print(f"K16 {W}x{H} {name} ({int(plain[2].sum())} valid of {plan.total}): parent "
                  f"bit-equal to plain {eq(rp)}, new {eq(rn)}, new at 1024 threads {eq(r5)}; "
                  f"clusters of {G['new'][0]} ({G['new'][1]} held at once, {G['new'][2]} of 16; "
                  f"1024 threads: {G['1024'][0]}, {G['1024'][1]}, {G['1024'][2]})", flush=True)
            if name != "rendered":
                continue
            ms_p, ms_n = cs.paired_ms(cp, cn, reps=50)
            ms_5 = cs.cuda_ms(c5, reps=50)
            dev_ms = [sum(v[0] for v in _device_kernels(c).values()) for c in (cp, cn, c5)]
            lib_ms = cs.cuda_ms(lambda: fast.collect_levels(keeps, scores, plan), reps=50)
            total = int(t[:len(K16_PHASES)].sum())
            ph = ", ".join(f"{k} {int(t[i])}" for i, k in enumerate(K16_PHASES))
            print(f"K16 {W}x{H}: parent {ms_p:.4f} ms, new {ms_n:.4f} ms a call (CUDA events, "
                  f"in turns), 1024 threads {ms_5:.4f}; device ms parent {dev_ms[0]:.4f}, new "
                  f"{dev_ms[1]:.4f}, 1024 threads {dev_ms[2]:.4f}; the wrapper {lib_ms:.4f} ms; "
                  f"CTA 0 thread 0 cycles {total}: {ph}", flush=True)


K3_PHASES = ("bounding box", "count and scan", "scatter + descriptors", "rows")
K3_STAMP_DEF = r"""
__device__ long long* g_k3;   // [0, 8) cycles, [8, 16) counts per phase kind, [20] the last clock
#define K3_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const long long now_ = \
  clock64(); g_k3[(k)] += now_ - g_k3[20]; g_k3[8 + (k)] += 1; g_k3[20] = now_; } } while (0)
#include "hamming_best2.cu"
extern "C" int k3_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k3, &p, sizeof(p)); }
"""
K17_PHASES = ("path codes + bitmap", "count per depth", "argmax per cell", "histogram + lists",
              "place", "pack + cluster barriers")
K17_STAMP_DEF = r"""
__device__ long long* g_k17;   // CTA b: [32 b, 32 b + 8) cycles, [32 b + 8, 32 b + 16) counts, 32 b + 20 the last clock
#define K17_STAMP(k) do { if (threadIdx.x == 0) { long long* g_ = g_k17 + 32 * blockIdx.x; \
  const long long now_ = clock64(); g_[(k)] += now_ - g_[20]; g_[8 + (k)] += 1; g_[20] = now_; \
  } } while (0)
#include "octree_select.cu"
extern "C" int k17_set_stamps(long long* p) { return (int)cudaMemcpyToSymbol(g_k17, &p, sizeof(p)); }
"""
K3K17_OUT = Path(__file__).resolve().parent / "build" / "k3_k17"



def build_k3_k17():
    """The parent's K3 and K17 (from ``build/parent/``) and this tree's,
    stamping their phases; all built at once.  Returns (parent K3, K3,
    parent K17, K17)."""
    if not (PARENT_CSRC / "hamming_best2.cu").exists():
        raise RuntimeError(f"chip_anatomy: no parent sources in {PARENT_CSRC}")
    K3K17_OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(PARENT_CSRC / "hamming_best2.cu", K3K17_OUT / "k3_parent.so", PARENT_CSRC)]
    src = K3K17_OUT / "k3_new.cu"
    src.write_text(K3_STAMP_DEF)
    jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    jobs.append((PARENT_CSRC / "octree_select.cu", K3K17_OUT / "k17_parent.so", PARENT_CSRC))
    src = K3K17_OUT / "k17_new.cu"
    src.write_text(K17_STAMP_DEF)
    jobs.append((src, src.with_suffix(".so"), kernels.CSRC))
    libs = _nvcc_all(jobs)
    for lib in libs[:2]:
        lib.hamming_best2_launch.argtypes = list(kernels._SIGNATURES["hamming_best2_launch"])
    for lib in libs[2:]:
        lib.octree_select_launch.argtypes = list(kernels._SIGNATURES["octree_select_launch"])
    libs[1].k3_set_stamps.argtypes = [ctypes.c_void_p]
    libs[3].k17_set_stamps.argtypes = [ctypes.c_void_p]
    return tuple(libs)


def graph_ms(launch, n: int = 20, reps: int = 20) -> float:
    """Device ms a launch of ``launch`` as the step's graph runs it: n
    launches captured in one CUDA graph, the replay's CUDA-event time over
    n (median of reps)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        launch()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            launch()
    return cs.cuda_ms(g.replay, reps=reps) / n


def device_ms(launch) -> tuple:
    """(device ms, kernels) of one launch from a profiler trace."""
    k = _device_kernels(launch)
    return sum(v[0] for v in k.values()), sum(v[1] for v in k.values())


def k3_call(lib, q, row_ok, c, col_ok, gate=None, words=None, parent=False):
    """K3's launch through ``lib`` as ``matcher.hamming_best2`` makes it;
    the parent's kernel reads the open gate's tensors, this one takes null
    box arguments.  Returns (a function that launches it, its (4, M) output)."""
    from extractorb_tpu_torch.frontend import matcher
    M, N = q.shape[0], c.shape[0]
    f32 = lambda t: t.to(torch.float32).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    if gate is None and words is None and parent:
        gate = matcher.open_gate(M, N, q.device)
    wp = [None, None] if words is None else [i32(words[0]), i32(words[1])]
    box = [None] * 5 if gate is None or words is not None else \
        [f32(gate.u), f32(gate.v), f32(gate.r), i32(gate.lo), i32(gate.hi)]
    cbox = [None] * 3 if gate is None or words is not None else \
        [f32(gate.x), f32(gate.y), i32(gate.octave)]
    keep = [*wp, q.contiguous(), *box, row_ok.contiguous(), c.contiguous(), *cbox,
            col_ok.contiguous()]
    ptr = [None if a is None else a.data_ptr() for a in keep]
    out = torch.empty(4, M, dtype=torch.int32, device=q.device)

    def launch():
        err = lib.hamming_best2_launch(*ptr[:9], M, *ptr[9:], N, *(o.data_ptr() for o in out),
                                       kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K3 did not launch ({err})")
    launch.keep = keep
    return launch, out


def _clone(a):
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        return type(a)(*map(_clone, a)) if hasattr(a, "_fields") else tuple(map(_clone, a))
    return a


K3_CACHE = Path(__file__).resolve().parent / "build" / "k3_sites.pt"


def k3_sites(dev):
    """(site, args, kw) of K3's five calls on the last frame of an eager
    [system] run (the step's graph off; a spy on ``matcher.hamming_best2``
    records every call with its caller), and [parity]'s word gate: frame 0
    against frame 4 with the words of the trained k=8, L=3 tree.  Saved to
    ``build/k3_sites.pt``, and read from there by later calls: a process
    whose profiler has traced the System's run traces few kernels after
    it, so ``chip_anatomy.py k3`` records them in a child process."""
    if K3_CACHE.exists():
        return torch.load(K3_CACHE, map_location=dev, weights_only=False)
    from extractorb_tpu_torch.frontend import matcher
    frames = cs.pf.render_stereo_sequence(cs.pf.procedural_texture(), cs.SYS_FRAMES,
                                          cs.SYS_SPEED, cs.WIDTH, cs.HEIGHT,
                                          cs.STEREO_BASELINE)[0]
    calls, real = [], matcher.hamming_best2

    def spy(*args, **kw):
        caller = sys._getframe(1)
        site = caller.f_code.co_name
        if site == "search_by_projection_last_frame":
            site += f" th {caller.f_locals['th']:g}"
        calls.append((site, _clone(args), _clone(kw)))
        return real(*args, **kw)
    sys_ = cs.System(cs.system_config(), device=dev)
    sys_.tracker.step_graph = False
    matcher.hamming_best2 = spy
    try:
        for k, img in enumerate(frames):
            sys_.track_monocular(img, k / 30.0)
    finally:
        matcher.hamming_best2 = real
    torch.cuda.synchronize()
    out = []
    for site in ("search_by_projection_last_frame th 15", "search_by_projection_last_frame th 30",
                 "mutual_best_match", "search_by_projection_local_map"):
        found = [c for c in calls if c[0] == site]
        for j, (name, args, kw) in enumerate(found[-2:] if site == "mutual_best_match" else
                                             found[-1:]):
            out.append((name + (f" ({'r12' if j == 0 else 'r21'})" if site ==
                                "mutual_best_match" else ""), args, kw))
    voc = cs.train_vocab(frames, dev)
    ext = cs.ORBExtractor(cs.ORBConfig(n_features=cs.SYS_FEATURES), frames[0].shape, dev)
    f1, f2 = ext(torch.from_numpy(frames[0]).to(dev)), ext(torch.from_numpy(frames[4]).to(dev))
    w1 = torch.where(f1.valid, voc.transform_words_device(f1.desc), -1)
    w2 = torch.where(f2.valid, voc.transform_words_device(f2.desc), -1)
    out.append(("[parity] word gate", (f1.desc, f1.valid, f2.desc, f2.valid),
                dict(words=(w1, w2))))
    out = (out, len(calls))
    K3_CACHE.parent.mkdir(exist_ok=True)
    torch.save(out, K3_CACHE)
    return out


def k3_anatomy(dev, parent, new) -> None:
    """K3, the parent's and this one's, on each call site of [system]'s
    ordinary frame and [parity]'s word gate: bit-equal to the parent and to
    the plain version, the CUDA-event ms of a launch in turns, the device
    ms from a profiler trace and in a captured graph of 20 launches, and
    CTA 0's cycles per phase of the box route."""
    from extractorb_tpu_torch.frontend import matcher
    stamps = torch.zeros(32, dtype=torch.int64, device=dev)
    if new.k3_set_stamps(stamps.data_ptr()):
        raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    if not K3_CACHE.exists():
        subprocess.run([sys.executable, __file__, "k3-record"], check=True)
    sites, n_calls = k3_sites(dev)
    print(f"K3: {n_calls} calls recorded in the eager [system] run; the last frame's sites:",
          flush=True)
    for name, args, kw in sites:
        q, row_ok, c, col_ok = args[:4]
        gate = args[4] if len(args) > 4 else kw.get("gate")
        words = kw.get("words")
        kind = "word" if words is not None else "open" if gate is None else "box"
        plain = matcher.hamming_best2_plain(q, row_ok, c, col_ok, gate, words)
        lp, rp = k3_call(parent, q, row_ok, c, col_ok, gate, words, parent=True)
        ln, rn = k3_call(new, q, row_ok, c, col_ok, gate, words)
        lp()
        stamps.zero_()
        ln()
        torch.cuda.synchronize()
        t = stamps.cpu().numpy()
        same = all(torch.equal(a, b) for a, b in zip(rn, plain)) and torch.equal(rn, rp)
        ms_p, ms_n = cs.paired_ms(lp, ln, reps=100)
        dp, kp = device_ms(lp)
        dn, kn = device_ms(ln)
        n_in = int((plain.best < matcher.INF).sum())
        print(f"K3 {name} {q.shape[0]}x{c.shape[0]} ({kind} gate, {n_in} rows with a match): "
              f"parent bit-equal to plain {all(torch.equal(a, b) for a, b in zip(rp, plain))}; "
              f"new bit-equal to plain and parent {same}; CUDA events a launch in turns parent "
              f"{ms_p:.4f} ms, new {ms_n:.4f} ms; device ms (profiler) parent {dp:.4f} "
              f"({kp} kernels), new {dn:.4f} ({kn}); in a graph of 20 launches parent "
              f"{graph_ms(lp):.4f}, new {graph_ms(ln):.4f}", flush=True)
        if kind == "box":
            total = int(t[:len(K3_PHASES)].sum())
            print(f"  new CTA 0 thread 0 cycles {total}: " + ", ".join(
                f"{k} {int(t[i])}" for i, k in enumerate(K3_PHASES)), flush=True)


def k17_parent_table(ex):
    """The parent K17's static inputs: its tables buffer (per level the
    depth-7 edges, the path-bit tables) and launch table (n_levels, sort_n,
    n_out, then per level k, k_off, cap, cap_off, budget, min_x, min_y,
    nxe, nye, five table offsets and the scale's bits)."""
    parts, rows, pos, k_off, cap_off = [], [], 0, 0, 0
    for (k, cap, tree), budget, scale in zip(ex.levels, ex.budgets, ex.scales):
        tabs = [tree.x_inner[-1], tree.y_inner[-1], tree.bx, tree.by, tree.topx]
        offs = []
        for t in tabs:
            offs.append(pos)
            parts.append(t.cpu().numpy().astype(np.int32))
            pos += t.numel()
        rows.append([k, k_off, cap, cap_off, budget, tree.min_x, tree.min_y, tabs[0].numel(),
                     tabs[1].numel(), *offs, int(np.float32(scale).view(np.int32))])
        k_off += k
        cap_off += cap
    sort_n = 1 << (max(k for k, _, _ in ex.levels) - 1).bit_length()
    table = np.ascontiguousarray(np.concatenate(
        [[len(rows), sort_n, ex.select_plan.n_out], np.asarray(rows, np.int64).reshape(-1)]
    ).astype(np.int32))
    return torch.as_tensor(np.concatenate(parts), device=ex.device), table


def k17_call(lib, cand, ex, parent=None):
    """K17's launch through ``lib`` on K16's output ``cand``; ``parent`` =
    k17_parent_table(ex) for the parent's kernel.  Returns (a function that
    launches it, its Selected outputs)."""
    from extractorb_tpu_torch.frontend.extractor import Selected
    plan, dev = ex.select_plan, ex.device
    L, S, n = plan.n_levels, plan.n_lvl_slots, plan.n_out
    i32 = lambda *shape: torch.empty(*shape, dtype=torch.int32, device=dev)
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    b8 = lambda *shape: torch.empty(*shape, dtype=torch.bool, device=dev)
    out = Selected(i32(n, 2), i32(n), b8(n), f32(n, 2), f32(n), f32(n), i32(L),
                   i32(S, 2), i32(S), b8(S))
    ws = i32(max(plan.ws_ints, L))
    xy, resp, valid = cand
    p = [a.data_ptr() for a in out]

    def launch():
        if parent is None:
            err = lib.octree_select_launch(
                xy.data_ptr(), resp.data_ptr(), valid.data_ptr(), plan.tables.data_ptr(),
                plan.table.ctypes.data, ws.data_ptr() if plan.ws_ints else None, p[7], p[8],
                p[9], p[6], *p[:6], kernels.stream())
        else:
            err = lib.octree_select_launch(
                xy.data_ptr(), resp.data_ptr(), valid.data_ptr(), parent[0].data_ptr(),
                parent[1].ctypes.data, p[7], p[8], p[9], p[6], ws.data_ptr(), *p[:6],
                kernels.stream())
        if err:
            raise RuntimeError(f"chip_anatomy: K17 did not launch ({err})")
    return launch, out


def k17_anatomy(dev, parent, new) -> None:
    """K17, the parent's and this one's, on K16's output for a rendered, a
    noise and a black frame at 640x480 / 1000 features and 512x512 / 1500:
    bit-equal to each other and to the plain version; on the rendered and
    the noise frame the CUDA-event ms in turns, the device ms from a
    profiler trace, each level's depth and each CTA's cycles per phase."""
    from extractorb_tpu_torch.frontend import fast
    from extractorb_tpu_torch.frontend.extractor import ORBExtractor, select_keypoints_plain
    from extractorb_tpu_torch.frontend.pyramid import compute_pyramid
    stamps = torch.zeros(32 * 16, dtype=torch.int64, device=dev)
    if new.k17_set_stamps(stamps.data_ptr()):
        raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    rng = np.random.default_rng(5)
    for (W, H), cfg in (((cs.WIDTH, cs.HEIGHT), cs.system_config()),
                        ((cs.KB8_SIZE, cs.KB8_SIZE), cs.kb8_config())):
        ex = ORBExtractor(cfg.orb, (H, W), dev)
        ptab = k17_parent_table(ex)
        frame = cs.pf.render_sequence(cs.pf.procedural_texture(), 1, width=W, height=H)[0][0]
        images = {"rendered": frame, "noise": rng.integers(0, 256, (H, W)).astype(np.uint8),
                  "black": np.zeros((H, W), np.uint8)}
        for name, im in images.items():
            pyr = compute_pyramid(torch.from_numpy(im).to(dev), ex.pyr_plan)
            cand = fast.collect_levels(*fast.fast_detect(pyr, ex.fast_plan), ex.collect_plan)
            plain = select_keypoints_plain(*cand, ex)
            (lp, rp), (ln, rn) = k17_call(parent, cand, ex, ptab), k17_call(new, cand, ex)
            lp()
            stamps.zero_()
            ln()
            torch.cuda.synchronize()
            t = stamps.cpu().numpy().reshape(16, 32)
            eq = lambda r, w: all(torch.equal(a, b) for a, b in zip(r, w))
            print(f"K17 {W}x{H} {name} ({int(plain.valid.sum())} of {plain.valid.numel()} slots, "
                  f"depths {plain.depth.tolist()}): parent bit-equal to plain {eq(rp, plain)}, "
                  f"new {eq(rn, plain)}, new to parent {eq(rn, rp)}", flush=True)
            if name == "black":
                continue
            ms_p, ms_n = cs.paired_ms(lp, ln, reps=100)
            (dp, kp), (dn, kn) = device_ms(lp), device_ms(ln)
            print(f"K17 {W}x{H} {name}: CUDA events a launch in turns parent {ms_p:.4f} ms, new "
                  f"{ms_n:.4f} ms; device ms (profiler) parent {dp:.4f} ({kp} kernels), new "
                  f"{dn:.4f} ({kn}); in a graph of 20 launches parent {graph_ms(lp):.4f}, new "
                  f"{graph_ms(ln):.4f}", flush=True)
            for lvl in range(ex.select_plan.n_levels):
                row = t[lvl]
                print(f"  new CTA {lvl} (K {ex.levels[lvl][0]}) cycles "
                      f"{int(row[:len(K17_PHASES)].sum())}: " + ", ".join(
                          f"{k} {int(row[i])}" for i, k in enumerate(K17_PHASES)), flush=True)


def k8_anatomy(dev) -> None:
    """K8's map update of 256 rows (200 in range) into a 32768-row mirror."""
    rng = np.random.default_rng(2)
    cap, b = cs.track_device.MapMirror.LADDER[0], 256
    rows = np.concatenate([rng.choice(cap, 200, replace=False), np.full(56, cap)]).astype(np.int32)
    new_pos = rng.normal(size=(b, 3)).astype(np.float32)
    new_valid = rng.random(b) < 0.5
    td = cs.track_device
    mir = td.MapMirror(dev)
    mir.pos = torch.from_numpy(rng.normal(size=(cap, 3)).astype(np.float32)).to(dev)
    mir.valid = torch.from_numpy(rng.random(cap) < 0.5).to(dev)
    mir.cap = cap
    rec = torch.empty(td.record_offsets(b)[2], dtype=torch.uint8, pin_memory=True)
    for a, v in zip(td.record_views(rec.numpy(), b), (rows, new_pos, new_valid)):
        a[:] = v
    o_pos, o_val, n = td.record_offsets(b)
    stage = torch.empty(n, dtype=torch.uint8, device=dev)
    views = (stage[:4 * b].view(torch.int32), stage[o_pos:o_pos + 12 * b].view(torch.float32)
             .view(b, 3), stage[o_val:o_val + b].view(torch.bool))

    def copied():   # one cudaMemcpyAsync of the record, then the kernel on its copy
        stage.copy_(rec, non_blocking=True)
        td.mirror_scatter(mir.pos, mir.valid, *views)

    def index_put(r, p_, v):   # the in-range rows, as index_put_ rejects the others
        keep = r < cap
        mir.pos.index_put_((r[keep].long(),), p_[keep])
        mir.valid.index_put_((r[keep].long(),), v[keep])

    on_card = [torch.from_numpy(a).to(dev) for a in (rows, new_pos, new_valid)]
    keep = on_card[0] < cap
    kr, kp, kv = on_card[0][keep].long(), on_card[1][keep], on_card[2][keep]
    runs = {
        "record read in place (MapMirror.sync's upload)":
            lambda: td.mirror_scatter_record(mir.pos, mir.valid, rec, b),
        "record copied, then the kernel": copied,
        "upload_rows (pack + record scatter)": lambda: mir.upload_rows(rows, new_pos, new_valid),
        "three .to(device) copies + index_put_ x2": lambda: index_put(
            *(torch.from_numpy(a).to(dev) for a in (rows, new_pos, new_valid))),
        "mirror_scatter, device inputs": lambda: td.mirror_scatter(mir.pos, mir.valid, *on_card),
        "index_put_ x2, device inputs (in-range rows)": lambda: (
            mir.pos.index_put_((kr,), kp), mir.valid.index_put_((kr,), kv)),
    }
    for rep in range(2):
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"K8 (round {rep}) {name}: {cs.cuda_ms(fn, reps=50):.4f} ms, "
                  f"{host_us:.1f} us of host time to enqueue", flush=True)


def problems(dev):
    """(name, problem, camera, bf) of the systems this script solves."""
    K = cs.pf.camera_matrix(cs.WIDTH, cs.HEIGHT)
    cam = cs.track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    bf = float(K[0, 0]) * cs.STEREO_BASELINE
    out = [(f"[ba-stereo] {tag}", p, c, b) for tag, p, c, b, sv in cs.ba_stereo_cases(dev)
           if tag in ("schur_dense stereo Kp32", "schur_dense stereo Kp64")]
    for size, (n_kf, n_pts, Kp, Pp, Op) in (("Kp64", (12, 1000, 64, 2048, 16384)),
                                            ("K256", (24, 500, 256, 512, 12288))):
        for fixed_point in (False, True):
            p = cs.ba_problem(np.random.default_rng(1), dev, n_kf=n_kf, n_pts=n_pts, Kp=Kp,
                              Pp=Pp, Op=Op, stereo_bf=bf)
            if fixed_point:
                p = p._replace(fixed_mp=p.fixed_mp.index_fill(0, torch.arange(5, device=dev),
                                                              True))
            out.append((f"test {size}{' fixed-point' if fixed_point else ''}", p, cam, bf))
    return out


def place_query(dev) -> None:
    """K29's query at [parity-mesh]'s largest size, timed four ways."""
    from torch.profiler import ProfilerActivity, profile
    mesh = dmesh.Mesh([dev] * cs.MESH_SHARDS)
    h, w, v, q = cs.place_problem(np.random.default_rng(15), cs.PLACE_K, cs.PLACE_W,
                                  cs.PLACE_NNZ)
    blocks = [kfb.shard_kf_axis(mesh, kfb.pad_to_mesh(a, mesh.size)) for a in (h, w, v)]
    qt = torch.from_numpy(q)
    qd = qt.to(dev)
    query = lambda qq: kfb.sharded_place_scores(mesh, *blocks, qq)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            query(qd)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "place_dense_kernel" in e.key]
    n_ev = sum(e.count for e in ev)
    device = (sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                  for e in ev) / 1e3 / n_ev if n_ev else None)
    query(qd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        query(qd)
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    hd, wd = torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev).float()
    print(f"K29 {cs.PLACE_K} x {cs.PLACE_W} on {mesh.size} shards, one launch a query: "
          f"{cs.cuda_ms(lambda: query(qt)):.4f} ms with q's host copy, "
          f"{cs.cuda_ms(lambda: query(qd)):.4f} with q on the card; the kernel {device} device ms "
          f"({n_ev} of 20 launches traced); {host_us:.1f} us of host time to enqueue a query; "
          f"q's host copy {cs.cuda_ms(lambda: qt.to(dev)):.4f} ms; torch.cdist + a matvec "
          f"{cs.cuda_ms(lambda: (torch.cdist(hd, qd[None], p=1), wd @ (qd > 0).float())):.4f} ms",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_anatomy.py needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    kernels.lib()
    parts = set(sys.argv[1].split(",")) if len(sys.argv) > 1 else {
        "k3", "k17", "k22", "k16", "k20", "k4", "k6", "k8", "k29", "k35"}
    if parts == {"k3-record"}:   # the child process of k3_anatomy
        k3_sites(dev)
        return 0
    if parts & {"k3", "k17"}:
        k3_parent, k3_new, k17_parent, k17_new = build_k3_k17()
        if "k3" in parts:
            k3_anatomy(dev, k3_parent, k3_new)
        if "k17" in parts:
            k17_anatomy(dev, k17_parent, k17_new)
    if parts & {"k22", "k16"}:
        k22_parent, k22_new, k16_parent, k16_new, k16_1024 = build_k22_k16()
        if "k16" in parts:
            k16_anatomy(dev, k16_parent, k16_new, k16_1024)
        if "k22" in parts:
            k22_anatomy(dev, k22_parent, k22_new)
    if parts & {"k20", "k4"}:
        k20_parent, k20_clusters, k4_parent, k4_new = build_k20_k4()
        if "k4" in parts:
            k4_anatomy(dev, k4_parent, k4_new)
        if "k20" in parts:
            k20_anatomy(dev, k20_parent, k20_clusters)
    if "k6" in parts:
        k6_anatomy(dev)
    if "k8" in parts:
        k8_anatomy(dev)
    if "k29" in parts:
        place_query(dev)
    if "k35" not in parts:
        return 0
    lib = build_solve()
    stamps = torch.zeros(1024, dtype=torch.int64, device=dev)
    if lib.k35_set_stamps(stamps.data_ptr()):
        raise RuntimeError("chip_anatomy: cudaMemcpyToSymbol failed")
    cases = problems(dev)
    for name, p, cam, bf in cases:
        S, b = cs.dense_system(p, cam, bf)
        S, b = (0.5 * (S + S.T)).float().contiguous(), b.float().contiguous()
        Kp, nt = p.R.shape[0], S.shape[0] // 32
        ev = torch.linalg.eigvalsh(S.double())
        x64 = torch.linalg.solve(S.double(), b.double())
        rel = lambda x: float((x.double() - x64).abs().max() / x64.abs().max())
        ws = torch.empty(int(lib.k35_ws(Kp)), dtype=torch.uint8, device=dev)
        x = torch.empty(S.shape[0], dtype=torch.float32, device=dev)
        call = lambda: lib.k35_solve(S.data_ptr(), b.data_ptr(), p.fixed_kf.data_ptr(), Kp,
                                     x.data_ptr(), ws.data_ptr(), kernels.stream())
        if call():
            raise RuntimeError(f"chip_anatomy: the solve did not launch ({name})")
        torch.cuda.synchronize()
        t = stamps.cpu().numpy()
        k35_err, k35_ms = rel(x), cs.cuda_ms(call, reps=10)
        lu_err = rel(torch.linalg.solve(S, b))
        lu_ms = cs.cuda_ms(lambda: torch.linalg.solve(S, b), reps=10)
        print(f"{name}: n={S.shape[0]}, cond {float(ev.max() / ev.min()):.3e}; error against "
              f"float64: K35 {k35_err:.3e} ({k35_ms:.4f} ms, S and b copied in), LU "
              f"{lu_err:.3e} ({lu_ms:.4f} ms)", flush=True)
        prev, rows = t[1], []
        for q in range(nt):
            s = t[8 + 8 * q: 13 + 8 * q]
            rows.append((s[0] - prev, s[1] - s[0], s[2] - s[1], s[3] - s[2], s[4] - s[3]))
            prev = s[4]
        rows = np.mean(rows, 0)
        print(f"  CTA 0 cycles: all {t[4] - t[0]}, prologue {t[1] - t[0]}, backward "
              f"{t[4] - t[3]}; a panel (mean of {nt}): write-back {rows[0]:.0f}, copy "
              f"{rows[1]:.0f}, triangular solves {rows[2]:.0f}, trailing update {rows[3]:.0f}, "
              f"barrier wait {rows[4]:.0f}", flush=True)
    for name, p, cam, bf in cases:
        if not name.startswith("test"):
            continue
        p64 = ba.BAProblem(*[None if a is None else (a.double() if a.is_floating_point() else a)
                             for a in p])
        dd = lambda a, b: max(float((a.R.double() - b.R.double()).abs().max()),
                              float((a.t.double() - b.t.double()).abs().max()))
        for iters in (1, 2, 10):
            rk = ba.optimize(p, cam, iters, bf=bf, solver="schur_dense")
            rp = ba.optimize_plain(p, cam, iters, bf=bf, solver="schur_dense")
            r64 = ba.optimize_plain(p64, cam, iters, bf=bf, solver="schur_dense")
            print(f"{name}, {iters} LM: poses K35 - plain {dd(rk, rp):.3e}, K35 - float64 plain "
                  f"{dd(rk, r64):.3e}, plain - float64 plain {dd(rp, r64):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
