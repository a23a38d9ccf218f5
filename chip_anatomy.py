"""Where the time of K29's query, K35's dense solve, K6's cluster solve and K8's
map update goes, on the card.

    python3 chip_anatomy.py

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
from extractorb_tpu_torch.solver import ba

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
    k6_anatomy(dev)
    k8_anatomy(dev)
    place_query(dev)
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
