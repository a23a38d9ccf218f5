"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All kernels are compiled into one shared library with a plain C
interface, loaded with ``ctypes``: one ``nvcc -c`` per source, run in
parallel, then one link.  The library is built
at first use into ``build/kernels/`` beside the package (listed in
``.gitignore``) and rebuilt when a source file or the flags change: its
file name carries a hash of both.  Nothing here runs at import time, so
the package imports on machines without ``nvcc`` or a card.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.  ``LAUNCHES``
counts kernel launches per wrapper: each wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# No --use_fast_math, and no contraction of a*b+c into FMAs: K2, K5, K7, K9,
# K10, K12, K17, K18, K24, K25's scoring, K26, K27 and K28 must round like their plain
# PyTorch versions (K1, K3, K8, K11, K15, K16 and K34 are integer code or copies; K4,
# K6, K13, K14, K19-K23, K30-K33, K35 and K36 are bound by latency and K29 by bytes, not
# float throughput).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()
# replays of captured CUDA graphs, per graph ("track_step": the tracking step)
GRAPH_LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of each C entry point; every launch entry point ends with the stream
_SIGNATURES = {
    # pyr, score, keep, tab(host ptr), n_blocks, smem_bytes, stream
    "fast_detect_launch": (_P, _P, _P, _P, _I, _I, _P),
    # pyr, xy, level, valid, K, pattern, umax, tab(host ptr), angle, desc, stream
    "orb_describe_launch": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    # q_word, c_word (null: box gate), q_desc, q_u, q_v, q_r, q_lo, q_hi, q_ok, M,
    # c_desc, c_x, c_y, c_oct, c_ok, N, best, second, best_idx, second_idx, stream
    "hamming_best2_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P),
    # R0, t0, pts, obs, obs_ur (null: mono), isig, valid, B, N, fx, fy, cx, cy,
    # kb8 (host float32 k1..k4; null: pinhole), bf, n_rounds, n_iters, R, t, inliers,
    # n_inliers, stream
    "pose_lm_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _F,
                       _I, _I, _P, _P, _P, _P, _P),
    # xn1, xn2, x1, x2, valid, sets, mats, S, N, fx, fy, cx, cy, ws,
    # success, R21, t21, points, tri, used_h, stream
    "two_view_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P,
                        _P, _P, _P, _P, _P, _P, _P),
    # R, t, pts, obs_kf, obs_mp, obs_uv, isig, valid, fixed_kf, fixed_mp, obs_ur (null:
    # mono), bf, K, P, O, fx, fy, cx, cy, kb8 (host float32 k1..k4; null: pinhole),
    # n_iters, cg_iters, use_huber, chi2_th, ws, dense_ws (null: PCG; else K35),
    # inliers, cost, stream
    "ba_pcg_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                      _F, _F, _F, _F, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P),
    # desc1, xy1, oct1, free1, N1, desc2, xy2, oct2, free2, N2, B, F12, sigma2,
    # n_lvl, geom_f, geom_b, fx, fy, cx, cy, factor, ws, m12, X, ok, stream
    "tri_search_launch": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                          _I, _P, _P, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P),
    # ptrs (host array), counts (host array), kinds (host array), n, out, stream
    "pack_i32_launch": (_P, _P, _P, _I, _P, _P),
    # xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r, flat_l, flat_r,
    # NL, NR, tab(host ptr), sc(host ptr), n_lvl, bf, max_d, th_orb,
    # u_right, depth, valid, sad, stream
    "stereo_match_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                            _F, _F, _I, _P, _P, _P, _P, _P),
    # pos, valid, cap, rows, new_pos, new_valid, b, stream
    "mirror_scatter_launch": (_P, _P, _I, _P, _P, _P, _I, _P),
    # pos, valid, cap, record (page-locked host: rows, new_pos, new_valid), b, stream
    "mirror_scatter_record_launch": (_P, _P, _I, _P, _I, _P),
    # p3d, xy, valid, sets, N, H, solver, th, min_inliers, Rs, ts, counts,
    # R, t, inliers, n_inliers, ok, stream
    "pnp_ransac_launch": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P),
    # p3d, bear, valid, sets, N, H, cos_th, min_inliers, Rs, ts, counts,
    # R, t, inliers, n_inliers, ok, stream
    "mlpnp_ransac_launch": (_P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P),
    # R0, t0, p3d, bear, info, valid, N, n_iters, R, t, stream
    "mlpnp_refine_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    # q, N, desc, ids, meta, k, L, out, stream
    "vocab_words_launch": (_P, _I, _P, _P, _P, _I, _I, _P, _P),
    # p1, p2, uv1, uv2, valid, sets, N, H, fix_scale, th2, fx, fy, cx, cy,
    # kb8 (host float32 k1..k4; null: pinhole), hyp, counts, out, inl, n_inl, ok, stream
    "sim3_ransac_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P,
                           _P, _P, _P, _P, _P, _P, _P),
    # state, p1, p2, obs1, obs2, valid, N, fix_scale, th2, fx, fy, cx, cy,
    # kb8 (host float32 k1..k4; null: pinhole), out, inl, n_in, stream
    "sim3_optimize_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P,
                             _P, _P, _P, _P),
    # R, t, s, ei, ej, mR, mt, ms, w, fixed, K, E, n_iters, cg_iters, fix_scale,
    # ws, cost, stream
    "pose_graph_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P, _P, _P),
    # n, devs (host int32 per shard), tab (host int64 (n, 13): R, t, s, ei, ej, mR, mt, ms,
    # w, fixed, ws, cost, stream), K, Es, n_iters, cg_iters, fix_scale, gather
    "pose_graph_sharded_launch": (_I, _P, _P, _I, _I, _I, _I, _I, _P),
    # R, t, ei, ej, mR, mt, w, fixed, K, E, n_iters, cg_iters, ws, cost, stream
    "pose_graph_4dof_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # R, t, pts, obs_kf, obs_mp, obs_uv, isig, valid, fixed_kf, fixed_mp, K, P, O,
    # fx, fy, cx, cy, kb8 (host float32 k1..k4; null: pinhole), n_iters, cg_iters,
    # use_huber, chi2_th, ws, inliers, cost, stream
    "ba_schur_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _F, _F, _F, _F, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    # n, devs (host int32 per shard), tab (host int64 (n, 13): R, t, pts, obs_kf, obs_mp,
    # obs_uv, isig, valid, fixed_kf, fixed_mp, ws, inliers, stream), K, Ps, Os, fx, fy, cx,
    # cy, kb8 (host float32 k1..k4; null: pinhole), n_iters, cg_iters, use_huber, chi2_th,
    # gather, cost
    "ba_schur_sharded_launch": (_I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _I, _I, _I, _F,
                                _P, _P),
    # n, devs (host int32 per shard), tab (host int64 (n, 13): R, t, pts, obs_kf, obs_mp,
    # obs_uv, isig, valid, fixed_kf, fixed_mp, ws, inliers, stream), K, P, Os, fx, fy, cx,
    # cy, kb8 (host float32 k1..k4; null: pinhole), n_iters, cg_iters, use_huber, chi2_th,
    # gather, cost
    "ba_pcg_sharded_launch": (_I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _I, _I, _I, _F,
                              _P, _P),
    # n, tab (host int64 (n, 4): hists, has, valid, rows), W, q, scores, common, stream
    "place_dense_launch": (_I, _P, _I, _P, _P, _P, _P),
    # kf_desc, kf_valid, q_desc, q_valid, Ks, N, Nq, th_low, ws, counts, stream
    "kf_match_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # img, flat, tables, tab(host ptr), stream
    "pyramid_launch": (_P, _P, _P, _P, _P),
    # keep, score, tab(host ptr), xy, resp, valid, stream
    "kp_collect_launch": (_P, _P, _P, _P, _P, _P, _P),
    # cand xy, resp, valid, tables, tab(host ptr), level xy, resp, valid, depth, ws,
    # xy, octave, valid, xy_f, response, size, stream
    "octree_select_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P),
    # best, best_idx, accept, M, N, by_distance, angle1, angle2 (null: no
    # rotation filter), out, stream
    "match_epilogue_launch": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # gyro, acc, dts, valid, bias, B, T, ng2, na2, wg2, wa2, out, stream
    "preint_launch": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P),
    # states, pts, chain, obs_kf, obs_mp, obs_uv, isig, valid, chain_valid, fixed_kf,
    # fixed_mp, ext, K, P, O, fx, fy, cx, cy, kb8 (host float32 k1..k4; null: pinhole),
    # prior_g, prior_a, n_iters, cg_iters, use_huber, chi2_th, ws, inliers, cost, stream
    "vi_ba_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _F, _F, _F, _F, _P, _F, _F, _I, _I, _I, _F, _P, _P, _P, _P),
    # n, devs (host int32 per shard), tab (host int64 (n, 15): states, pts, chain, obs_kf,
    # obs_mp, obs_uv, isig, valid, chain_valid, fixed_kf, fixed_mp, ext, ws, inliers,
    # stream), K, Ps, Os, fx, fy, cx, cy, kb8 (host float32 k1..k4; null: pinhole),
    # prior_g, prior_a, n_iters, cg_iters, use_huber, chi2_th, gather, cost
    "vi_ba_sharded_launch": (_I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _F, _F, _I, _I, _I,
                             _F, _P, _P),
    # Rwb, twb, chain, valid, v0, bias0, Rwg_seed, K, prior_g, prior_a, fix_scale,
    # n_iters, ws, out, stream
    "inertial_init_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _I, _P, _P, _P),
    # state, pts, uv, isig, valid, N, fx, fy, cx, cy, kb8 (host float32 k1..k4; null:
    # pinhole), joint, n_rounds, n_iters, out, inliers, n_inliers, stream
    "pose_inertial_launch": (_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _P, _I, _I, _I, _P, _P,
                             _P, _P),
    # desc_l, lap_l, NL, desc_r, lap_r, NR, th_orb, ratio, best_idx, best, second, cand, stream
    "stereo_fisheye_match_launch": (_P, _P, _I, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P),
    # uv_l, uv_r, idx, cand, oct_l, oct_r, N, prm (host float32), n_lvl, p3d, depth, valid,
    # right_idx, stream
    "fisheye_triangulate_launch": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P),
    # uv, n, prm (host float32: fx, fy, cx, cy, 1/fx, 1/fy, k1, k2, k3, p1, p2), out, stream
    "undistort_launch": (_P, _I, _P, _P, _P),
    # img, H, W, tiles, clip limit, LUT scale, 1/th, 1/tw, lut, out, stream
    "clahe_launch": (_P, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P),
    # xy, bounds, valid, n, rows, cols, strict, cell, ok, stream
    "grid_pos_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # xy, bounds, valid, n, rows, cols, cap, grid, counts, stream
    "grid_assign_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # xy, octave, valid, n, x, y, r, min_level, max_level, out, stream
    "grid_area_launch": (_P, _P, _P, _I, _F, _F, _F, _I, _I, _P, _P),
    # a kept cudaGraph_t, out: all nodes; returns its kernel nodes
    "graph_kernel_nodes": (_P, _P),
    # H, n, mode (0 condition, 1 marginalize, 2 sparsify), s1, e1, s2, e2, ws, out, stream
    "marginal_launch": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # workspace sizes in bytes
    "two_view_workspace_bytes": (_I, _I),
    "ba_workspace_bytes": (_I, _I, _I, _I, _I),
    "ba_schur_dense_workspace_bytes": (_I, _I, _I),
    "pose_graph_workspace_bytes": (_I, _I, _I),
    "pose_graph_4dof_workspace_bytes": (_I, _I),
    "ba_schur_workspace_bytes": (_I, _I, _I, _I),
    "ba_schur_gather_bytes": (_I, _I),
    "pose_graph_gather_bytes": (_I, _I),
    "vi_ba_workspace_bytes": (_I, _I, _I, _I),
    "vi_ba_gather_bytes": (_I, _I),
    "ba_pcg_gather_bytes": (_I, _I, _I),
    "kf_match_workspace_bytes": (_I, _I, _I),
    "inertial_init_workspace_bytes": (_I,),
    "marginal_workspace_bytes": (_I,),
}
# return types other than the launch status (an int cudaError_t)
_RESTYPES = {"two_view_workspace_bytes": _L, "ba_workspace_bytes": _L,
             "ba_schur_dense_workspace_bytes": _L,
             "pose_graph_workspace_bytes": _L, "pose_graph_4dof_workspace_bytes": _L,
             "ba_schur_workspace_bytes": _L, "ba_schur_gather_bytes": _L,
             "pose_graph_gather_bytes": _L,
             "vi_ba_workspace_bytes": _L, "inertial_init_workspace_bytes": _L,
             "vi_ba_gather_bytes": _L, "ba_pcg_gather_bytes": _L,
             "kf_match_workspace_bytes": _L, "marginal_workspace_bytes": _L}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libextractorb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is up to date:
    one ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *[str(o) for _, o, _ in procs]],
                          capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
    return _lib


_entries: dict = {}


def entry(name: str):
    """The library's C entry point ``name`` (the library built and loaded on
    first use), fetched once: a wrapper whose host time counts calls this."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(lib(), name)
    return fn


def resolve_device(device, what: str) -> torch.device:
    """``device``, or with None the card (cuda:0): the port's entry points
    run on the card unless the caller asks for the CPU.  Raises without a
    card rather than falling back to the plain path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device: {what} runs on a card; pass device='cpu' to "
                               "run the plain path")
        device = "cuda:0"
    return torch.device(device)


def stream(index: Optional[int] = None) -> int:
    """The handle of the current CUDA stream of device ``index`` (None: the
    current device), the one PyTorch enqueues on."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


@contextlib.contextmanager
def ordered_plain(on_card: bool):
    """Run a plain version on the card in PyTorch's deterministic mode, so
    its ``index_add_`` sums in one order and the plain solve, like the
    kernel it is held to, gives one result per input (K6, K20).  Ops
    without a deterministic CUDA implementation (cuBLAS) only warn, and the
    warnings are dropped.  A no-op for CPU tensors."""
    if not on_card:
        yield
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
