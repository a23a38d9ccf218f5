"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels (K1-K14) from
``extractorb_tpu_torch/csrc``, checks each against its plain PyTorch
version at the shapes of the main paths, drives the monocular tracking
step (``TrackStep``) over a rendered 640x480 sequence with 1000 ORB
features, runs ``System.track_monocular`` from a cold map (two-view init,
local mapping, window BA) over a rendered 30-frame sequence, then
``System.track_stereo`` and ``System.track_rgbd`` over the same frames
seen by a rectified rig and by the renderer's depth, and checks each
against the scene's truth and the CPU plain path.  Then tracking recovery:
[reloc] and [reloc-stereo] black out frames 14-15 (LOST, relocalization
through K10), [recovery] frames 14-21 (a new Atlas map and a second
initialisation), and [resume] loads a session the CPU plain path saved
after frame 15 onto the card and tracks the rest.  Then loop closing:
K11-K14 and K3's word gate against their plain versions, [loop] corrects
a constructed out-and-back map through ``LoopCloser.process_keyframe``,
[merge] welds two Atlas maps from pixels (``System(cfg, vocab)``), and
[system-vocab] repeats [system] with a vocabulary.  Any failure raises:
the script then exits non-zero and never prints its last line.  It needs
a CUDA card and nothing outside the repository (the scenes are generated
from a seed).

Output: one line per phase, the card's name and power limit, a JSON line
``{"kernels": [...]}`` with each kernel's launches on the main paths, its
largest deviation from the plain version, its time, the plain version's,
its bound and a library call's time where one computes the same function,
then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import port_fixtures as pf  # noqa: E402
from extractorb_tpu_torch import interop, kernels  # noqa: E402
from extractorb_tpu_torch.config import (CameraConfig, ORBConfig, SLAMConfig,  # noqa: E402
                                         TrackingConfig)
from extractorb_tpu_torch.frontend import brief, fast, matcher, stereo  # noqa: E402
from extractorb_tpu_torch.frontend.extractor import ORBExtractor  # noqa: E402
from extractorb_tpu_torch.frontend.pyramid import compute_pyramid  # noqa: E402
from extractorb_tpu_torch.geometry import two_view  # noqa: E402
from extractorb_tpu_torch.core.camera import Pinhole  # noqa: E402
from extractorb_tpu_torch.dist import global_ba, sharded_ba  # noqa: E402
from extractorb_tpu_torch.geometry import sim3 as gsim3  # noqa: E402
from extractorb_tpu_torch.place import vocab as vocab_mod  # noqa: E402
from extractorb_tpu_torch.slam import checkpoint, local_mapping, loop_closing, track_device  # noqa: E402,E501
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap  # noqa: E402
from extractorb_tpu_torch.slam.system import System  # noqa: E402
from extractorb_tpu_torch.slam.track_device import TrackStep  # noqa: E402
from extractorb_tpu_torch.slam.tracking import TrackState  # noqa: E402
from extractorb_tpu_torch.solver import ba, pnp, pose_graph, pose_opt  # noqa: E402
from extractorb_tpu_torch.utils import packed_fetch  # noqa: E402

WIDTH, HEIGHT = 640, 480
N_FEATURES = 1000
MAP_CAP = 32768      # MapMirror.LADDER[0] of the JAX package
LOCAL_CAP = 4096     # the tracker's local-block capacity
N_FRAMES = 13
SPEED = 0.06
# K1 and K2 run once per extraction (frame 0 and every step), K3 five
# times and K4 twice per step
PER_STEP = {"fast_detect": 1, "orb_describe": 1, "hamming_best2": 5, "pose_lm": 2}
KERNELS = {
    "fast_detect": ("extractorb_tpu_torch/csrc/fast_detect.cu",
                    "extractorb_tpu/frontend/fast.py:87"),
    "orb_describe": ("extractorb_tpu_torch/csrc/orb_describe.cu",
                     "extractorb_tpu/frontend/brief.py:37"),
    "hamming_best2": ("extractorb_tpu_torch/csrc/hamming_best2.cu",
                      "extractorb_tpu/frontend/matcher.py:44"),
    "pose_lm": ("extractorb_tpu_torch/csrc/pose_lm.cu",
                "extractorb_tpu/solver/pose_opt.py:77"),
    "two_view": ("extractorb_tpu_torch/csrc/two_view.cu",
                 "extractorb_tpu/geometry/two_view.py:316"),
    "ba_pcg": ("extractorb_tpu_torch/csrc/ba_pcg.cu", "extractorb_tpu/solver/ba.py:144"),
    "tri_search": ("extractorb_tpu_torch/csrc/tri_search.cu",
                   "extractorb_tpu/slam/local_mapping.py:204"),
    "mirror_scatter": ("extractorb_tpu_torch/csrc/map_io.cu",
                       "extractorb_tpu/slam/track_device.py:450"),
    "pack_i32": ("extractorb_tpu_torch/csrc/map_io.cu",
                 "extractorb_tpu/utils/packed_fetch.py:37"),
    "stereo_match": ("extractorb_tpu_torch/csrc/stereo_match.cu",
                     "extractorb_tpu/frontend/stereo.py:35"),
    "pnp_ransac": ("extractorb_tpu_torch/csrc/pnp_ransac.cu",
                   "extractorb_tpu/solver/pnp.py:154"),
}
# the tracking paths' kernels (K1-K10); the loop-closing path adds these
VISUAL_KERNELS = tuple(KERNELS)
KERNELS.update({
    "vocab_words": ("extractorb_tpu_torch/csrc/vocab_words.cu",
                    "extractorb_tpu/place/vocab.py:144"),
    "hamming_best2_words": ("extractorb_tpu_torch/csrc/hamming_best2.cu",
                            "extractorb_tpu/frontend/matcher.py:353"),
    "sim3_ransac": ("extractorb_tpu_torch/csrc/sim3.cu", "extractorb_tpu/geometry/sim3.py:175"),
    "sim3_optimize": ("extractorb_tpu_torch/csrc/sim3.cu", "extractorb_tpu/geometry/sim3.py:74"),
    "pose_graph": ("extractorb_tpu_torch/csrc/pose_graph.cu",
                   "extractorb_tpu/solver/pose_graph.py:197"),
    "ba_schur": ("extractorb_tpu_torch/csrc/ba_schur.cu", "extractorb_tpu/dist/sharded_ba.py:258"),
})
# the [system] run: the rendered sequence of tests/test_slam_e2e.py's
# planar test at 640x480 / 1000 features, 30 frames at speed 0.04
SYS_FRAMES = 30
SYS_SPEED = 0.04
SYS_FEATURES = 1000
# the [stereo] and [rgbd] runs: the rig of tests/test_slam_stereo_rgbd.py,
# a 0.1 m baseline (bf = 50 at f = 500) and ThDepth 40 (thDepth 4 m: the
# 3 m poster is close, the 5 m wall far)
STEREO_BASELINE = 0.1
STEREO_TH_DEPTH = 40.0
# the recovery runs: [system]'s frames with these black; [resume] saves the
# CPU plain path's session after frames 0..RESUME_AT-1
RELOC_BLACK = (14, 15)
RECOVERY_BLACK = tuple(range(14, 22))
RESUME_AT = 16
# the [loop] map (pf.build_looped_map at full width): keyframes out and back
# 0.15 m apart over points whose ~1000 a keyframe sees
LOOP_KFS = 24
LOOP_POINTS = 1400
LOOP_STEP = 0.15
# the [merge] run: tests/test_loop_from_pixels.py's sweep at 640x480
MERGE_FRAMES = 40
MERGE_BLACK = tuple(range(19, 29))
MERGE_MAX_FRAMES = 1
MERGE_MAX_ATE = 0.30   # the JAX test's bound (tests/test_loop_from_pixels.py:142)
# peak rates of one H100 SXM (NVIDIA's data sheet, dense rates): memory
# bytes/s, and float32 operations/s outside the tensor cores, against which
# the bounds also count the kernels' integer ALU work
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_FP64_OPS_PER_S = 34e12   # float64 outside the tensor cores (K10's minimal solves)


def camera_config(width: int, height: int) -> CameraConfig:
    K = pf.camera_matrix(width, height)
    return CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                        cy=float(K[1, 2]), width=width, height=height)


def track_sequence(step: TrackStep, frames, depths, poses, pose_m1, device, timer=None):
    """Seed a map from frame 0 (true depth), then run ``step`` on frames
    1.. chaining each output into the next input as the tracker does at
    pipeline_depth 0: last features, undistorted coords and map-point ids
    from the previous output, the previous pose as R_last/t_last and the
    one before as R_prev/t_prev (frame -1's true pose for frame 1).

    Returns the per-frame outputs as numpy dicts.  ``timer(fn)`` may wrap
    each step call (the chip run times it)."""
    imgs = [torch.from_numpy(f).to(device) for f in frames]
    f0 = interop.to_numpy(step.extractor(imgs[0]))
    kp_mp, map_pos, map_valid, local, ref = pf.seed_map(
        f0["xy"], f0["octave"], f0["valid"], f0["desc"], depths[0], poses[0],
        pf.camera_matrix(frames[0].shape[1], frames[0].shape[0]), step.scale_factors,
        step.map_cap, step.local_cap)
    last = dict(xy_un=f0["xy"], desc=f0["desc"], octave=f0["octave"], angle=f0["angle"])
    args = interop.step_inputs_from_numpy(frames[1], last, kp_mp, map_pos, map_valid, local,
                                          ref, *poses[0], *pose_m1, device)
    outs = []
    for k in range(1, len(frames)):
        args = (imgs[k],) + args[1:]
        out = timer(lambda: step(*args)) if timer else step(*args)
        outs.append(out)
        args = (None, out.xy_un, out.feats.desc, out.feats.octave, out.feats.angle,
                out.kp_mp, *args[6:17], out.R, out.t, args[17], args[18])
    return [interop.to_numpy(o) for o in outs]


def check_sequence(results, poses):
    """Every tracked frame keeps enough inliers and its camera centre
    stays near the truth (thresholds of tests/port_fixtures.py)."""
    for k, r in enumerate(results, start=1):
        err = pf.camera_centre_error(r["R"], r["t"], poses[k])
        n = int(r["n_inl_final"])
        if not (np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()):
            raise AssertionError(f"frame {k}: non-finite pose")
        if n < pf.MIN_INLIERS or err > pf.MAX_CENTER_ERR:
            raise AssertionError(f"frame {k}: n_inl_final {n} (min {pf.MIN_INLIERS}), "
                                 f"centre error {err:.4f} m (max {pf.MAX_CENTER_ERR})")


# ----------------------------------------------------------------- timing


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``reps`` calls, after two warm-up calls."""
    for _ in range(2 if reps > 2 else 1):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def record(err, ms, plain_ms, nbytes, ops, library_ms=None, ops64=0) -> dict:
    """One kernel's parity and timing record with its bound: the larger of
    the bytes it must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate of
    their type (``ops64``: float64 ones)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (ops / PEAK_OPS_PER_S + ops64 / PEAK_FP64_OPS_PER_S) * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations", library_ms=library_ms,
                bytes=int(nbytes), ops=int(ops + ops64))


# ----------------------------------------------------------------- phases


def phase_environment():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)


def phase_build():
    t0 = time.perf_counter()
    kernels.lib()
    print(f"[build] {os.path.relpath(kernels.library_path(), ROOT)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernel_parity(step: TrackStep, frame: np.ndarray, dev) -> dict:
    """Each kernel against its plain version on the same CUDA inputs, at
    the shapes of the main path.  Returns per-kernel (err, ms, plain_ms)."""
    rng = np.random.default_rng(0)
    ex = step.extractor
    stats = {}

    # K1: FAST on the 8-level pyramid of a 640x480 frame; bit-equal
    pyr = compute_pyramid(torch.from_numpy(frame).to(dev), ex.pyr_plan)
    keep_k, score_k = fast.fast_detect(pyr, ex.fast_plan)
    keep_p, score_p = fast.fast_detect_plain(pyr, ex.fast_plan)
    err = max(float((a.int() - b.int()).abs().max()) for a, b in
              zip(keep_k + score_k, keep_p + score_p))
    if err:
        raise AssertionError(f"fast_detect: keep/score differ from the plain version by {err}")
    # work: 16 differences, 16 arcs of 9-wide min and max and the 3x3 NMS,
    # ~320 integer operations per inner pixel; score (int16) + keep out
    n_inner = sum(k.numel() for k in keep_k)
    stats["fast_detect"] = record(err, cuda_ms(lambda: fast.fast_detect(pyr, ex.fast_plan)),
                                  cuda_ms(lambda: fast.fast_detect_plain(pyr, ex.fast_plan)),
                                  pyr.flat.numel() + 3 * n_inner, 320 * n_inner)
    print(f"[parity] fast_detect keep+score bit-equal on {len(keep_k)} levels", flush=True)

    # K2: the frame's keypoints of all levels (before the merge); descriptors
    # bit-equal, angles within 1e-4 deg
    xy, _, valid, level = ex.keypoints(pyr)
    ang_k, desc_k = brief.orb_describe(pyr, ex.desc_plan, xy, level, valid)
    ang_p, desc_p = brief.orb_describe_plain(pyr, ex.desc_plan, xy, level, valid)
    n_bad = int((desc_k != desc_p).any(1).sum())
    d_ang = float((ang_k - ang_p).abs().max())
    if n_bad or d_ang > 1e-4:
        raise AssertionError(f"orb_describe: {n_bad} descriptors differ, angle error {d_ang}")
    # work per keypoint: the moments over the 31-px disc (4 ops x 749 px),
    # the 7x7 blur of the 37x37 centre (2 x 49 ops a pixel), 512 rotated
    # samples (8 ops) and 256 compares; in: pyramid + keypoints, out: angle + desc
    K = xy.shape[0]
    stats["orb_describe"] = record(
        d_ang, cuda_ms(lambda: brief.orb_describe(pyr, ex.desc_plan, xy, level, valid)),
        cuda_ms(lambda: brief.orb_describe_plain(pyr, ex.desc_plan, xy, level, valid)),
        pyr.flat.numel() + K * (8 + 4 + 1) + K * (4 + 32),
        int(valid.sum()) * (4 * 749 + 2 * 49 * 37 * 37 + 8 * 512 + 2 * 256))
    print(f"[parity] orb_describe {int(valid.sum())} keypoints: descriptors bit-equal, "
          f"max angle error {d_ang:.2e} deg", flush=True)

    # K3: the local-map search shape (4096 map points x 1128 keypoints)
    # with windows and level ranges, and the open-gate mutual-match shape
    M, N = LOCAL_CAP, step.capacity
    t = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)
    q = t(rng.integers(0, 256, (M, 32)), torch.uint8)
    c = t(rng.integers(0, 256, (N, 32)), torch.uint8)
    c[: N // 2] = q[: N // 2] ^ t(rng.integers(0, 2, (N // 2, 32)) << rng.integers(0, 8, (N // 2, 32)), torch.uint8)
    lo = t(rng.integers(-1, 7, M), torch.int32)
    gate = matcher.Gate(t(rng.uniform(0, WIDTH, M), torch.float32),
                        t(rng.uniform(0, HEIGHT, M), torch.float32),
                        t(rng.uniform(2.5, 40.0, M), torch.float32), lo, lo + 1,
                        t(rng.uniform(0, WIDTH, N), torch.float32),
                        t(rng.uniform(0, HEIGHT, N), torch.float32),
                        t(rng.integers(0, 8, N), torch.int32))
    row_ok = t(rng.random(M) < 0.9, torch.bool)
    col_ok = t(rng.random(N) < 0.95, torch.bool)
    cases = [(q, row_ok, c, col_ok, gate), (c, col_ok, c.flip(0).contiguous(), col_ok, None)]
    err = 0.0
    for qd, rk, cd, ck, g in cases:
        rk_ = matcher.hamming_best2(qd, rk, cd, ck, g)
        g_ = g if g is not None else matcher.open_gate(qd.shape[0], cd.shape[0], dev)
        rp_ = matcher.hamming_best2_plain(qd, rk, cd, ck, g_)
        for name, a, b in zip(rk_._fields, rk_, rp_):
            err = max(err, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"hamming_best2: {name} differs from the plain version")
    # work: ~10 ops of gate test per pair, XOR + popcount + top-2 insert
    # (~20 ops) per pair inside the gate
    n_gate = int(matcher._gate_mask(gate, row_ok, col_ok).sum())
    stats["hamming_best2"] = record(
        err, cuda_ms(lambda: matcher.hamming_best2(q, row_ok, c, col_ok, gate)),
        cuda_ms(lambda: matcher.hamming_best2_plain(q, row_ok, c, col_ok, gate)),
        M * (32 + 21) + N * (32 + 13) + 4 * M * 4, 10 * M * N + 20 * n_gate)
    print(f"[parity] hamming_best2 ({M}x{N} gated, {N}x{N} open): all outputs bit-equal",
          flush=True)

    # K4: two mono problems of 1128 observations, 20% gross outliers
    B = 2
    R0, t0, pts, obs, isig, val, _ = pf.synthetic_pose_problems(
        rng, B, N, step.cam.fx, step.cam.fy, step.cam.cx, step.cam.cy)
    args = [t(a, torch.float32) for a in (R0, t0, pts, obs, isig)] + [t(val, torch.bool)]
    rk = pose_opt.optimize_pose(*args, step.cam)
    rp = pose_opt.optimize_pose_plain(*args, step.cam)
    d = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
    if d > 1e-4 or not torch.equal(rk.inliers, rp.inliers):
        raise AssertionError(f"pose_lm: pose error {d}, inliers equal "
                             f"{torch.equal(rk.inliers, rp.inliers)}")
    stats["pose_lm"] = record(d, cuda_ms(lambda: pose_opt.optimize_pose(*args, step.cam)),
                              cuda_ms(lambda: pose_opt.optimize_pose_plain(*args, step.cam)),
                              *pose_lm_work(B, N, int(val.sum()), stereo_rows=False))
    print(f"[parity] pose_lm B={B} N={N}: max |dR|,|dt| {d:.2e}, inliers equal", flush=True)
    return stats


def pose_lm_work(B: int, N: int, n_valid: int, stereo_rows: bool):
    """Bytes and operations of B pose problems of N slots: inputs (poses,
    points, pixels, inv_sigma2, valid[, ur]) and outputs once; per valid
    observation and LM iteration (4 x 10) ~200 operations for the residual,
    Jacobian, normal-equation sums and the trial cost (~260 with the
    stereo row)."""
    nbytes = B * (48 + 4 + 48) + B * N * (12 + 8 + 4 + 1 + 1 + (4 if stereo_rows else 0))
    return nbytes, 40 * (260 if stereo_rows else 200) * n_valid


def phase_parity_stereo(left, right, depth0, dev) -> dict:
    """K9 and K4's stereo rows against their plain versions on the same
    CUDA inputs: the features and pyramids of a rendered 640x480 pair
    (1128 keypoint slots a side), and two pose problems built from them."""
    cfg = stereo_config("stereo")
    ext = ORBExtractor(cfg.orb, left.shape, dev)
    fl, pl = ext.extract_with_pyramid(torch.from_numpy(left).to(dev))
    fr, pr = ext.extract_with_pyramid(torch.from_numpy(right).to(dev))
    sf = tuple(float(s) for s in ext.scales)
    bf, b = cfg.camera.bf, cfg.camera.bf / cfg.camera.fx
    args = (fl.xy, fl.octave, fl.desc, fl.valid, fr.xy, fr.octave, fr.desc, fr.valid, pl, pr,
            ext.pyr_plan, sf, bf, b)
    rk = stereo.compute_stereo_matches(*args)
    rp = stereo.compute_stereo_matches_plain(*args)
    v = rp.valid
    same = (torch.equal(rk.valid, rp.valid) and torch.equal(rk.u_right[v], rp.u_right[v])
            and torch.equal(rk.depth[v], rp.depth[v]))
    if not same or int(v.sum()) < 300:
        raise AssertionError(f"stereo_match: valid/u_right/depth equal {same}, "
                             f"{int(v.sum())} matches")
    # work: ~10 ops of gate test per pair, XOR + popcount + min (~20 ops)
    # per pair in the gates, 11 shifts x 121 x 3 ops of SAD per candidate;
    # in: both keypoint sets, and of the pyramids only what a candidate
    # reads (its 11x11 left window and 11x21 right strip); out: u_right,
    # depth, valid
    NL, NR = fl.xy.shape[0], fr.xy.shape[0]
    scales = torch.as_tensor(ext.scales, device=dev)
    mask = stereo.candidate_mask(fl.xy, fl.octave, fl.valid, fr.xy, fr.octave, fr.valid, scales,
                                 torch.tensor(np.float32(bf / b), device=dev))
    best = torch.where(mask, matcher.hamming_matrix(fl.desc, fr.desc), 1 << 20).min(1).values
    n_sad = int((best < stereo.TH_ORB).sum())
    stats = {"stereo_match": record(
        0.0, cuda_ms(lambda: stereo.compute_stereo_matches(*args)),
        cuda_ms(lambda: stereo.compute_stereo_matches_plain(*args)),
        (NL + NR) * (8 + 4 + 32 + 1) + n_sad * (11 * 11 + 11 * 21) + NL * 9,
        10 * NL * NR + 20 * int(mask.sum()) + n_sad * 11 * 121 * 3 + 20 * NL)}
    print(f"[parity] stereo_match {NL}x{NR}: valid, u_right and depth bit-equal "
          f"({int(v.sum())} matches of {n_sad} candidates)", flush=True)

    # K4 with the stereo rows: the pair's keypoints as observations, points
    # from the renderer's depth (frame 0 is the world origin), right u from
    # K9, two perturbed start poses
    H, W = depth0.shape
    K = pf.camera_matrix(W, H)
    xy = fl.xy.cpu().numpy()
    z = depth0[np.clip(np.rint(xy[:, 1]).astype(int), 0, H - 1),
               np.clip(np.rint(xy[:, 0]).astype(int), 0, W - 1)]
    pts = np.stack([(xy[:, 0] - K[0, 2]) * z / K[0, 0], (xy[:, 1] - K[1, 2]) * z / K[1, 1], z], -1)
    isig = (1.0 / np.asarray(sf, np.float32) ** 2)[np.clip(fl.octave.cpu().numpy(), 0, 7)]
    rng = np.random.default_rng(3)
    R0 = np.stack([pf.so3_exp_np(rng.normal(0, 0.01, 3)) for _ in range(2)])
    t0 = rng.normal(0, 0.02, (2, 3))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    pargs = (t(R0), t(t0), t(np.stack([pts, pts])), torch.stack([fl.xy, fl.xy]),
             t(np.stack([isig, isig])), torch.stack([fl.valid, fl.valid]))
    ur = torch.stack([rk.u_right, rk.u_right])
    cam = track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    gk = pose_opt.optimize_pose(*pargs, cam, obs_ur=ur, bf=bf)
    gp = pose_opt.optimize_pose_plain(*pargs, cam, obs_ur=ur, bf=bf)
    d = max(float((gk.R - gp.R).abs().max()), float((gk.t - gp.t).abs().max()))
    if d > 1e-4 or not torch.equal(gk.inliers, gp.inliers):
        raise AssertionError(f"pose_lm stereo: pose error {d:.2e}, inliers equal "
                             f"{torch.equal(gk.inliers, gp.inliers)}")
    stats["pose_lm_stereo"] = record(
        d, cuda_ms(lambda: pose_opt.optimize_pose(*pargs, cam, obs_ur=ur, bf=bf)),
        cuda_ms(lambda: pose_opt.optimize_pose_plain(*pargs, cam, obs_ur=ur, bf=bf)),
        *pose_lm_work(2, NL, 2 * int(fl.valid.sum()), stereo_rows=True))
    print(f"[parity] pose_lm stereo B=2 N={NL} ({int((rk.u_right >= 0).sum())} stereo "
          f"observations): max |dR|,|dt| {d:.2e}, inliers equal", flush=True)
    return stats


def phase_main_path(step: TrackStep, frames, depths, poses, dev):
    times, host_ms = [], []

    def timer(fn):
        # each step ends in a synchronise, as a tracker that reads the
        # pose back does; the host clock spans enqueue and device work
        before = dict(kernels.LAUNCHES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        times.append((a, b))
        rose = {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in PER_STEP}
        if rose != PER_STEP:
            raise AssertionError(f"step {len(times)}: launches rose by {rose}, "
                                 f"expected {PER_STEP}")
        return out

    kernels.LAUNCHES.clear()
    results = track_sequence(step, frames, depths, poses, pf.true_pose(-1, SPEED), dev, timer)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_steps = len(frames) - 1
    for name, per in PER_STEP.items():
        want = per * n_steps + (1 if name in ("fast_detect", "orb_describe") else 0)
        if launches.get(name, 0) != want:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the main path, "
                                 f"expected {want}")
    print(f"[track] launches per step {PER_STEP}; in all {launches}", flush=True)
    check_sequence(results, poses)
    ms = [a.elapsed_time(b) for a, b in times]
    for k, (r, t_ms, h_ms) in enumerate(zip(results, ms, host_ms), start=1):
        print(f"[track] frame {k:2d}: {t_ms:7.2f} ms events {h_ms:7.2f} ms host  "
              f"n_match {int(r['n_match_motion'])} n_inl {int(r['n_inl_final'])}  "
              f"used_ref {bool(r['used_ref'])}  centre error "
              f"{pf.camera_centre_error(r['R'], r['t'], poses[k]):.4f} m", flush=True)
    print(f"[track] step median over frames 2-{n_steps}: {statistics.median(ms[1:]):.2f} ms "
          f"events, {statistics.median(host_ms[1:]):.2f} ms host clock (frame 1 {ms[0]:.2f} / "
          f"{host_ms[0]:.2f} ms)", flush=True)
    return results, launches


def phase_reference(step_gpu: TrackStep, results, frames, depths, poses):
    """The first two steps again through the plain CPU path (which the
    CPU tests hold to the JAX package): poses within 1e-3, >= 98% of the
    map-point ids equal."""
    cpu = TrackStep(step_gpu.cam_cfg, step_gpu.orb_cfg, step_gpu.img_shape,
                    step_gpu.map_cap, step_gpu.local_cap, "cpu")
    ref = track_sequence(cpu, frames[:3], depths[:3], poses[:3], pf.true_pose(-1, SPEED), "cpu")
    for k, (g, c) in enumerate(zip(results, ref), start=1):
        d = max(float(np.abs(g["R"] - c["R"]).max()), float(np.abs(g["t"] - c["t"]).max()))
        agree = float((g["kp_mp"] == c["kp_mp"]).mean())
        if d > 1e-3 or agree < 0.98:
            raise AssertionError(f"frame {k}: card vs CPU pose {d:.2e}, kp_mp agree {agree:.4f}")
        print(f"[reference] frame {k}: card vs CPU plain path |dpose| {d:.2e}, "
              f"kp_mp agree {agree:.4f}", flush=True)



def system_config(width: int = WIDTH, height: int = HEIGHT,
                  n_features: int = SYS_FEATURES) -> SLAMConfig:
    """The mono configuration of the [system] run (tests/test_slam_e2e.py:94-100)."""
    return SLAMConfig(orb=ORBConfig(n_features=n_features),
                      camera=camera_config(width, height),
                      tracking=TrackingConfig(max_frames=6))


def init_pairs(frames, dev, k1: int = 0, k2: int = 2):
    """The two-view input the tracker builds from frames k1 and k2: init
    extractor (5x), search_for_initialization, the first 1024 matches.
    Returns numpy (x1, x2, valid) of 1024 rows."""
    orb = ORBConfig(n_features=5 * SYS_FEATURES)
    ext = ORBExtractor(orb, frames[k1].shape, dev)
    f1, f2 = (ext(torch.from_numpy(frames[k]).to(dev)) for k in (k1, k2))
    m12 = matcher.search_for_initialization(
        f1.desc, f1.xy, f1.angle, f1.octave, f1.valid,
        f2.desc, f2.xy, f2.angle, f2.octave, f2.valid, 100).cpu().numpy()
    xy1, xy2 = f1.xy.cpu().numpy(), f2.xy.cpu().numpy()
    sel = np.where(m12 >= 0)[0][:1024]
    x1, x2, valid = np.zeros((1024, 2), np.float32), np.zeros((1024, 2), np.float32), \
        np.zeros(1024, bool)
    x1[:len(sel)], x2[:len(sel)], valid[:len(sel)] = xy1[sel], xy2[m12[sel]], True
    return x1, x2, valid


def ba_problem(rng, dev, n_kf: int = 6, n_pts: int = 1000, Kp: int = 32, Pp: int = 2048,
               Op: int = 8192) -> ba.BAProblem:
    """A BA problem padded like run_ba's init problem (Kp 32, Pp 2048, Op
    8192): n_kf keyframes (the first two fixed, so no gauge freedom is
    left), points 4-9 m away, pixel noise within +-0.5 px and 5% gross
    outliers (+40 px), so no residual lies near the chi2 threshold."""
    K = pf.camera_matrix(WIDTH, HEIGHT)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4, 9, n_pts)], -1)
    Rs = np.stack([pf.so3_exp_np(rng.normal(0, 0.03, 3)) for _ in range(n_kf)])
    ts = np.stack([np.array([0.25 * k, 0, 0]) + rng.normal(0, 0.02, 3) for k in range(n_kf)])
    obs_kf, obs_mp, obs_uv = [], [], []
    for k in range(n_kf):
        pc = pts @ Rs[k].T + ts[k]
        uv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
        obs_kf.append(np.full(n_pts, k))
        obs_mp.append(np.arange(n_pts))
        obs_uv.append(uv + rng.uniform(-0.5, 0.5, uv.shape))
    obs_kf, obs_mp, obs_uv = (np.concatenate(a) for a in (obs_kf, obs_mp, obs_uv))
    O = len(obs_kf)
    obs_uv[rng.random(O) < 0.05] += 40.0
    R0, t0, p0 = Rs.copy(), ts.copy(), pts + rng.normal(0, 0.03, pts.shape)
    for k in range(2, n_kf):
        R0[k] = Rs[k] @ pf.so3_exp_np(rng.normal(0, 0.01, 3))
        t0[k] = ts[k] + rng.normal(0, 0.01, 3)

    def pad(a, n, fill=0.0):
        out = np.full((n,) + a.shape[1:], fill, np.asarray(a).dtype)
        out[:len(a)] = a
        return out

    Rp = np.tile(np.eye(3), (Kp, 1, 1))
    Rp[:n_kf] = R0
    pp = pad(p0, Pp)
    pp[n_pts:, 2] = 1.0
    fk = np.ones(Kp, bool)
    fk[2:n_kf] = False
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    f, i, b = torch.float32, torch.int32, torch.bool
    isig = pad(1.2 ** (-2.0 * rng.integers(0, 3, O)), Op, 1.0)
    return ba.BAProblem(R=t(Rp, f), t=t(pad(t0, Kp), f), points=t(pp, f),
                        obs_kf=t(pad(obs_kf, Op, 0), i), obs_mp=t(pad(obs_mp, Op, 0), i),
                        obs_uv=t(pad(obs_uv, Op), f), inv_sigma2=t(isig, f),
                        obs_valid=t(pad(np.ones(O, bool), Op, False), b), fixed_kf=t(fk, b),
                        fixed_mp=t(np.arange(Pp) >= n_pts, b))


def tri_inputs(frames, poses, dev, n_features: int = SYS_FEATURES, center: int = 4):
    """The triangulation job of keyframe ``center`` against the 8 frames
    around it (the K7 shape of a keyframe event: B=8 x 1128 x 1128), with
    the true poses.  Returns (args, geometry) for matcher.tri_search."""
    ext = ORBExtractor(ORBConfig(n_features=n_features), frames[0].shape, dev)
    ids = [k for k in range(center - 4, center + 5) if k != center]
    feats = {k: ext(torch.from_numpy(frames[k]).to(dev)) for k in ids + [center]}
    K = pf.camera_matrix(WIDTH, HEIGHT).astype(np.float32)
    sf = track_device.scale_factors(ORBConfig(n_features=n_features))
    inv_sigma2 = [1.0 / float(s * s) for s in sf]
    R1, t1 = (np.asarray(a, np.float32) for a in poses[center])
    F12 = np.stack([local_mapping.fundamental_matrix(K, R1, t1, *(np.asarray(a, np.float32)
                                                                  for a in poses[k]))
                    for k in ids])
    P = lambda R, t: (K @ np.concatenate([np.asarray(R, np.float32),
                                          np.asarray(t, np.float32)[:, None]], 1))
    d = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    centre = lambda R, t: -np.asarray(R).T @ np.asarray(t)
    f1 = feats[center]
    args = (f1.desc, f1.xy, f1.octave, f1.valid,
            torch.stack([feats[k].desc for k in ids]), torch.stack([feats[k].xy for k in ids]),
            torch.stack([feats[k].octave for k in ids]), torch.stack([feats[k].valid for k in ids]),
            d(F12), d([1.0 / s for s in inv_sigma2]))
    geom = matcher.TriGeometry(
        P1=d(P(R1, t1)), P2=d(np.stack([P(*poses[k]) for k in ids])), R1=d(R1), t1=d(t1),
        R2=d(np.stack([poses[k][0] for k in ids])), t2=d(np.stack([poses[k][1] for k in ids])),
        O1=d(centre(R1, t1)), O2=d(np.stack([centre(*poses[k]) for k in ids])),
        K=(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])),
        scale_factors=d(sf), factor=float(np.float32(1.5 * float(sf[1]))))
    return args, geom


def phase_parity_k5_k8(frames, poses, dev) -> dict:
    """K5-K8 against their plain versions on the same CUDA inputs, at the
    shapes of the [system] path.  Returns per-kernel (err, ms, plain_ms)."""
    stats = {}
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)

    # K5: 1024 init pairs of frames 0 and 2; R, t within 1e-4, masks equal
    x1, x2, valid = init_pairs(frames, dev)
    sets = two_view.sample_sets(12345, valid).to(dev)
    args = (sets, t(x1, torch.float32), t(x2, torch.float32), t(valid, torch.bool),
            torch.from_numpy(pf.camera_matrix(WIDTH, HEIGHT).astype(np.float32)))
    rk = two_view.reconstruct(*args)
    rp = two_view.reconstruct_plain(*args[:4], args[4].to(dev))
    d = max(float((rk.R21 - rp.R21).abs().max()), float((rk.t21 - rp.t21).abs().max()))
    same = (bool(rk.success) == bool(rp.success) and bool(rk.used_homography)
            == bool(rp.used_homography) and torch.equal(rk.is_triangulated, rp.is_triangulated))
    if d > 1e-4 or not same or not bool(rk.success):
        raise AssertionError(f"two_view: |dR|,|dt| {d:.2e}, success {bool(rk.success)}/"
                             f"{bool(rp.success)}, masks/flags equal {same}")
    # work: each of S hypotheses x 2 models scores every valid pair (~40
    # ops), a 9x9 Jacobi (~8000 ops) per hypothesis and model, 8 motions
    # triangulated and checked per pair (~100 ops)
    S, Np, nv = sets.shape[0], x1.shape[0], int(valid.sum())
    stats["two_view"] = record(
        d, cuda_ms(lambda: two_view.reconstruct(*args), reps=10),
        cuda_ms(lambda: two_view.reconstruct_plain(*args[:4], args[4].to(dev)), reps=3),
        Np * (16 + 1) + S * 8 * 4 + 48 + Np * 13 + 4,
        2 * S * nv * 40 + 2 * S * 8000 + 8 * nv * 100)
    print(f"[parity] two_view {int(valid.sum())} pairs: success, homography flag and "
          f"triangulated mask equal ({int(rk.is_triangulated.sum())} points), "
          f"max |dR|,|dt| {d:.2e}", flush=True)

    # K6: a padded init-shaped problem, 12 LM x 40 PCG; within 1e-4, inliers equal
    prob = ba_problem(np.random.default_rng(1), dev)
    K = pf.camera_matrix(WIDTH, HEIGHT)
    cam = track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    bk = ba.optimize(prob, cam, n_iters=12, cg_iters=40)
    bp = ba.optimize_plain(prob, cam, n_iters=12, cg_iters=40)
    d = max(float((bk.R - bp.R).abs().max()), float((bk.t - bp.t).abs().max()),
            float((bk.points - bp.points).abs().max()))
    if d > 1e-4 or not torch.equal(bk.inliers, bp.inliers):
        raise AssertionError(f"ba_pcg: max deviation {d:.2e}, inliers equal "
                             f"{torch.equal(bk.inliers, bp.inliers)}")
    # work per LM iteration (12) and valid observation: ~150 ops of
    # residual and Jacobians, ~80 ops per PCG iteration (40)
    Ob, Pb, Kb = prob.obs_kf.shape[0], prob.points.shape[0], prob.R.shape[0]
    stats["ba_pcg"] = record(
        d, cuda_ms(lambda: ba.optimize(prob, cam, 12, 40), reps=5),
        cuda_ms(lambda: ba.optimize_plain(prob, cam, 12, 40), reps=2),
        Ob * (4 + 4 + 8 + 4 + 1) + Pb * (12 + 1) + Kb * (48 + 1) + Kb * 48 + Pb * 12 + Ob + 4,
        12 * int(prob.obs_valid.sum()) * (150 + 40 * 80))
    print(f"[parity] ba_pcg K={prob.R.shape[0]} P={prob.points.shape[0]} "
          f"O={prob.obs_kf.shape[0]}: poses and points within {d:.2e}, inliers equal "
          f"({int(bk.inliers.sum())})", flush=True)

    # K7: B=8 neighbours x 1128 x 1128; matches and gates bit-equal, X within 1e-5
    targs, geom = tri_inputs(frames, poses, dev)
    mk, Xk, okk = matcher.tri_search(*targs, geom)
    mp_, Xp, okp = matcher.tri_search_plain(*targs, geom)
    if not (torch.equal(mk, mp_) and torch.equal(okk, okp)):
        raise AssertionError(f"tri_search: m12 equal {torch.equal(mk, mp_)}, "
                             f"ok equal {torch.equal(okk, okp)}")
    rel = float(((Xk - Xp).norm(dim=-1) / Xp.norm(dim=-1).clamp(min=1e-9))[okp].max()) \
        if bool(okp.any()) else 0.0
    if rel > 1e-5 or int(okp.sum()) == 0:
        raise AssertionError(f"tri_search: X relative error {rel:.2e}, {int(okp.sum())} accepted")
    # work: epipolar gate, level test and XOR + popcount, ~30 ops per pair
    B, N1, N2 = targs[4].shape[0], targs[0].shape[0], targs[4].shape[1]
    stats["tri_search"] = record(
        rel, cuda_ms(lambda: matcher.tri_search(*targs, geom)),
        cuda_ms(lambda: matcher.tri_search_plain(*targs, geom), reps=5),
        (N1 + B * N2) * (32 + 8 + 4 + 1) + B * (36 + 4 * 48) + B * N1 * (4 + 12 + 1),
        30 * B * N1 * N2)
    print(f"[parity] tri_search B={targs[4].shape[0]} x {targs[0].shape[0]} x "
          f"{targs[4].shape[1]}: m12 and ok bit-equal ({int((mk >= 0).sum())} matches, "
          f"{int(okk.sum())} accepted), X max relative error {rel:.2e}", flush=True)

    # K8: the mirror scatter at cap 32768 / 256 rows, a confirmation-sized pack
    rng = np.random.default_rng(2)
    cap = track_device.MapMirror.LADDER[0]
    pos = t(rng.normal(size=(cap, 3)), torch.float32)
    val = t(rng.random(cap) < 0.5, torch.bool)
    rows = t(np.concatenate([rng.choice(cap, 200, replace=False), np.full(56, cap)]), torch.int32)
    new_pos, new_val = t(rng.normal(size=(256, 3)), torch.float32), t(rng.random(256) < 0.5,
                                                                      torch.bool)
    pk, vk, pp_, vp = pos.clone(), val.clone(), pos.clone(), val.clone()
    track_device.mirror_scatter(pk, vk, rows, new_pos, new_val)
    track_device.mirror_scatter_plain(pp_, vp, rows, new_pos, new_val)
    leaves = [t(rng.normal(size=(3, 3)), torch.float32), t(rng.integers(-5, 5, 1128), torch.int32),
              t(rng.random(4096) < 0.5, torch.bool), t(rng.integers(0, 256, (1128, 32)),
                                                       torch.uint8),
              t(7, torch.int64), t(rng.integers(-100, 100, 64), torch.int8)]
    same = (torch.equal(pk, pp_) and torch.equal(vk, vp) and torch.equal(
        packed_fetch.pack_i32(leaves), packed_fetch.pack_i32_plain(leaves)))
    back = packed_fetch.pack_fetch(leaves)
    same = same and all(np.array_equal(b, a.cpu().numpy()) and b.dtype == a.cpu().numpy().dtype
                        for a, b in zip(leaves, back))
    if not same:
        raise AssertionError("map_io: mirror_scatter or pack_i32 differs from the plain version")
    # the library yardstick: index_put_ of the in-range rows (the kernel
    # also drops the out-of-range ones, which index_put_ would reject)
    keep = rows < cap
    kr, kp, kv = rows[keep].long(), new_pos[keep], new_val[keep]
    stats["mirror_scatter"] = record(
        0.0, cuda_ms(lambda: track_device.mirror_scatter(pk, vk, rows, new_pos, new_val)),
        cuda_ms(lambda: track_device.mirror_scatter_plain(pp_, vp, rows, new_pos, new_val)),
        rows.numel() * (4 + 12 + 1) + int(keep.sum()) * 13, 0,
        library_ms=cuda_ms(lambda: (pk.index_put_((kr,), kp), vk.index_put_((kr,), kv))))
    words = packed_fetch.pack_i32_plain(leaves).numel()
    stats["pack_i32"] = record(0.0, cuda_ms(lambda: packed_fetch.pack_i32(leaves)),
                               cuda_ms(lambda: packed_fetch.pack_i32_plain(leaves)),
                               sum(a.numel() * a.element_size() for a in leaves) + 4 * words, 0)
    print("[parity] mirror_scatter (32768 rows, 256 updates) and pack_i32 "
          f"({sum(a.numel() for a in leaves)} words): bit-equal, exact round trip", flush=True)
    return stats


class _TwoViewRecorder:
    """Wraps two_view.reconstruct to keep each result (host copies)."""

    def __init__(self):
        self.results = []
        self._orig = two_view.reconstruct

    def __enter__(self):
        def rec(*args):
            res = self._orig(*args)
            self.results.append({k: v.cpu().numpy() for k, v in res._asdict().items()})
            return res
        two_view.reconstruct = rec
        return self

    def __exit__(self, *exc):
        two_view.reconstruct = self._orig


def stereo_config(sensor: str, width: int = WIDTH, height: int = HEIGHT,
                  n_features: int = SYS_FEATURES) -> SLAMConfig:
    """The configuration of the [stereo] / [rgbd] runs: [system]'s, with
    the rig's bf and ThDepth."""
    cfg = system_config(width, height, n_features)
    cam = dataclasses.replace(cfg.camera, bf=cfg.camera.fx * STEREO_BASELINE,
                              th_depth=STEREO_TH_DEPTH)
    return dataclasses.replace(cfg, camera=cam, sensor=sensor)


def run_system(frames, dev, on_frame=None, cfg=None, second=None, event_ms=None):
    """The System over ``frames`` (ts = k / 30) from a cold map, with
    ``cfg`` (default: system_config at the frames' size):
    ``track_monocular``, or with cfg.sensor "stereo" / "rgbd"
    ``track_stereo`` / ``track_rgbd`` with ``second[k]`` the right image /
    depth map.  ``on_frame(k, state, seconds, keyframe_event, system)``
    sees each frame; on a card, ``event_ms`` (a list) gets each frame's
    CUDA-event time."""
    if cfg is None:
        cfg = system_config(frames[0].shape[1], frames[0].shape[0])
    sys_ = System(cfg, device=dev)
    states = []
    timed = dev.type == "cuda" and event_ms is not None
    for k, img in enumerate(frames):
        n_kf = sys_.n_keyframes()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        if cfg.sensor == "stereo":
            st = sys_.track_stereo(img, second[k], k / 30.0)
        elif cfg.sensor == "rgbd":
            st = sys_.track_rgbd(img, second[k], k / 30.0)
        else:
            st = sys_.track_monocular(img, k / 30.0)
        if timed:
            ev[1].record()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if timed:
            event_ms.append(ev[0].elapsed_time(ev[1]))
        states.append(st)
        if on_frame is not None:
            on_frame(k, st, dt, sys_.n_keyframes() != n_kf, sys_)
    sys_.flush()
    return sys_, states


def check_system(sys_, states, poses):
    """Init by frame 2, every later frame OK, >= 4 keyframes, > 500 map
    points, ATE after Sim3 alignment <= 0.05 x scene scale (the bound of
    tests/test_slam_e2e.py:128)."""
    first_ok = next((k for k, s in enumerate(states) if s == TrackState.OK), None)
    if first_ok is None or first_ok > 2:
        raise AssertionError(f"no initialisation by frame 2: {states}")
    bad = [k for k in range(first_ok, len(states)) if states[k] != TrackState.OK]
    if bad:
        raise AssertionError(f"frames {bad} not OK after initialisation: {states}")
    if sys_.n_keyframes() < 4 or sys_.n_map_points() <= 500:
        raise AssertionError(f"{sys_.n_keyframes()} keyframes, {sys_.n_map_points()} map points")
    ate, scale = pf.trajectory_ate(sys_.tracker.trajectory, poses)
    if not np.isfinite(ate) or ate > 0.05 * max(scale, 1.0):
        raise AssertionError(f"ATE {ate:.4f} m over a scene scale of {scale:.3f} m")
    return first_ok, ate, scale


def phase_system(frames, poses, dev):
    host_ms, kf_frames = [], []

    def on_frame(k, st, dt, kf, _):
        host_ms.append(dt * 1e3)
        if kf:
            kf_frames.append(k)

    kernels.LAUNCHES.clear()
    with _TwoViewRecorder() as rec:
        sys_, states = run_system(frames, dev, on_frame)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr = sys_.tracker
    first_ok, ate, scale = check_system(sys_, states, poses)
    own = {"two_view": tr.stats["two_view"], "ba_pcg": tr.stats["ba"],
           "tri_search": tr.stats["tri_groups"], "mirror_scatter": tr._mirror.n_scatter}
    for name, n in own.items():
        if launches.get(name, 0) != n or n == 0:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, the tracker "
                                 f"counted {n}")
    missing = [n for n in VISUAL_KERNELS if n not in ("stereo_match", "pnp_ransac")
               and launches.get(n, 0) == 0]
    if missing or launches.get("stereo_match", 0):
        raise AssertionError(f"kernels never launched on the [system] path: {missing}, "
                             f"stereo_match {launches.get('stereo_match', 0)}")
    for k, (st, ms) in enumerate(zip(states, host_ms)):
        print(f"[system] frame {k:2d}: {ms:8.2f} ms host clock  {st.name:15s}"
              f"{'  keyframe event' if k in kf_frames else ''}", flush=True)
    steady = [ms for k, ms in enumerate(host_ms) if k > first_ok and k not in kf_frames]
    kf_ms = [ms for k, ms in enumerate(host_ms) if k > first_ok and k in kf_frames]
    print(f"[system] init at frame {first_ok}, {sys_.n_keyframes()} keyframes, "
          f"{sys_.n_map_points()} map points, ATE {ate:.4f} m (scene scale {scale:.3f} m); "
          f"tracked-frame median {statistics.median(steady):.2f} ms, keyframe-event median "
          f"{statistics.median(kf_ms) if kf_ms else float('nan'):.2f} ms (host clock)",
          flush=True)
    print(f"[system] launches {launches}; tracker counts {own}", flush=True)
    return launches, rec.results, sys_, states, kf_ms


def phase_system_reference(frames, card_inits, card_sys):
    """The same init and two tracked frames through the CPU plain path,
    with the same sample sets (the tracker's seeded draw): R21/t21 within
    1e-3, triangulated masks agree on >= 99%, poses within 1e-3."""
    n = len(card_sys.tracker.trajectory)
    first_ok = int(round(card_sys.tracker.trajectory[1][0] * 30.0))
    with _TwoViewRecorder() as rec:
        cpu_sys, _ = run_system(frames[: first_ok + 3], torch.device("cpu"))
    g, c = card_inits[-1], rec.results[-1]
    d = max(float(np.abs(g["R21"] - c["R21"]).max()), float(np.abs(g["t21"] - c["t21"]).max()))
    agree = float((g["is_triangulated"] == c["is_triangulated"]).mean())
    if d > 1e-3 or agree < 0.99 or len(card_inits) != len(rec.results):
        raise AssertionError(f"init: card vs CPU |dR21|,|dt21| {d:.2e}, masks agree {agree:.4f}, "
                             f"{len(card_inits)} vs {len(rec.results)} attempts")
    print(f"[system-reference] init: card vs CPU plain path |dR21|,|dt21| {d:.2e}, "
          f"triangulated masks agree {agree:.4f}", flush=True)
    for (ts, Rg, tg), (_, Rc, tc) in zip(card_sys.tracker.trajectory[: min(n, 4)],
                                         cpu_sys.tracker.trajectory):
        dp = max(float(np.abs(Rg - Rc).max()), float(np.abs(tg - tc).max()))
        if dp > 1e-3:
            raise AssertionError(f"frame {ts * 30:.0f}: card vs CPU pose {dp:.2e}")
        print(f"[system-reference] frame {ts * 30:.0f}: card vs CPU plain path |dpose| {dp:.2e}",
              flush=True)


def phase_depth_system(sensor: str, frames, second, poses, dev):
    """``System.track_stereo`` / ``track_rgbd`` from a cold map: OK from
    frame 0, >= 3 keyframes, metric camera-centre error < 0.08 m and the
    path length within 5% (the bounds of tests/test_slam_stereo_rgbd.py),
    every kernel of the path launched, K1/K2 once per image and K9 once
    per stereo frame, each equal to the tracker's own count."""
    tag = f"[{sensor}]"
    host_ms, kf_frames = [], []

    def on_frame(k, st, dt, kf, _):
        host_ms.append(dt * 1e3)
        if kf:
            kf_frames.append(k)

    kernels.LAUNCHES.clear()
    sys_, states = run_system(frames, dev, on_frame, stereo_config(sensor), second)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr, n = sys_.tracker, len(frames)
    bad = [k for k, st in enumerate(states) if st != TrackState.OK]
    err, ratio = pf.metric_error(tr.trajectory, poses)
    if bad or sys_.n_keyframes() < 3 or not err < 0.08 or abs(ratio - 1.0) >= 0.05:
        raise AssertionError(f"{tag} frames {bad} not OK, {sys_.n_keyframes()} keyframes, "
                             f"metric error {err:.4f} m, path ratio {ratio:.4f}")
    images = 2 * n if sensor == "stereo" else n
    want = {"fast_detect": images, "orb_describe": images,
            "stereo_match": n if sensor == "stereo" else 0}
    own = {"stereo_match": tr.stats["stereo_match"], "ba_pcg": tr.stats["ba"],
           "tri_search": tr.stats["tri_groups"], "mirror_scatter": tr._mirror.n_scatter}
    for name, v in list(want.items()) + list(own.items()):
        if launches.get(name, 0) != v:
            raise AssertionError(f"{tag} {name}: {launches.get(name, 0)} launches, expected {v}")
    path = [k for k in VISUAL_KERNELS if k not in ("two_view", "pnp_ransac")
            and (sensor == "stereo" or k != "stereo_match")]
    missing = [k for k in path if launches.get(k, 0) == 0]
    if missing or launches.get("two_view", 0) or not launches.get("pose_lm_stereo", 0):
        raise AssertionError(f"{tag} never launched {missing}; two_view "
                             f"{launches.get('two_view', 0)}, stereo pose solves "
                             f"{launches.get('pose_lm_stereo', 0)}")
    for k, (st, ms) in enumerate(zip(states, host_ms)):
        print(f"{tag} frame {k:2d}: {ms:8.2f} ms host clock  {st.name:4s}"
              f"{'  keyframe event' if k in kf_frames else ''}", flush=True)
    steady = [ms for k, ms in enumerate(host_ms) if k > 1 and k not in kf_frames]
    kf_ms = [ms for k, ms in enumerate(host_ms) if k > 0 and k in kf_frames]
    print(f"{tag} {sys_.n_keyframes()} keyframes, {sys_.n_map_points()} map points, metric "
          f"error {err:.4f} m, path ratio {ratio:.4f}; fused-frame median "
          f"{statistics.median(steady):.2f} ms, keyframe-event median "
          f"{statistics.median(kf_ms) if kf_ms else float('nan'):.2f} ms (host clock)",
          flush=True)
    print(f"{tag} launches {launches}; tracker counts {own}", flush=True)
    return launches


def phase_stereo_reference(frames, rights, dev):
    """The first 3 frames of [stereo] on the card and through the CPU plain
    path side by side: the init map (point count and positions) and the
    init keyframe's ur/depth equal, poses within 1e-3."""
    cfg = stereo_config("stereo")
    card, cpu = System(cfg, device=dev), System(cfg, device=torch.device("cpu"))
    for k in range(3):
        for s in (card, cpu):
            s.track_stereo(frames[k], rights[k], k / 30.0)
        if k == 0:
            mg, mc = card.tracker.atlas.current, cpu.tracker.atlas.current
            n = mg._next_mp
            kg, kc = mg.keyframes[0], mc.keyframes[0]
            same = (n == mc._next_mp and np.array_equal(mg.mp_pos[:n], mc.mp_pos[:n])
                    and np.array_equal(kg.ur, kc.ur) and np.array_equal(kg.depth, kc.depth))
            if not same or n <= 500:
                raise AssertionError(f"init: card {n} points vs CPU {mc._next_mp}, "
                                     f"positions and ur/depth equal {same}")
            print(f"[stereo-reference] init: {n} map points, positions and the keyframe's "
                  f"ur/depth equal to the CPU plain path's", flush=True)
    for s in (card, cpu):
        s.flush()
    for (ts, Rg, tg), (_, Rc, tc) in zip(card.tracker.trajectory, cpu.tracker.trajectory):
        dp = max(float(np.abs(Rg - Rc).max()), float(np.abs(tg - tc).max()))
        if dp > 1e-3:
            raise AssertionError(f"frame {ts * 30:.0f}: card vs CPU pose {dp:.2e}")
        print(f"[stereo-reference] frame {ts * 30:.0f}: card vs CPU plain path |dpose| {dp:.2e}",
              flush=True)


def phase_parity_pnp(dev) -> dict:
    """K10 against its plain version on the same CUDA inputs at the
    relocalization shape: 1128 keypoint slots (1000 features + 8 x 16), 80%
    of them matched, 256 sets, th = 3 px / fx, 30% gross outliers and 0.001
    of noise in normalized coordinates.  ok, n_inliers and the inlier mask
    equal, the winner's pose within 1e-4."""
    rng = np.random.default_rng(4)
    N = SYS_FEATURES + 8 * 16
    pts, xy, _, _, _ = pf.pnp_scene(rng, N, 0.3, 0.001)
    valid = rng.random(N) < 0.8
    args = tuple(torch.from_numpy(a).to(dev) for a in (pts, xy, valid))
    sets = pnp.sample_pnp_sets(0, torch.from_numpy(valid)).to(dev)
    th = 3.0 / camera_config(WIDTH, HEIGHT).fx
    run_k = lambda: pnp.ransac_pnp(*args, sets, th=th, min_inliers=12)
    run_p = lambda: pnp.ransac_pnp_plain(*args, sets, th=th, min_inliers=12)
    rk, rp = run_k(), run_p()
    d = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
    same = (bool(rk.ok) == bool(rp.ok) and int(rk.n_inliers) == int(rp.n_inliers)
            and torch.equal(rk.inliers, rp.inliers))
    if not same or not d <= 1e-4 or not bool(rk.ok):
        raise AssertionError(f"pnp_ransac: ok {bool(rk.ok)}/{bool(rp.ok)}, n_inliers "
                             f"{int(rk.n_inliers)}/{int(rp.n_inliers)}, masks equal "
                             f"{torch.equal(rk.inliers, rp.inliers)}, |dR|,|dt| {d:.2e}")
    # work: per hypothesis ~20k float64 operations of minimal solve (the
    # 12x12 symmetric eigenproblem ~9 n^3 = 15.6k, M^T M 3.5k, the 4x4 solve,
    # covariance, beta and Horn ~1k); ~28 float32 operations per (hypothesis,
    # valid slot) of scoring and per valid slot of the winner's mask.
    # In: points, coordinates, mask, sets; out: R, t, mask, count, ok
    H, nv = sets.shape[0], int(valid.sum())
    stats = {"pnp_ransac": record(d, cuda_ms(run_k), cuda_ms(run_p, reps=5),
                                  N * (12 + 8 + 1) + H * 6 * 4 + 48 + N + 5,
                                  28 * (H + 1) * nv, ops64=20000 * H)}
    print(f"[parity] pnp_ransac N={N} H={H}: ok, n_inliers ({int(rk.n_inliers)} of {nv} matched) "
          f"and inlier mask equal, max |dR|,|dt| {d:.2e}", flush=True)
    return stats


def run_recovery(tag: str, frames, dev, cfg=None, second=None):
    """A System run for the recovery phases: per-frame states, host and
    event ms, and which frames attempted a relocalization."""
    host_ms, event_ms, reloc_frames = [], [], []
    seen = {"reloc": 0}

    def on_frame(k, st, dt, kf, sys_):
        host_ms.append(dt * 1e3)
        n = sys_.tracker.stats["reloc"]
        if n != seen["reloc"]:
            reloc_frames.append(k)
        seen["reloc"] = n

    kernels.LAUNCHES.clear()
    sys_, states = run_system(frames, dev, on_frame, cfg, second, event_ms)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for k in reloc_frames:
        ev = event_ms[k] if event_ms else float("nan")
        print(f"{tag} frame {k:2d}: {host_ms[k]:8.2f} ms host {ev:8.2f} ms events  "
              f"{states[k].name} (relocalization attempt)", flush=True)
    print(f"{tag} states {[s.name for s in states]}", flush=True)
    print(f"{tag} launches {launches}; tracker counts {dict(sys_.tracker.stats)}", flush=True)
    return sys_, states, launches


def check_relocalized(tag: str, states, black, sys_, launches):
    """LOST (or RECENTLY_LOST) on the first black frame, OK again within 2
    frames of the first real image and on every later frame, K10 launched
    once per PnP call of the tracker."""
    first_real = black[-1] + 1
    back = next((k for k in range(first_real, len(states)) if states[k] == TrackState.OK), None)
    lost = states[black[0]] in (TrackState.LOST, TrackState.RECENTLY_LOST)
    if not lost or back is None or back > first_real + 1 or any(
            s != TrackState.OK for s in states[back:]):
        raise AssertionError(f"{tag} states {[s.name for s in states]}")
    n_pnp = sys_.tracker.stats["pnp"]
    if launches.get("pnp_ransac", 0) != n_pnp or n_pnp == 0 or not sys_.tracker.stats["reloc_ok"]:
        raise AssertionError(f"{tag} pnp_ransac {launches.get('pnp_ransac', 0)} launches, the "
                             f"tracker counted {n_pnp} PnP calls")
    return back


def phase_reloc(frames, poses, dev):
    """[reloc]: the [system] run with frames 14-15 black: LOST, relocalized
    (K3, K10, K4) on the first real frame or the next, then OK to the end;
    the whole run's ATE within the [system] limit; every kernel of the mono
    path launched."""
    sys_, states, launches = run_recovery("[reloc]", pf.blackout(frames, RELOC_BLACK), dev)
    back = check_relocalized("[reloc]", states, RELOC_BLACK, sys_, launches)
    ate, scale = pf.trajectory_ate(sys_.tracker.trajectory, poses)
    if not np.isfinite(ate) or ate > 0.05 * max(scale, 1.0):
        raise AssertionError(f"[reloc] ATE {ate:.4f} m over a scene scale of {scale:.3f} m")
    missing = [n for n in VISUAL_KERNELS if n != "stereo_match" and launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"[reloc] never launched {missing}")
    print(f"[reloc] OK again at frame {back}, {sys_.n_keyframes()} keyframes, ATE {ate:.4f} m "
          f"(scene scale {scale:.3f} m)", flush=True)
    return launches


def phase_reloc_stereo(frames, rights, poses, dev):
    """[reloc-stereo]: [stereo] with frames 14-15 black in both images:
    relocalized as [reloc], metric error < 0.08 m, K9 once per stereo
    frame, K4 with the stereo rows."""
    black = lambda ims: pf.blackout(ims, RELOC_BLACK)
    cfg = stereo_config("stereo", frames[0].shape[1], frames[0].shape[0])
    sys_, states, launches = run_recovery("[reloc-stereo]", black(frames), dev, cfg, black(rights))
    back = check_relocalized("[reloc-stereo]", states, RELOC_BLACK, sys_, launches)
    err, ratio = pf.metric_error(sys_.tracker.trajectory, poses)
    if not err < 0.08 or launches.get("stereo_match", 0) != sys_.tracker.stats["stereo_match"] \
            or not launches.get("pose_lm_stereo", 0):
        raise AssertionError(f"[reloc-stereo] metric error {err:.4f} m, stereo_match "
                             f"{launches.get('stereo_match', 0)} launches, stereo pose solves "
                             f"{launches.get('pose_lm_stereo', 0)}")
    print(f"[reloc-stereo] OK again at frame {back}, {sys_.n_keyframes()} keyframes, metric "
          f"error {err:.4f} m, path ratio {ratio:.4f}", flush=True)
    return launches


def phase_recovery(frames, poses, dev):
    """[recovery]: frames 14-21 black: LOST on 14, the sixth failed LOST
    frame starts a new Atlas map and drops the failed one (fewer than 10
    keyframes), the next real frames initialise it again (K5) and track OK
    to the end; the new map's ATE within the [system] limit."""
    sys_, states, launches = run_recovery("[recovery]", pf.blackout(frames, RECOVERY_BLACK), dev)
    tr = sys_.tracker
    reset = RECOVERY_BLACK[0] + 6
    first_real = RECOVERY_BLACK[-1] + 1
    back = next((k for k in range(first_real, len(states)) if states[k] == TrackState.OK), None)
    ok = (all(s == TrackState.LOST for s in states[RECOVERY_BLACK[0]:reset])
          and states[reset] == TrackState.NO_IMAGES_YET and back is not None
          and back <= first_real + 2 and all(s == TrackState.OK for s in states[back:])
          and len(tr.atlas.maps) == 1 and tr.atlas.current.mid == 1)
    n_tv = tr.stats["two_view"]
    if not ok or launches.get("two_view", 0) != n_tv or n_tv < 2:
        raise AssertionError(f"[recovery] states {[s.name for s in states]}, "
                             f"{len(tr.atlas.maps)} maps (current {tr.atlas.current.mid}), "
                             f"two_view {launches.get('two_view', 0)} launches / {n_tv}")
    ate, scale = pf.trajectory_ate(tr.trajectory[tr._map_traj_start:], poses)
    if not np.isfinite(ate) or ate > 0.05 * max(scale, 1.0):
        raise AssertionError(f"[recovery] new map ATE {ate:.4f} m over {scale:.3f} m")
    print(f"[recovery] new map at frame {reset}, initialised again by frame {back}, "
          f"{sys_.n_keyframes()} keyframes, new-map ATE {ate:.4f} m over "
          f"{len(tr.trajectory) - tr._map_traj_start} frames", flush=True)
    return launches


def phase_resume(frames, poses, dev):
    """[resume]: the CPU plain path tracks [system]'s frames 0-15 and saves
    its session; ``load_session`` without a device puts it on the card,
    which tracks frames 16-29 OK (the fused step from the restored last
    frame) with the whole trajectory's ATE within the [system] limit."""
    cfg = system_config(frames[0].shape[1], frames[0].shape[0])
    cpu = System(cfg, device=torch.device("cpu"))
    for k in range(RESUME_AT):
        cpu.track_monocular(frames[k], k / 30.0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "session.npz")
        checkpoint.save_session(cpu.tracker, path)
        kernels.LAUNCHES.clear()
        tr = checkpoint.load_session(path, cfg)
        states = [tr.track(frames[k], k / 30.0) for k in range(RESUME_AT, len(frames))]
        tr.flush()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ate, scale = pf.trajectory_ate(tr.trajectory, poses)
    fused = ("fast_detect", "orb_describe", "hamming_best2", "pose_lm", "pack_i32")
    if tr.device.type != "cuda" or any(s != TrackState.OK for s in states) or \
            len(tr.trajectory) != len(cpu.tracker.trajectory) + len(states) or \
            not ate <= 0.05 * max(scale, 1.0) or any(not launches.get(n, 0) for n in fused):
        raise AssertionError(f"[resume] on {tr.device}: states {[s.name for s in states]}, "
                             f"ATE {ate:.4f} m, launches {launches}")
    print(f"[resume] session of frames 0-{RESUME_AT - 1} (CPU plain path) tracked on "
          f"{tr.device} through frame {len(frames) - 1}: all OK, ATE {ate:.4f} m over "
          f"{scale:.3f} m; launches {launches}", flush=True)
    return launches



# ----------------------------------------------------------- loop closing


def random_vocab(k: int = 10, L: int = 6, seed: int = 0) -> vocab_mod.Vocabulary:
    """A vocabulary of ORBvoc's shape (k children, L levels, every node
    full: k^L words, ~111k node rows at k=10, L=6) with random child
    descriptors and unit weights."""
    rng = np.random.default_rng(seed)
    desc = [rng.integers(0, 256, (k ** l, k, 32), dtype=np.uint8) for l in range(L)]
    ids = [np.arange(k ** (l + 1), dtype=np.int64).reshape(k ** l, k) for l in range(L)]
    return vocab_mod.Vocabulary(k, L, desc, ids, np.ones(k ** L))


def train_vocab(frames, dev, every: int = 5, n_features: int = SYS_FEATURES):
    """The vocabulary of tests/test_loop_from_pixels.py:92-98: k=8, L=3,
    trained (seed 0) on the descriptors the extractor finds in every
    ``every``-th frame."""
    h, w = frames[0].shape
    ext = ORBExtractor(ORBConfig(n_features=n_features), (h, w), dev)
    descs = []
    for img in frames[::every]:
        f = ext(torch.from_numpy(img).to(dev))
        descs.append(f.desc.cpu().numpy()[f.valid.cpu().numpy()])
    return vocab_mod.Vocabulary.train(np.concatenate(descs, 0), k=8, L=3, seed=0)


def looped_map(dev, n_kf: int = LOOP_KFS, n_pts: int = LOOP_POINTS):
    """The [loop] map: ``pf.build_looped_map`` at full width (LOOP_KFS
    keyframes of up to 1128 keypoints, ~1000 observed each), the return
    pass half a step off the outbound one; keyframe features on ``dev``."""
    def feats(d, xy, v):
        n = len(v)
        return interop.features_from_numpy(
            dict(xy=xy, response=np.zeros(n, np.float32), angle=np.zeros(n, np.float32),
                 octave=np.zeros(n, np.int32), size=np.full(n, 31.0, np.float32), desc=d,
                 valid=v), dev)
    return pf.build_looped_map(0, SLAMMap, KeyFrame, feats, n_kf=n_kf, n_pts=n_pts,
                               step=LOOP_STEP, n_cap=SYS_FEATURES + 8 * 16,
                               return_shift=LOOP_STEP / 2)


def sim3_scene(rng, N: int = 512, out_frac: float = 0.3):
    """N Sim3 pairs: points 2-8 m in front of camera 1, p2 = s R p1 + t
    (s 1.3), both pixels with 0.5 px noise, ``out_frac`` of the second
    pixels moved 10-40 px, 90% valid.  float32 numpy (p1, p2, uv1, uv2,
    valid) and the true (R, t, s)."""
    cam = camera_config(WIDTH, HEIGHT)
    proj = lambda p: np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                               cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)
    p1 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(2, 8, N)], -1)
    R, t, s = pf.so3_exp_np([0.05, -0.1, 0.03]), np.array([0.2, -0.05, 0.1]), 1.3
    p2 = s * p1 @ R.T + t
    uv1 = proj(p1) + rng.normal(0, 0.5, (N, 2))
    uv2 = proj(p2) + rng.normal(0, 0.5, (N, 2))
    out = rng.random(N) < out_frac
    uv2[out] += rng.uniform(10, 40, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
    f = lambda a: np.asarray(a, np.float32)
    return f(p1), f(p2), f(uv1), f(uv2), rng.random(N) < 0.9, (R, t, s)


def pose_graph_problem(rng, dev, K: int = 200, extra: int = 4, far: int = 3):
    """An essential graph of K keyframes on a closed loop of radius 1 m (a
    monocular map's scale): a chain, ``extra`` edges from each keyframe to
    random ones 2-20 later around the loop and ``far`` loop edges to random
    keyframes anywhere (~1500 edges in all), measurements from the true
    poses with 1 mrad / 1 mm noise and exact scale (m_s = 1, every start
    scale 1, as ``LoopCloser._optimize_essential_graph`` builds them), the
    start poses off by a random walk of 10 mrad / 1 cm a step, keyframe 0
    fixed.  Its log-scale residuals end in [1e-5, 1e-3], where the float32
    Sim3 maps' (s - 1) / sigma terms cancel (csrc/pose_graph.cu)."""
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    Rs, ts = [], []
    for a in ang:
        R = pf.so3_exp_np([0.0, a, 0.0])
        Rs.append(R)
        ts.append(-R @ np.array([np.cos(a), 0.02 * np.sin(3 * a), np.sin(a)]))
    edges = [(i, i + 1) for i in range(K - 1)]
    for i in range(K):
        for j in rng.choice(np.arange(i + 2, i + 21), extra, replace=False):
            if j % K != i:
                edges.append((i, int(j % K)))
        for j in rng.choice(K, far, replace=False):
            if abs(int(j) - i) > 20:
                edges.append((i, int(j)))
    mR, mt = [], []
    for i, j in edges:
        dR = pf.so3_exp_np(rng.normal(0, 1e-3, 3))
        Rm = dR @ Rs[j] @ Rs[i].T
        mR.append(Rm)
        mt.append(ts[j] - Rs[j] @ Rs[i].T @ ts[i] + rng.normal(0, 1e-3, 3))
    R0, t0 = [Rs[0]], [ts[0]]
    for i in range(1, K):
        dR = pf.so3_exp_np(rng.normal(0, 1e-2, 3))
        R0.append(dR @ Rs[i])
        t0.append(ts[i] + rng.normal(0, 1e-2, 3) * i ** 0.5)
    f = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    E = len(edges)
    return pose_graph.PoseGraphProblem(
        R=f(R0), t=f(t0), s=f(np.ones(K)), edge_i=f([e[0] for e in edges], torch.int32),
        edge_j=f([e[1] for e in edges], torch.int32), m_R=f(mR), m_t=f(mt), m_s=f(np.ones(E)),
        weight=f(np.ones(E)), edge_valid=f(np.ones(E, bool), torch.bool),
        fixed=f(np.arange(K) == 0, torch.bool))


def phase_parity_loop(frames, voc, dev) -> dict:
    """K11-K14 and K3's word gate against their plain versions on the same
    CUDA inputs at the shapes of the loop-closing path."""
    rng = np.random.default_rng(5)
    stats = {}
    cam = Pinhole.from_config(camera_config(WIDTH, HEIGHT))
    h, w = frames[0].shape
    ext = ORBExtractor(ORBConfig(n_features=SYS_FEATURES), (h, w), dev)
    f1, f2 = ext(torch.from_numpy(frames[0]).to(dev)), ext(torch.from_numpy(frames[4]).to(dev))

    # K11: 1128 keypoint slots of a frame through an ORBvoc-shaped tree
    # (k=10, L=6) and through the trained one (k=8, L=3); words equal
    big = random_vocab()
    desc = f1.desc
    for name, v in (("orbvoc-shaped k=10 L=6", big), ("trained k=8 L=3", voc)):
        wk, wp = v.transform_words_device(desc), v.transform_words_plain(desc)
        if not torch.equal(wk.long(), wp.long()):
            raise AssertionError(f"vocab_words ({name}): {int((wk != wp).sum())} words differ")
        print(f"[parity] vocab_words {name}: {desc.shape[0]} descriptors, words equal", flush=True)
    # work: per descriptor and level k child rows (32 B descriptor, 4 B id)
    # and ~24 operations per child (8 XOR, 8 popcount, 8 adds); in: the
    # descriptors and the levels' rows they read, out: the words
    N, k, L = desc.shape[0], big.k, big.L
    stats["vocab_words"] = record(
        0.0, cuda_ms(lambda: big.transform_words_device(desc)),
        cuda_ms(lambda: big.transform_words_plain(desc), reps=5),
        N * 32 + N * L * k * 36 + N * 4, N * L * k * 24)

    # K3 word gate: frame 0 against frame 4, words from the trained tree
    w1, w2 = voc.transform_words_device(f1.desc), voc.transform_words_device(f2.desc)
    w1 = torch.where(f1.valid, w1, -1)
    w2 = torch.where(f2.valid, w2, -1)
    args = (f1.desc, f1.valid, f2.desc, f2.valid)
    rk = matcher.hamming_best2(*args, words=(w1, w2))
    rp = matcher.hamming_best2_plain(*args, words=(w1, w2))
    for name, a, b in zip(rk._fields, rk, rp):
        if not torch.equal(a, b):
            raise AssertionError(f"hamming_best2_words: {name} differs from the plain version")
    n_same = int(matcher._word_mask(w1, w2, f1.valid, f2.valid).sum())
    M2, N2 = f1.desc.shape[0], f2.desc.shape[0]
    # work: a word compare per pair (2 ops), XOR + popcount + top-2 (~20)
    # per same-word pair; in: descriptors, words, flags; out: 4 rows
    stats["hamming_best2_words"] = record(
        0.0, cuda_ms(lambda: matcher.hamming_best2(*args, words=(w1, w2))),
        cuda_ms(lambda: matcher.hamming_best2_plain(*args, words=(w1, w2))),
        (M2 + N2) * 37 + 16 * M2, 2 * M2 * N2 + 20 * n_same)
    print(f"[parity] hamming_best2 word gate {M2}x{N2} ({n_same} same-word pairs): all outputs "
          f"bit-equal", flush=True)

    # K12 RANSAC: 512 pairs, 30% outliers, the seeded sets
    p1, p2, uv1, uv2, val, _ = sim3_scene(rng)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sargs = [t_(a) for a in (p1, p2, uv1, uv2, val)]
    sets = gsim3.sample_sim3_sets(3, torch.from_numpy(val)).to(dev)
    run_k = lambda: gsim3.solve_sim3_ransac(sets, *sargs, cam)
    run_p = lambda: gsim3.solve_sim3_ransac_plain(sets, *sargs, cam)
    rk, rp = run_k(), run_p()
    d = max(float((rk.R12 - rp.R12).abs().max()), float((rk.t12 - rp.t12).abs().max()),
            float((rk.s12 - rp.s12).abs()))
    same = (bool(rk.success) == bool(rp.success) and int(rk.n_inliers) == int(rp.n_inliers)
            and torch.equal(rk.inliers, rp.inliers))
    if not same or not d <= 1e-5 or not bool(rk.success):
        raise AssertionError(f"sim3_ransac: ok {bool(rk.success)}/{bool(rp.success)}, count "
                             f"{int(rk.n_inliers)}/{int(rp.n_inliers)}, masks equal "
                             f"{torch.equal(rk.inliers, rp.inliers)}, |dR|,|dt|,|ds| {d:.2e}")
    H, nv = sets.shape[0], int(val.sum())
    # work: per hypothesis Horn's 4x4 cyclic Jacobi in float64 (~6 sweeps x
    # 6 rotations x ~100 ops) and ~60 float32 operations per (hypothesis,
    # pair) of scoring, again for the winner's mask; in: pairs, sets; out:
    # the winner, its mask, count, ok
    stats["sim3_ransac"] = record(d, cuda_ms(run_k), cuda_ms(run_p, reps=5),
                                  512 * 41 + H * 12 + 52 + 512 + 5, 60 * (H + 1) * 512,
                                  ops64=3600 * H)
    print(f"[parity] sim3_ransac N=512 H={H}: ok, count ({int(rk.n_inliers)} of {nv} valid) and "
          f"mask equal, max |dR|,|dt|,|ds| {d:.2e}", flush=True)

    # K12 OptimizeSim3: 1024 pairs from a start 0.02 rad / 5 cm / 3% off
    p1, p2, uv1, uv2, val, (R, t, s) = sim3_scene(rng, 1024, out_frac=0.1)
    # x1 = s R x2 + t of the JAX function: the inverse of the scene's Sim3
    Ri, ti, si = R.T, -(R.T @ t) / s, 1.0 / s
    R0 = t_((pf.so3_exp_np([0.02, 0.0, -0.01]) @ Ri).astype(np.float32))
    t0 = t_((ti + np.array([0.05, 0.0, -0.03])).astype(np.float32))
    s0 = torch.tensor(si * 1.03, dtype=torch.float32, device=dev)
    oargs = (R0, t0, s0, t_(p1), t_(p2), t_(uv1), t_(uv2), t_(val))
    for fix in (False, True):
        ok_ = gsim3.optimize_sim3(*oargs, cam, fix)
        op_ = gsim3.optimize_sim3_plain(*oargs, cam, fix)
        d = max(float((ok_.R12 - op_.R12).abs().max()), float((ok_.t12 - op_.t12).abs().max()),
                float((ok_.s12 - op_.s12).abs()))
        if int(ok_.n_in) != int(op_.n_in) or not d <= 1e-4:
            raise AssertionError(f"sim3_optimize fix_scale={fix}: n_in {int(ok_.n_in)}/"
                                 f"{int(op_.n_in)}, |dR|,|dt|,|ds| {d:.2e}")
        print(f"[parity] sim3_optimize N=1024 fix_scale={fix}: n_in {int(ok_.n_in)} equal, max "
              f"|dR|,|dt|,|ds| {d:.2e}", flush=True)
    # work: 15 steps x 1024 edges x (the two residuals in Dual<7>, ~7 x 250
    # ops, and the 2 x 35 normal-equation products) + the 7x7 solves; in:
    # pairs once, out: the Sim3, mask, count
    stats["sim3_optimize"] = record(
        d, cuda_ms(lambda: gsim3.optimize_sim3(*oargs, cam, True)),
        cuda_ms(lambda: gsim3.optimize_sim3_plain(*oargs, cam, True), reps=3),
        52 + 1024 * 41 + 52 + 1024 + 4, 15 * 1024 * (7 * 250 + 4 * 70))

    # K13: an exact-scale essential graph of 200 keyframes, ~1500 edges.
    # The kernel computes in float64, so its plain version is the plain
    # solve of the same problem widened to float64; it must also be no
    # farther from that solve than the float32 plain solve is.
    prob = pose_graph_problem(rng, dev)
    K, E = prob.R.shape[0], prob.edge_i.shape[0]
    prob64 = pose_graph.PoseGraphProblem(*[a.double() if a.is_floating_point() else a
                                           for a in prob])
    dist = lambda x, y: max(float((a.double() - b.double()).abs().max()) for a, b in zip(x, y))
    d_pg = 0.0
    for fix in (False, True):
        gk = pose_graph.optimize_pose_graph(prob, n_iters=15, fix_scale=fix)
        g64 = pose_graph.optimize_pose_graph_plain(prob64, n_iters=15, fix_scale=fix)
        g32 = pose_graph.optimize_pose_graph_plain(prob, n_iters=15, fix_scale=fix)
        d, d32 = dist(gk[:3], g64[:3]), dist(g32[:3], g64[:3])
        line = (f"pose_graph K={K} E={E} fix_scale={fix}: max |dR|,|dt|,|ds| {d:.2e} from the "
                f"plain float64 solve (float32 plain solve {d32:.2e}), cost {float(gk[3]):.7g} / "
                f"plain {float(g64[3]):.7g}")
        if not (d <= 1e-4 and d <= d32):
            raise AssertionError(line)
        print(f"[parity] {line}", flush=True)
        d_pg = max(d_pg, d)
    # work per LM iteration, all float64: per edge two residual evaluations
    # in Dual<7> (~7 x 900 ops) and the 2 x 7 x 7 x 14 products of g and the
    # blocks, the 7x7 inverses, 50 PCG steps of 2 x 2 x 49 x 2 ops per edge,
    # and the trial cost; in: the float32 poses and edges; out: poses, cost
    stats["pose_graph"] = record(
        d_pg, cuda_ms(lambda: pose_graph.optimize_pose_graph(prob, n_iters=15), reps=5),
        cuda_ms(lambda: pose_graph.optimize_pose_graph_plain(prob64, n_iters=15), reps=2),
        K * 53 + E * 72 + K + K * 52 + 4, 0,
        ops64=15 * (E * (2 * 7 * 900 + 2 * 7 * 7 * 14) + K * 700 + 50 * (E * 392 + K * 120)))

    # K14: the [loop] map's full GBA problem.  Its observations agree with
    # its poses, so its final cost is float32 rounding (~1e-6 over 27000
    # observations) and is printed, not compared; the cost is held to 1e-4
    # relative on a noisy problem of the same K and O (24 keyframes, 1125
    # points seen by each, +-0.5 px noise, 5% outliers, two fixed
    # keyframes), where it stands far above rounding.
    mp, _, _, _ = looped_map(dev)
    gprob = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    Kb, Pb, Ob = gprob.R.shape[0], gprob.points.shape[0], gprob.obs_kf.shape[0]
    noisy = ba_problem(rng, dev, n_kf=Kb, n_pts=Ob // Kb, Kp=Kb, Pp=-(-(Ob // Kb) // 128) * 128,
                       Op=Ob)
    d_ba = 0.0
    for name, prob_ in (("[loop] map", gprob), ("noisy", noisy)):
        bk = sharded_ba.optimize_schur(prob_, cam)
        bp = sharded_ba.optimize_schur_plain(prob_, cam)
        d = max(float((bk.R - bp.R).abs().max()), float((bk.t - bp.t).abs().max()),
                float((bk.points - bp.points).abs().max()))
        ck, cp = float(bk.cost), float(bp.cost)
        dc = abs(ck - cp) / cp if name == "noisy" else 0.0
        if not d <= 1e-3 or not dc <= 1e-4 or not torch.equal(bk.inliers, bp.inliers):
            raise AssertionError(f"ba_schur ({name}): |dR|,|dt|,|dp| {d:.2e}, cost {ck:.6g} / "
                                 f"{cp:.6g}, inliers equal {torch.equal(bk.inliers, bp.inliers)}")
        cost_note = f"{dc:.2e} relative" if name == "noisy" else "rounding, not compared"
        print(f"[parity] ba_schur {name} K={prob_.R.shape[0]} P={prob_.points.shape[0]} "
              f"O={prob_.obs_kf.shape[0]}: max |dR|,|dt|,|dp| {d:.2e}, inliers equal, cost "
              f"{ck:.6g} / plain {cp:.6g} ({cost_note})", flush=True)
        d_ba = max(d_ba, d, dc)
    # work per LM iteration: per observation the residual and Jacobian
    # (~60 ops), the 21 + 6 block and 9 gradient products (~80), the trial
    # cost (~30); 20 PCG steps of W^T v, W y (~2 x 2 x 2 x 9 ops an
    # observation) and the 3x3 / 6x6 block products; in: problem, out:
    # poses, points, mask, cost
    stats["ba_schur"] = record(
        d_ba, cuda_ms(lambda: sharded_ba.optimize_schur(gprob, cam), reps=5),
        cuda_ms(lambda: sharded_ba.optimize_schur_plain(gprob, cam), reps=2),
        Kb * 50 + Pb * 13 + Ob * 22 + Kb * 48 + Pb * 12 + Ob + 4,
        10 * (Ob * 170 + 20 * (Ob * 72 + Pb * 18 + Kb * 72)))
    return stats


def run_loop(dev, n_kf: int = LOOP_KFS):
    """The LoopCloser over the keyframes of the [loop] map on ``dev`` in
    order until a loop closes, with the reference's thresholds; then
    ``finish``.  Returns the
    map, the closer, the (keyframe, matched keyframe) of each loop closed
    and each keyframe event's host ms."""
    mp, _, desc, centres = looped_map(dev, n_kf)
    voc = vocab_mod.Vocabulary.train(desc, k=8, L=3, seed=0)
    cam = Pinhole.from_config(camera_config(WIDTH, HEIGHT))
    inv_sigma2 = [1.2 ** (-2 * i) for i in range(8)]
    closer = loop_closing.LoopCloser(voc, cam, inv_sigma2=inv_sigma2, device=dev)
    loops, ms = [], []
    for kid in sorted(mp.keyframes):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = closer.process_keyframe(mp, kid)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if got:
            loops.append((kid, mp.keyframes[kid].loop_edges[-1]))
            break   # as tests/test_loop_closing.py: the later return keyframes would close again
    n_gba = closer.n_gba_applied
    closer.finish(mp)
    return mp, closer, loops, ms, centres, closer.n_gba_applied - n_gba


def phase_loop(dev):
    """[loop]: the constructed out-and-back map at full width (24 keyframes,
    ~1000 observed keypoints each, the return pass drifting) through
    ``LoopCloser.process_keyframe`` on the card: exactly one loop, on the
    keyframes the CPU plain path closes, the closing keyframe's centre
    error well under its drift, and the GBA applied at ``finish``.  The
    closer stops at the first loop, as tests/test_loop_closing.py does;
    the return keyframes after it keep the drift they gathered since the
    closing one, which no loop has measured yet."""
    kernels.LAUNCHES.clear()
    mp, closer, loops, ms, centres, n_gba = run_loop(dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _, _, cpu_loops, _, _, _ = run_loop(torch.device("cpu"))
    drift = looped_map(torch.device("cpu"))[0]
    last_id = loops[0][0] if loops else max(mp.keyframes)
    err = lambda kf: float(np.linalg.norm(-kf.R.T @ kf.t - centres[kf.kid]))
    e_after, e_before = err(mp.keyframes[last_id]), err(drift.keyframes[last_id])
    n_kf = len(mp.keyframes)
    want = {"vocab_words": len(ms), "pose_graph": 1, "ba_schur": 1}
    bad = {n: launches.get(n, 0) for n, v in want.items() if launches.get(n, 0) != v}
    bad.update({n: 0 for n in ("sim3_ransac", "sim3_optimize", "hamming_best2_words")
                if not launches.get(n, 0)})
    if len(loops) != 1 or loops != cpu_loops or not e_after < 0.5 * e_before or n_gba != 1 \
            or bad:
        raise AssertionError(f"[loop] loops {loops} (CPU plain path {cpu_loops}), closing keyframe "
                             f"centre error {e_after:.4f} m (drifted {e_before:.4f} m), GBA applied "
                             f"{n_gba}, launches {launches}")
    k = loops[0][0]
    print(f"[loop] {n_kf} keyframes, {int(np.mean([kf.n_kps for kf in mp.keyframes.values()]))} "
          f"keypoints each: one loop at keyframe {k} (matched {loops[0][1]}) after {len(ms)} "
          f"keyframe events, as the CPU plain "
          f"path; its centre error {e_after:.4f} m (drifted {e_before:.4f} m); GBA "
          f"applied at finish", flush=True)
    print(f"[loop] keyframe-event ms (host clock): median {statistics.median(ms):.2f}, loop "
          f"event {ms[k]:.2f}", flush=True)
    print(f"[loop] launches {launches}", flush=True)
    return launches


def merge_config(width: int = WIDTH, height: int = HEIGHT) -> SLAMConfig:
    """[merge]'s configuration: [system]'s with the recovery timing of
    tests/test_loop_from_pixels.py (time_recently_lost 0.05 s) and a
    keyframe every frame (the JAX test's cadence of 2 leaves the
    procedural scene's first map at 9 keyframes when the lens is covered,
    below the 10 an Atlas keeps, so nothing would be left to merge into)."""
    return dataclasses.replace(system_config(width, height),
                               tracking=TrackingConfig(max_frames=MERGE_MAX_FRAMES,
                                                       time_recently_lost=0.05))


def phase_merge(dev):
    """[merge]: ``System(cfg, vocab).track_monocular`` over the 40-frame
    out-and-back sweep with frames 19-28 black and a vocabulary trained
    on the sequence (k=8, L=3): a second Atlas map starts after the
    blackout and place recognition welds it into the first one.  Final
    state OK, one map, n_merges >= 1, ATE within the JAX test's bound."""
    frames, poses = pf.render_loop_sequence(pf.wide_texture(), MERGE_FRAMES, WIDTH, HEIGHT)
    voc = train_vocab(frames, dev)
    events, kf = [], []

    def on_frame(k, st, dt, kf_event, sys_):
        lc_ = sys_.tracker.loop_closer
        events.append((k, st.name, len(sys_.tracker.atlas.maps), lc_.n_merges, dt * 1e3))
        if kf_event:
            kf.append(k)

    kernels.LAUNCHES.clear()
    cfg = merge_config()
    sys_ = System(cfg, vocab=voc, device=dev)
    for k, img in enumerate(pf.blackout(frames, MERGE_BLACK)):
        n_kf = sys_.n_keyframes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sys_.track_monocular(img, k / 30.0)
        torch.cuda.synchronize()
        on_frame(k, st, time.perf_counter() - t0, sys_.n_keyframes() != n_kf, sys_)
    sys_.flush()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr, lc_ = sys_.tracker, sys_.tracker.loop_closer
    ate, _ = pf.trajectory_ate(tr.final_trajectory(), poses)
    merged_at = next((k for k, _, _, n, _ in events if n), None)
    for k, name, n_maps, n_merges, ms in events:
        if k in MERGE_BLACK or abs(k - (merged_at or -9)) <= 1:
            print(f"[merge] frame {k:2d}: {ms:8.2f} ms host clock  {name:15s} {n_maps} map(s)"
                  f"{'  merged' if k == merged_at else ''}", flush=True)
    if events[-1][1] != "OK" or len(tr.atlas.maps) != 1 or lc_.n_merges < 1 or \
            not ate < MERGE_MAX_ATE or launches.get("ba_pcg", 0) != tr.stats["ba"] or \
            any(not launches.get(n, 0) for n in ("vocab_words", "sim3_ransac")):
        raise AssertionError(f"[merge] states {[e[1] for e in events]}, {len(tr.atlas.maps)} "
                             f"maps, {lc_.n_merges} merges, ATE {ate:.4f} m, launches {launches}")
    print(f"[merge] welded at frame {merged_at}: one map of {sys_.n_keyframes()} keyframes, "
          f"{lc_.n_merges} merge(s), final state OK, ATE {ate:.4f} m (bound {MERGE_MAX_ATE})",
          flush=True)
    print(f"[merge] launches {launches}; tracker counts {dict(tr.stats)}", flush=True)
    return launches


def phase_system_vocab(frames, poses, dev, ref_states, ref_n_kf, ref_kf_ms):
    """[system-vocab]: [system] with a vocabulary trained on its frames:
    the same states and keyframes as [system] (no loop fires on a straight
    sweep), K11 once per keyframe the closer saw."""
    kf_ms = []

    def on_frame(k, st, dt, kf, _):
        if kf and k > 2:
            kf_ms.append(dt * 1e3)

    voc = train_vocab(frames, dev)
    sys_ = System(system_config(frames[0].shape[1], frames[0].shape[0]), vocab=voc, device=dev)
    kernels.LAUNCHES.clear()
    states = []
    for k, img in enumerate(frames):
        n_kf = sys_.n_keyframes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states.append(sys_.track_monocular(img, k / 30.0))
        torch.cuda.synchronize()
        on_frame(k, states[-1], time.perf_counter() - t0, sys_.n_keyframes() != n_kf, sys_)
    sys_.flush()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr, lc_ = sys_.tracker, sys_.tracker.loop_closer
    n_seen = len(lc_._words)
    if states != ref_states or sys_.n_keyframes() != ref_n_kf or \
            launches.get("vocab_words", 0) != n_seen or n_seen != tr.atlas.current._next_kf - 2:
        raise AssertionError(f"[system-vocab] states {[s.name for s in states]} vs "
                             f"{[s.name for s in ref_states]}, {sys_.n_keyframes()} keyframes vs "
                             f"{ref_n_kf}, vocab_words {launches.get('vocab_words', 0)} launches for "
                             f"{n_seen} keyframes")
    print(f"[system-vocab] states and {ref_n_kf} keyframes equal to [system]'s; vocab_words "
          f"{launches.get('vocab_words', 0)} launches for {n_seen} keyframes; keyframe-event "
          f"median {statistics.median(kf_ms):.2f} ms with the vocabulary, "
          f"{statistics.median(ref_kf_ms):.2f} ms without (host clock)", flush=True)
    return launches

def main() -> int:
    phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED,
                                               WIDTH, HEIGHT)
    sys_frames, sys_rights, sys_depths, sys_poses = pf.render_stereo_sequence(
        pf.procedural_texture(), SYS_FRAMES, SYS_SPEED, WIDTH, HEIGHT, STEREO_BASELINE)
    step = TrackStep(camera_config(WIDTH, HEIGHT), ORBConfig(n_features=N_FEATURES),
                     (HEIGHT, WIDTH), MAP_CAP, LOCAL_CAP, dev)
    stats = phase_kernel_parity(step, frames[0], dev)
    stats.update(phase_parity_stereo(sys_frames[0], sys_rights[0], sys_depths[0], dev))
    stats.update(phase_parity_k5_k8(sys_frames, sys_poses, dev))
    stats.update(phase_parity_pnp(dev))
    stats.update(phase_parity_loop(sys_frames, train_vocab(sys_frames, dev), dev))
    paths = {}
    results, paths["track"] = phase_main_path(step, frames, depths, poses, dev)
    phase_reference(step, results, frames, depths, poses)
    paths["system"], inits, card_sys, sys_states, sys_kf_ms = phase_system(sys_frames, sys_poses,
                                                                           dev)
    phase_system_reference(sys_frames, inits, card_sys)
    paths["stereo"] = phase_depth_system("stereo", sys_frames, sys_rights, sys_poses, dev)
    paths["rgbd"] = phase_depth_system("rgbd", sys_frames, sys_depths, sys_poses, dev)
    phase_stereo_reference(sys_frames, sys_rights, dev)
    paths["reloc"] = phase_reloc(sys_frames, sys_poses, dev)
    paths["reloc_stereo"] = phase_reloc_stereo(sys_frames, sys_rights, sys_poses, dev)
    paths["recovery"] = phase_recovery(sys_frames, sys_poses, dev)
    paths["resume"] = phase_resume(sys_frames, sys_poses, dev)
    paths["loop"] = phase_loop(dev)
    paths["merge"] = phase_merge(dev)
    paths["system_vocab"] = phase_system_vocab(sys_frames, sys_poses, dev, sys_states,
                                               card_sys.n_keyframes(), sys_kf_ms)
    count = lambda n: {p: l.get(n, 0) for p, l in paths.items()}
    rows = []
    for n, (src, rep) in KERNELS.items():
        by_path = count(n)
        row = dict(name=n, route="cuda", source=src, replaces=rep,
                   launches=sum(by_path.values()), launches_by_path=by_path)
        row.update({k: v for k, v in stats[n].items() if k not in ("bytes", "ops")})
        if n == "pose_lm":
            st = stats["pose_lm_stereo"]
            row.update(stereo_launches=sum(count("pose_lm_stereo").values()),
                       stereo_ms=st["ms"], stereo_plain_ms=st["plain_ms"],
                       stereo_bound_ms=st["bound_ms"], stereo_max_abs_err=st["max_abs_err"])
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
