"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``extractorb_tpu_torch/csrc``,
checks each against its plain PyTorch version at the shapes of the main
path, then drives the monocular tracking step (``TrackStep``) over a
rendered 640x480 sequence with 1000 ORB features and checks the tracked
poses against the scene's truth.  Any failure raises: the script then
exits non-zero and never prints its last line.  It needs a CUDA card and
nothing outside the repository (the scene is generated from a seed).

Output: one line per phase, the card's name and power limit, a JSON line
``{"kernels": [...]}`` with each kernel's launches on the main path,
its largest deviation from the plain version and both times, then the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import port_fixtures as pf  # noqa: E402
from extractorb_tpu_torch import interop, kernels  # noqa: E402
from extractorb_tpu_torch.config import CameraConfig, ORBConfig  # noqa: E402
from extractorb_tpu_torch.frontend import brief, fast, matcher  # noqa: E402
from extractorb_tpu_torch.frontend.pyramid import compute_pyramid  # noqa: E402
from extractorb_tpu_torch.slam.track_device import TrackStep  # noqa: E402
from extractorb_tpu_torch.solver import pose_opt  # noqa: E402

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
}


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
    for _ in range(2):
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
    stats["fast_detect"] = (err, cuda_ms(lambda: fast.fast_detect(pyr, ex.fast_plan)),
                            cuda_ms(lambda: fast.fast_detect_plain(pyr, ex.fast_plan)))
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
    stats["orb_describe"] = (
        d_ang, cuda_ms(lambda: brief.orb_describe(pyr, ex.desc_plan, xy, level, valid)),
        cuda_ms(lambda: brief.orb_describe_plain(pyr, ex.desc_plan, xy, level, valid)))
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
    stats["hamming_best2"] = (
        err, cuda_ms(lambda: matcher.hamming_best2(q, row_ok, c, col_ok, gate)),
        cuda_ms(lambda: matcher.hamming_best2_plain(q, row_ok, c, col_ok, gate)))
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
    stats["pose_lm"] = (d, cuda_ms(lambda: pose_opt.optimize_pose(*args, step.cam)),
                        cuda_ms(lambda: pose_opt.optimize_pose_plain(*args, step.cam)))
    print(f"[parity] pose_lm B={B} N={N}: max |dR|,|dt| {d:.2e}, inliers equal", flush=True)
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


def main() -> int:
    phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED,
                                               WIDTH, HEIGHT)
    step = TrackStep(camera_config(WIDTH, HEIGHT), ORBConfig(n_features=N_FEATURES),
                     (HEIGHT, WIDTH), MAP_CAP, LOCAL_CAP, dev)
    stats = phase_kernel_parity(step, frames[0], dev)
    results, launches = phase_main_path(step, frames, depths, poses, dev)
    phase_reference(step, results, frames, depths, poses)
    rows = [dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n],
                 max_abs_err=stats[n][0], ms=stats[n][1], plain_ms=stats[n][2])
            for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
