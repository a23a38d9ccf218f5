"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels (K1-K8) from
``extractorb_tpu_torch/csrc``, checks each against its plain PyTorch
version at the shapes of the main path, drives the monocular tracking step
(``TrackStep``) over a rendered 640x480 sequence with 1000 ORB features,
then runs ``System.track_monocular`` from a cold map (two-view init, local
mapping, window BA) over a rendered 30-frame sequence, and checks both
against the scene's truth and the CPU plain path.  Any failure raises:
the script then exits non-zero and never prints its last line.  It needs
a CUDA card and nothing outside the repository (the scenes are generated
from a seed).

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
from extractorb_tpu_torch.config import (CameraConfig, ORBConfig, SLAMConfig,  # noqa: E402
                                         TrackingConfig)
from extractorb_tpu_torch.frontend import brief, fast, matcher  # noqa: E402
from extractorb_tpu_torch.frontend.extractor import ORBExtractor  # noqa: E402
from extractorb_tpu_torch.frontend.pyramid import compute_pyramid  # noqa: E402
from extractorb_tpu_torch.geometry import two_view  # noqa: E402
from extractorb_tpu_torch.slam import local_mapping, track_device  # noqa: E402
from extractorb_tpu_torch.slam.system import System  # noqa: E402
from extractorb_tpu_torch.slam.track_device import TrackStep  # noqa: E402
from extractorb_tpu_torch.slam.tracking import TrackState  # noqa: E402
from extractorb_tpu_torch.solver import ba, pose_opt  # noqa: E402
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
}
# the [system] run: the rendered sequence of tests/test_slam_e2e.py's
# planar test at 640x480 / 1000 features, 30 frames at speed 0.04
SYS_FRAMES = 30
SYS_SPEED = 0.04
SYS_FEATURES = 1000


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
    stats["two_view"] = (d, cuda_ms(lambda: two_view.reconstruct(*args), reps=10),
                         cuda_ms(lambda: two_view.reconstruct_plain(*args[:4], args[4].to(dev)),
                                 reps=3))
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
    stats["ba_pcg"] = (d, cuda_ms(lambda: ba.optimize(prob, cam, 12, 40), reps=5),
                       cuda_ms(lambda: ba.optimize_plain(prob, cam, 12, 40), reps=2))
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
    stats["tri_search"] = (rel, cuda_ms(lambda: matcher.tri_search(*targs, geom)),
                           cuda_ms(lambda: matcher.tri_search_plain(*targs, geom), reps=5))
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
    stats["mirror_scatter"] = (0.0, cuda_ms(lambda: track_device.mirror_scatter(
        pk, vk, rows, new_pos, new_val)), cuda_ms(lambda: track_device.mirror_scatter_plain(
            pp_, vp, rows, new_pos, new_val)))
    stats["pack_i32"] = (0.0, cuda_ms(lambda: packed_fetch.pack_i32(leaves)),
                         cuda_ms(lambda: packed_fetch.pack_i32_plain(leaves)))
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


def run_system(frames, dev, on_frame=None, cfg=None):
    """System.track_monocular over ``frames`` (ts = k / 30) from a cold
    map, with ``cfg`` (default: system_config at the frames' size).
    ``on_frame(k, state, seconds, keyframe_event)`` sees each frame."""
    if cfg is None:
        cfg = system_config(frames[0].shape[1], frames[0].shape[0])
    sys_ = System(cfg, device=dev)
    states = []
    for k, img in enumerate(frames):
        n_kf = sys_.n_keyframes()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sys_.track_monocular(img, k / 30.0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        states.append(st)
        if on_frame is not None:
            on_frame(k, st, dt, sys_.n_keyframes() != n_kf)
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

    def on_frame(k, st, dt, kf):
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
    missing = [n for n in KERNELS if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the [system] path: {missing}")
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
    return launches, rec.results, sys_


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


def main() -> int:
    phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED,
                                               WIDTH, HEIGHT)
    sys_frames, _, sys_poses = pf.render_sequence(pf.procedural_texture(), SYS_FRAMES,
                                                  SYS_SPEED, WIDTH, HEIGHT)
    step = TrackStep(camera_config(WIDTH, HEIGHT), ORBConfig(n_features=N_FEATURES),
                     (HEIGHT, WIDTH), MAP_CAP, LOCAL_CAP, dev)
    stats = phase_kernel_parity(step, frames[0], dev)
    stats.update(phase_parity_k5_k8(sys_frames, sys_poses, dev))
    results, _ = phase_main_path(step, frames, depths, poses, dev)
    phase_reference(step, results, frames, depths, poses)
    launches, inits, card_sys = phase_system(sys_frames, sys_poses, dev)
    phase_system_reference(sys_frames, inits, card_sys)
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
