"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels (K1-K36) from
``extractorb_tpu_torch/csrc``, checks each against its plain PyTorch
version at the shapes of the main paths, counts the device kernels and
host time of one extraction through the kernels and through the plain
glue, drives the monocular tracking
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
[system-vocab] repeats [system] with a vocabulary.  Then the
monocular-inertial path: [vi] runs ``System.track_monocular(img, ts,
imu=...)`` over 40 frames of tests/test_vi_e2e.py's analytic trajectory
with 100 Hz IMU samples (IMU initialisation, fused inertial frames, each
one replay of the inertial step's CUDA graph with the frame's K19 window
inside it, local inertial BAs), [graph-vi] runs the same sequence through
that graph and through the eager launches (every step's outputs
bit-equal, both timed), K19-K22 are held to their plain versions on the
eager run's own inputs, and [vi-reference] repeats its frames through the
IMU initialisation on the CPU plain path.  Then the stereo-inertial path and
inertial loop closing: [vi-stereo] runs ``System.track_stereo(l, r, ts,
imu=...)`` over the same scene seen by a rectified rig (the IMU
initialised with a fixed scale, every later frame through the legacy
inertial solve), [vi-stereo-reference] repeats it on the CPU plain path,
[vi-loop] closes a loop on a constructed inertial map (the 4-DoF essential
graph K23, the inertial GBA), and K23 (also on a long session's graph),
K20 on the post-loop GBA, K21's fixed-scale solve and K22's legacy variant
are held to their plain versions on those runs' inputs ([parity]).  Then
pipelined tracking (``tracking.pipeline_depth`` 3): K24, the distorted
camera's undistortion, against its plain version ([parity]), [graph]
holds the tracking step's CUDA graph to the eager step on [track]'s
sequence and times both, [pipelined] runs ``track_monocular`` at depth 3
over [system]'s scene seen through TUM fr1's distorted pinhole (the graph
against the eager step over the whole run, depth 0 beside it),
[pipelined-stereo] / [pipelined-rgbd] run [stereo] / [rgbd] at depth 3
and [pipelined-vi] runs [vi] at depth 3.  Then the KB8 fisheye camera: [parity-kb8] holds K4 and K6 through
the KB8 camera template and K25 (MLPnP's RANSAC and refinement) to their
plain versions, [kb8] runs ``System.track_monocular`` over [system]'s scene
and motion seen through TUM-VI's 512x512 KB8 camera with 1500 features
(init, every later frame OK, ATE), [kb8-reference] repeats its first frames
on the CPU plain path, and [reloc-kb8] blacks out frames 14-15 and
relocalizes through K25.  Then TUM-VI's fisheye stereo rig and KB8 with an
IMU: [parity-stereo-kb8] holds K26 (the lapping-area match and the
triangulation) to its plain version on the rig's frames and on a rig turned
0.8 degrees, [stereo-kb8] runs ``System.track_stereo`` on the rig,
[stereo-kb8-reference] repeats its first frames on the CPU plain path, and
[vi-stereo-kb8] / [vi-kb8] run [vi]'s trajectory through KB8 on the rig
(imu-stereo) and monocular (imu-monocular; [graph-vi] holds its inertial
step graph to the eager launches), holding K20 and K22's KB8
instantiations to their plain versions at their first calls.  Last, loop
closing through the KB8 camera: [loop-kb8] runs [loop] on the constructed
map with its keypoints in TUM-VI's 512x512 KB8 image (every K12 and K14
launch through ``CamKB8``), [parity-loop-kb8] holds K12<KB8> and K14<KB8>
to their plain versions (on a KB8 Sim3 scene, on every K12 and K14 call of
[loop-kb8] and on its map's GBA problem), [merge-kb8] runs [merge] through
the KB8 camera (``System(kb8 cfg, vocab)`` over the sweep seen through
the fisheye) and [vi-loop-kb8] runs [vi-loop] on the KB8 inertial map
(K23, K20<KB8>, K12<KB8>).
Then the demos' path: [parity-clahe] holds K27 (CLAHE) and [parity-grid]
K28 (the frame grid's cell lookup, bucketing and area mask) bit-equal to
their plain versions, and [demos] runs the seven demo mains of
``extractorb_tpu_torch.demos`` on the card at their JAX default budgets,
each with the launch counts set to 0 before it and checked after it.
Last, loop closing over a device mesh (one process driving an ordered list
of devices, ``dist/mesh.py``): [loop-mesh] runs [loop] over 4 shards of
the card (the visible cards when there are more than one) with the
keyframe database's dense backend (K29 once per card and query), the essential
graph edge-sharded (K31) and the GBA over landmark shards (K30), and holds
the loop and the corrected keyframes to [loop]'s one-shard run;
[parity-mesh] holds K29 (also at 1024 keyframes x 65536 words), K30 and
K31 to their plain versions over those shards, and K30 to K14;
[vi-loop-mesh] runs [vi-loop] over the same shards, its inertial GBA over
landmark shards (K32 in place of K20); [mesh-api] calls the mesh's two
functions no engine path calls, ``optimize_sharded`` (K33) on the [loop]
map's problem and ``sharded_loop_candidate_match`` (K34) against its
keyframes; [parity-mesh] holds K32 to its plain version and to K20, K33
and K34 (also at 1024 keyframes x 1024 descriptors) to theirs.  Then the
JAX programs no engine path calls: [ba-stereo] runs
``ba.optimize`` at the window BA's padding (Kp 32 and Kp 64) with the
stereo rows (K6 <stereo>, <stereo, CamKB8>) and ``solver="schur_dense"``
(K35), mono and stereo, pinhole and KB8, each held to its plain version;
[parity-marginal] runs ``condition``, ``marginalize`` and ``sparsify`` (K36)
at n = 9, 30 and 45; [search-api] runs ``fuse_by_projection``,
``search_by_projection_reloc`` and ``search_by_sim3`` (K3, K18) on the
[system] map, bit-equal to the plain path; and [det] counts the distinct
results of 20 calls of K13, K14, K14<KB8>, K29-K33, K35 and K36.
On one card the shards' partial sums meet in one kernel; the peer route
between cards runs only where there are several (``chip_peer.py``).
Any failure raises:
the script then exits non-zero and never prints its last line.  It needs
a CUDA card and nothing outside the repository (the scenes are generated
from a seed).

Output: one line per phase, the card's name and power limit, a JSON line
``{"kernels": [...]}`` with each kernel's launches on the main paths, its
largest deviation from the plain version, its time, the plain version's,
its bound and a library call's time where one computes the same function,
then the last line ``{"ok": true, "device": {...}}``.  Before them
[graph-bounds] gives each step graph's bound (the sum of its kernels')
beside its replay's time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import port_fixtures as pf  # noqa: E402
from extractorb_tpu_torch import interop, kernels  # noqa: E402
from extractorb_tpu_torch.config import (CameraConfig, IMUConfig, ORBConfig,  # noqa: E402
                                         SLAMConfig, TrackingConfig)
from extractorb_tpu_torch.frontend import brief, fast, matcher, stereo  # noqa: E402
from extractorb_tpu_torch.frontend import extractor as fext  # noqa: E402
from extractorb_tpu_torch.frontend.extractor import ORBExtractor  # noqa: E402
from extractorb_tpu_torch.frontend.pyramid import (compute_pyramid,  # noqa: E402
                                                   compute_pyramid_plain)
from extractorb_tpu_torch.geometry import two_view  # noqa: E402
from extractorb_tpu_torch.core.camera import KannalaBrandt8, Pinhole  # noqa: E402
from extractorb_tpu_torch.dist import global_ba, sharded_ba  # noqa: E402
from extractorb_tpu_torch.dist import kf_blocks as kfb  # noqa: E402
from extractorb_tpu_torch.dist import mesh as dmesh  # noqa: E402
from extractorb_tpu_torch.dist import sharded_pose_graph as dpg  # noqa: E402
from extractorb_tpu_torch.geometry import sim3 as gsim3  # noqa: E402
from extractorb_tpu_torch.place import vocab as vocab_mod  # noqa: E402
from extractorb_tpu_torch.slam import checkpoint, local_mapping, loop_closing, track_device  # noqa: E402,E501
from extractorb_tpu_torch.slam import imu_frontend  # noqa: E402
from extractorb_tpu_torch.imu.calib import ImuCalib  # noqa: E402
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap  # noqa: E402
from extractorb_tpu_torch.slam.system import System  # noqa: E402
from extractorb_tpu_torch.slam.track_device import TrackStep  # noqa: E402
from extractorb_tpu_torch.slam.tracking import TrackState  # noqa: E402
from extractorb_tpu_torch.imu import preintegration as preint_mod  # noqa: E402
from extractorb_tpu_torch.solver import ba, pnp, pose_graph, pose_opt  # noqa: E402
from extractorb_tpu_torch.solver import inertial as sin  # noqa: E402
from extractorb_tpu_torch.solver import marginal as mg  # noqa: E402
from extractorb_tpu_torch.utils import packed_fetch  # noqa: E402

WIDTH, HEIGHT = 640, 480
N_FEATURES = 1000
MAP_CAP = 32768      # MapMirror.LADDER[0] of the JAX package
LOCAL_CAP = 4096     # the tracker's local-block capacity
N_FRAMES = 13
SPEED = 0.06
# the extraction kernels (K15, K1, K16, K17, K2) run once per extraction
# (frame 0 and every step), K3 five times, K18 three times (after the two
# last-frame searches and the local-map search) and K4 twice per step
EXTRACT_KERNELS = ("pyramid", "fast_detect", "kp_collect", "octree_select", "orb_describe")
PER_STEP = {**{n: 1 for n in EXTRACT_KERNELS}, "hamming_best2": 5, "match_epilogue": 3,
            "pose_lm": 2}
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
    "pyramid": ("extractorb_tpu_torch/csrc/pyramid.cu", "extractorb_tpu/frontend/pyramid.py:118"),
    "kp_collect": ("extractorb_tpu_torch/csrc/kp_collect.cu",
                   "extractorb_tpu/frontend/fast.py:187"),
    "octree_select": ("extractorb_tpu_torch/csrc/octree_select.cu",
                      "extractorb_tpu/frontend/octree.py:202"),
    "match_epilogue": ("extractorb_tpu_torch/csrc/match_epilogue.cu",
                       "extractorb_tpu/frontend/matcher.py:54"),
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
# the monocular-inertial path adds these
INERTIAL_KERNELS = ("preint", "vi_ba", "inertial_init", "pose_inertial")
KERNELS.update({
    "preint": ("extractorb_tpu_torch/csrc/preint.cu", "extractorb_tpu/imu/preintegration.py:53"),
    "vi_ba": ("extractorb_tpu_torch/csrc/vi_ba.cu", "extractorb_tpu/solver/inertial.py:231"),
    "inertial_init": ("extractorb_tpu_torch/csrc/inertial_init.cu",
                      "extractorb_tpu/solver/inertial.py:422"),
    "pose_inertial": ("extractorb_tpu_torch/csrc/pose_inertial.cu",
                      "extractorb_tpu/solver/inertial.py:532"),
    # the inertial loop-closing path adds this
    "pose_graph_4dof": ("extractorb_tpu_torch/csrc/pose_graph_4dof.cu",
                        "extractorb_tpu/solver/pose_graph.py:68"),
    # the distorted camera's step (the [pipelined] path) adds this
    "undistort": ("extractorb_tpu_torch/csrc/undistort.cu", "extractorb_tpu/core/camera.py:151"),
    # the KB8 camera's relocalization (the [reloc-kb8] path) adds these
    "mlpnp_ransac": ("extractorb_tpu_torch/csrc/mlpnp.cu", "extractorb_tpu/solver/pnp.py:275"),
    "mlpnp_refine": ("extractorb_tpu_torch/csrc/mlpnp.cu", "extractorb_tpu/solver/pnp.py:306"),
    # the fisheye rig (the [stereo-kb8] and [vi-stereo-kb8] paths) adds K26
    "stereo_fisheye_match": ("extractorb_tpu_torch/csrc/stereo_fisheye.cu",
                             "extractorb_tpu/frontend/stereo.py:182 (+ :170 lapping_mask)"),
    "fisheye_triangulate": ("extractorb_tpu_torch/csrc/stereo_fisheye.cu",
                            "extractorb_tpu/core/camera.py:174"),
    # the demos (the [demos] path) add K27 and K28
    "clahe": ("extractorb_tpu_torch/csrc/clahe.cu", "extractorb_tpu/utils/clahe.py:22"),
    "grid_pos": ("extractorb_tpu_torch/csrc/grid.cu", "extractorb_tpu/frontend/grid.py:31"),
    "grid_assign": ("extractorb_tpu_torch/csrc/grid.cu", "extractorb_tpu/frontend/grid.py:59"),
    "grid_area": ("extractorb_tpu_torch/csrc/grid.cu", "extractorb_tpu/frontend/grid.py:96"),
    # loop closing over a device mesh (the [loop-mesh] path) adds K29-K31
    "place_dense": ("extractorb_tpu_torch/csrc/place_dense.cu",
                    "extractorb_tpu/dist/kf_blocks.py:39"),
    "ba_schur_sharded": ("extractorb_tpu_torch/csrc/ba_schur.cu + shard_sum.cuh",
                         "extractorb_tpu/dist/sharded_ba.py:258 (more than one shard)"),
    "pose_graph_sharded": ("extractorb_tpu_torch/csrc/pose_graph.cu + shard_sum.cuh",
                           "extractorb_tpu/dist/sharded_pose_graph.py:27"),
    # the inertial loop closer over a device mesh (the [vi-loop-mesh] path) adds K32, and
    # the mesh's two functions no engine path calls (the [mesh-api] path) K33 and K34
    "vi_ba_sharded": ("extractorb_tpu_torch/csrc/vi_ba.cu + shard_sum.cuh",
                      "extractorb_tpu/dist/sharded_ba.py:589"),
    "ba_pcg_sharded": ("extractorb_tpu_torch/csrc/ba_pcg.cu + shard_sum.cuh",
                       "extractorb_tpu/dist/sharded_ba.py:40"),
    "kf_match": ("extractorb_tpu_torch/csrc/kf_match.cu", "extractorb_tpu/dist/kf_blocks.py:98"),
    # the window BA's dense solver and the marginal toolbox (the [ba-stereo] and
    # [parity-marginal] paths) add K35 and K36; K6 <stereo> is the ba_pcg row's
    "ba_schur_dense": ("extractorb_tpu_torch/csrc/ba_schur_dense.cu",
                       "extractorb_tpu/solver/ba.py:215"),
    "marginal": ("extractorb_tpu_torch/csrc/marginal.cu",
                 "extractorb_tpu/solver/marginal.py:23 (+ :52 condition, :63 sparsify)"),
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
# the [vi] run: tests/test_vi_e2e.py's 40 frames at 10 fps, 100 Hz IMU, and
# its bounds on the metric scale and the ATE
VI_FRAMES = 40
VI_MAX_SCALE_ERR = 0.35
VI_MAX_ATE = 0.25
# the [vi-stereo] run: [vi]'s scene and length seen by [stereo]'s rig; the
# rig fixes the metric scale, so its bound on |s - 1| is 0.05
VI_STEREO_FRAMES = 40
VI_STEREO_MAX_SCALE_ERR = 0.05
# the pipelined runs (tracking.pipeline_depth 3, JAX bench.py:353): [system]'s
# scene seen through TUM fr1's distorted pinhole (pf.FR1_DIST) for the mono
# run; the bounds of the JAX package's pipelined tests
# (tests/test_pipelined.py:60, tests/test_slam_stereo_rgbd.py:227,257)
PIPE_DEPTH = 3
PIPE_MAX_ATE = 0.15
PIPE_STEREO_BOUNDS = {"stereo": (0.15, 0.07), "rgbd": (0.1, 0.06)}
PIPE_VI_MIN_FUSED = 8   # tests/test_vi_e2e.py:219
# the [kb8] runs: [system]'s scene and motion seen through TUM-VI's 512x512
# KB8 fisheye (pf.kb8_camera), 1500 features (the JAX package's TUM-VI run,
# tests/test_real_sequences.py:141; ORB-SLAM3 Examples/Monocular/TUM_512.yaml)
KB8_SIZE = 512
KB8_FEATURES = 1500
# the fisheye rig of [stereo-kb8] and [vi-stereo-kb8]: TUM-VI's 0.101 m
# baseline and ThDepth 35 (tests/test_stereo_fisheye.py:135-143)
KB8_BASELINE = 0.101
KB8_TH_DEPTH = 35.0
# [vi-stereo-kb8] and [vi-kb8]: [vi]'s trajectory, shortened to the frames
# that reach the monocular IMU initialisation (2 s) and a second after it
VI_KB8_FRAMES = 32
# the [det] phase: calls of K13, K14, K29-K33, K35 and K36 on one input
DET_CALLS = 20
# [parity-mesh] / [loop-mesh]: the shards of one card (or the visible cards,
# when there are more than one); K29 also at an ORBvoc-scale dense block of
# 1024 keyframes over 65536 words (its largest dense vocabulary), ~1000
# words a keyframe
MESH_SHARDS = 4
PLACE_K, PLACE_W, PLACE_NNZ = 1024, 65536, 1000
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


def paired_ms(fa, fb, reps: int = 50):
    """Median CUDA-event times of ``fa`` and ``fb``, timed in turns (a, b, b,
    a, ...) after a warm-up of each, so drifts of the host's speed fall on
    both alike."""
    for fn in (fa, fb):
        fn()
        fn()
    times = ([], [])
    for i in range(reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            (fa, fb)[j]()
            b.record()
            b.synchronize()
            times[j].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def timed(fn):
    """``fn()``'s result and the CUDA-event time of that one call (no
    warm-up: for plain versions that take seconds)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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


def parity_extract_glue(ex: ORBExtractor, frame: np.ndarray, dev) -> dict:
    """K15, K16 and K17 against their plain versions at the main path's
    shapes (640x480, 1000 features): the pyramid, every level's candidates,
    the quadtree depths, the compacted and the packed slots, all
    bit-equal; then the Features of the extractor on the card against the
    CPU plain path's.  On the rendered frame, a noise frame (kept pixels far
    above k on every level) and a black one (no kept pixel: depth 7).  Then
    K18 on the last-frame search's shape, both claim rules with and without
    the rotation filter."""
    rng = np.random.default_rng(5)
    cpu = ORBExtractor(ex.cfg, frame.shape, "cpu")
    images = {"rendered": frame, "noise": rng.integers(0, 256, frame.shape).astype(np.uint8),
              "black": np.zeros_like(frame)}
    for name, im in images.items():
        img = torch.from_numpy(im).to(dev)
        pk, pp = compute_pyramid(img, ex.pyr_plan), compute_pyramid_plain(img, ex.pyr_plan)
        if not torch.equal(pk.flat, pp.flat):
            raise AssertionError(f"pyramid ({name}): differs from the plain version")
        keeps, scores = fast.fast_detect(pk, ex.fast_plan)
        ck = fast.collect_levels(keeps, scores, ex.collect_plan)
        cp = fast.collect_levels_plain(keeps, scores, ex.collect_plan)
        if not all(torch.equal(a, b) for a, b in zip(ck, cp)):
            raise AssertionError(f"kp_collect ({name}): differs from the plain version")
        sk, sp = fext.select_keypoints(*cp, ex), fext.select_keypoints_plain(*cp, ex)
        bad = [f for f, a, b in zip(sk._fields, sk, sp) if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"octree_select ({name}): {bad} differ from the plain version")
        fk, fc = ex(img), cpu(torch.from_numpy(im))
        bad = [f.name for f in dataclasses.fields(fk)
               if not torch.equal(getattr(fk, f.name).cpu(), getattr(fc, f.name))]
        if bad:
            raise AssertionError(f"extractor ({name}): {bad} differ from the CPU plain path")
        print(f"[parity] {name} frame: pyramid, candidates ({int(cp[2].sum())} valid of "
              f"{cp[2].numel()}), quadtree depths {sk.depth.tolist()}, compacted and packed "
              f"slots bit-equal; Features ({int(fk.valid.sum())} valid) equal to the CPU plain "
              f"path's", flush=True)

    stats = {}
    img = torch.from_numpy(frame).to(dev)
    pyr = compute_pyramid(img, ex.pyr_plan)
    keeps, scores = fast.fast_detect(pyr, ex.fast_plan)
    cand = fast.collect_levels(keeps, scores, ex.collect_plan)
    # K15: the image in, every bordered level out once; ~20 integer
    # operations per output pixel (reflect, 8 table reads, 4 taps)
    px = pyr.flat.numel()
    stats["pyramid"] = record(0.0, cuda_ms(lambda: compute_pyramid(img, ex.pyr_plan)),
                              cuda_ms(lambda: compute_pyramid_plain(img, ex.pyr_plan)),
                              img.numel() + px, 20 * px)
    # K16: keep + score planes in (3 bytes a pixel), xy/resp/valid out; three
    # passes of ~8 operations a pixel (the order of the k taken keys is the
    # kernel's placement by rank, not counted).  The library yardstick:
    # torch.topk of every level's key (built beforehand)
    plan = ex.collect_plan
    n_inner = sum(k.numel() for k in keeps)
    keys = [torch.where(k, s.to(torch.int32), -1).reshape(-1) * (1 << 21)
            + ((1 << 21) - 1 - torch.arange(k.numel(), dtype=torch.int32, device=dev))
            for k, s in zip(keeps, scores)]
    stats["kp_collect"] = record(
        0.0, cuda_ms(lambda: fast.collect_levels(keeps, scores, plan)),
        cuda_ms(lambda: fast.collect_levels_plain(keeps, scores, plan)),
        3 * n_inner + plan.total * 13, 24 * n_inner,
        library_ms=cuda_ms(lambda: [torch.topk(k, n) for k, n in zip(keys, plan.k_levels)]))
    # K17: candidates in (13 bytes), the packed slots out (xy, octave,
    # valid, xy_f, response, size: 29 bytes); ~40 operations a candidate
    # (its cell at 8 depths, the occupied cells, the cell argmax, the top
    # cap_l cut).  The per-level slots and depths are the kernel's own
    # intermediates and no sort is needed, so neither is counted
    sp = ex.select_plan
    stats["octree_select"] = record(
        0.0, cuda_ms(lambda: fext.select_keypoints(*cand, ex)),
        cuda_ms(lambda: fext.select_keypoints_plain(*cand, ex)),
        13 * sp.n_cand + 29 * sp.n_out, 40 * sp.n_cand)
    print(f"[parity] pyramid {ex.pyr_plan.total} B, kp_collect {plan.total} slots, "
          f"octree_select {sp.n_lvl_slots} -> {sp.n_out} slots: timed on the rendered frame",
          flush=True)

    # K18: 1128 rows x 1128 keypoints, 70% accepted, colliding columns,
    # angles on exact bin halves and just under 360
    M = N = sp.n_out
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    best = t(rng.integers(0, 60, M), torch.int32)
    best_idx = t(rng.integers(0, N // 3, M), torch.int32)
    accept = t(rng.random(M) < 0.7, torch.bool)
    a1 = t(np.where(rng.random(M) < 0.3, rng.choice([15.0, 45.0, 359.99997, 0.0], M),
                    rng.uniform(0, 360, M)), torch.float32)
    a2 = t(rng.uniform(0, 360, N), torch.float32)
    for by_distance in (False, True):
        for rot in ((), (a1, a2)):
            args = (best, best_idx, accept, N, by_distance, *rot)
            if not torch.equal(matcher.match_epilogue(*args), matcher.match_epilogue_plain(*args)):
                raise AssertionError(f"match_epilogue (by_distance {by_distance}, rotation "
                                     f"{bool(rot)}): differs from the plain version")
    args = (best, best_idx, accept, N, False, a1, a2)
    stats["match_epilogue"] = record(
        0.0, cuda_ms(lambda: matcher.match_epilogue(*args)),
        cuda_ms(lambda: matcher.match_epilogue_plain(*args)), M * 17 + N * 4, 30 * M)
    print(f"[parity] match_epilogue {M}x{N}: both claim rules, with and without the rotation "
          f"filter, equal to the plain version", flush=True)
    return stats


def extract_plain_glue(ex: ORBExtractor, img: torch.Tensor):
    """One extraction through the plain versions of K15-K17, composed as
    the kernels are: the plain pyramid, K1, the plain collection,
    quadtree, compaction and pack, then K2 on the packed slots."""
    pyr = compute_pyramid_plain(img, ex.pyr_plan)
    keeps, scores = fast.fast_detect(pyr, ex.fast_plan)
    sel = fext.select_keypoints_plain(*fast.collect_levels_plain(keeps, scores, ex.collect_plan),
                                      ex)
    return brief.orb_describe(pyr, ex.desc_plan, sel.xy, sel.octave, sel.valid)


def device_events(fn):
    """The names of the device events of one call of ``fn`` (after a warm-up
    call) in a ``torch.profiler`` trace, and how many are kernels (copies
    and fills apart)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names, sum(1 for e in names if not e.startswith(("Memcpy", "Memset")))


# the calls trace_fresh can make, by name: (args, kwargs) -> the call
TRACE_CALLS = {
    "vi_ba": lambda prob, cam, it, cg: sin.optimize_vi_ba(prob, cam, n_iters=it, cg_iters=cg),
    "vi_ba_passes": lambda prob, cam, it, cg: sharded_ba.optimize_vi_sharded(
        dmesh.Mesh([prob.points.device]), prob, cam, n_iters=it, cg_iters=cg),
    "pose_lm": lambda *args, **kw: pose_opt.optimize_pose(*args, **kw),
    "ba_pcg": lambda prob, cam, it, cg: ba.optimize(prob, cam, n_iters=it, cg_iters=cg),
    "ba_pcg_passes": lambda prob, cam, it, cg: sharded_ba.optimize_sharded(
        dmesh.Mesh([prob.points.device]), prob, cam, it, cg),
    "extract_glue": lambda ex, img: extract_plain_glue(ex, img),
    "extract_kernels": lambda ex, img: ex(img),
}


def port_kernel(name: str) -> bool:
    """A device event of one of the port's own kernels (csrc/*.cu): not a
    copy, a fill or one of PyTorch's kernels (the wrappers' glue)."""
    return not name.startswith(("Memcpy", "Memset")) and "at::" not in name


def trace_main(path: str) -> int:
    """``chip_smoke.py --trace PATH``: each call of the dict saved at PATH
    ({label: (TRACE_CALLS name, args, kwargs)}) once to warm up, then once
    in each of four ``torch.profiler`` traces.  The profiler on the card
    drops a device event now and then, never adds one, so the trace with
    the most device events stands for the call.  Prints one JSON object
    {label: [the port's kernels of the call, their device ms, the other
    device events, the kernels (copies and fills apart), the device
    events]}."""
    calls = torch.load(path, weights_only=False)
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (name, args, kw) in calls.items():
        fn = lambda: TRACE_CALLS[name](*args, **kw)
        fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(4):
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            mine = [e for e in evs if port_kernel(e.name)]
            kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
            ms = sum(getattr(e, "device_time", getattr(e, "cuda_time", 0.0)) for e in mine) / 1e3
            rec = [len(mine), ms, len(evs) - len(mine), len(kern), len(evs)]
            if best is None or rec[4] > best[4]:
                best = rec
        out[label] = best
    print(json.dumps(out), flush=True)
    return 0


# the calls the run traces at its end: (label, call, what to do with its
# trace_main record)
PENDING_TRACES = []


def trace_later(label: str, call: tuple, on_result) -> None:
    PENDING_TRACES.append((label, call, on_result))


def run_traces() -> None:
    """Every pending call traced by one fresh process (trace_fresh), each
    result handed to its callback."""
    out = trace_fresh({label: call for label, call, _ in PENDING_TRACES})
    for label, _, on_result in PENDING_TRACES:
        on_result(out[label])
    PENDING_TRACES.clear()


def trace_fresh(calls: dict) -> dict:
    """``trace_main`` on ``calls`` in a fresh process on the same card: a
    profiler in this long process drops device events (chip_anatomy.py's
    K29 note), a new one sees them all.  Returns {label: trace_main's
    record}; raises if a trace saw no device event."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "calls.pt")
        torch.save(calls, path)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace", path],
                           capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"trace_fresh: the tracing process failed:\n{r.stderr[-3000:]}")
    out = {k: tuple(v) for k, v in json.loads(r.stdout.strip().splitlines()[-1]).items()}
    if not all(v[4] > 0 for v in out.values()):
        raise AssertionError(f"trace_fresh: a call with no device event traced: {out}")
    return out


def phase_extract_launches(ex: ORBExtractor, frame: np.ndarray, dev) -> dict:
    """The host-clock median of one 640x480 extraction over 20 calls ending
    in a synchronise, and at the run's end its device kernels (a fresh
    process's profiler trace, copies and fills apart): through the plain
    glue and through the kernels."""
    img = torch.from_numpy(frame).to(dev)
    runs = {"plain glue": ("extract_glue", lambda: extract_plain_glue(ex, img)),
            "kernels": ("extract_kernels", lambda: ex(img))}
    out = {}
    for name, (call, fn) in runs.items():
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(host_ms=statistics.median(host), events_ms=cuda_ms(fn))
        print(f"[extract] {name}: host clock median {out[name]['host_ms']:.3f} ms, CUDA events "
              f"{out[name]["events_ms"]:.3f} ms an extraction", flush=True)

        def counted(trace, name=name):
            out[name].update(kernels=trace[3], device_events=trace[4])
            print(f"[extract] {name}: {trace[3]:g} device kernels ({trace[4]:g} device events) "
                  "per extraction", flush=True)
            if name == "kernels" and out["kernels"]["kernels"] >= out["plain glue"]["kernels"]:
                raise AssertionError(f"extraction launches {out}")
        trace_later(f"extract {name}", (call, (ex, img), {}), counted)
    return out


class _EpilogueRecorder:
    """Wraps matcher.match_epilogue (K18) to keep every call's inputs and
    output; ``check`` then holds each against the plain version."""

    def __init__(self):
        self.calls = []
        self._orig = matcher.match_epilogue

    def __enter__(self):
        def rec(*args, **kw):
            out = self._orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out
        matcher.match_epilogue = rec
        return self

    def __exit__(self, *exc):
        matcher.match_epilogue = self._orig

    def check(self, tag: str):
        for args, kw, out in self.calls:
            if not torch.equal(out, matcher.match_epilogue_plain(*args, **kw)):
                raise AssertionError(f"{tag} match_epilogue differs from the plain version")
        n = sum(int((out >= 0).sum()) for _, _, out in self.calls)
        print(f"{tag} match_epilogue: all {len(self.calls)} searches equal to the plain "
              f"version ({n} matches)", flush=True)


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

    # K2: the frame's selected keypoints of all levels, packed; descriptors
    # bit-equal, angles within 1e-4 deg
    sel = ex.keypoints(pyr)
    xy, valid, level = sel.xy, sel.valid, sel.octave
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
    stats.update(parity_extract_glue(ex, frame, dev))

    # K3: the local-map search shape (4096 map points x 1128 keypoints)
    # with windows and level ranges (the box route's grid), the same with
    # the grid's edge cases, the last-frame search at th 30 (windows up to
    # 108 px), and the open-gate mutual-match shape (the dense route)
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
    edge = gate._replace(u=gate.u.clone(), r=gate.r.clone(), lo=gate.lo.clone(),
                         hi=gate.hi.clone(), x=gate.x.clone(), y=gate.y.clone())
    nan, inf = float("nan"), float("inf")
    edge.x[:4] = t([nan, inf, -inf, 1e4], torch.float32)   # columns that never pass / far out
    edge.y[4:6] = t([nan, -inf], torch.float32)
    edge.r[:8] = t([0.0, inf, inf, nan, -1.0, inf, 0.0, inf], torch.float32)
    edge.u[8:10] = nan
    edge.lo[:8], edge.hi[:8] = -1, 9
    # windows whose right edge lies on a column, or an ulp inside or outside
    j = torch.arange(16, 16 + 64, device=dev)
    ex = edge.u[16:80] + edge.r[16:80]
    edge.x[j] = torch.where(j % 3 == 0, ex, torch.nextafter(ex, torch.where(
        j % 3 == 1, torch.full_like(ex, -inf), torch.full_like(ex, inf))))
    edge.y[j] = gate.v[16:80]
    th30 = matcher.Gate(gate.u[:N], gate.v[:N], 30.0 * t(np.float32(1.2) ** rng.integers(
        0, 4, N).astype(np.float32), torch.float32), lo[:N] - 1, lo[:N] + 1, gate.x, gate.y,
        gate.octave)
    cases = [("local-map", (q, row_ok, c, col_ok, gate)),
             ("local-map edge cases", (q, row_ok, c, col_ok, edge)),
             ("last-frame th 30", (q[:N], row_ok[:N], c, col_ok, th30)),
             ("open gate", (c, col_ok, c.flip(0).contiguous(), col_ok, None))]
    err = 0.0
    for case, (qd, rk, cd, ck, g) in cases:
        rk_ = matcher.hamming_best2(qd, rk, cd, ck, g)
        rp_ = matcher.hamming_best2_plain(qd, rk, cd, ck, g)
        for name, a, b in zip(rk_._fields, rk_, rp_):
            err = max(err, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"hamming_best2 ({case}): {name} differs from the plain "
                                     "version")
    # work the box route needs: the grid over the columns once (bounding
    # box, cell, count and place, ~30 ops a column), a row's window's cells
    # (~20 ops a row), and XOR + popcount + top-2 insert (~20 ops) per pair
    # inside the gate; the gate tests of the pairs it does not admit depend
    # on the grid and are not counted
    n_gate = int(matcher._gate_mask(gate, row_ok, col_ok).sum())
    stats["hamming_best2"] = record(
        err, cuda_ms(lambda: matcher.hamming_best2(q, row_ok, c, col_ok, gate)),
        cuda_ms(lambda: matcher.hamming_best2_plain(q, row_ok, c, col_ok, gate)),
        M * (32 + 21) + N * (32 + 13) + 4 * M * 4, 30 * N + 20 * M + 20 * n_gate)
    dense_ms = cuda_ms(lambda: matcher.hamming_best2(*cases[-1][1]))
    print(f"[parity] hamming_best2 ({', '.join(k for k, _ in cases)}): all outputs bit-equal; "
          f"{stats['hamming_best2']['ms']:.4f} ms at {M}x{N} (box route), {dense_ms:.4f} ms at "
          f"{N}x{N} (dense route)", flush=True)

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
    print(f"[parity] pose_lm B={B} N={N}: max |dR|,|dt| {d:.2e}, inliers equal; "
          f"{stats['pose_lm']['ms']:.4f} ms a call (CUDA events)", flush=True)
    trace_later("pose_lm", ("pose_lm", (*args, step.cam), {}), lambda r: device_note(
        stats["pose_lm"], r, f"pose_lm B={B} N={N}"))
    return stats


def pose_lm_work(B: int, N: int, n_valid: int, stereo_rows: bool):
    """Bytes and operations of B pose problems of N slots: inputs (poses,
    points, pixels, inv_sigma2, valid[, ur]) and outputs once; per valid
    observation and LM iteration (4 x 10) ~200 operations for the residual,
    Jacobian, normal-equation sums and the trial cost (~260 with the
    stereo row)."""
    nbytes = B * (48 + 4 + 48) + B * N * (12 + 8 + 4 + 1 + 1 + (4 if stereo_rows else 0))
    return nbytes, 40 * (260 if stereo_rows else 200) * n_valid


def phase_pose_lm_global(dev) -> dict:
    """K4 above its staging limit, one problem mono and one with the stereo
    u: the global route (the problem staged in device memory) against the
    plain version, within 1e-4 with the inliers equal, one launch each."""
    stats = {}
    K = pf.camera_matrix(WIDTH, HEIGHT)
    cam = track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    bf = float(cam.fx) * STEREO_BASELINE
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    for stereo in (False, True):
        n = pose_opt.pose_lm_max_n(stereo, dev) + 500
        R0, t0, pts, obs, isig, val, (Rt, tt) = pf.synthetic_pose_problems(
            np.random.default_rng(6), 1, n, cam.fx, cam.fy, cam.cx, cam.cy)
        args = [t(a) for a in (R0, t0, pts, obs, isig)] + [t(val, torch.bool)]
        kw = {}
        if stereo:
            z = np.einsum("bij,bnj->bni", Rt, pts)[..., 2] + tt[:, None, 2]
            kw = dict(obs_ur=t(np.where(np.arange(n) % 3 != 0, obs[..., 0] - bf / z, -1.0)),
                      bf=bf)
        before = kernels.LAUNCHES["pose_lm_global"]
        gk = pose_opt.optimize_pose(*args, cam, **kw)
        launched = kernels.LAUNCHES["pose_lm_global"] - before
        gp = pose_opt.optimize_pose_plain(*args, cam, **kw)
        d = max(float((gk.R - gp.R).abs().max()), float((gk.t - gp.t).abs().max()))
        tag = "stereo" if stereo else "mono"
        if d > 1e-4 or not torch.equal(gk.inliers, gp.inliers) or launched != 1:
            raise AssertionError(f"pose_lm global route {tag} N={n}: pose error {d:.2e}, inliers "
                                 f"equal {torch.equal(gk.inliers, gp.inliers)}, {launched} "
                                 "launches of the route")
        stats[tag] = dict(n=n, max_abs_err=d, ms=cuda_ms(
            lambda: pose_opt.optimize_pose(*args, cam, **kw), reps=5))
        print(f"[parity] pose_lm {tag} B=1 N={n}, above the staging limit: the global route "
              f"within {d:.2e} of plain, inliers equal ({int(gk.n_inliers[0])}); "
              f"{stats[tag]['ms']:.4f} ms a call", flush=True)
    return stats


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
          f"observations): max |dR|,|dt| {d:.2e}, inliers equal; "
          f"{stats['pose_lm_stereo']['ms']:.4f} ms a call", flush=True)
    trace_later("pose_lm_stereo", ("pose_lm", (*pargs, cam), dict(obs_ur=ur, bf=bf)),
                lambda r: device_note(stats["pose_lm_stereo"], r, f"pose_lm stereo B=2 N={NL}"))
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
    with _EpilogueRecorder() as epi:
        results = track_sequence(step, frames, depths, poses, pf.true_pose(-1, SPEED), dev,
                                 timer)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    epi.check("[track]")
    n_steps = len(frames) - 1
    for name, per in PER_STEP.items():
        want = per * n_steps + (1 if name in EXTRACT_KERNELS else 0)
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


def phase_graph_vs_eager(frames, depths, poses, dev) -> dict:
    """[graph]: [track]'s sequence through a TrackStep with its CUDA graph
    and through one with the eager launches: every output bit-equal, and
    each step's CUDA-event and host-clock time (frames 3.. are replays)."""
    runs = {}
    for graph in (None, False):
        st = TrackStep(camera_config(WIDTH, HEIGHT), ORBConfig(n_features=N_FEATURES),
                       (HEIGHT, WIDTH), MAP_CAP, LOCAL_CAP, dev, graph=graph)
        ev, host = [], []

        def timer(fn):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append((a, b))
            return out

        res = track_sequence(st, frames, depths, poses, pf.true_pose(-1, SPEED), dev, timer)
        runs[graph] = (st, res, [a.elapsed_time(b) for a, b in ev], host)
    (sg, rg, evg, hg), (_, re_, eve, he) = runs[None], runs[False]
    for k, (a, b) in enumerate(zip(rg, re_), start=1):
        diff = [n for n in a if not np.array_equal(a[n], b[n])]
        if diff:
            raise AssertionError(f"[graph] step {k}: {diff} differ from the eager step's")
    g = sg.graph
    med = lambda v: statistics.median(v[2:])
    out = dict(ms=med(evg), plain_ms=med(eve), host_ms=med(hg), plain_host_ms=med(he),
               kernel_nodes=g.kernel_nodes, nodes=g.nodes, replays=g.n_replays,
               wrapper_launches=dict(g.launches))
    print(f"[graph] TrackStep as one CUDA graph ({g.kernel_nodes} kernel nodes of {g.nodes}, "
          f"{sum(g.launches.values())} kernel-wrapper launches captured): all outputs of "
          f"{len(rg)} steps bit-equal to the eager step's; median of frames 3-{len(rg)}: "
          f"{out['ms']:.3f} ms events / {out['host_ms']:.3f} ms host per replay, eager "
          f"{out['plain_ms']:.3f} / {out['plain_host_ms']:.3f} ms", flush=True)
    print("[graph] " + json.dumps(out), flush=True)
    return out


def _variant(name: str) -> bool:
    """A wrapper counter that counts some of another counter's launches
    (K4's stereo or KB8 problems, K22's joint or KB8 ones)."""
    return name.endswith(("_kb8", "_stereo")) or name == "pose_inertial_joint"


def phase_graph_bounds(stats, graphs) -> dict:
    """Each step graph's bound: the sum, over the kernels one replay
    launches, of their bounds at [parity]'s shapes (K19 at the fused
    frame's window, K22 its joint variant; K4 and K22 through KB8 for a KB8
    graph), beside its replay's CUDA-event ms and the eager step's.
    ``graphs``: {tag: ([graph] / [graph-vi]'s numbers, kb8)}."""
    out = {}
    for tag, (g, kb8) in graphs.items():
        parts = {}
        for name, n in g["wrapper_launches"].items():
            if _variant(name):
                continue
            key = "pose_inertial_joint" if name == "pose_inertial" else name
            if kb8 and f"{key}_kb8" in stats:
                key = f"{key}_kb8"
            b = (stats["preint"]["frame_window"]["bound_ms"] if name == "preint"
                 else stats[key]["bound_ms"])
            parts[key] = n * b
        out[tag] = dict(bound_ms=sum(parts.values()), ms=g["ms"], plain_ms=g["plain_ms"],
                        kernel_nodes=g["kernel_nodes"], parts=parts)
        print(f"[graph-bounds] {tag}: bound {out[tag]['bound_ms']:.5f} ms (the sum of its "
              f"kernels' bounds), replay {g['ms']:.3f} ms, eager {g['plain_ms']:.3f} ms",
              flush=True)
    print("[graph-bounds] " + json.dumps(out), flush=True)
    return out


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


def vi_config(width: int = WIDTH, height: int = HEIGHT,
              n_features: int = SYS_FEATURES) -> SLAMConfig:
    """The monocular-inertial configuration of [vi] (tests/test_vi_e2e.py's
    _vi_cfg): 10 fps, a 100 Hz IMU with the noise of the simulator, a
    keyframe every 3 frames at most."""
    return SLAMConfig(orb=ORBConfig(n_features=n_features),
                      camera=dataclasses.replace(camera_config(width, height), fps=pf.VI_FPS),
                      imu=IMUConfig(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6,
                                    acc_walk=1e-5, frequency=pf.VI_IMU_HZ),
                      tracking=TrackingConfig(max_frames=3), sensor="imu-monocular")


def vi_stereo_config(width: int = WIDTH, height: int = HEIGHT,
                     n_features: int = SYS_FEATURES) -> SLAMConfig:
    """The stereo-inertial configuration of [vi-stereo]: [vi]'s with the
    rig of [stereo] (bf = fx x 0.1, ThDepth 40) and sensor imu-stereo."""
    cfg = vi_config(width, height, n_features)
    cam = dataclasses.replace(cfg.camera, bf=cfg.camera.fx * STEREO_BASELINE,
                              th_depth=STEREO_TH_DEPTH)
    return dataclasses.replace(cfg, camera=cam, sensor="imu-stereo")


def run_vi(frames, dev, cfg=None, on_frame=None, sys_=None, start: int = 0, rights=None):
    """``System.track_monocular(img, ts, imu=...)`` over frames start.. of the
    visual-inertial scene, or with ``rights`` ``track_stereo(left, right,
    ts, imu=...)`` (default configuration: vi_stereo_config); returns
    (system, states)."""
    if cfg is None:
        cfg = (vi_config if rights is None else vi_stereo_config)(frames[0].shape[1],
                                                                  frames[0].shape[0])
    sys_ = sys_ or System(cfg, device=dev)
    states = []
    for k in range(start, len(frames)):
        ts = k / pf.VI_FPS
        imu = pf.imu_window((k - 1) / pf.VI_FPS, ts) if k else None
        t0 = time.perf_counter()
        if rights is None:
            states.append(sys_.track_monocular(frames[k], ts, imu=imu))
        else:
            states.append(sys_.track_stereo(frames[k], rights[k], ts, imu=imu))
        if on_frame is not None:
            on_frame(k, states[-1], time.perf_counter() - t0, sys_)
    return sys_, states


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
               Op: int = 8192, kb8=None, stereo_bf=None) -> ba.BAProblem:
    """A BA problem padded like run_ba's init problem (Kp 32, Pp 2048, Op
    8192): n_kf keyframes (the first two fixed, so no gauge freedom is
    left), points 4-9 m away, pixel noise within +-0.5 px and 5% gross
    outliers (+40 px), so no residual lies near the chi2 threshold.  With
    ``kb8`` (fx, fy, cx, cy, k1..k4) the points spread to about 55 degrees
    off the axis and project through the KB8 model.  With ``stereo_bf``
    every other observation gets a right-image u, u - bf / z within +-0.5
    px (``obs_ur``; -1 on the rest and the padding)."""
    K = pf.camera_matrix(WIDTH, HEIGHT)
    w = 3.0 if kb8 is not None else 1.0
    pts = np.stack([rng.uniform(-2 * w, 2 * w, n_pts), rng.uniform(-1.5 * w, 1.5 * w, n_pts),
                    rng.uniform(4, 9, n_pts)], -1)
    Rs = np.stack([pf.so3_exp_np(rng.normal(0, 0.03, 3)) for _ in range(n_kf)])
    ts = np.stack([np.array([0.25 * k, 0, 0]) + rng.normal(0, 0.02, 3) for k in range(n_kf)])
    obs_kf, obs_mp, obs_uv = [], [], []
    for k in range(n_kf):
        pc = pts @ Rs[k].T + ts[k]
        uv = (pf.kb8_project_np(pc, kb8) if kb8 is not None
              else pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2])
        obs_kf.append(np.full(n_pts, k))
        obs_mp.append(np.arange(n_pts))
        obs_uv.append(uv + rng.uniform(-0.5, 0.5, uv.shape))
    obs_kf, obs_mp, obs_uv = (np.concatenate(a) for a in (obs_kf, obs_mp, obs_uv))
    O = len(obs_kf)
    ur = None
    if stereo_bf is not None:
        z = np.einsum("oj,oj->o", Rs[obs_kf][:, 2], pts[obs_mp]) + ts[obs_kf][:, 2]
        ur = np.full(Op, -1.0)
        ur[:O:2] = (obs_uv[:, 0] - stereo_bf / z + rng.uniform(-0.5, 0.5, O))[::2]
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
                        fixed_mp=t(np.arange(Pp) >= n_pts, b),
                        obs_ur=None if ur is None else t(ur, f))


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

    # K6: a padded init-shaped problem at 12 LM x 40 PCG (the init BA) and at 5 x 25 (the
    # window BA): within 1e-4 of plain with the inliers equal, bit-equal to K6's passes
    # launched one by one (K33's route on one shard), one device kernel a call
    prob = ba_problem(np.random.default_rng(1), dev)
    K = pf.camera_matrix(WIDTH, HEIGHT)
    cam = track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    one_shard = dmesh.Mesh([dev])
    for n_iters, cg_iters, pre in ((12, 40, ""), (5, 25, "window_")):
        solve = lambda: ba.optimize(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
        passes = lambda: sharded_ba.optimize_sharded(one_shard, prob, cam, n_iters, cg_iters)
        bk, bp = solve(), ba.optimize_plain(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
        d = max(float((bk.R - bp.R).abs().max()), float((bk.t - bp.t).abs().max()),
                float((bk.points - bp.points).abs().max()))
        if d > 1e-4 or not torch.equal(bk.inliers, bp.inliers):
            raise AssertionError(f"ba_pcg {n_iters} x {cg_iters}: max deviation {d:.2e}, "
                                 f"inliers equal {torch.equal(bk.inliers, bp.inliers)}")
        bm = passes()
        if not all(torch.equal(getattr(bm, f), getattr(bk, f))
                   for f in ("R", "t", "points", "inliers")):
            raise AssertionError(f"ba_pcg {n_iters} x {cg_iters}: the cluster solve differs from "
                                 "K6's passes launched one by one")
        parent = 7 + n_iters * (6 + 3 * cg_iters) + 2   # the parent's launches a call
        nbytes, ops = ba_work(prob, "cg", n_iters, cg_iters)
        rec = record(d, cuda_ms(solve, reps=5),
                     cuda_ms(lambda: ba.optimize_plain(prob, cam, n_iters, cg_iters), reps=2),
                     nbytes, ops)
        rec.update(parent_launches_per_call=parent, passes_ms=cuda_ms(passes, reps=5))
        if pre:
            stats["ba_pcg"].update({pre + k: v for k, v in rec.items()
                                    if k not in ("bytes", "ops", "library_ms")})
        else:
            stats["ba_pcg"] = rec
        print(f"[parity] ba_pcg K={prob.R.shape[0]} P={prob.points.shape[0]} "
              f"O={prob.obs_kf.shape[0]}, {n_iters} LM x {cg_iters} PCG: poses and points within "
              f"{d:.2e} of plain, inliers equal ({int(bk.inliers.sum())}), bit-equal to the "
              f"passes launched one by one (the parent: {parent} launches a call), "
              f"{rec['ms']:.4f} ms against the passes' {rec['passes_ms']:.4f}", flush=True)

        def solved(trace, it=n_iters, cg=cg_iters, pre=pre):
            if trace[3] != 1:
                raise AssertionError(f"ba_pcg {it} x {cg}: {trace[3]:g} device kernels a call")
            stats["ba_pcg"][pre + "kernels_per_call"] = trace[3]
            print(f"[parity] ba_pcg {it} x {cg}: {trace[3]:g} device kernel a call (a fresh "
                  "process's profiler trace)", flush=True)

        def passed(trace, it=n_iters, cg=cg_iters, pre=pre):
            stats["ba_pcg"][pre + "passes_kernels_per_call"] = trace[3]
            print(f"[parity] ba_pcg {it} x {cg}, the passes one by one: {trace[3]:g} device "
                  "kernels a call", flush=True)
        trace_later(f"ba_pcg {n_iters} x {cg_iters}", ("ba_pcg", (prob, cam, n_iters, cg_iters),
                                                       {}), solved)
        trace_later(f"ba_pcg passes {n_iters} x {cg_iters}",
                    ("ba_pcg_passes", (prob, cam, n_iters, cg_iters), {}), passed)
    bk = ba.optimize(prob, cam, 12, 40)
    n_diff = sum(not all(torch.equal(getattr(ba.optimize(prob, cam, 12, 40), f), getattr(bk, f))
                         for f in ba.BAResult._fields) for _ in range(50))
    if n_diff:
        raise AssertionError(f"ba_pcg determinism: {n_diff} of 50 calls differ from the first")
    print("[parity] ba_pcg determinism: 50 calls on one problem give bit-identical outputs",
          flush=True)

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
    rows_h = np.concatenate([rng.choice(cap, 200, replace=False), np.full(56, cap)])
    pos_h, new_pos_h = rng.normal(size=(cap, 3)), rng.normal(size=(256, 3))
    val_h, new_val_h = rng.random(cap) < 0.5, rng.random(256) < 0.5
    pos, val = t(pos_h, torch.float32), t(val_h, torch.bool)
    rows, new_pos, new_val = t(rows_h, torch.int32), t(new_pos_h, torch.float32), t(new_val_h,
                                                                                  torch.bool)
    pk, vk, pp_, vp = pos.clone(), val.clone(), pos.clone(), val.clone()
    track_device.mirror_scatter(pk, vk, rows, new_pos, new_val)
    track_device.mirror_scatter_plain(pp_, vp, rows, new_pos, new_val)
    # MapMirror's own upload: the same rows from host arrays, one record in its
    # page-locked staging buffer read by the kernel in place; no pageable copy
    rows_h, new_pos_h = rows_h.astype(np.int32), new_pos_h.astype(np.float32)
    mirrors = []

    def sync_twice():   # a full upload, then an update of the 256 rows through sync
        host_map = types.SimpleNamespace(mid=0, version=1, _next_mp=cap,
                                         mp_pos=pos_h.astype(np.float32), mp_valid=val_h.copy())
        mirrors.append(track_device.MapMirror(dev))
        mirrors[-1].sync(host_map)
        keep_h = rows_h < cap
        host_map.mp_pos[rows_h[keep_h]] = new_pos_h[keep_h]
        host_map.mp_valid[rows_h[keep_h]] = new_val_h[keep_h]
        host_map.version = 2
        mirrors[-1].sync(host_map)

    names, _ = device_events(sync_twice)
    mir = mirrors[-1]
    if any("Pageable" in n for n in names) or mir.n_scatter != 1:
        raise AssertionError(f"MapMirror.sync: device events {names}, {mir.n_scatter} scatters")
    leaves = [t(rng.normal(size=(3, 3)), torch.float32), t(rng.integers(-5, 5, 1128), torch.int32),
              t(rng.random(4096) < 0.5, torch.bool), t(rng.integers(0, 256, (1128, 32)),
                                                       torch.uint8),
              t(7, torch.int64), t(rng.integers(-100, 100, 64), torch.int8)]
    same = (torch.equal(pk, pp_) and torch.equal(vk, vp) and torch.equal(mir.pos, pp_)
            and torch.equal(mir.valid, vp) and torch.equal(
                packed_fetch.pack_i32(leaves), packed_fetch.pack_i32_plain(leaves)))
    back = packed_fetch.pack_fetch(leaves)
    same = same and all(np.array_equal(b, a.cpu().numpy()) and b.dtype == a.cpu().numpy().dtype
                        for a, b in zip(leaves, back))
    if not same:
        raise AssertionError("map_io: mirror_scatter, MapMirror.sync or pack_i32 differs from the "
                             "plain version")
    # the library yardstick: index_put_ of the in-range rows (the kernel
    # also drops the out-of-range ones, which index_put_ would reject); for
    # the upload from host arrays, three .to(device) copies before it
    keep = rows < cap
    kr, kp, kv = rows[keep].long(), new_pos[keep], new_val[keep]

    def copies_index_put():
        r, p_, v = (torch.from_numpy(a).to(dev) for a in (rows_h, new_pos_h, new_val_h))
        k = r < cap
        r = r[k].long()
        pk.index_put_((r,), p_[k])
        vk.index_put_((r,), v[k])

    ms, lib_ms = paired_ms(lambda: track_device.mirror_scatter(pk, vk, rows, new_pos, new_val),
                           lambda: (pk.index_put_((kr,), kp), vk.index_put_((kr,), kv)))
    stats["mirror_scatter"] = record(
        0.0, ms, cuda_ms(lambda: track_device.mirror_scatter_plain(pp_, vp, rows, new_pos,
                                                                   new_val)),
        rows.numel() * (4 + 12 + 1) + int(keep.sum()) * 13, 0, library_ms=lib_ms)
    up_ms, up_lib_ms = paired_ms(lambda: mir.upload_rows(rows_h, new_pos_h, new_val_h),
                                 copies_index_put)
    stats["mirror_scatter"].update(upload_ms=up_ms, upload_library_ms=up_lib_ms)
    st = stats["mirror_scatter"]
    if st["ms"] > st["library_ms"]:
        raise AssertionError(f"mirror_scatter {st['ms']:.4f} ms, slower than two index_put_ "
                             f"calls' {st['library_ms']:.4f}")
    words = packed_fetch.pack_i32_plain(leaves).numel()
    stats["pack_i32"] = record(0.0, cuda_ms(lambda: packed_fetch.pack_i32(leaves)),
                               cuda_ms(lambda: packed_fetch.pack_i32_plain(leaves)),
                               sum(a.numel() * a.element_size() for a in leaves) + 4 * words, 0)
    print("[parity] mirror_scatter (32768 rows, 256 updates) and pack_i32 "
          f"({sum(a.numel() for a in leaves)} words): bit-equal, exact round trip; "
          f"mirror_scatter {st['ms']:.4f} ms against index_put_ x2 {st['library_ms']:.4f}; "
          f"MapMirror's upload of the rows from host arrays {st['upload_ms']:.4f} ms against "
          f"three .to(device) copies + index_put_ x2 {st['upload_library_ms']:.4f}; its sync "
          f"made no pageable copy ({len(names)} device events)", flush=True)
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
    with _TwoViewRecorder() as rec, _EpilogueRecorder() as epi:
        sys_, states = run_system(frames, dev, on_frame)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    epi.check("[system]")
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
    # every extraction runs K15, K1, K16, K17 and K2 once each
    per_image = {n: launches.get(n, 0) for n in EXTRACT_KERNELS}
    if len(set(per_image.values())) != 1:
        raise AssertionError(f"[system] extraction kernels launched unevenly: {per_image}")
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
    want = {**{k: images for k in EXTRACT_KERNELS}, "stereo_match": n if sensor == "stereo" else 0}
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
    fused = EXTRACT_KERNELS + ("hamming_best2", "match_epilogue", "pose_lm", "pack_i32")
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


def _map_feats(dev):
    def feats(d, xy, v):
        n = len(v)
        return interop.features_from_numpy(
            dict(xy=xy, response=np.zeros(n, np.float32), angle=np.zeros(n, np.float32),
                 octave=np.zeros(n, np.int32), size=np.full(n, 31.0, np.float32), desc=d,
                 valid=v), dev)
    return feats


def looped_map(dev, n_kf: int = LOOP_KFS, n_pts: int = LOOP_POINTS, kb8: bool = False):
    """The [loop] map: ``pf.build_looped_map`` at full width (LOOP_KFS
    keyframes of up to 1128 keypoints, ~1000 observed each), the return
    pass half a step off the outbound one; keyframe features on ``dev``.
    With ``kb8`` (the [loop-kb8] map) the keypoints lie in TUM-VI's 512x512
    KB8 image (every landmark in view: 1128 a keyframe)."""
    return pf.build_looped_map(0, SLAMMap, KeyFrame, _map_feats(dev), n_kf=n_kf, n_pts=n_pts,
                               step=LOOP_STEP, n_cap=SYS_FEATURES + 8 * 16,
                               return_shift=LOOP_STEP / 2,
                               camera=pf.kb8_camera() if kb8 else None)


def loop_camera(kb8: bool = False):
    """The camera of the [loop] map (640x480 pinhole) or of [loop-kb8]'s
    (TUM-VI's 512x512 KB8)."""
    return (KannalaBrandt8(*pf.kb8_camera()) if kb8 else
            Pinhole.from_config(camera_config(WIDTH, HEIGHT)))


def sim3_scene(rng, N: int = 512, out_frac: float = 0.3, kb8=None):
    """N Sim3 pairs: points 2-8 m in front of camera 1, p2 = s R p1 + t
    (s 1.3), both pixels with 0.5 px noise, ``out_frac`` of the second
    pixels moved 10-40 px, 90% valid.  float32 numpy (p1, p2, uv1, uv2,
    valid) and the true (R, t, s).  With ``kb8`` (fx, fy, cx, cy, k1..k4)
    the points spread to about 55 degrees off the axis and project through
    the KB8 model."""
    cam = camera_config(WIDTH, HEIGHT)
    proj = ((lambda p: pf.kb8_project_np(p, kb8)) if kb8 is not None else
            (lambda p: np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                                 cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)))
    w = 3.0 if kb8 is not None else 1.0
    p1 = np.stack([rng.uniform(-2 * w, 2 * w, N), rng.uniform(-1.5 * w, 1.5 * w, N),
                   rng.uniform(2, 8, N)], -1)
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
    # work the function needs: the keypoints joined by word (~10 ops each),
    # XOR + popcount + top-2 (~20) per same-word pair; in: descriptors,
    # words, flags; out: 4 rows
    stats["hamming_best2_words"] = record(
        0.0, cuda_ms(lambda: matcher.hamming_best2(*args, words=(w1, w2))),
        cuda_ms(lambda: matcher.hamming_best2_plain(*args, words=(w1, w2))),
        (M2 + N2) * 37 + 16 * M2, 10 * (M2 + N2) + 20 * n_same)
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
    prob64 = graph_f64(prob)
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


def run_loop(dev, n_kf: int = LOOP_KFS, kb8: bool = False, mark: bool = False, devices=None,
             keep=None):
    """The LoopCloser over the keyframes of the [loop] map (with ``kb8`` the
    [loop-kb8] map and camera) on ``dev`` in order until a loop closes, with
    the reference's thresholds; then ``finish``.  Returns the map, the
    closer, the (keyframe, matched keyframe) of each loop closed and each
    keyframe event's host ms.  ``mark`` puts event i in a profiler range
    ``frame_i``.  With ``devices`` (the [loop-mesh] run) the closer runs
    over the mesh of those devices (``use_devices``): places scored by the
    database's device backend, every essential graph edge-sharded
    (``sharded_graph_min_edges`` 1), the GBA over landmark shards.  ``keep``
    (a dict) gets the keyframes' poses before ``finish`` applies the GBA
    (``"before"``)."""
    with dmesh.use_devices(devices) if devices else contextlib.nullcontext():
        mp, _, desc, centres = looped_map(dev, n_kf, kb8=kb8)
        voc = vocab_mod.Vocabulary.train(desc, k=8, L=3, seed=0)
        inv_sigma2 = [1.2 ** (-2 * i) for i in range(8)]
        closer = loop_closing.LoopCloser(voc, loop_camera(kb8), inv_sigma2=inv_sigma2,
                                         device=dev, img_wh=(KB8_SIZE, KB8_SIZE) if kb8 else None)
        if devices:
            closer.sharded_graph_min_edges = 1
            closer.db.enable_device_backend(dmesh.make_mesh())
        loops, ms = [], []
        for kid in sorted(mp.keyframes):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (torch.profiler.record_function(f"frame_{len(ms)}") if mark
                  else contextlib.nullcontext()):
                got = closer.process_keyframe(mp, kid)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if got:
                loops.append((kid, mp.keyframes[kid].loop_edges[-1]))
                break   # as tests/test_loop_closing.py: the later return keyframes would close again
        if keep is not None:
            keep["before"] = {k: (kf.R.copy(), kf.t.copy()) for k, kf in mp.keyframes.items()}
        n_gba = closer.n_gba_applied
        closer.finish(mp)
    return mp, closer, loops, ms, centres, closer.n_gba_applied - n_gba


def phase_loop(dev, kb8: bool = False, rec=None):
    """[loop]: the constructed out-and-back map at full width (24 keyframes,
    ~1000 observed keypoints each, the return pass drifting) through
    ``LoopCloser.process_keyframe`` on the card: exactly one loop, on the
    keyframes the CPU plain path closes, the closing keyframe's centre
    error well under its drift, and the GBA applied at ``finish``.  The
    closer stops at the first loop, as tests/test_loop_closing.py does;
    the return keyframes after it keep the drift they gathered since the
    closing one, which no loop has measured yet.  With ``kb8`` [loop-kb8]:
    the map and closer through TUM-VI's 512x512 KB8 camera, where every
    K12 and K14 launch takes the ``CamKB8`` instantiation (no pinhole one).
    ``rec`` (a ``_LoopRecorder``) keeps the card run's K12 and K14 calls."""
    tag = "[loop-kb8]" if kb8 else "[loop]"
    kernels.LAUNCHES.clear()
    with rec if rec is not None else contextlib.nullcontext():
        mp, closer, loops, ms, centres, n_gba = run_loop(dev, kb8=kb8)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _, _, cpu_loops, _, _, _ = run_loop(torch.device("cpu"), kb8=kb8)
    drift = looped_map(torch.device("cpu"), kb8=kb8)[0]
    last_id = loops[0][0] if loops else max(mp.keyframes)
    err = lambda kf: float(np.linalg.norm(-kf.R.T @ kf.t - centres[kf.kid]))
    e_after, e_before = err(mp.keyframes[last_id]), err(drift.keyframes[last_id])
    n_kf = len(mp.keyframes)
    want = {"vocab_words": len(ms), "pose_graph": 1, "ba_schur": 1}
    if kb8:   # every K12 / K14 launch through the KB8 camera
        want.update({f"{n}_kb8": launches.get(n, 0)
                     for n in ("sim3_ransac", "sim3_optimize", "ba_schur")})
    bad = {n: launches.get(n, 0) for n, v in want.items() if launches.get(n, 0) != v}
    bad.update({n: 0 for n in ("sim3_ransac", "sim3_optimize", "hamming_best2_words")
                if not launches.get(n, 0)})
    if len(loops) != 1 or loops != cpu_loops or not e_after < 0.5 * e_before or n_gba != 1 \
            or bad:
        raise AssertionError(f"{tag} loops {loops} (CPU plain path {cpu_loops}), closing "
                             f"keyframe centre error {e_after:.4f} m (drifted {e_before:.4f} m), "
                             f"GBA applied {n_gba}, launches {launches} (off: {bad})")
    k = loops[0][0]
    print(f"{tag} {n_kf} keyframes, {int(np.mean([kf.n_kps for kf in mp.keyframes.values()]))} "
          f"keypoints each: one loop at keyframe {k} (matched {loops[0][1]}) after {len(ms)} "
          f"keyframe events, as the CPU plain "
          f"path; its centre error {e_after:.4f} m (drifted {e_before:.4f} m); GBA "
          f"applied at finish", flush=True)
    print(f"{tag} keyframe-event ms (host clock): median {statistics.median(ms):.2f}, loop "
          f"event {ms[k]:.2f}", flush=True)
    print(f"{tag} launches {launches}", flush=True)
    return launches


def _ba_dist(a, b) -> float:
    return max(float((a.R - b.R).abs().max()), float((a.t - b.t).abs().max()),
               float((a.points - b.points).abs().max()))


def phase_parity_loop_kb8(rec, dev) -> dict:
    """[parity-loop-kb8]: K12 and K14 through the KB8 camera against their
    plain versions: on a KB8 Sim3 scene at [parity]'s shapes (512 pairs, 30%
    outliers, the seeded sets; 1024 pairs from a start 0.02 rad / 5 cm / 3%
    off), on every K12 and K14 call of the [loop-kb8] run (``rec``), on the
    [loop-kb8] map's full GBA problem and on a noisy KB8 problem of its K and
    O.  Equal inliers and counts; the Sim3 within 1e-4, the GBA within 1e-3,
    its cost within 1e-3 relative on the noisy problem (the post-loop GBA
    call: the inliers and a cost at rounding, below)."""
    rng = np.random.default_rng(15)
    kb8 = pf.kb8_camera()
    cam = loop_camera(kb8=True)
    stats = {}
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sim3_dist(a, b):
        return max(float((a.R12 - b.R12).abs().max()), float((a.t12 - b.t12).abs().max()),
                   float((a.s12 - b.s12).abs()))

    # K12<KB8> RANSAC
    p1, p2, uv1, uv2, val, _ = sim3_scene(rng, kb8=kb8)
    sargs = [t_(a) for a in (p1, p2, uv1, uv2, val)]
    sets = gsim3.sample_sim3_sets(3, torch.from_numpy(val)).to(dev)
    run_k = lambda: gsim3.solve_sim3_ransac(sets, *sargs, cam)
    run_p = lambda: gsim3.solve_sim3_ransac_plain(sets, *sargs, cam)
    rk, rp = run_k(), run_p()
    d_r = sim3_dist(rk, rp)
    if not (bool(rk.success) == bool(rp.success) and bool(rk.success)
            and int(rk.n_inliers) == int(rp.n_inliers) and torch.equal(rk.inliers, rp.inliers)
            and d_r <= 1e-4):
        raise AssertionError(f"sim3_ransac<KB8>: ok {bool(rk.success)}/{bool(rp.success)}, count "
                             f"{int(rk.n_inliers)}/{int(rp.n_inliers)}, |dR|,|dt|,|ds| {d_r:.2e}")
    H, nv = sets.shape[0], int(val.sum())
    print(f"[parity-loop-kb8] sim3_ransac<KB8> N=512 H={H}: ok, count ({int(rk.n_inliers)} of "
          f"{nv} valid) and mask equal, max |dR|,|dt|,|ds| {d_r:.2e}", flush=True)

    # K12<KB8> OptimizeSim3
    p1, p2, uv1, uv2, val, (R, t, s) = sim3_scene(rng, 1024, out_frac=0.1, kb8=kb8)
    Ri, ti, si = R.T, -(R.T @ t) / s, 1.0 / s
    R0 = t_((pf.so3_exp_np([0.02, 0.0, -0.01]) @ Ri).astype(np.float32))
    t0 = t_((ti + np.array([0.05, 0.0, -0.03])).astype(np.float32))
    s0 = torch.tensor(si * 1.03, dtype=torch.float32, device=dev)
    oargs = (R0, t0, s0, t_(p1), t_(p2), t_(uv1), t_(uv2), t_(val))
    d_o = 0.0
    for fix in (False, True):
        ok_ = gsim3.optimize_sim3(*oargs, cam, fix)
        op_ = gsim3.optimize_sim3_plain(*oargs, cam, fix)
        d = sim3_dist(ok_, op_)
        if int(ok_.n_in) != int(op_.n_in) or not torch.equal(ok_.inliers, op_.inliers) \
                or not d <= 1e-4:
            raise AssertionError(f"sim3_optimize<KB8> fix_scale={fix}: n_in {int(ok_.n_in)}/"
                                 f"{int(op_.n_in)}, |dR|,|dt|,|ds| {d:.2e}")
        print(f"[parity-loop-kb8] sim3_optimize<KB8> N=1024 fix_scale={fix}: n_in "
              f"{int(ok_.n_in)} equal, max |dR|,|dt|,|ds| {d:.2e}", flush=True)
        d_o = max(d_o, d)

    # every K12 call of the [loop-kb8] run
    n_calls = 0
    for key, kern, plain in (
            ("sim3_ransac", gsim3.solve_sim3_ransac, gsim3.solve_sim3_ransac_plain),
            ("sim3_optimize", gsim3.optimize_sim3, gsim3.optimize_sim3_plain)):
        for args, kw in rec.calls[key]:
            a, b = kern(*args, **kw), plain(*args, **kw)
            d = sim3_dist(a, b)
            cnt = (a.n_inliers, b.n_inliers) if key == "sim3_ransac" else (a.n_in, b.n_in)
            if int(cnt[0]) != int(cnt[1]) or not torch.equal(a.inliers, b.inliers) \
                    or not d <= 1e-4:
                raise AssertionError(f"{key}<KB8> on [loop-kb8] call {n_calls}: counts "
                                     f"{int(cnt[0])}/{int(cnt[1])}, |dR|,|dt|,|ds| {d:.2e}")
            d_r, d_o = (max(d_r, d), d_o) if key == "sim3_ransac" else (d_r, max(d_o, d))
            n_calls += 1
    print(f"[parity-loop-kb8] the [loop-kb8] run's {len(rec.calls['sim3_ransac'])} sim3_ransac "
          f"and {len(rec.calls['sim3_optimize'])} sim3_optimize calls: counts and masks equal "
          f"to the plain versions', Sim3 within 1e-4", flush=True)
    # work: as [parity]'s K12 rows; KB8's projection (~40 ops in float, ~7 x
    # 60 in Dual<7>) in place of the pinhole's
    stats["sim3_ransac_kb8"] = record(d_r, cuda_ms(run_k), cuda_ms(run_p, reps=5),
                                      512 * 41 + H * 12 + 52 + 512 + 5, 100 * (H + 1) * 512,
                                      ops64=3600 * H)
    stats["sim3_optimize_kb8"] = record(
        d_o, cuda_ms(lambda: gsim3.optimize_sim3(*oargs, cam, True)),
        cuda_ms(lambda: gsim3.optimize_sim3_plain(*oargs, cam, True), reps=3),
        52 + 1024 * 41 + 52 + 1024 + 4, 15 * 1024 * (7 * 450 + 4 * 70))

    # K14<KB8>: the [loop-kb8] map's full GBA problem, a noisy one of its
    # K and O, and the post-loop GBA call of the [loop-kb8] run
    mp, _, _, _ = looped_map(dev, kb8=True)
    gprob = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    Kb, Pb, Ob = gprob.R.shape[0], gprob.points.shape[0], gprob.obs_kf.shape[0]
    noisy = ba_problem(rng, dev, n_kf=Kb, n_pts=Ob // Kb, Kp=Kb, Pp=-(-(Ob // Kb) // 128) * 128,
                       Op=Ob, kb8=kb8)
    d_ba = 0.0
    for name, prob_ in (("[loop-kb8] map", gprob), ("noisy", noisy)):
        bk = sharded_ba.optimize_schur(prob_, cam)
        bp = sharded_ba.optimize_schur_plain(prob_, cam)
        d = _ba_dist(bk, bp)
        ck, cp = float(bk.cost), float(bp.cost)
        dc = abs(ck - cp) / cp if name == "noisy" else 0.0
        if not d <= 1e-3 or not dc <= 1e-3 or not torch.equal(bk.inliers, bp.inliers):
            raise AssertionError(f"ba_schur<KB8> ({name}): |dR|,|dt|,|dp| {d:.2e}, cost {ck:.6g} / "
                                 f"{cp:.6g}, inliers equal {torch.equal(bk.inliers, bp.inliers)}")
        cost_note = f"{dc:.2e} relative" if name == "noisy" else "rounding, not compared"
        print(f"[parity-loop-kb8] ba_schur<KB8> {name} K={prob_.R.shape[0]} "
              f"P={prob_.points.shape[0]} O={prob_.obs_kf.shape[0]}: max |dR|,|dt|,|dp| "
              f"{d:.2e}, inliers equal, cost {ck:.6g} / plain {cp:.6g} ({cost_note})", flush=True)
        d_ba = max(d_ba, d, dc)
    # the post-loop GBA call of [loop-kb8]: its map agrees with itself, the
    # cost sits at float32 rounding with one keyframe fixed, and the LM's
    # accept decisions on that noise make the solution unique only to
    # ~1e-3 (the plain version moves that far when its points move by one
    # ulp, the witness below): held are the inlier mask and both costs at
    # rounding (under 1e-4); the distances are printed
    (gargs, gkw), = rec.calls["ba_schur"]
    prob_ = gargs[0]
    bk = sharded_ba.optimize_schur(prob_, cam, **gkw)
    bp = sharded_ba.optimize_schur_plain(prob_, cam, **gkw)
    bw = sharded_ba.optimize_schur_plain(
        prob_._replace(points=torch.nextafter(prob_.points,
                                              torch.full_like(prob_.points, float("inf")))),
        cam, **gkw)
    d, d_w = _ba_dist(bk, bp), _ba_dist(bw, bp)
    if not torch.equal(bk.inliers, bp.inliers) or not max(float(bk.cost), float(bp.cost)) < 1e-4:
        raise AssertionError(f"ba_schur<KB8> ([loop-kb8] post-loop call): inliers equal "
                             f"{torch.equal(bk.inliers, bp.inliers)}, cost {float(bk.cost):.6g} / "
                             f"{float(bp.cost):.6g}")
    print(f"[parity-loop-kb8] ba_schur<KB8> [loop-kb8] post-loop call K={prob_.R.shape[0]} "
          f"P={prob_.points.shape[0]} O={prob_.obs_kf.shape[0]}: inliers equal, cost "
          f"{float(bk.cost):.6g} / plain {float(bp.cost):.6g} (rounding); max |dR|,|dt|,|dp| "
          f"{d:.2e} from plain, whose points moved by one ulp move it {d_w:.2e}", flush=True)
    # work: as [parity]'s K14 row, with KB8's Dual<3> projection (~250 ops)
    # in place of the pinhole's ~60 per observation in the build and cost
    stats["ba_schur_kb8"] = record(
        d_ba, cuda_ms(lambda: sharded_ba.optimize_schur(gprob, cam), reps=5),
        cuda_ms(lambda: sharded_ba.optimize_schur_plain(gprob, cam), reps=2),
        Kb * 50 + Pb * 13 + Ob * 22 + Kb * 48 + Pb * 12 + Ob + 4,
        10 * (Ob * 360 + 20 * (Ob * 72 + Pb * 18 + Kb * 72)))
    return stats


def merge_config(width: int = WIDTH, height: int = HEIGHT, kb8: bool = False) -> SLAMConfig:
    """[merge]'s configuration: [system]'s with the recovery timing of
    tests/test_loop_from_pixels.py (time_recently_lost 0.05 s) and a
    keyframe every frame (the JAX test's cadence of 2 leaves the
    procedural scene's first map at 9 keyframes when the lens is covered,
    below the 10 an Atlas keeps, so nothing would be left to merge into).
    With ``kb8`` [merge-kb8]'s: [kb8]'s camera and 1500 features."""
    base = kb8_config(width, height) if kb8 else system_config(width, height)
    return dataclasses.replace(base, tracking=TrackingConfig(max_frames=MERGE_MAX_FRAMES,
                                                             time_recently_lost=0.05))


def merge_frames(kb8: bool = False):
    """[merge]'s sweep at 640x480, or [merge-kb8]'s through TUM-VI's 512x512
    KB8 camera (the wall wrapped to fill the view)."""
    if kb8:
        return pf.render_loop_sequence(pf.wide_texture(), MERGE_FRAMES, KB8_SIZE, KB8_SIZE,
                                       camera="kb8")
    return pf.render_loop_sequence(pf.wide_texture(), MERGE_FRAMES, WIDTH, HEIGHT)


def phase_merge(dev, kb8: bool = False):
    """[merge]: ``System(cfg, vocab).track_monocular`` over the 40-frame
    out-and-back sweep with frames 19-28 black and a vocabulary trained
    on the sequence (k=8, L=3): a second Atlas map starts after the
    blackout and place recognition welds it into the first one.  Final
    state OK, one map, n_merges >= 1, ATE within the JAX test's bound.
    With ``kb8`` [merge-kb8]: the sweep, the System and the weld through
    TUM-VI's 512x512 KB8 camera (K12 and the weld BA K6 through ``CamKB8``,
    relocalization by K25)."""
    tag = "[merge-kb8]" if kb8 else "[merge]"
    frames, poses = merge_frames(kb8)
    voc = train_vocab(frames, dev, n_features=KB8_FEATURES if kb8 else SYS_FEATURES)
    events, kf = [], []

    def on_frame(k, st, dt, kf_event, sys_):
        lc_ = sys_.tracker.loop_closer
        events.append((k, st.name, len(sys_.tracker.atlas.maps), lc_.n_merges, dt * 1e3))
        if kf_event:
            kf.append(k)

    kernels.LAUNCHES.clear()
    cfg = merge_config(KB8_SIZE, KB8_SIZE, kb8=True) if kb8 else merge_config()
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
            print(f"{tag} frame {k:2d}: {ms:8.2f} ms host clock  {name:15s} {n_maps} map(s)"
                  f"{'  merged' if k == merged_at else ''}", flush=True)
    # with the KB8 camera every launch of a camera kernel takes CamKB8, and
    # relocalization runs MLPnP (K25), never K10
    off = {n: (launches.get(n, 0), launches.get(f"{n}_kb8", 0))
           for n in ("sim3_ransac", "sim3_optimize", "ba_schur", "ba_pcg", "pose_lm")
           if kb8 and launches.get(n, 0) != launches.get(f"{n}_kb8", 0)}
    if kb8 and launches.get("pnp_ransac", 0):
        off["pnp_ransac"] = launches["pnp_ransac"]
    if events[-1][1] != "OK" or len(tr.atlas.maps) != 1 or lc_.n_merges < 1 or \
            not ate < MERGE_MAX_ATE or launches.get("ba_pcg", 0) != tr.stats["ba"] or \
            any(not launches.get(n, 0) for n in ("vocab_words", "sim3_ransac")) or off:
        raise AssertionError(f"{tag} states {[e[1] for e in events]}, {len(tr.atlas.maps)} "
                             f"maps, {lc_.n_merges} merges, ATE {ate:.4f} m, launches {launches} "
                             f"(off: {off})")
    print(f"{tag} welded at frame {merged_at}: one map of {sys_.n_keyframes()} keyframes, "
          f"{lc_.n_merges} merge(s), final state OK, ATE {ate:.4f} m (bound {MERGE_MAX_ATE})",
          flush=True)
    print(f"{tag} launches {launches}; tracker counts {dict(tr.stats)}", flush=True)
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

# ------------------------------------------------------------ inertial path


class _InertialRecorder:
    """Keeps the arguments of every K19-K22 wrapper call of a run, to hold
    the kernels to their plain versions at the main path's shapes."""

    NAMES = ((preint_mod, "integrate_batch", "preint"), (sin, "optimize_vi_ba", "vi_ba"),
             (sin, "inertial_only", "inertial_init"),
             (sin, "optimize_pose_inertial", "pose_inertial"),
             (sin, "optimize_pose_inertial_last_frame", "pose_inertial_joint"))

    def __init__(self):
        self.calls = {key: [] for _, _, key in self.NAMES}
        self._orig = {}

    def __enter__(self):
        for mod, name, key in self.NAMES:
            orig = getattr(mod, name)
            self._orig[(mod, name)] = orig

            def rec(*args, _orig=orig, _key=key, **kw):
                self.calls[_key].append((args, kw))
                return _orig(*args, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)


class _LoopRecorder(_InertialRecorder):
    """Keeps the arguments of every K12 and K14 wrapper call of a
    loop-closing run."""

    NAMES = ((gsim3, "solve_sim3_ransac", "sim3_ransac"), (gsim3, "optimize_sim3", "sim3_optimize"),
             (global_ba, "optimize_schur", "ba_schur"))


# ------------------------------------------------------- the device mesh


def mesh_devices(dev):
    """[loop-mesh]'s shards: the visible cards when there are more than one,
    else ``MESH_SHARDS`` shards of ``dev``."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * MESH_SHARDS


def place_problem(rng, K: int, W: int, nnz=None):
    """Dense L1-normalised BoW histograms of K keyframes over W words, their
    shared-word masks, validity (the last three rows invalid) and a query
    near row 5.  ``nnz`` None: every word weighted at random and a word
    counted as held above 1 / W (tests/test_dist_ba.py:156-166); else ~nnz
    words a keyframe, as a keyframe's BoW is sparse."""
    if nnz is None:
        hists = rng.random((K, W)).astype(np.float32)
        hists /= hists.sum(1, keepdims=True)
        has = hists > 1.0 / W
    else:
        hists = np.zeros((K, W), np.float32)
        hists[np.repeat(np.arange(K), nnz), rng.integers(0, W, K * nnz)] = rng.random(K * nnz)
        hists /= hists.sum(1, keepdims=True)
        has = hists > 0
    valid = np.ones(K, bool)
    valid[-3:] = False
    q = hists[5] + (hists[5] > 0) * rng.random(W).astype(np.float32) * 0.01
    q = (q / q.sum()).astype(np.float32)
    return hists, has, valid, q


def pad_graph(p, n: int):
    """An essential graph's edges padded with 1 to n invalid ones (identity
    measurements, weight 0, vertex 0) to a multiple of n."""
    E = p.edge_i.shape[0]
    pad = -(-(E + 1) // n) * n - E
    dev = p.t.device
    z = lambda a, fill: torch.cat([a, torch.full((pad,) + a.shape[1:], fill, dtype=a.dtype,
                                                 device=dev)])
    return p._replace(edge_i=z(p.edge_i, 0), edge_j=z(p.edge_j, 0),
                      m_R=torch.cat([p.m_R, torch.eye(3, dtype=p.m_R.dtype,
                                                      device=dev).expand(pad, 3, 3)]),
                      m_t=z(p.m_t, 0.0), m_s=z(p.m_s, 1.0), weight=z(p.weight, 0.0),
                      edge_valid=z(p.edge_valid, False))


def graph_f64(p):
    return pose_graph.PoseGraphProblem(*[a.double() if a.is_floating_point() else a for a in p])


def phase_parity_mesh(loop_graph, dev) -> dict:
    """[parity-mesh]: K29, K30 and K31 over ``MESH_SHARDS`` shards of ``dev``
    against their plain versions on the same inputs.  K29 (one launch a
    query) at the test size, at 37 x 1003 (W % 16 != 0: the rows on plain
    loads) and at 1024 keyframes x 65536 words (scores within 1e-5, counts
    and invalid rows equal), timed with q's host copy and with q on the
    card, with ``torch.cdist`` and a matvec as the library call; K30 on the [loop]
    map's global problem and on a noisy one of its K (within 1e-3, inliers
    equal, the noisy cost within 1e-3), and against
    K14 on the noisy problem; K31 on a 200-keyframe graph (both
    ``fix_scale``) and on [loop-mesh]'s essential graph ``loop_graph``,
    against the float64 plain solve (within 1e-4)."""
    mesh = dmesh.Mesh([dev] * MESH_SHARDS)
    n = mesh.size
    rng = np.random.default_rng(15)
    stats = {}

    # K29
    d29 = 0.0
    for name, (K, W, nnz) in (("test size", (24, 64, None)),
                              ("37 x 1003 (the plain-load rows)", (37, 1003, None)),
                              (f"{PLACE_K} x {PLACE_W}", (PLACE_K, PLACE_W, PLACE_NNZ))):
        h, w, v, q = place_problem(rng, K, W, nnz)
        blocks = [kfb.shard_kf_axis(mesh, kfb.pad_to_mesh(a, n)) for a in (h, w, v)]
        qt = torch.from_numpy(q)
        ks, kc = (kfb.gather_host(b) for b in kfb.sharded_place_scores(mesh, *blocks, qt))
        ps, pc = (kfb.gather_host(b) for b in kfb.sharded_place_scores_plain(mesh, *blocks, qt))
        fin = np.isfinite(ps)
        d = float(np.abs(ks[fin] - ps[fin]).max())
        if not (np.array_equal(np.isfinite(ks), fin) and np.array_equal(kc, pc) and d <= 1e-5):
            raise AssertionError(f"place_dense ({name}): max |d score| {d:.2e}, counts equal "
                                 f"{np.array_equal(kc, pc)}, -inf rows equal "
                                 f"{np.array_equal(np.isfinite(ks), fin)}")
        print(f"[parity-mesh] place_dense {name} on {n} shards: max |d score| {d:.2e}, counts "
              f"and -inf rows equal, best row {int(np.argmax(ks))}", flush=True)
        d29 = max(d29, d)
    hd, qd = torch.from_numpy(h).to(dev), qt.to(dev)
    wd = torch.from_numpy(w).to(dev).float()
    lib_ms = cuda_ms(lambda: (torch.cdist(hd, qd[None], p=1), wd @ (qd > 0).float()))
    ms = cuda_ms(lambda: kfb.sharded_place_scores(mesh, *blocks, qt))
    kernel_ms = cuda_ms(lambda: kfb.sharded_place_scores(mesh, *blocks, qd))
    # a query: the block read once (4 + 1 bytes a word), q, valid, the scores
    # and counts written; per word a subtract, an absolute value and an add,
    # and the count's compare, and and add
    stats["place_dense"] = record(
        d29, ms, cuda_ms(lambda: kfb.sharded_place_scores_plain(mesh, *blocks, qt), reps=5),
        K * W * 5 + W * 4 + K + K * 8, K * W * 6, library_ms=lib_ms)
    stats["place_dense"]["q_on_card_ms"] = kernel_ms
    print(f"[parity-mesh] place_dense {K} x {W} on {n} shards of one card, one launch: "
          f"{ms:.4f} ms a query with q's host copy, {kernel_ms:.4f} with q on the card, bound "
          f"{stats['place_dense']['bound_ms']:.4f}; torch.cdist + a matvec {lib_ms:.4f}",
          flush=True)
    del hd, wd, blocks

    # K30: the [loop] map's problem on n landmark shards (self-consistent: its
    # cost is float32 rounding, printed, not compared) and a noisy problem of
    # its K (two fixed keyframes, no gauge freedom)
    cam = loop_camera()
    mp, _, _, _ = looped_map(dev)
    gprob = global_ba.build_global_problem(mp, [1.0] * 8, n, None, dev)[0]
    Kb, Pb, Ob = gprob.R.shape[0], gprob.points.shape[0], gprob.obs_kf.shape[0]
    n_pts = Ob // Kb // 2
    noisy = ba_problem(rng, dev, n_kf=Kb, n_pts=n_pts, Kp=Kb, Pp=-(-n_pts // 128) * 128,
                       Op=Kb * n_pts)
    noisy_n = sharded_ba.relayout_for_schur(noisy, n)
    d30 = 0.0
    for name, prob_ in (("[loop] map", gprob), ("noisy", noisy_n)):
        bk = sharded_ba.optimize_schur(prob_, cam, mesh=mesh)
        bp = sharded_ba.optimize_schur_plain(prob_, cam, mesh=mesh)
        d = _ba_dist(bk, bp)
        ck, cp = float(bk.cost), float(bp.cost)
        dc = abs(ck - cp) / cp if name == "noisy" else 0.0
        if not d <= 1e-3 or not dc <= 1e-3 or not torch.equal(bk.inliers, bp.inliers):
            raise AssertionError(f"ba_schur_sharded ({name}): |dR|,|dt|,|dp| {d:.2e}, cost "
                                 f"{ck:.6g} / {cp:.6g}, inliers equal "
                                 f"{torch.equal(bk.inliers, bp.inliers)}")
        note = f"{dc:.2e} relative" if name == "noisy" else "rounding, not compared"
        print(f"[parity-mesh] ba_schur_sharded {name} on {n} shards K={Kb} "
              f"P={prob_.points.shape[0]} O={prob_.obs_kf.shape[0]}: max |dR|,|dt|,|dp| {d:.2e} "
              f"from the plain {n}-shard solve, inliers equal, cost {ck:.6g} / plain {cp:.6g} "
              f"({note})", flush=True)
        d30 = max(d30, d, dc)
    b14 = sharded_ba.optimize_schur(noisy, cam)
    P0 = noisy.points.shape[0]
    d14 = max(float((bk.R - b14.R).abs().max()), float((bk.t - b14.t).abs().max()),
              float((bk.points[:P0] - b14.points).abs().max()))
    c14 = abs(float(bk.cost) - float(b14.cost)) / float(b14.cost)
    if not (d14 <= 1e-3 and c14 <= 1e-3 and int(bk.inliers.sum()) == int(b14.inliers.sum())):
        raise AssertionError(f"ba_schur_sharded against K14 (noisy): {d14:.2e}, cost {c14:.2e} "
                             f"relative, inliers {int(bk.inliers.sum())} / "
                             f"{int(b14.inliers.sum())}")
    k30_ms = cuda_ms(lambda: sharded_ba.optimize_schur(gprob, cam, mesh=mesh), reps=5)
    gprob1 = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    k14_ms = cuda_ms(lambda: sharded_ba.optimize_schur(gprob1, cam), reps=5)
    print(f"[parity-mesh] ba_schur_sharded against K14 on the noisy problem: max |dR|,|dt|,|dp| "
          f"{d14:.2e}, cost {c14:.2e} relative, {int(b14.inliers.sum())} inliers each; the "
          f"[loop] map's GBA {k30_ms:.3f} ms on {n} shards, {k14_ms:.3f} ms on one (K14)",
          flush=True)
    # work: K14's per LM iteration (as [parity]'s row) with the pose side on
    # every shard, and per reduction the n shards' partials read and the
    # sums written back (27 K floats and a cost per LM step, 6 K per W y)
    stats["ba_schur_sharded"] = record(
        d30, k30_ms,
        cuda_ms(lambda: sharded_ba.optimize_schur_plain(gprob, cam, mesh=mesh), reps=2),
        Kb * 50 * n + Pb * 13 + Ob * 22 + Kb * 48 + Pb * 12 + Ob + 4,
        10 * (Ob * 170 + 20 * (Ob * 72 + Pb * 18 + Kb * 72 * n) + n * Kb * 40))

    # K31: float64, against the float64 plain n-shard solve
    prob = pad_graph(pose_graph_problem(rng, dev), n)
    K, E = prob.R.shape[0], prob.edge_i.shape[0]
    d31, plain_ms = 0.0, []
    for name, p_, fixes in ((f"K={K} E={E}", prob, (False, True)),
                            (f"[loop-mesh]'s essential graph K={loop_graph.R.shape[0]} "
                             f"E={loop_graph.edge_i.shape[0]}", loop_graph, (False,))):
        for fix in fixes:
            gk = dpg.optimize_sharded_pose_graph(mesh, p_, n_iters=15, fix_scale=fix)
            g64, t64 = timed(lambda: dpg.optimize_sharded_pose_graph_plain(
                mesh, graph_f64(p_), n_iters=15, fix_scale=fix))
            plain_ms.append(t64)
            d = max(float((a.double() - b).abs().max()) for a, b in zip(gk[:3], g64[:3]))
            line = (f"pose_graph_sharded {name} fix_scale={fix} on {n} shards: max "
                    f"|dR|,|dt|,|ds| {d:.2e} from the plain float64 {n}-shard solve, cost "
                    f"{float(gk[3]):.7g} / plain {float(g64[3]):.7g}")
            if not d <= 1e-4:
                raise AssertionError(line)
            print(f"[parity-mesh] {line}", flush=True)
            d31 = max(d31, d)
    # work: K13's (as [parity]'s row), float64, with the vertex side on every
    # shard, and per reduction the n shards' partials read and the sums
    # written (56 K per LM step, 7 K per PCG step)
    stats["pose_graph_sharded"] = record(
        d31, cuda_ms(lambda: dpg.optimize_sharded_pose_graph(mesh, prob, n_iters=15), reps=5),
        plain_ms[0], K * 53 * n + E * 72 + K + K * 52 + 4, 0,
        ops64=15 * (E * (2 * 7 * 900 + 2 * 7 * 7 * 14) + K * 700 * n
                    + 50 * (E * 392 + K * 120 * n) + n * K * 120))
    return stats


def vi_dist(a, b) -> float:
    """The largest state or point difference of two VI BA results."""
    return max(float((getattr(a, f).double() - getattr(b, f).double()).abs().max())
               for f in ("Rwb", "twb", "v", "bg", "ba", "points"))


def one_view_fixed(prob):
    """``prob`` with its points seen by fewer than two valid observations
    fixed: the well-posed part of the constructed map's GBA problem."""
    n_obs = torch.bincount(prob.obs_mp[prob.obs_valid].long(), minlength=prob.points.shape[0])
    return prob._replace(fixed_mp=prob.fixed_mp | (n_obs < 2))


def candidate_problem(rng, K: int, N: int, Nq: int):
    """K34's inputs: K keyframes of N random descriptors, a query of Nq
    taken from keyframe 11 with every seventh replaced; ties (a query row
    equal to two rows of keyframe 3, two query rows equal to one row of
    keyframe 6, a keyframe of one repeated descriptor), keyframe 4 masked
    and ~5% of the query rows and ~10% of the keyframe rows masked."""
    desc = rng.integers(0, 256, (K, N, 32), np.uint8)
    valid = rng.random((K, N)) < 0.9
    q = desc[11, :Nq].copy()
    q[::7] = rng.integers(0, 256, (len(q[::7]), 32), np.uint8)
    qv = rng.random(Nq) < 0.95
    desc[3, 9] = desc[3, 5]
    q[2] = desc[3, 5]
    q[40] = q[41] = desc[6, 7]
    desc[8, :] = desc[8, 0]
    q[50] = desc[8, 0]
    valid[4] = False
    return desc, valid, q, qv


def phase_parity_mesh_rest(vi_call, dev) -> dict:
    """[parity-mesh], the rest of the mesh: K32, K33 and K34 against their
    plain versions on the shards of [vi-loop-mesh].

    K32 on [vi-loop-mesh]'s own post-loop GBA call (7 LM x 40 PCG over its
    shards): the map's single-observation points make the float32 PCG break
    down (ROADMAP C, as K20's [parity] row), so on the raw inputs K32 is
    held to the plain n-shard solve through two iterations and its result
    must be finite; with the one-view points fixed, within 1e-4 of the plain
    n-shard solve after all 7 iterations with the inliers equal, and within
    1e-3 of K20 on the same problem as one shard (the n-shard sums run in
    another order: the plain 4- and 1-shard solves of this problem part by
    ~6e-4 on the CPU; K30 is held to K14 the same way).  K33 on a noisy problem
    of tests/test_dist_ba.py::build_problem's size (6 keyframes, 100
    points; 20 LM steps: after JAX's default 10 its float32 solves have not
    converged, and the last accept decisions, taken on costs a few float32
    ulps apart, part the plain solve from the float64 one by 2.1e-4 on the
    CPU and by 2.5e-5 after 20) and on one of the [loop] map's size (10 LM
    steps), two keyframes fixed: poses and points within 1e-4 of the plain
    n-shard solve, inliers equal, cost within 1e-4.  K34 at the
    test size and at 1024 keyframes x 1024 descriptors against a
    1000-descriptor query (~34 MB): counts bit-equal."""
    mesh, prob, cam, kw = vi_call
    n = mesh.size
    it, cg = kw["n_iters"], kw["cg_iters"]
    k32 = lambda q, m: sharded_ba.optimize_vi_sharded(mesh, q, cam, n_iters=m, cg_iters=cg)
    plain = lambda q, m: sin.optimize_vi_ba_plain(q, cam, n_iters=m, cg_iters=cg, mesh=mesh)
    k20 = lambda q, m: sin.optimize_vi_ba(q, cam, n_iters=m, cg_iters=cg)
    K, P, O = prob.Rwb.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]
    stats = {}

    d2 = vi_dist(k32(prob, 2), plain(prob, 2))
    vk = k32(prob, it)
    finite = all(bool(torch.isfinite(getattr(vk, f)).all())
                 for f in ("Rwb", "twb", "v", "bg", "ba", "points"))
    line = (f"vi_ba_sharded [vi-loop-mesh] post-loop GBA on {n} shards K={K} P={P} O={O} ({it} "
            f"LM x {cg} PCG): within {d2:.2e} of the plain {n}-shard solve after 2 iterations; "
            f"after {it}: cost {float(vk.cost):.7g}, finite {finite}")
    if not (d2 <= 1e-4 and finite):
        raise AssertionError(line)
    print(f"[parity-mesh] {line}", flush=True)
    q = one_view_fixed(prob)
    qk, (qp, plain_ms), q20 = k32(q, it), timed(lambda: plain(q, it)), k20(q, it)
    d, d20 = vi_dist(qk, qp), vi_dist(qk, q20)
    same = torch.equal(qk.inliers, qp.inliers) and torch.equal(qk.inliers, q20.inliers)
    line = (f"vi_ba_sharded [vi-loop-mesh] post-loop GBA, the "
            f"{int((q.fixed_mp & ~prob.fixed_mp).sum())} points seen by one keyframe fixed: "
            f"states and points within {d:.2e} of the plain {n}-shard solve and {d20:.2e} of "
            f"K20 on one shard, inliers equal {same}; cost {float(qk.cost):.7g} / plain "
            f"{float(qp.cost):.7g} / K20 {float(q20.cost):.7g}")
    if not (d <= 1e-4 and d20 <= 1e-3 and same):
        raise AssertionError(line)
    print(f"[parity-mesh] {line}", flush=True)
    ov = int(prob.obs_valid.sum())
    k32_ms, k20_ms = cuda_ms(lambda: k32(q, it), reps=3), cuda_ms(lambda: k20(q, it), reps=3)
    print(f"[parity-mesh] vi_ba_sharded: {k32_ms:.3f} ms on {n} shards, K20 {k20_ms:.3f} ms on "
          f"one, plain {n}-shard {plain_ms:.1f} ms", flush=True)
    # work: K20's (as [parity]'s row) with the state side on every shard, and
    # per reduction the n shards' partials read and the sums written back (27
    # K floats and a cost per LM step, 6 K per product, 2 dots per PCG step)
    stats["vi_ba_sharded"] = dict(record(
        max(d, d2), k32_ms, plain_ms,
        n * K * (84 + 1168 + 3) + P * 13 + O * 21 + 48 * n + K * 84 + P * 12 + O + 4,
        it * (ov * (150 + cg * 80) + n * K * (2 * 16 * 2500 + cg * 2 * 15 * 30 * 2)
              + P * cg * 30 + n * K * (27 + 6 * cg))), k20_ms=k20_ms)

    # K33: observation-sharded, poses and points on every shard
    rng = np.random.default_rng(16)
    mp, _, _, _ = looped_map(dev)
    gprob = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    Kb, Ob = gprob.R.shape[0], int(gprob.obs_valid.sum())
    n_pts = Ob // Kb // 2
    cam_l = loop_camera()
    d33, rec33 = 0.0, None
    for name, (nk, npt, it33) in (("build_problem's size", (6, 100, 20)),
                                  ("[loop] map's size", (Kb, n_pts, 10))):
        Op = -(-nk * npt // n) * n
        prob_ = ba_problem(rng, dev, n_kf=nk, n_pts=npt, Kp=nk, Pp=npt, Op=Op)
        bk = sharded_ba.optimize_sharded(mesh, prob_, cam_l, n_iters=it33)
        bp, p_ms = timed(lambda: sharded_ba.optimize_sharded_plain(mesh, prob_, cam_l,
                                                                   n_iters=it33))
        dd = _ba_dist(bk, bp)
        dc = abs(float(bk.cost) - float(bp.cost)) / float(bp.cost)
        line = (f"ba_pcg_sharded {name} on {n} shards K={nk} P={npt} O={Op} ({it33} LM x 40 "
                f"PCG): poses and points within {dd:.2e} of the plain {n}-shard solve, inliers "
                f"equal {torch.equal(bk.inliers, bp.inliers)}, cost {float(bk.cost):.7g} / "
                f"{float(bp.cost):.7g} ({dc:.2e} relative)")
        if not (dd <= 1e-4 and dc <= 1e-4 and torch.equal(bk.inliers, bp.inliers)):
            raise AssertionError(line)
        print(f"[parity-mesh] {line}", flush=True)
        d33 = max(d33, dd, dc)
        ov = int(prob_.obs_valid.sum())
        # work: K6's (as [parity]'s row, 10 LM x 40 PCG) with the pose and point
        # side on every shard, and per reduction the n shards' partials read and
        # the sums written back (6K + 3P + 21K + 6P per LM step, 6K + 3P per product)
        rec33 = record(
            d33, cuda_ms(lambda: sharded_ba.optimize_sharded(mesh, prob_, cam_l), reps=5), p_ms,
            Op * 21 + npt * 13 * n + nk * 49 * n + nk * 48 + npt * 12 + Op + 4,
            10 * (ov * (150 + 40 * 80) + n * (nk * 27 + npt * 9) * 2 * 41
                  + n * (nk * 100 + npt * 40) * 41))
    stats["ba_pcg_sharded"] = rec33

    # K34: the keyframe-sharded candidate match
    d34 = 0
    for name, (K_, N_, Nq) in (("test size", (16, 64, 64)),
                               ("1024 x 1024, a 1000-descriptor query", (1024, 1024, 1000))):
        desc, valid, qd, qv = candidate_problem(rng, K_, N_, Nq)
        blocks = [kfb.shard_kf_axis(mesh, a) for a in (desc, valid)]
        qt = (torch.from_numpy(qd), torch.from_numpy(qv))
        ck = kfb.gather_host(kfb.sharded_loop_candidate_match(mesh, *blocks, *qt))
        cp, p_ms = timed(lambda: kfb.sharded_loop_candidate_match_plain(mesh, *blocks, *qt))
        cp = kfb.gather_host(cp)
        line = (f"kf_match {name} on {n} shards: counts equal {np.array_equal(ck, cp)}, best "
                f"keyframe {int(np.argmax(ck))} ({int(ck.max())} mutual matches), keyframe 4 "
                f"(masked) {int(ck[4])}")
        if not (np.array_equal(ck, cp) and int(np.argmax(ck)) == 11 and ck[4] == 0):
            raise AssertionError(line)
        print(f"[parity-mesh] {line}", flush=True)
        d34 = max(d34, int(np.abs(ck - cp).max()))
    # work: every (query, keyframe descriptor) pair twice (the row and the
    # column argmin), 8 XOR + 8 popcounts + 8 adds and a compare each; in: the
    # descriptors and masks once, out: the counts
    stats["kf_match"] = record(
        float(d34), cuda_ms(lambda: kfb.sharded_loop_candidate_match(mesh, *blocks, *qt),
                            reps=10), p_ms,
        K_ * N_ * 33 + Nq * 33 + K_ * 4, 2 * K_ * N_ * Nq * 25)
    return stats


def phase_mesh_api(dev):
    """[mesh-api]: the mesh's two functions that no engine path calls,
    through their entry points over ``mesh_devices`` (the counts cleared
    before and read after): ``optimize_sharded`` (K33) on the [loop] map's
    global problem with its observations sharded and its free points moved
    by 1 cm (seeded), and ``sharded_loop_candidate_match`` (K34) of keyframe
    5's descriptors against every keyframe of the [loop] map,
    keyframe-sharded.  The BA's sum of chi2 must fall and keyframe 5 must
    hold the most matches.  Returns the launches."""
    devs = mesh_devices(dev)
    mesh = dmesh.Mesh(devs)
    n = mesh.size
    mp, _, _, _ = looped_map(dev)
    gprob = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    noise = torch.from_numpy(np.random.default_rng(17).normal(
        0, 0.01, tuple(gprob.points.shape)).astype(np.float32)).to(dev)
    gprob = gprob._replace(points=gprob.points + noise * (~gprob.fixed_mp)[:, None])
    O = gprob.obs_kf.shape[0]
    if O % n:
        raise AssertionError(f"[mesh-api] {O} observations on {n} shards")
    kids = sorted(mp.keyframes)
    desc = np.stack([mp.keyframes[k].desc for k in kids])
    valid = np.stack([mp.keyframes[k].valid for k in kids])
    qd, qv = desc[5], valid[5]
    blocks = [kfb.shard_kf_axis(mesh, kfb.pad_to_mesh(a, n)) for a in (desc, valid)]
    c0 = float(sharded_ba.optimize_sharded_plain(mesh, gprob, loop_camera(), n_iters=0).cost)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    res = sharded_ba.optimize_sharded(mesh, gprob, loop_camera())
    counts = kfb.gather_host(kfb.sharded_loop_candidate_match(
        mesh, *blocks, torch.from_numpy(qd), torch.from_numpy(qv)))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"ba_pcg_sharded": 1, "kf_match": n}
    line = (f"[mesh-api] optimize_sharded on the [loop] map's problem over {n} shards K="
            f"{gprob.R.shape[0]} P={gprob.points.shape[0]} O={O}: chi2 {c0:.6g} -> "
            f"{float(res.cost):.6g}, {int(res.inliers.sum())} inliers; "
            f"sharded_loop_candidate_match of keyframe 5 against {len(kids)} keyframes: best "
            f"{int(np.argmax(counts))} ({int(counts.max())} of {int(qv.sum())}); launches "
            f"{launches}")
    if launches != want or not float(res.cost) < c0 or counts[5] != counts.max():
        raise AssertionError(line)
    print(line, flush=True)
    return launches


class _MeshRecorder(_InertialRecorder):
    """Keeps the arguments of every K29 and K31 wrapper call of a run."""

    NAMES = ((kfb, "sharded_place_scores", "place_dense"),
             (dpg, "optimize_sharded_pose_graph", "pose_graph_sharded"))


def phase_loop_mesh(dev):
    """[loop-mesh]: [loop] over a device mesh (``mesh_devices``: 4 shards of
    the card, or the visible cards) with [loop]'s 512-word vocabulary on the
    database's device backend and every essential graph edge-sharded: the
    loop closes at the keyframe pair of [loop]'s one-shard run, the
    keyframes at the loop event (the essential graph applied, the GBA not
    yet) stay within 2e-3 of that run's, the GBA is applied at ``finish``,
    and K29 (once per card and query), K30 and K31 (once each) run in
    place of K14 and K13.  Each query's dense scores are held to the host
    pass's (within 1e-5) and their near-ties printed; the loop event's host
    ms, and its device ms from a profiled run (the union of its device
    events).  Returns the launches and the loop's essential graph."""
    import chip_profile

    devs = mesh_devices(dev)
    keep1, keep = {}, {}
    _, _, loops1, _, _, _ = run_loop(dev, keep=keep1)
    rec = _MeshRecorder()
    kernels.LAUNCHES.clear()
    with rec:
        mp, closer, loops, ms, centres, n_gba = run_loop(dev, devices=devs, keep=keep)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_q, n_sh, n_cards = len(rec.calls["place_dense"]), len(devs), len(set(devs))
    want = {"place_dense": n_q * n_cards, "ba_schur_sharded": 1, "pose_graph_sharded": 1,
            "ba_schur": 0, "pose_graph": 0}
    bad = {k: launches.get(k, 0) for k, v in want.items() if launches.get(k, 0) != v}
    same_kfs = set(keep["before"]) == set(keep1["before"])
    d_pose = max(max(float(np.abs(-R.T @ t + R1.T @ t1).max()), float(np.abs(R - R1).max()))
                 for k, (R, t) in keep["before"].items()
                 for R1, t1 in [keep1["before"][k]]) if same_kfs else float("inf")
    if len(loops) != 1 or loops != loops1 or n_gba != 1 or n_q == 0 or bad or \
            not d_pose <= 2e-3:
        raise AssertionError(f"[loop-mesh] loops {loops} (one shard {loops1}), GBA applied "
                             f"{n_gba}, {n_q} queries, launches {launches} (off: {bad}), poses "
                             f"{d_pose:.2e} from the one-shard run's")
    # each query's dense scores against the host formula on the same entries
    d_sc, ties = 0.0, []
    for (args, _) in rec.calls["place_dense"]:
        m_, h, w, v, q = args
        sc = kfb.gather_host(kfb.sharded_place_scores(m_, h, w, v, q)[0])
        ref = 1.0 - 0.5 * np.abs(kfb.gather_host(h).astype(np.float64)
                                 - np.asarray(q)[None]).sum(1)
        ok = kfb.gather_host(v)
        d_sc = max(d_sc, float(np.abs(sc[ok] - ref[ok]).max()))
        top = np.sort(sc[ok])[::-1][:5]
        ties += [float(a - b) for a, b in zip(top[:-1], top[1:]) if a - b < 1e-5]
    if not d_sc <= 1e-5:
        raise AssertionError(f"[loop-mesh] dense scores {d_sc:.2e} from the host formula")
    (gmesh, graph), _ = rec.calls["pose_graph_sharded"][0]
    E = int(graph.edge_valid.sum())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, loops_p, ms_p, _, _ = run_loop(dev, devices=devs, mark=True)
    device, _, _ = chip_profile.device_ms_per_frame(prof, len(ms_p))
    del prof
    k = len(ms) - 1
    print(f"[loop-mesh] {n_sh} shards ({', '.join(str(d) for d in devs)}; the peer route "
          f"{'ran' if len(set(devs)) > 1 else 'did not run: one card'}): one loop at keyframe "
          f"{loops[0][0]} (matched {loops[0][1]}) as [loop]'s one-shard run; the essential graph "
          f"E={E} edges (padded to {graph.edge_i.shape[0]}) edge-sharded; keyframes at the loop "
          f"event within {d_pose:.2e} of the one-shard run's; GBA over {gmesh.size} landmark "
          f"shards applied at finish", flush=True)
    print(f"[loop-mesh] {n_q} queries on the dense backend: max |d score| {d_sc:.2e} from the "
          f"host formula; near-ties (< 1e-5) among each query's top 5: "
          f"{['%.1e' % x for x in ties] or 'none'}", flush=True)
    print(f"[loop-mesh] loop event (keyframe event {k}): host {ms[k]:.2f} ms, device "
          f"{device[k]:.3f} ms (profiled run: loops {loops_p}); other events' median host "
          f"{statistics.median(ms[:k]):.2f} ms", flush=True)
    print(f"[loop-mesh] launches {launches}", flush=True)
    return launches, graph


def vi_frames(width: int = WIDTH, height: int = HEIGHT, n: int = VI_FRAMES):
    return pf.render_vi_sequence(pf.procedural_texture(), n, width, height)


def phase_vi(frames, dev):
    """[vi]: ``System.track_monocular(img, ts, imu=...)`` over the 40-frame
    visual-inertial sequence at 640x480 / 1000 features from a cold map.
    The IMU initialises, the last 4 frames are OK, the metric scale and the
    ATE stay inside test_vi_e2e's bounds, the K19-K22 launches equal the
    tracker's own counts, and every fused inertial frame but its step key's
    first two is one replay of the inertial step's CUDA graph."""
    host_ms, kf_ids, inited = [], [], []

    def on_frame(k, st, dt, sys_):
        host_ms.append(dt * 1e3)
        kf_ids.append([kf.frame_id for kf in sys_.tracker.atlas.current.keyframes.values()])
        inited.append(sys_.tracker.atlas.current.imu_initialized)

    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    before = graph_counts(cached_graph(vi_config(), dev))
    torch.cuda.synchronize()
    sys_, states = run_vi(frames, dev, on_frame=on_frame)
    sys_.flush()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr = sys_.tracker
    st = tr.stats
    ate, scale = pf.vi_ate_scale(tr.final_trajectory())
    init_at = inited.index(True) if any(inited) else None
    own = {"preint": st["preint"], "vi_ba": st["vi_ba"], "inertial_init": st["inertial_init"],
           "pose_inertial": st["pose_inertial"] + st["pose_inertial_joint"] + st["fused_inertial"],
           "pose_inertial_joint": st["pose_inertial_joint"] + st["fused_inertial"],
           "ba_pcg": st["ba"], "two_view": st["two_view"]}
    bad = {n: (launches.get(n, 0), c) for n, c in own.items() if launches.get(n, 0) != c}
    missing = [n for n in VISUAL_KERNELS + INERTIAL_KERNELS
               if n not in ("stereo_match", "pnp_ransac") and launches.get(n, 0) == 0]
    if (init_at is None or any(s != TrackState.OK for s in states[-4:]) or bad or missing
            or not abs(scale - 1.0) < VI_MAX_SCALE_ERR or not ate < VI_MAX_ATE
            or st["fused_inertial"] != tr.n_fused_frames or tr.n_fused_frames < 1):
        raise AssertionError(f"[vi] states {[s.name for s in states]}, IMU init at {init_at}, "
                             f"scale {scale:.4f}, ATE {ate:.4f} m, fused {tr.n_fused_frames}, "
                             f"launches vs tracker {bad}, never launched {missing}")
    graph = inertial_graph_counts("[vi]", sys_, before)
    kf_set = {k for k in range(1, len(kf_ids)) if kf_ids[k] and kf_ids[k][-1] == k}
    for k, (s_, ms) in enumerate(zip(states, host_ms)):
        tag = ("  keyframe event" if k in kf_set else "") + ("  IMU initialised" if k == init_at
                                                               else "")
        print(f"[vi] frame {k:2d}: {ms:8.2f} ms host clock  {s_.name:15s}{tag}", flush=True)
    steady = [ms for k, ms in enumerate(host_ms) if init_at is not None and k > init_at + 1
              and k not in kf_set]
    print(f"[vi] IMU initialised at frame {init_at}, {sys_.n_keyframes()} keyframes, "
          f"{tr.n_fused_frames} fused inertial frames ({st['fused_prior']} with the legacy "
          f"solve's prior), scale {scale:.4f} (|s - 1| < {VI_MAX_SCALE_ERR}), ATE {ate:.4f} m "
          f"(< {VI_MAX_ATE}); fused-frame median "
          f"{statistics.median(steady) if steady else float('nan'):.2f} ms host clock",
          flush=True)
    print(f"[vi] inertial step graph: {graph['eager']} eager, {graph['captures']} capture(s), "
          f"{graph['replays']} replays for {graph['fused']} fused frames", flush=True)
    print(f"[vi] launches {launches}; tracker counts {own}", flush=True)
    return launches, states, init_at, kf_ids, [e for e in tr.trajectory]


def phase_graph_vi(tag: str, frames, cfg, dev):
    """[graph-vi]: ``tag``'s sequence (``run_vi`` with ``cfg``) through the
    inertial step's CUDA graph and through ``graph=False`` from a cold map:
    every step's outputs bit-equal (v, bg, ba and H15 with them) and the
    same trajectory.  Prints the graph's kernel nodes and replays, and the
    medians over the replayed fused inertial steps of their CUDA-event ms
    and host ms against the same steps' eager launches, with the fused
    frames' track-call host ms.  The eager run keeps K19-K22's arguments
    (``_InertialRecorder``: the graph's would be its static buffers, and a
    replay calls no wrapper), which [parity] holds the kernels to.  Returns
    (that recorder, the numbers)."""
    runs = {}
    for graph in (None, False):
        frame_ms, fused_frames, seen = [], [], [0]
        kernels.GRAPH_LAUNCHES.clear()
        before = graph_counts(cached_graph(cfg, dev))
        with contextlib.ExitStack() as stack:
            outs = stack.enter_context(_StepOutputs())
            rec = stack.enter_context(_InertialRecorder()) if graph is False else None

            def on_frame(k, st, dt, s_):
                frame_ms.append(dt * 1e3)
                if len(outs.calls) > seen[0] and outs.calls[-1]["inertial"]:
                    fused_frames.append(k)
                seen[0] = len(outs.calls)

            sys_ = System(cfg, device=dev)
            sys_.tracker.step_graph = graph
            torch.cuda.synchronize()
            run_vi(frames, dev, cfg=cfg, on_frame=on_frame, sys_=sys_)
            sys_.flush()
            torch.cuda.synchronize()
        gc = inertial_graph_counts(f"[graph-vi] {tag}", sys_, before) if graph is None else None
        runs[graph] = (sys_, outs.calls, rec, frame_ms, fused_frames, gc)
    (sg, cg, _, fg, kg, gc), (se, ce, rec_e, fe, ke, _) = runs[None], runs[False]
    if len(cg) != len(ce) or kg != ke or not any(c["inertial"] for c in cg):
        raise AssertionError(f"{tag} graph run: {len(cg)} steps, fused inertial frames {kg}; "
                             f"eager run: {len(ce)}, {ke}")
    for k, (a, b) in enumerate(zip(cg, ce)):
        diff = _differing(a, b)
        if diff:
            raise AssertionError(f"{tag} step {k}: {diff} differ between the graph and the "
                                 "eager launches")
    tg, te = sg.tracker.trajectory, se.tracker.trajectory
    if len(tg) != len(te) or not all(np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
                                     for x, y in zip(tg, te)):
        raise AssertionError(f"{tag} graph and eager trajectories differ")
    rep = [k for k, c in enumerate(cg) if c["inertial"] and c["replay"]]
    med = lambda v: statistics.median(v) if v else float("nan")
    ev = lambda calls: med([calls[k]["events"][0].elapsed_time(calls[k]["events"][1])
                            for k in rep])
    hs = lambda calls: med([calls[k]["host_ms"] for k in rep])
    out = dict(gc, ms=ev(cg), plain_ms=ev(ce), step_host_ms=hs(cg), plain_step_host_ms=hs(ce),
               frame_host_ms=med([fg[k] for k in kg]), plain_frame_host_ms=med([fe[k] for k in ke]))
    print(f"[graph-vi] {tag}: the inertial step as one CUDA graph ({gc['kernel_nodes']} kernel "
          f"nodes of {gc['nodes']}, {sum(gc['wrapper_launches'].values())} kernel-wrapper "
          f"launches captured: {gc['wrapper_launches']}); all outputs of {len(cg)} steps "
          f"({len(kg)} fused inertial, {gc['replays']} replays, {gc['eager']} eager, "
          f"{gc['captures']} capture(s)) bit-equal to graph=False's, trajectories equal; median "
          f"over the replayed steps: {out['ms']:.3f} ms events / {out['step_host_ms']:.3f} ms "
          f"host per replay, eager {out['plain_ms']:.3f} / {out['plain_step_host_ms']:.3f} ms; "
          f"fused frames' track call {out['frame_host_ms']:.2f} ms host (eager "
          f"{out['plain_frame_host_ms']:.2f})", flush=True)
    print(f"[graph-vi] {tag} " + json.dumps(out), flush=True)
    return rec_e, out


def _largest(calls, size):
    return max(calls, key=size)


def device_note(rec: dict, trace, tag: str) -> None:
    """A kernel's record gets its device ms and kernels a call from a
    fresh process's profiler trace (run_traces)."""
    n_kern, dms, glue = trace[:3]
    rec.update(device_ms=dms, kernels_per_call=n_kern)
    print(f"[parity] {tag}: {dms:.4f} device ms a call, {n_kern:g} of the port's kernels "
          f"({glue:g} other device events; a fresh process's profiler trace)", flush=True)


def vi_cluster_record(prob, cam, it: int, cg: int, vk, tag: str, rec: dict) -> None:
    """K20, one cluster launch a call, against K32's passes launched one by
    one on one shard (the parent's route, ~9 + it (6 + 3 cg) + 2 launches a
    call): bit-equal to them on ``prob`` (vk: K20's result) and timed in
    turns; at the run's end one of the port's kernels a call in a fresh
    process's profiler trace (the wrapper's PyTorch glue apart), and K20's
    device ms beside its CUDA-event ms.  Into rec."""
    one_shard = dmesh.Mesh([prob.points.device])
    solve = lambda: sin.optimize_vi_ba(prob, cam, n_iters=it, cg_iters=cg)
    passes = lambda: sharded_ba.optimize_vi_sharded(one_shard, prob, cam, n_iters=it,
                                                    cg_iters=cg)
    vm = passes()
    if not all(torch.equal(getattr(vm, f), getattr(vk, f)) for f in sin.VIBAResult._fields):
        raise AssertionError(f"{tag} {it} x {cg}: the cluster solve differs from the passes "
                             "launched one by one")
    ms, passes_ms = paired_ms(solve, passes, reps=6)
    parent = 9 + it * (6 + 3 * cg) + 2
    rec.update(parent_launches_per_call=parent, passes_ms=passes_ms, cluster_ms=ms)
    print(f"[parity] {tag} {it} x {cg}: bit-equal to the passes launched one by one; "
          f"{ms:.4f} ms against the passes' {passes_ms:.4f} (in turns); the parent: {parent} "
          f"launches a call", flush=True)

    def solved(trace):
        if trace[0] != 1:
            raise AssertionError(f"{tag} {it} x {cg}: {trace[0]} of the port's device kernels "
                                 "a call")
        device_note(rec, trace, f"{tag} {it} x {cg}")

    def passed(trace):
        rec["passes_kernels_per_call"] = trace[0]
        print(f"[parity] {tag} {it} x {cg}, the passes one by one: {trace[0]:g} device "
              "kernels a call", flush=True)

    trace_later(f"{tag} solve", ("vi_ba", (prob, cam, it, cg), {}), solved)
    trace_later(f"{tag} passes", ("vi_ba_passes", (prob, cam, it, cg), {}), passed)


def phase_parity_inertial(rec, dev) -> dict:
    """K19-K22 against their plain versions on the card, on the [vi] run's
    own inputs (its largest call of each), with their times and bounds."""
    stats = {}

    def err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    # K19: the largest batch of windows; fields within 1e-5 and C within 1e-4
    # of each field's largest entry
    args, _ = _largest(rec.calls["preint"], lambda c: c[0][0].numel())
    pk = preint_mod.integrate_batch(*args)
    pp = preint_mod.integrate_batch_plain(*args)
    rel = {f: float((getattr(pk, f) - getattr(pp, f)).abs().max()
                    / getattr(pp, f).abs().max().clamp(min=1e-30))
           for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dT", "C")}
    if max(v for f, v in rel.items() if f != "C") > 1e-5 or rel["C"] > 1e-4:
        raise AssertionError(f"preint: relative deviations {rel}")
    B, T = args[1].shape[0], args[1].shape[1]
    nv = int(args[3].sum())
    stats["preint"] = record(max(rel.values()), cuda_ms(lambda: preint_mod.integrate_batch(*args)),
                             cuda_ms(lambda: preint_mod.integrate_batch_plain(*args), reps=3),
                             B * T * 29 + B * 24 + B * 286 * 4, nv * 4700)
    print(f"[parity] preint B={B} T={T} ({nv} samples): fields within {max(rel.values()):.2e} "
          f"of their largest entry (C {rel['C']:.2e})", flush=True)
    # and at its per-frame window: the run's median call by samples
    calls = sorted(rec.calls["preint"], key=lambda c: int(c[0][3].sum()))
    args, _ = calls[len(calls) // 2]
    B, T, nv = args[1].shape[0], args[1].shape[1], int(args[3].sum())
    fw = record(0.0, cuda_ms(lambda: preint_mod.integrate_batch(*args)),
                cuda_ms(lambda: preint_mod.integrate_batch_plain(*args), reps=3),
                B * T * 29 + B * 24 + B * 286 * 4, nv * 4700)
    stats["preint"].update(frame_window=dict(
        B=B, T=T, samples=nv, calls=len(calls), ms=fw["ms"], plain_ms=fw["plain_ms"],
        bound_ms=fw["bound_ms"], bound_by=fw["bound_by"]))
    print(f"[parity] preint at the median window of the run's {len(calls)} calls: B={B} T={T} "
          f"({nv} samples) {stats['preint']['frame_window']['ms']:.4f} ms", flush=True)

    # K20: the largest VI BA (states and points within 1e-4, as K6; inliers
    # equal), and one result per input over 5 calls
    args, kw = _largest(rec.calls["vi_ba"], lambda c: c[0][0].obs_kf.shape[0])
    prob, cam = args[0], args[1]
    it, cg = kw.get("n_iters", 8), kw.get("cg_iters", 50)
    vk = sin.optimize_vi_ba(prob, cam, n_iters=it, cg_iters=cg)
    vp = sin.optimize_vi_ba_plain(prob, cam, n_iters=it, cg_iters=cg)
    fields = ("Rwb", "twb", "v", "bg", "ba", "points")
    d = err([getattr(vk, f) for f in fields], [getattr(vp, f) for f in fields])
    same = all(all(torch.equal(getattr(sin.optimize_vi_ba(prob, cam, n_iters=it, cg_iters=cg), f),
                               getattr(vk, f)) for f in sin.VIBAResult._fields) for _ in range(4))
    if d > 1e-4 or not torch.equal(vk.inliers, vp.inliers) or not same:
        raise AssertionError(f"vi_ba: max deviation {d:.2e}, inliers equal "
                             f"{torch.equal(vk.inliers, vp.inliers)}, deterministic {same}")
    K, P, O = prob.Rwb.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]
    ov = int(prob.obs_valid.sum())
    stats["vi_ba"] = record(
        d, cuda_ms(lambda: sin.optimize_vi_ba(prob, cam, n_iters=it, cg_iters=cg), reps=5),
        cuda_ms(lambda: sin.optimize_vi_ba_plain(prob, cam, n_iters=it, cg_iters=cg), reps=1),
        K * (84 + 1168 + 3) + P * 13 + O * 21 + 48 + K * 84 + P * 12 + O + 4,
        it * (ov * (150 + cg * 80) + K * (2 * 16 * 2500 + cg * 2 * 15 * 30 * 2) + P * cg * 30))
    vi_cluster_record(prob, cam, it, cg, vk, "vi_ba", stats["vi_ba"])
    print(f"[parity] vi_ba K={K} P={P} O={O} ({it} LM x {cg} PCG): states and points within "
          f"{d:.2e}, inliers equal ({int(vk.inliers.sum())}); 5 calls bit-identical", flush=True)

    # K21: the first init solve, against the plain version with float64 normal
    # equations (the kernel's recorded divergence); within 1e-4
    args, kw = rec.calls["inertial_init"][0]
    ik = sin.inertial_only(*args, **kw)
    ip = sin.inertial_only_plain(*args, **kw, solve_dtype=torch.float64)
    fields = ("Rwg", "v", "bg", "ba")
    d = max(err([getattr(ik, f) for f in fields], [getattr(ip, f) for f in fields]),
            float(abs(ik.scale - ip.scale) / ip.scale.abs().clamp(min=1.0)))
    if d > 1e-4:
        raise AssertionError(f"inertial_init: max deviation {d:.2e}")
    K = args[0].shape[0]
    n, n_it = 9 + 3 * K, kw.get("n_iters", 30)
    stats["inertial_init"] = record(
        d, cuda_ms(lambda: sin.inertial_only(*args, **kw), reps=5),
        cuda_ms(lambda: sin.inertial_only_plain(*args, **kw, solve_dtype=torch.float64), reps=1),
        K * (36 + 12 + 1168 + 1 + 12) + 24 + 36 + (17 + 3 * K) * 4,
        n_it * K * 16 * 3000, ops64=n_it * (n ** 3 // 3 + 2 * K * 225 * 9))
    print(f"[parity] inertial_init K={K} (n={n}): scale, gravity, velocities and biases within "
          f"{d:.2e} (plain version with float64 normal equations)", flush=True)

    # K22: the fused step's joint solve and the same problem without the
    # prior (the legacy variant); states within 1e-4, inliers equal, the
    # Hessian within 1e-4 and the marginalised prior within 1e-3 relative
    args, kw = _largest(rec.calls["pose_inertial_joint"], lambda c: int(c[0][10].sum()))
    for joint in (True, False):
        fk = sin.optimize_pose_inertial_last_frame if joint else sin.optimize_pose_inertial
        fp = (sin.optimize_pose_inertial_last_frame_plain if joint
              else sin.optimize_pose_inertial_plain)
        kwj = kw if joint else {}
        rk, rp = fk(*args, **kwj), fp(*args, **kwj)
        fields = ("Rwb", "twb", "v", "bg", "ba")
        d = err([getattr(rk, f) for f in fields], [getattr(rp, f) for f in fields])
        hrel = float((rk.H - rp.H).abs().max() / rp.H.abs().max())
        if d > 1e-4 or not torch.equal(rk.inliers, rp.inliers) or hrel > (1e-3 if joint else 1e-4):
            raise AssertionError(f"pose_inertial joint={joint}: max deviation {d:.2e}, H "
                                 f"{hrel:.2e}, inliers equal {torch.equal(rk.inliers, rp.inliers)}")
        N, nv = args[7].shape[0], int(args[10].sum())
        n = 30 if joint else 15
        stats["pose_inertial_joint" if joint else "pose_inertial"] = record(
            max(d, hrel), cuda_ms(lambda: fk(*args, **kwj), reps=10),
            cuda_ms(lambda: fp(*args, **kwj), reps=1), 592 * 4 + N * 25 + 246 * 4 + N + 4,
            41 * (nv * 150 + (3 if joint else 1) * 16 * 2500 + n ** 3 // 3))
        print(f"[parity] pose_inertial joint={joint} N={N} ({nv} points): states within "
              f"{d:.2e}, H within {hrel:.2e} relative, inliers equal "
              f"({int(rk.inliers.sum())})", flush=True)
    return stats


def phase_vi_reference(frames, card_states, init_at, card_kf_ids, card_traj):
    """[vi-reference]: the same frames through the IMU initialisation and two
    frames after it on the CPU plain path: the same states, the same init
    frame and keyframes; the scale and pose differences are reported."""
    n = init_at + 3
    inited = []
    cpu_sys, cpu_states = run_vi(frames[:n], torch.device("cpu"), on_frame=lambda k, st, dt, s:
                                 inited.append(s.tracker.atlas.current.imu_initialized))
    cpu_init = inited.index(True) if any(inited) else None
    kf_c = [kf.frame_id for kf in cpu_sys.tracker.atlas.current.keyframes.values()]
    kf_g = card_kf_ids[n - 1]
    if cpu_states != card_states[:n] or cpu_init != init_at or kf_c != kf_g:
        raise AssertionError(f"[vi-reference] states {[s.name for s in cpu_states]} vs card "
                             f"{[s.name for s in card_states[:n]]}, IMU init {cpu_init} vs "
                             f"{init_at}, keyframes {kf_c} vs {kf_g}")
    tc = cpu_sys.tracker.trajectory
    dp = max(max(float(np.abs(Rc - Rg).max()), float(np.abs(pc - pg).max()))
             for (_, Rc, pc), (_, Rg, pg) in zip(tc, card_traj))
    _, sc = pf.vi_ate_scale(tc)
    _, sg = pf.vi_ate_scale(card_traj[: len(tc)])
    print(f"[vi-reference] frames 0-{n - 1}: states, keyframes and the IMU init frame "
          f"({init_at}) equal to the CPU plain path's; max |dpose| {dp:.2e}, scale "
          f"{sc:.5f} (CPU) vs {sg:.5f} (card)", flush=True)


# ----------------------------------------- stereo-inertial and inertial loop


def vi_stereo_frames(width: int = WIDTH, height: int = HEIGHT, n: int = VI_STEREO_FRAMES):
    left, right, _ = pf.render_vi_stereo_sequence(pf.procedural_texture(), n, width, height,
                                                  STEREO_BASELINE)
    return left, right


def phase_vi_stereo(left, right, dev):
    """[vi-stereo]: ``System.track_stereo(l, r, ts, imu=...)`` over the
    visual-inertial scene seen by the rig, 640x480 / 1000 features, from a
    cold map.  Every frame is OK, the IMU initialises (K21 with the scale
    fixed, then K20), no frame takes the fused step, |s - 1| < 0.05, ATE <
    0.25 m, and the K9 and K19-K22 launches equal the tracker's counts, K22's
    legacy variant among them."""
    host_ms, kf_ids, inited = [], [], []

    def on_frame(k, st, dt, sys_):
        host_ms.append(dt * 1e3)
        kf_ids.append([kf.frame_id for kf in sys_.tracker.atlas.current.keyframes.values()])
        inited.append(sys_.tracker.atlas.current.imu_initialized)

    kernels.LAUNCHES.clear()
    with _InertialRecorder() as rec:
        torch.cuda.synchronize()
        sys_, states = run_vi(left, dev, on_frame=on_frame, rights=right)
        sys_.flush()
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr = sys_.tracker
    st = tr.stats
    ate, scale = pf.vi_ate_scale(tr.final_trajectory())
    init_at = inited.index(True) if any(inited) else None
    own = {"stereo_match": st["stereo_match"], "preint": st["preint"], "vi_ba": st["vi_ba"],
           "inertial_init": st["inertial_init"],
           "pose_inertial": st["pose_inertial"] + st["pose_inertial_joint"],
           "pose_inertial_joint": st["pose_inertial_joint"], "ba_pcg": st["ba"]}
    bad = {n: (launches.get(n, 0), c) for n, c in own.items() if launches.get(n, 0) != c}
    fixed = [kw.get("fix_scale") for _, kw in rec.calls["inertial_init"]]
    legacy = launches.get("pose_inertial", 0) - launches.get("pose_inertial_joint", 0)
    if (init_at is None or any(s != TrackState.OK for s in states) or bad or not fixed
            or not all(fixed) or legacy < 1 or not launches.get("vi_ba")
            or tr.n_fused_frames or not abs(scale - 1.0) < VI_STEREO_MAX_SCALE_ERR
            or not ate < VI_MAX_ATE):
        raise AssertionError(f"[vi-stereo] states {[s.name for s in states]}, IMU init at "
                             f"{init_at} (fix_scale {fixed}), scale {scale:.4f}, ATE {ate:.4f} m, "
                             f"fused {tr.n_fused_frames}, legacy K22 {legacy}, launches vs "
                             f"tracker {bad}")
    kf_set = {k for k in range(1, len(kf_ids)) if kf_ids[k] and kf_ids[k][-1] == k}
    for k, (s_, ms) in enumerate(zip(states, host_ms)):
        tag = ("  keyframe event" if k in kf_set else "") + ("  IMU initialised" if k == init_at
                                                               else "")
        print(f"[vi-stereo] frame {k:2d}: {ms:8.2f} ms host clock  {s_.name:15s}{tag}",
              flush=True)
    steady = [ms for k, ms in enumerate(host_ms) if k > init_at + 1 and k not in kf_set]
    print(f"[vi-stereo] IMU initialised at frame {init_at} (fix_scale), {sys_.n_keyframes()} "
          f"keyframes, no fused frame, {legacy} legacy K22 solves without a prior and "
          f"{st['pose_inertial_joint']} with one, scale {scale:.4f} "
          f"(|s - 1| < {VI_STEREO_MAX_SCALE_ERR}), ATE {ate:.4f} m (< {VI_MAX_ATE}); post-init "
          f"frame median {statistics.median(steady) if steady else float('nan'):.2f} ms host "
          f"clock", flush=True)
    print(f"[vi-stereo] launches {launches}; tracker counts {own}", flush=True)
    return launches, rec, states, init_at, kf_ids, [e for e in tr.trajectory]


def phase_vi_stereo_reference(left, right, card_states, init_at, card_kf_ids, card_traj):
    """[vi-stereo-reference]: the same frames on the CPU plain path: the
    same states, IMU init frame and keyframes, every pose within 1e-3."""
    inited = []
    cpu_sys, cpu_states = run_vi(left, torch.device("cpu"), rights=right,
                                 on_frame=lambda k, st, dt, s: inited.append(
                                     s.tracker.atlas.current.imu_initialized))
    cpu_init = inited.index(True) if any(inited) else None
    kf_c = [kf.frame_id for kf in cpu_sys.tracker.atlas.current.keyframes.values()]
    tc = cpu_sys.tracker.trajectory
    dp = max(max(float(np.abs(Rc - Rg).max()), float(np.abs(pc - pg).max()))
             for (_, Rc, pc), (_, Rg, pg) in zip(tc, card_traj))
    if cpu_states != card_states or cpu_init != init_at or kf_c != card_kf_ids[-1] \
            or len(tc) != len(card_traj) or not dp <= 1e-3:
        raise AssertionError(f"[vi-stereo-reference] states {[s.name for s in cpu_states]} vs "
                             f"card {[s.name for s in card_states]}, IMU init {cpu_init} vs "
                             f"{init_at}, keyframes {kf_c} vs {card_kf_ids[-1]}, max |dpose| "
                             f"{dp:.2e}")
    _, sc = pf.vi_ate_scale(tc)
    _, sg = pf.vi_ate_scale(card_traj)
    print(f"[vi-stereo-reference] frames 0-{len(left) - 1}: states, keyframes and the IMU init "
          f"frame ({init_at}) equal to the CPU plain path's; max |dpose| {dp:.2e}, scale "
          f"{sc:.5f} (CPU) vs {sg:.5f} (card)", flush=True)


def inertial_looped_map(dev, calib: ImuCalib, kb8: bool = False):
    """The [vi-loop] map: [loop]'s map built with ``inertial=True`` (prev_kf
    chain, velocities, zero biases, the true motion's 100 Hz windows
    preintegrated on ``dev``, in a gravity-aligned world; yaw drift).  With
    ``kb8`` the [vi-loop-kb8] map, its keypoints in the KB8 image."""
    zero = np.zeros(6, np.float32)
    return pf.build_looped_map(0, SLAMMap, KeyFrame, _map_feats(dev), n_kf=LOOP_KFS,
                               n_pts=LOOP_POINTS, step=LOOP_STEP, n_cap=SYS_FEATURES + 8 * 16,
                               return_shift=LOOP_STEP / 2, inertial=True,
                               preintegrate=lambda m: imu_frontend.integrate_raw_host(
                                   m, zero, calib, dev),
                               camera=pf.kb8_camera() if kb8 else None)


def run_vi_loop(dev, kb8: bool = False, devices=None, mark: bool = False):
    """The [vi-loop] closer over the inertial looped map until the first
    loop, then ``finish`` (over the mesh of ``devices`` with ``use_devices``
    when given; ``mark``: event i in a profiler range ``frame_i``).
    Returns the map, the closer, the closing keyframe, each keyframe event's
    host ms, the true centres, each keyframe's drift before the loop, each
    4-DoF graph with its solved rotations, the one-device VI BA calls, the
    sharded VI BA calls and the launches."""
    calib = ImuCalib.from_config(vi_config().imu)
    graphs, real = [], pose_graph.optimize_pose_graph_4dof
    vibas, real_vi = [], sin.optimize_vi_ba
    sharded, real_sh = [], sharded_ba.optimize_vi_sharded

    def spy(prob, *args, **kw):
        res = real(prob, *args, **kw)
        graphs.append((prob, res[0].cpu().numpy()))
        return res

    def spy_vi(prob, cam_, **kw):
        vibas.append((prob, cam_, kw))
        return real_vi(prob, cam_, **kw)

    def spy_sh(mesh, prob, cam_, **kw):
        sharded.append((mesh, prob, cam_, kw))
        return real_sh(mesh, prob, cam_, **kw)

    ms, closed = [], None
    pose_graph.optimize_pose_graph_4dof = spy
    sin.optimize_vi_ba = spy_vi
    sharded_ba.optimize_vi_sharded = spy_sh
    try:
        with dmesh.use_devices(devices) if devices else contextlib.nullcontext():
            mp, _, desc, centres = inertial_looped_map(dev, calib, kb8=kb8)
            drift = {k: float(np.linalg.norm(-kf.R.T @ kf.t - centres[k]))
                     for k, kf in mp.keyframes.items()}
            voc = vocab_mod.Vocabulary.train(desc, k=8, L=3, seed=0)
            closer = loop_closing.LoopCloser(voc, loop_camera(kb8),
                                             inv_sigma2=[1.2 ** (-2 * i) for i in range(8)],
                                             imu_calib=calib, device=dev,
                                             img_wh=(KB8_SIZE, KB8_SIZE) if kb8 else None)
            kernels.LAUNCHES.clear()
            for kid in sorted(mp.keyframes):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (torch.profiler.record_function(f"frame_{len(ms)}") if mark
                      else contextlib.nullcontext()):
                    got = closer.process_keyframe(mp, kid)
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if got:
                    closed = kid
                    break
            closer.finish(mp)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        pose_graph.optimize_pose_graph_4dof = real
        sin.optimize_vi_ba = real_vi
        sharded_ba.optimize_vi_sharded = real_sh
    return mp, closer, closed, ms, centres, drift, graphs, vibas, sharded, launches


def phase_vi_loop(dev, kb8: bool = False, devices=None):
    """[vi-loop]: the inertial looped map at [loop]'s size through
    ``LoopCloser.process_keyframe`` with a vocabulary and the map's IMU
    calibration, to the first loop: K23 solves the 4-DoF essential graph
    once, the inertial GBA runs K20, no Sim3 graph or Schur GBA runs, the
    closing keyframe ends within half its drift, and K23's solve moves no
    keyframe's roll or pitch (its gravity direction in the camera) by 1e-5
    or more, measured on its output before the GBA runs.  With ``kb8``
    [vi-loop-kb8]: the map's keypoints in TUM-VI's 512x512 KB8 image and the
    closer through that camera (K12<KB8>, K20<KB8>).  With ``devices``
    [vi-loop-mesh]: the closer over the mesh of those devices
    (``use_devices``), its inertial GBA over landmark shards (K32 once, no
    K20).  Returns the launches, the 4-DoF graph, the GBA call (K20's
    arguments, or K32's with its mesh first) and each event's host ms."""
    tag = "[vi-loop-kb8]" if kb8 else ("[vi-loop-mesh]" if devices else "[vi-loop]")
    mp, closer, closed, ms, centres, drift, graphs, vibas, sharded, launches = run_vi_loop(
        dev, kb8=kb8, devices=devices)
    err = (float(np.linalg.norm(-mp.keyframes[closed].R.T @ mp.keyframes[closed].t
                                - centres[closed])) if closed is not None else float("nan"))
    d_grav = (float(np.abs(pf.gravity_in_cameras(graphs[0][1])
                           - pf.gravity_in_cameras(graphs[0][0].R.cpu().numpy())).max())
              if graphs else float("nan"))
    want = {"vocab_words": len(ms), "pose_graph_4dof": 1, "pose_graph": 0, "ba_schur": 0,
            "vi_ba": 0 if devices else 1, "vi_ba_sharded": 1 if devices else 0}
    if kb8:   # every K12 / K20 launch through the KB8 camera
        want.update({f"{n}_kb8": launches.get(n, 0)
                     for n in ("sim3_ransac", "sim3_optimize", "vi_ba")})
    calls = sharded if devices else vibas
    if len(calls) != 1 or calls[0][-1] != {"n_iters": 7, "cg_iters": 40} or \
            (devices and (vibas or calls[0][0].size != len(devices))):
        raise AssertionError(f"{tag} inertial GBA calls {[c[-1] for c in calls]}, one-device "
                             f"calls {len(vibas)}")
    bad = {n: launches.get(n, 0) for n, v in want.items() if launches.get(n, 0) != v}
    bad.update({n: 0 for n in ("sim3_ransac", "sim3_optimize", "hamming_best2_words")
                if not launches.get(n, 0)})
    if closed is None or closer.n_loops != 1 or not err < 0.5 * drift[closed] \
            or not d_grav < 1e-5 or bad:
        raise AssertionError(f"{tag} loop at {closed}, closing keyframe centre error "
                             f"{err:.4f} m (drifted {drift.get(closed, float('nan')):.4f} m), "
                             f"roll/pitch change {d_grav:.2e}, launches {launches}")
    prob = graphs[0][0]
    gba = (f"inertial GBA over {len(devices)} landmark shards (K32)" if devices
           else "inertial GBA (K20)")
    print(f"{tag} {len(mp.keyframes)} keyframes, "
          f"{int(np.mean([kf.n_kps for kf in mp.keyframes.values()]))} keypoints each: one loop "
          f"at keyframe {closed} (matched {mp.keyframes[closed].loop_edges[-1]}) after "
          f"{len(ms)} keyframe events; 4-DoF graph K={prob.R.shape[0]} E={prob.edge_i.shape[0]} "
          f"(K23), roll/pitch moved {d_grav:.2e} by it; {gba}; its centre error "
          f"{err:.4f} m (drifted {drift[closed]:.4f} m)", flush=True)
    print(f"{tag} keyframe-event ms (host clock): median {statistics.median(ms):.2f}, loop "
          f"event {ms[-1]:.2f}", flush=True)
    print(f"{tag} launches {launches}", flush=True)
    return launches, prob, calls[0], ms


def phase_vi_loop_mesh(dev):
    """[vi-loop-mesh]: [vi-loop] over ``mesh_devices`` (4 shards of the card,
    or the visible cards): the same checks, with the inertial GBA over
    landmark shards (K32 once, K20 never), and the loop event's device ms
    from a profiled run (the union of its device events).  Returns the
    launches and the K32 call (mesh, problem, camera, keywords)."""
    import chip_profile

    devs = mesh_devices(dev)
    launches, _, call, ms = phase_vi_loop(dev, devices=devs)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, closed_p, ms_p, *_ = run_vi_loop(dev, devices=devs, mark=True)
    device, _, _ = chip_profile.device_ms_per_frame(prof, len(ms_p))
    del prof
    k = len(ms) - 1
    print(f"[vi-loop-mesh] {len(devs)} shards ({', '.join(str(d) for d in devs)}): loop event "
          f"(keyframe event {k}, with the inertial GBA): host {ms[k]:.2f} ms, device "
          f"{device[k]:.3f} ms (profiled run: loop at keyframe {closed_p}, host "
          f"{ms_p[k]:.2f} ms); other events' median host {statistics.median(ms[:k]):.2f} ms",
          flush=True)
    return launches, call


def graph_work(K: int, E: int):
    """K23's bytes and operations: per LM iteration two residual
    evaluations an edge in Dual<4> (~8000 ops), the 2 x (24 + 96) x 2
    products of g and the blocks and the trial cost (~600); 50 PCG steps of
    an edge pass and a vertex pass (~192 ops an edge) and ~60 ops a vertex;
    in: poses and edges, out: poses and the cost."""
    return (K * 49 + E * 61 + K * 48 + 4,
            15 * (E * (8000 + 480 + 600 + 50 * 192) + K * (100 + 50 * 60)))


def phase_parity_vi_gba(call) -> dict:
    """K20 on [vi-loop]'s post-loop inertial GBA, the closer's own inputs (7
    LM x 40 PCG), against its plain version.

    Most of the constructed map's points are seen by one keyframe: their
    damped 3x3 blocks are rank 2 + lambda, and float32 rounding makes some
    indefinite at lambda = 1e-4, so PCG breaks down (ROADMAP C: JAX's
    float32 VI BA does the same).  On these inputs K20 and the plain version
    are held through the first two iterations, whose candidates both
    reject, and K20's result must be finite; the float64 plain solve is the
    witness (its first candidate is finite and its solve descends).  With
    the points seen by one keyframe fixed, the same inputs are well posed:
    there K20 is held to the plain version after all 7 iterations (states
    and points within 1e-4, inliers equal, as on [vi])."""
    prob, cam, kw = call
    it, cg = kw["n_iters"], kw["cg_iters"]
    fields = ("Rwb", "twb", "v", "bg", "ba", "points")
    dist = lambda x, y: max(float((getattr(x, f).double() - getattr(y, f).double()).abs().max())
                            for f in fields)
    k20 = lambda q, n: sin.optimize_vi_ba(q, cam, n_iters=n, cg_iters=cg)
    plain = lambda q, n: sin.optimize_vi_ba_plain(q, cam, n_iters=n, cg_iters=cg)
    K, P, O = prob.Rwb.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]

    d2 = dist(k20(prob, 2), plain(prob, 2))
    vk, vp = k20(prob, it), plain(prob, it)
    p64 = sin._cast(prob, torch.float64)
    v64 = plain(p64, it)
    first = [float(f(q, 1).cost) for f, q in ((k20, prob), (plain, prob), (plain, p64))]
    finite = all(bool(torch.isfinite(getattr(vk, f)).all()) for f in fields)
    line = (f"vi_ba [vi-loop] post-loop GBA K={K} P={P} O={O} ({it} LM x {cg} PCG): first "
            f"candidate's cost K20 {first[0]:.7g}, plain {first[1]:.7g}, float64 plain "
            f"{first[2]:.7g}; within {d2:.2e} of the plain version after 2 iterations; after "
            f"{it}: cost {float(vk.cost):.7g} / plain {float(vp.cost):.7g} / float64 plain "
            f"{float(v64.cost):.7g}, K20 {dist(vk, v64):.2e} and plain {dist(vp, v64):.2e} from "
            f"the float64 solve, K20 finite {finite}")
    if not (d2 <= 1e-4 and finite and np.isfinite(first[2]) and float(v64.cost) < first[2]):
        raise AssertionError(line)
    print(f"[parity] {line}", flush=True)

    n_obs = torch.bincount(prob.obs_mp[prob.obs_valid].long(), minlength=P)
    q = prob._replace(fixed_mp=prob.fixed_mp | (n_obs < 2))
    qk, qp = k20(q, it), plain(q, it)
    q64 = plain(sin._cast(q, torch.float64), it)
    d = dist(qk, qp)
    same = torch.equal(qk.inliers, qp.inliers)
    line = (f"vi_ba [vi-loop] post-loop GBA, the {int((n_obs == 1).sum())} points seen by one "
            f"keyframe fixed: states and points within {d:.2e} of the plain version, inliers "
            f"equal {same}; {dist(qk, q64):.2e} from the float64 solve (plain "
            f"{dist(qp, q64):.2e}); cost {float(qk.cost):.7g} / plain {float(qp.cost):.7g}")
    if not (d <= 1e-4 and same):
        raise AssertionError(line)
    print(f"[parity] {line}", flush=True)
    return dict(vi_loop_max_abs_err=d, vi_loop_ms=cuda_ms(lambda: k20(q, it), reps=3),
                vi_loop_plain_ms=cuda_ms(lambda: plain(q, it), reps=1))


def phase_parity_vi_loop(prob, stereo_rec, stats, dev) -> dict:
    """K23 against its plain version on [vi-loop]'s essential graph (and the
    float64 plain solve, for the precision rule), one result over 20 calls,
    and timed on a seeded graph of a long session (300 keyframes, ~10^4
    edges); K21's fixed-scale solve and K22's legacy variant on
    [vi-stereo]'s own inputs."""
    out = {}
    dist = lambda x, y: max(float((a.double() - b.double()).abs().max()) for a, b in zip(x, y))
    prob64 = pose_graph.PoseGraph4DoFProblem(*[a.double() if a.is_floating_point() else a
                                               for a in prob])
    gk = pose_graph.optimize_pose_graph_4dof(prob)
    with kernels.ordered_plain(True):
        g32 = pose_graph.optimize_pose_graph_4dof_plain(prob)
        g64 = pose_graph.optimize_pose_graph_4dof_plain(prob64)
    d, d_k64, d_3264 = dist(gk[:2], g32[:2]), dist(gk[:2], g64[:2]), dist(g32[:2], g64[:2])
    same = all(all(torch.equal(a, b) for a, b in zip(pose_graph.optimize_pose_graph_4dof(prob),
                                                     gk)) for _ in range(19))
    K, E = prob.R.shape[0], prob.edge_i.shape[0]
    line = (f"pose_graph_4dof K={K} E={E}: max |dR|,|dt| {d:.2e} from the float32 plain solve; "
            f"{d_k64:.2e} from the float64 plain solve (float32 plain {d_3264:.2e}, ratio "
            f"{d_k64 / max(d_3264, 1e-30):.2f}); cost {float(gk[2]):.7g} / plain "
            f"{float(g32[2]):.7g}; 20 calls bit-identical {same}")
    if not (d <= 1e-4 and d_k64 <= 10 * d_3264 and same):
        raise AssertionError(line)
    print(f"[parity] {line}", flush=True)
    out["pose_graph_4dof"] = record(
        d, cuda_ms(lambda: pose_graph.optimize_pose_graph_4dof(prob), reps=10),
        cuda_ms(lambda: pose_graph.optimize_pose_graph_4dof_plain(prob), reps=1),
        *graph_work(K, E))

    # a long session's graph: 300 keyframes, ~10^4 edges; within 1e-4 of the
    # float32 plain solve, no farther from the float64 one than it
    fields = pf.pose_graph_4dof_random(np.random.default_rng(7), K=300, extra=7, far=26)
    big = interop.pose_graph_4dof_from_numpy(fields, dev)
    big64 = interop.pose_graph_4dof_from_numpy(fields, dev, torch.float64)
    bk = pose_graph.optimize_pose_graph_4dof(big)
    with kernels.ordered_plain(True):
        b32 = pose_graph.optimize_pose_graph_4dof_plain(big)
        b64 = pose_graph.optimize_pose_graph_4dof_plain(big64)
    db, db64, db3264 = dist(bk[:2], b32[:2]), dist(bk[:2], b64[:2]), dist(b32[:2], b64[:2])
    K, E = big.R.shape[0], big.edge_i.shape[0]
    rec = record(db, cuda_ms(lambda: pose_graph.optimize_pose_graph_4dof(big), reps=3),
                 cuda_ms(lambda: pose_graph.optimize_pose_graph_4dof_plain(big), reps=1),
                 *graph_work(K, E))
    line = (f"pose_graph_4dof K={K} E={E} (a long session's graph): max |dR|,|dt| {db:.2e} "
            f"from the float32 plain solve, {db64:.2e} from the float64 one (float32 plain "
            f"{db3264:.2e}); {rec['ms']:.3f} ms a call, plain {rec['plain_ms']:.1f} ms, bound "
            f"{rec['bound_ms']:.3g} ms ({rec['bound_by']})")
    if not (db <= 1e-4 and db64 <= 10 * max(db3264, 1e-7)):
        raise AssertionError(line)
    print(f"[parity] {line}", flush=True)
    out["pose_graph_4dof"].update({f"long_session_{k}": rec[k] for k in
                                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                                  long_session_K=K, long_session_E=E)

    # K21 with fix_scale, against its float64 plain solve (within 1e-4)
    args, kw = stereo_rec.calls["inertial_init"][0]
    ik = sin.inertial_only(*args, **kw)
    ip = sin.inertial_only_plain(*args, **kw, solve_dtype=torch.float64)
    fields = ("Rwg", "v", "bg", "ba")
    d21 = max(dist([getattr(ik, f) for f in fields], [getattr(ip, f) for f in fields]),
              float(abs(ik.scale - ip.scale)))
    if not kw.get("fix_scale") or d21 > 1e-4 or float(ik.scale) != 1.0:
        raise AssertionError(f"inertial_init fix_scale={kw.get('fix_scale')}: max deviation "
                             f"{d21:.2e}, scale {float(ik.scale)}")
    print(f"[parity] inertial_init fix_scale=True K={args[0].shape[0]}: gravity, velocities "
          f"and biases within {d21:.2e} (plain version with float64 normal equations), scale "
          f"{float(ik.scale)}", flush=True)
    out["inertial_init"] = dict(stats["inertial_init"], fix_scale_max_abs_err=d21)

    # K22 <false>: [vi-stereo]'s largest legacy solve without a prior
    args, kw = _largest(stereo_rec.calls["pose_inertial"], lambda c: int(c[0][10].sum()))
    rk, rp = sin.optimize_pose_inertial(*args, **kw), sin.optimize_pose_inertial_plain(*args, **kw)
    fields = ("Rwb", "twb", "v", "bg", "ba")
    d22 = dist([getattr(rk, f) for f in fields], [getattr(rp, f) for f in fields])
    hrel = float((rk.H - rp.H).abs().max() / rp.H.abs().max())
    if d22 > 1e-4 or hrel > 1e-4 or not torch.equal(rk.inliers, rp.inliers):
        raise AssertionError(f"pose_inertial [vi-stereo]: max deviation {d22:.2e}, H {hrel:.2e}, "
                             f"inliers equal {torch.equal(rk.inliers, rp.inliers)}")
    print(f"[parity] pose_inertial joint=False [vi-stereo] N={args[7].shape[0]} "
          f"({int(args[10].sum())} points): states within {d22:.2e}, H within {hrel:.2e} "
          f"relative, inliers equal ({int(rk.inliers.sum())})", flush=True)
    out["pose_inertial"] = dict(stats["pose_inertial"], stereo_max_abs_err=max(d22, hrel))
    return out


# ------------------------------------------------------------ pipelined path


def fr1_config(depth: int, width: int = WIDTH, height: int = HEIGHT,
               n_features: int = SYS_FEATURES) -> SLAMConfig:
    """[system]'s configuration with TUM fr1's distorted pinhole (scaled to
    the image) and the given pipeline depth."""
    K, d = pf.fr1_camera_matrix(width, height), pf.FR1_DIST
    cam = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                       cy=float(K[1, 2]), k1=d[0], k2=d[1], p1=d[2], p2=d[3], k3=d[4],
                       width=width, height=height)
    cfg = system_config(width, height, n_features)
    return dataclasses.replace(cfg, camera=cam, tracking=dataclasses.replace(
        cfg.tracking, pipeline_depth=depth))


def fr1_frames(n: int = SYS_FRAMES, width: int = WIDTH, height: int = HEIGHT):
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), n, SYS_SPEED, width, height,
                                          pf.fr1_camera_matrix(width, height), pf.FR1_DIST)
    return frames, poses


class _StepOutputs:
    """Wraps TrackStep.__call__ to keep every step's outputs (clones, by
    field name), whether it was an inertial step, whether its step has a
    graph and whether the call was a replay, its host-clock ms and a
    CUDA-event pair around it (on a card)."""

    def __init__(self):
        self.calls = []
        self._orig = TrackStep.__call__

    def __enter__(self):
        orig = self._orig

        def rec(step, *args, **kw):
            cuda = step.device.type == "cuda"
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            n_rep = step.graph.n_replays if step.graph is not None else 0
            t0 = time.perf_counter()
            if cuda:
                ev[0].record()
            out = orig(step, *args, **kw)
            if cuda:
                ev[1].record()
            host = (time.perf_counter() - t0) * 1e3
            replay = step.graph is not None and step.graph.n_replays > n_rep
            c = {f"feats.{f.name}": getattr(out.feats, f.name).clone()
                 for f in dataclasses.fields(out.feats)}
            c.update({n: v.clone() for n, v in out._asdict().items()
                      if n != "feats" and v is not None})
            c.update(inertial=step.inertial, graph=step.graph is not None, replay=replay,
                     host_ms=host, events=ev)
            self.calls.append(c)
            return out
        TrackStep.__call__ = rec
        return self

    def __exit__(self, *exc):
        TrackStep.__call__ = self._orig


def _differing(a: dict, b: dict) -> list:
    """The output fields of two ``_StepOutputs`` calls that are not
    bit-equal (or that only one of them has)."""
    return [n for n in a.keys() | b.keys() if n not in a or n not in b
            or torch.is_tensor(a[n]) and not torch.equal(a[n], b[n])]


def run_pipelined(frames, dev, cfg, graph=None, second=None, imu: bool = False):
    """``System(cfg)`` over ``frames`` from a cold map with the tracker's
    step graph setting ``graph``, then ``flush()``: track_monocular (with
    [vi]'s IMU windows when ``imu``), or track_stereo / track_rgbd with
    ``second``.  Returns (system, states, per-call host ms, seconds from
    the first call to the end of the flush)."""
    sys_ = System(cfg, device=dev)
    sys_.tracker.step_graph = graph
    states, host_ms = [], []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for k, img in enumerate(frames):
        t0 = time.perf_counter()
        if imu:
            ts = k / pf.VI_FPS
            st = sys_.track_monocular(img, ts, imu=pf.imu_window((k - 1) / pf.VI_FPS, ts)
                                      if k else None)
        elif cfg.sensor == "stereo":
            st = sys_.track_stereo(img, second[k], k / 30.0)
        elif cfg.sensor == "rgbd":
            st = sys_.track_rgbd(img, second[k], k / 30.0)
        else:
            st = sys_.track_monocular(img, k / 30.0)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(st)
    sys_.flush()
    torch.cuda.synchronize()
    return sys_, states, host_ms, time.perf_counter() - t_start


def _step_graph(sys_, inertial: bool = False):
    """The captured StepGraph of a system's visual (or inertial) step."""
    g = cached_graph(sys_.tracker.cfg, sys_.tracker.device, inertial)
    if g is None or g.cuda_graph is None:
        raise AssertionError(f"no captured {'inertial ' if inertial else ''}tracking-step graph")
    return g


def graph_counts(g) -> tuple:
    return (g.n_warm, g.n_captures, g.n_replays) if g is not None else (0, 0, 0)


def inertial_graph_counts(tag: str, sys_, before: tuple) -> dict:
    """The inertial step graph's eager calls, captures and replays in a run
    (``before``: its counts when the run started, from
    ``graph_counts(cached_graph(...))``): every fused inertial frame but each
    key's first two is a replay, and the replays agree with
    ``kernels.GRAPH_LAUNCHES``; no visual step replayed."""
    g = _step_graph(sys_, inertial=True)
    warm, cap, rep = (a - b for a, b in zip(graph_counts(g), before))
    n = sys_.tracker.n_fused_frames
    if (warm + rep != n or rep < 1 or rep < n - 2 * max(1, cap)
            or rep != kernels.GRAPH_LAUNCHES["track_step_inertial"]
            or kernels.GRAPH_LAUNCHES["track_step"]):
        raise AssertionError(f"{tag} {n} fused inertial frames: {warm} eager, {cap} captures, "
                             f"{rep} replays; graph launches {dict(kernels.GRAPH_LAUNCHES)}")
    return dict(fused=n, eager=warm, captures=cap, replays=rep, kernel_nodes=g.kernel_nodes,
                nodes=g.nodes, wrapper_launches=dict(g.launches))


def cached_graph(cfg, dev, inertial: bool = True):
    """The StepGraph of the cached TrackStep that a System(cfg) on dev
    takes for its inertial (or visual) step, or None before there is one."""
    graphs = [st.graph for key, st in track_device._STEP_CACHE.items()
              if st.graph is not None and key[0] == cfg.camera and key[5] == str(dev)
              and key[7] == inertial]
    return graphs[-1] if graphs else None


def phase_parity_undistort(frames, dev) -> dict:
    """K24 against its plain version on the keypoints of a distorted
    640x480 frame (the step's 1128 slots): bit-equal."""
    cfg = fr1_config(PIPE_DEPTH)
    ex = ORBExtractor(cfg.orb, frames[0].shape, dev)
    xy = ex(torch.from_numpy(frames[0]).to(dev)).xy
    cam = Pinhole.from_config(cfg.camera)
    d = (cfg.camera.k1, cfg.camera.k2, cfg.camera.p1, cfg.camera.p2, cfg.camera.k3)
    from extractorb_tpu_torch.core import camera as camera_mod
    got = camera_mod.undistort_points_pinhole(xy, cam, d)
    want = camera_mod.undistort_points_pinhole_plain(xy, cam, d)
    if not torch.equal(got, want):
        raise AssertionError(f"undistort differs from the plain version by "
                             f"{float((got - want).abs().max())}")
    n = xy.shape[0]
    # in: N float2, out: N float2; per point 8 x 28 operations + 8
    stats = {"undistort": record(
        0.0, cuda_ms(lambda: camera_mod.undistort_points_pinhole(xy, cam, d)),
        cuda_ms(lambda: camera_mod.undistort_points_pinhole_plain(xy, cam, d)),
        16 * n, n * (8 * 28 + 8))}
    print(f"[parity] undistort N={n} (FR1): bit-equal to the plain version", flush=True)
    return stats


def phase_pipelined(frames, poses, dev):
    """[pipelined]: ``System.track_monocular`` at tracking.pipeline_depth 3
    over the FR1-distorted sequence, from a cold map, with the step's CUDA
    graph (the main path: counts set to 0 before it and read after), then
    the same at depth 3 with the eager step (every step's pose and
    associations bit-equal to the graph's) and at depth 0 (ATE; host ms)."""
    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    with _StepOutputs() as rec_g:
        sys_, states, host_ms, wall = run_pipelined(frames, dev, fr1_config(PIPE_DEPTH))
    launches = dict(kernels.LAUNCHES)
    replays = kernels.GRAPH_LAUNCHES["track_step"]
    tr = sys_.tracker
    first_ok = next((k for k, st in enumerate(states) if st == TrackState.OK), None)
    n_traj = len(tr.trajectory)
    ate, scale = pf.trajectory_ate(tr.trajectory, poses)
    if (first_ok is None or first_ok > 2 or tr.state != TrackState.OK
            or n_traj != len(frames) - first_ok + 1 or not ate < PIPE_MAX_ATE):
        raise AssertionError(f"[pipelined] states {[st.name for st in states]}, final "
                             f"{tr.state.name}, {n_traj} trajectory rows, ATE {ate:.4f} m")
    graph = _step_graph(sys_)
    n_imgs = len(frames)
    want = {**{k: n_imgs for k in EXTRACT_KERNELS}, "undistort": n_imgs,
            "two_view": tr.stats["two_view"], "ba_pcg": tr.stats["ba"],
            "tri_search": tr.stats["tri_groups"]}
    bad = {k: (launches.get(k, 0), v) for k, v in want.items() if launches.get(k, 0) != v}
    missing = [k for k in VISUAL_KERNELS + ("undistort",)
               if k not in ("stereo_match", "pnp_ransac") and launches.get(k, 0) == 0]
    if (bad or missing or replays < 1 or replays != graph.n_replays
            or graph.n_replays + graph.n_warm != len(rec_g.calls)):
        raise AssertionError(f"[pipelined] launches {launches} against {bad}, never launched "
                             f"{missing}, {replays} graph replays")
    # the same sequence with the eager step: bit-equal poses and associations
    with _StepOutputs() as rec_e:
        sys_e, _, host_e, wall_e = run_pipelined(frames, dev, fr1_config(PIPE_DEPTH), graph=False)
    if len(rec_e.calls) != len(rec_g.calls) or any(c["graph"] for c in rec_e.calls):
        raise AssertionError(f"[pipelined] eager run: {len(rec_e.calls)} steps against "
                             f"{len(rec_g.calls)}")
    for k, (g, e) in enumerate(zip(rec_g.calls, rec_e.calls)):
        diff = _differing(g, e)
        if diff:
            raise AssertionError(f"[pipelined] step {k}: the graph's {diff} differ from the "
                                 "eager step's")
    same_traj = all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                    for a, b in zip(tr.trajectory, sys_e.tracker.trajectory))
    if not same_traj or len(tr.trajectory) != len(sys_e.tracker.trajectory):
        raise AssertionError("[pipelined] graph and eager trajectories differ")
    # depth 0, the same sequence
    sys0, states0, host0, wall0 = run_pipelined(frames, dev, fr1_config(0))
    ate0, _ = pf.trajectory_ate(sys0.tracker.trajectory, poses)
    if len(sys0.tracker.trajectory) != n_traj or not ate0 < PIPE_MAX_ATE:
        raise AssertionError(f"[pipelined] depth 0: {len(sys0.tracker.trajectory)} rows, "
                             f"ATE {ate0:.4f} m")
    kf3 = {kf.frame_id for kf in tr.atlas.current.keyframes.values()}
    kf0 = {kf.frame_id for kf in sys0.tracker.atlas.current.keyframes.values()}
    ordinary = lambda kfs, ms: [m for k, m in enumerate(ms) if k > first_ok + 2 and k not in kfs]
    med = lambda v: statistics.median(v) if v else float("nan")
    print(f"[pipelined] depth {PIPE_DEPTH}, FR1 distortion: init at frame {first_ok}, "
          f"{n_traj} trajectory rows, {len(kf3)} keyframes, ATE {ate:.4f} m (depth 0: "
          f"{ate0:.4f} m, {len(kf0)} keyframes; scene scale {scale:.3f} m, bound "
          f"{PIPE_MAX_ATE})", flush=True)
    print(f"[pipelined] step graph: {graph.n_captures} capture(s), {replays} replays and "
          f"{graph.n_warm} eager warm-up calls for {len(rec_g.calls)} fused frames; 1 graph "
          f"launch per ordinary frame, {graph.kernel_nodes} kernel nodes of {graph.nodes} nodes "
          f"({sum(graph.launches.values())} kernel-wrapper launches: {dict(graph.launches)})",
          flush=True)
    print(f"[pipelined] graph vs eager step: all outputs of the {len(rec_g.calls)} steps "
          f"bit-equal, trajectories equal", flush=True)
    print(f"[pipelined] ordinary-frame host ms (median of the track calls): depth "
          f"{PIPE_DEPTH} graph {med(ordinary(kf3, host_ms)):.2f}, depth {PIPE_DEPTH} eager "
          f"{med(ordinary(kf3, host_e)):.2f}, depth 0 graph {med(ordinary(kf0, host0)):.2f}; "
          f"whole sequence with flush {wall * 1e3:.1f} / {wall_e * 1e3:.1f} / {wall0 * 1e3:.1f} "
          f"ms", flush=True)
    print(f"[pipelined] launches {launches}; graph launches {replays}", flush=True)
    return launches, dict(replays=replays, kernel_nodes=graph.kernel_nodes, nodes=graph.nodes)


def phase_pipelined_depth(sensor: str, frames, second, poses, dev):
    """[pipelined-stereo] / [pipelined-rgbd]: ``track_stereo`` /
    ``track_rgbd`` at depth 3 from a cold map: every frame OK and in the
    trajectory, the metric error and path length inside the JAX pipelined
    tests' bounds, the step replayed as a graph."""
    tag = f"[pipelined-{sensor}]"
    cfg = stereo_config(sensor)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                 pipeline_depth=PIPE_DEPTH))
    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    sys_, states, host_ms, wall = run_pipelined(frames, dev, cfg, second=second)
    launches = dict(kernels.LAUNCHES)
    replays = kernels.GRAPH_LAUNCHES["track_step"]
    tr = sys_.tracker
    err, ratio = pf.metric_error(tr.final_trajectory(), poses)
    max_err, max_ratio = PIPE_STEREO_BOUNDS[sensor]
    n = len(frames)
    images = 2 * n if sensor == "stereo" else n
    want = {**{k: images for k in EXTRACT_KERNELS},
            "stereo_match": n if sensor == "stereo" else 0}
    bad = {k: (launches.get(k, 0), v) for k, v in want.items() if launches.get(k, 0) != v}
    if (any(st != TrackState.OK for st in states) or tr.state != TrackState.OK
            or len(tr.trajectory) != n or not err < max_err or not abs(ratio - 1) < max_ratio
            or bad or replays < n - 6 or not launches.get("pose_lm_stereo", 0)):
        raise AssertionError(f"{tag} states {[st.name for st in states]}, "
                             f"{len(tr.trajectory)} rows, metric error {err:.4f} m, path ratio "
                             f"{ratio:.4f}, launches {bad}, {replays} graph replays")
    kfs = {kf.frame_id for kf in tr.atlas.current.keyframes.values()}
    ordinary = [m for k, m in enumerate(host_ms) if k > 3 and k not in kfs]
    print(f"{tag} depth {PIPE_DEPTH}: {n} frames OK, {sys_.n_keyframes()} keyframes, metric "
          f"error {err:.4f} m, path ratio {ratio:.4f}; {replays} graph replays; ordinary-frame "
          f"host ms median {statistics.median(ordinary):.2f}, sequence with flush "
          f"{wall * 1e3:.1f} ms", flush=True)
    print(f"{tag} launches {launches}", flush=True)
    return launches


def phase_pipelined_vi(frames, dev):
    """[pipelined-vi]: imu-monocular at depth 3 (tests/test_vi_e2e.py:197):
    the last frame OK, the IMU initialised, at least 8 fused inertial
    frames, |s - 1| < 0.35 and ATE < 0.25 m; every fused frame but its
    step key's first two a replay of the inertial step's CUDA graph."""
    cfg = vi_config()
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                 pipeline_depth=PIPE_DEPTH))
    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    before = graph_counts(cached_graph(cfg, dev))
    sys_, states, host_ms, wall = run_pipelined(frames, dev, cfg, imu=True)
    launches = dict(kernels.LAUNCHES)
    tr = sys_.tracker
    ate, scale = pf.vi_ate_scale(tr.final_trajectory())
    missing = [k for k in INERTIAL_KERNELS if launches.get(k, 0) == 0]
    if (states[-1] != TrackState.OK or not tr.atlas.current.imu_initialized
            or tr.n_fused_frames < PIPE_VI_MIN_FUSED or not abs(scale - 1) < VI_MAX_SCALE_ERR
            or not ate < VI_MAX_ATE or missing):
        raise AssertionError(f"[pipelined-vi] states {[st.name for st in states]}, IMU "
                             f"{tr.atlas.current.imu_initialized}, fused {tr.n_fused_frames}, "
                             f"scale {scale:.4f}, ATE {ate:.4f} m, never launched {missing}")
    graph = inertial_graph_counts("[pipelined-vi]", sys_, before)
    print(f"[pipelined-vi] depth {PIPE_DEPTH}: IMU initialised, {tr.n_fused_frames} fused "
          f"inertial frames ({graph['replays']} graph replays, {graph['eager']} eager, "
          f"{graph['captures']} capture(s)), {sys_.n_keyframes()} keyframes, scale {scale:.4f}, "
          f"ATE {ate:.4f} m; sequence with flush {wall * 1e3:.1f} ms", flush=True)
    print(f"[pipelined-vi] launches {launches}", flush=True)
    return launches


# ------------------------------------------------ determinism (C.7), KB8


# ---------------------------------- the BA's stereo rows and dense solve,
# the marginal toolbox and the searches no engine path calls
# [ba-stereo]: the window BA's stereo rows (K6 <stereo>) and its dense
# solver (K35), at the window BA's padding (local_mapping's ladders): Kp 32 /
# Pp 2048 / Op 8192 with 6 keyframes, and schur_dense's largest window, Kp
# 64 (12 keyframes, Op 16384); every other observation has a right-image u
# at [stereo]'s bf (KB8: the fisheye rig's baseline)
BA_ITERS, BA_CG = 10, 40


def ba_stereo_cases(dev):
    """(tag, problem, camera, bf, solver) of every [ba-stereo] solve."""
    K = pf.camera_matrix(WIDTH, HEIGHT)
    pin = track_device.pinhole_project(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    kb8 = pf.kb8_camera(KB8_SIZE, KB8_SIZE)
    cam8 = track_device.kb8_project(*kb8)
    bf, bf8 = float(K[0, 0]) * STEREO_BASELINE, float(kb8[0]) * KB8_BASELINE
    p32 = ba_problem(np.random.default_rng(21), dev, stereo_bf=bf)
    # five observed points fixed: K6 masks their steps, K35 still eliminates
    # them into S (JAX's ba.py:218, ROADMAP C.2)
    p32 = p32._replace(fixed_mp=p32.fixed_mp.index_fill(0, torch.arange(5, device=dev), True))
    p32k = ba_problem(np.random.default_rng(22), dev, kb8=kb8, stereo_bf=bf8)
    p64 = ba_problem(np.random.default_rng(23), dev, n_kf=12, Kp=64, Op=16384, stereo_bf=bf)
    return [("cg stereo Kp32", p32, pin, bf, "cg"),
            ("schur_dense stereo Kp32", p32, pin, bf, "schur_dense"),
            ("schur_dense mono Kp32", p32._replace(obs_ur=None), pin, 0.0, "schur_dense"),
            ("cg stereo KB8 Kp32", p32k, cam8, bf8, "cg"),
            ("schur_dense stereo KB8 Kp32", p32k, cam8, bf8, "schur_dense"),
            ("cg stereo Kp64", p64, pin, bf, "cg"),
            ("schur_dense stereo Kp64", p64, pin, bf, "schur_dense")]


def _gate_flips(p, cam, bf, rk, rp) -> int:
    """Observations whose inlier flag differs between two BA results, other
    than those within 1e-3 (relative) of their chi2 gate in ``rp``."""
    Rk, tk, pw = ba._gather(rp.R, rp.t, rp.points, p)
    r = ba._residual(ba._camera_point(Rk, tk, pw), p, cam, bf)
    chi2 = torch.sum(r * r, -1) * p.inv_sigma2
    gate = ba._gates(p, ba.CHI2_MONO)[1]
    edge = (chi2 - gate).abs() <= 1e-3 * gate
    return int(((rk.inliers != rp.inliers) & ~edge).sum())


def ba_work(p, solver: str, n_iters: int = BA_ITERS, cg_iters: int = BA_CG):
    """Bytes (inputs read once, outputs written once) and float operations
    of one BA call: per LM step ~150 a valid observation and row pair for
    the residual, Jacobians and blocks, then the cg sweeps (~80 a valid
    observation each) or K35's step: W and W C (~150 an observation), the
    pairs of observations that share a point (~220 each, the S blocks; S is
    symmetric, so c (c + 1) / 2 pairs at a point of c), the Cholesky n^3 / 3
    and the two solves 2 n^2 at n = 6K."""
    Ob, Pb, Kb = p.obs_kf.shape[0], p.points.shape[0], p.R.shape[0]
    nv = int(p.obs_valid.sum())
    rows = 3 if p.obs_ur is not None else 2
    nbytes = (Ob * (4 + 4 + 8 + 4 + 1 + (4 if rows == 3 else 0)) + Pb * (12 + 1) + Kb * 49
              + Kb * 48 + Pb * 12 + Ob + 4)
    lin = nv * 75 * rows
    if solver == "cg":
        step = nv * 40 * rows * cg_iters
    else:
        per_point = torch.bincount(p.obs_mp[p.obs_valid].long(), minlength=Pb).double()
        n = 6 * Kb
        pairs = int((per_point * (per_point + 1) / 2).sum())
        step = nv * 150 + pairs * 220 + n ** 3 // 3 + 2 * n * n
    return nbytes, n_iters * (lin + step)


def dense_system(p, cam, bf: float):
    """S and b of the first LM step of ``schur_dense`` at lambda 1e-4, in the
    plain version's arithmetic (for timing one library solve of it)."""
    dt = p.points.dtype
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    free_mp = (~p.fixed_mp).to(dt)[:, None]
    delta_h, _ = ba._gates(p, ba.CHI2_MONO)
    _, _, Jl, _, _, Jpw, bp, bl, Hpp, Hll = ba._linearize(p.R, p.t, p.points, p, cam, bf, delta_h,
                                                          True, free_kf, free_mp)
    lam = torch.tensor(1e-4, dtype=dt, device=p.points.device)
    return ba._schur_dense_system(p, Jpw, Jl, Hpp, Hll, bp, bl, lam, free_kf)[:2]


# the device kernels of K35's solve (both instantiations of the cluster
# kernel: tiles in the cluster's shared memory or in L2), and of its step
K35_SOLVE_KERNELS = ("solve_cluster_kernel",)
K35_STEP_KERNELS = ("point_kernel", "schur_kernel", "back_kernel") + K35_SOLVE_KERNELS


def k35_step_ms(p, cam, bf: float):
    """Device ms of K35's passes per LM step and of its solve (every kernel
    of ``K35_SOLVE_KERNELS``), from a ``torch.profiler`` trace of one call,
    over the solves the trace holds (None where it holds none)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba.optimize(p, cam, BA_ITERS, BA_CG, bf=bf, solver="schur_dense")
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    is_solve = lambda e: any(k in e.key for k in K35_SOLVE_KERNELS)
    ev = [e for e in prof.key_averages() if any(k in e.key for k in K35_STEP_KERNELS)]
    total = sum(dev_us(e) for e in ev)
    solve = sum(dev_us(e) for e in ev if is_solve(e))
    steps = sum(e.count for e in ev if is_solve(e))   # one solve launch a step
    if total <= 0 or steps == 0:
        return None, None
    print(f"[ba-stereo] the trace holds {steps} of {BA_ITERS} K35 steps", flush=True)
    return total / 1e3 / steps, solve / 1e3 / steps


def phase_ba_stereo(dev):
    """[ba-stereo]: ``ba.optimize`` on ``ba_stereo_cases`` through its entry
    point (the counts cleared before and read after): cg and schur_dense,
    mono and stereo, pinhole and KB8, at Kp 32 and Kp 64.  Each result is
    held to the plain version on the card: poses within 1e-4, the same
    inliers off the gate edges, cost rtol 1e-4.  Returns the launches and
    the records of K6 <stereo>, K6 <stereo, CamKB8> and K35."""
    cases = ba_stereo_cases(dev)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    res = [ba.optimize(p, cam, BA_ITERS, BA_CG, bf=bf, solver=sv) for _, p, cam, bf, sv in cases]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"ba_pcg": 7, "ba_pcg_stereo": 6, "ba_schur_dense": 4, "ba_pcg_kb8": 2,
            "ba_pcg_stereo_kb8": 2}
    if launches != want:
        raise AssertionError(f"[ba-stereo] launches {launches}, expected {want}")
    stats = {}
    for (tag, p, cam, bf, sv), rk in zip(cases, res):
        rp, plain_ms = timed(lambda: ba.optimize_plain(p, cam, BA_ITERS, BA_CG, bf=bf, solver=sv))
        d = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
        dp = float((rk.points - rp.points).abs().max())
        flips = _gate_flips(p, cam, bf, rk, rp)
        crel = abs(float(rk.cost) - float(rp.cost)) / max(abs(float(rp.cost)), 1e-30)
        line = (f"[ba-stereo] {tag} K={p.R.shape[0]} P={p.points.shape[0]} O={p.obs_kf.shape[0]}"
                f" {BA_ITERS} LM: poses within {d:.2e} (points {dp:.2e}), cost {float(rk.cost):.6g}"
                f" (plain {float(rp.cost):.6g}, rel {crel:.1e}), {int(rk.inliers.sum())} inliers, "
                f"{int((rk.inliers != rp.inliers).sum())} flips ({flips} off the gate edges)")
        if d > 1e-4 or flips or crel > 1e-4:
            raise AssertionError(line)
        print(line, flush=True)
        key = {"cg stereo Kp32": "ba_pcg_stereo", "cg stereo KB8 Kp32": "ba_pcg_stereo_kb8",
               "schur_dense stereo Kp32": "ba_schur_dense",
               "schur_dense stereo Kp64": "ba_schur_dense_kp64"}.get(tag)
        if key is None:
            continue
        nbytes, ops = ba_work(p, sv)
        lib_ms = None
        if sv == "schur_dense":
            S, b = dense_system(p, cam, bf)
            lib_ms = cuda_ms(lambda: torch.linalg.solve(S, b))
        stats[key] = record(d, cuda_ms(lambda: ba.optimize(p, cam, BA_ITERS, BA_CG, bf=bf,
                                                            solver=sv), reps=5),
                            plain_ms, nbytes + (16 if "kb8" in key else 0), ops, lib_ms)
        if sv == "schur_dense":
            step_ms, solve_ms = k35_step_ms(p, cam, bf)
            stats[key].update(step_ms=step_ms, solve_ms=solve_ms, n=6 * p.R.shape[0])
            print(f"[ba-stereo] {tag}: {stats[key]['ms']:.3f} ms a call ({BA_ITERS} LM steps), "
                  f"K35 {step_ms} ms device a step (its solve {solve_ms}), "
                  f"torch.linalg.solve of the same ({6 * p.R.shape[0]})^2 S {lib_ms:.4f} ms",
                  flush=True)
    return launches, stats


# [parity-marginal]: the marginal toolbox (K36) on information matrices of
# the inertial sizes: n = 9 (the JAX test's), 30 (two 15-dim states) and 45
MARGINAL_CASES = ((9, (3, 5), (6, 8)), (30, (0, 14), (15, 29)), (45, (15, 29), (30, 44)))


def information(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n + 3)).astype(np.float32)
    return torch.from_numpy(A @ A.T + 0.1 * np.eye(n, dtype=np.float32))


def phase_parity_marginal(dev):
    """[parity-marginal]: ``condition``, ``marginalize`` and ``sparsify``
    through their entry points on ``MARGINAL_CASES`` (the counts cleared
    before and read after: one K36 launch a call), then each against its
    plain version on the card: condition bit-equal, marginalize and
    sparsify within 1e-5 of max|H|.  Returns the launches and K36's record
    (marginalize at n = 30, block 15; sparsify's time beside it)."""
    Hs = [information(n, 30 + n).to(dev) for n, _, _ in MARGINAL_CASES]
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    outs = [(mg.condition(H, *b1), mg.marginalize(H, *b1), mg.sparsify(H, *b1, *b2))
            for H, (_, b1, b2) in zip(Hs, MARGINAL_CASES)]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    k = len(MARGINAL_CASES)
    want = {"marginal": 3 * k, "marginal_condition": k, "marginal_marginalize": k,
            "marginal_sparsify": k}
    if launches != want:
        raise AssertionError(f"[parity-marginal] launches {launches}, expected {want}")
    errs = {}
    for H, (n, b1, b2), (c, m, sp) in zip(Hs, MARGINAL_CASES, outs):
        scale = float(H.abs().max())
        dm = float((m - mg.marginalize_plain(H, *b1)).abs().max()) / scale
        ds = float((sp - mg.sparsify_plain(H, *b1, *b2)).abs().max()) / scale
        line = (f"[parity-marginal] n={n} block {b1} (sparsify with {b2}): condition bit-equal "
                f"{torch.equal(c, mg.condition_plain(H, *b1))}, marginalize {dm:.2e}, sparsify "
                f"{ds:.2e} of max|H|")
        if not torch.equal(c, mg.condition_plain(H, *b1)) or dm > 1e-5 or ds > 1e-5:
            raise AssertionError(line)
        print(line, flush=True)
        errs[n] = dm * scale
    H, (n, b1, b2) = Hs[1], MARGINAL_CASES[1]
    b = b1[1] - b1[0] + 1
    # one marginalisation: H read, H' written; a symmetric b x b eigen-solve
    # (~9 b^3 float64 operations) and T, H' (2 n^2 b)
    ops64 = 9 * b ** 3 + 2 * n * n * b
    st = record(errs[n], cuda_ms(lambda: mg.marginalize(H, *b1)),
                cuda_ms(lambda: mg.marginalize_plain(H, *b1)), 8 * n * n, 0, None, ops64)
    st.update(sparsify_ms=cuda_ms(lambda: mg.sparsify(H, *b1, *b2)),
              sparsify_plain_ms=cuda_ms(lambda: mg.sparsify_plain(H, *b1, *b2)),
              condition_ms=cuda_ms(lambda: mg.condition(H, *b1)))
    print(f"[parity-marginal] n={n}: marginalize {st['ms']:.4f} ms (plain {st['plain_ms']:.4f}),"
          f" sparsify {st['sparsify_ms']:.4f} ms (plain {st['sparsify_plain_ms']:.4f}), "
          f"condition {st['condition_ms']:.4f} ms", flush=True)
    return launches, {"marginal": st}


@contextlib.contextmanager
def plain_matcher():
    """The searches through K3's and K18's plain versions (on the card)."""
    saved = matcher.hamming_best2, matcher.match_epilogue
    matcher.hamming_best2 = matcher.hamming_best2_plain
    matcher.match_epilogue = matcher.match_epilogue_plain
    try:
        yield
    finally:
        matcher.hamming_best2, matcher.match_epilogue = saved


def search_api_inputs(sys_, dev):
    """The three searches' arguments from a System's map: every valid map
    point against the last keyframe's keypoints (fuse), the previous
    keyframe's points with their octaves and angles there (reloc, at the
    last keyframe's pose), and the two keyframes' points in their own
    camera frames (Sim3, S12 their relative pose, scale 1)."""
    tr = sys_.tracker
    mp = tr.atlas.current
    kids = sorted(mp.keyframes)
    k1, k2 = mp.keyframes[kids[-1]], mp.keyframes[kids[-2]]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    u8 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.uint8), device=dev)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)
    n_mp = mp._next_mp
    pts = dict(mp_pos=f(mp.mp_pos[:n_mp]), mp_desc=u8(mp.mp_desc[:n_mp]),
               mp_valid=b(mp.mp_valid[:n_mp]), mp_normal=f(mp.mp_normal[:n_mp]),
               mp_max_dist=f(mp.mp_max_dist[:n_mp]))
    kp = dict(kp_xy=f(k1.xy_un), kp_desc=u8(k1.desc), kp_octave=i(k1.octave), kp_valid=b(k1.valid))
    common = (tr.cam, tr.scale_factors, tr.img_wh)
    fuse = ((pts["mp_pos"], pts["mp_desc"], pts["mp_valid"], pts["mp_normal"],
             pts["mp_max_dist"], f(k1.R), f(k1.t), kp["kp_xy"], kp["kp_desc"], kp["kp_octave"],
             kp["kp_valid"]) + common, {})
    sel = np.nonzero(k2.kp_mp >= 0)[0]
    ids = k2.kp_mp[sel]
    reloc = ((f(mp.mp_pos[ids]), u8(mp.mp_desc[ids]), b(mp.mp_valid[ids]), i(k2.octave[sel]),
              f(k2.angle[sel]), f(mp.mp_max_dist[ids]), f(k1.R), f(k1.t), kp["kp_xy"],
              kp["kp_desc"], kp["kp_octave"], f(k1.angle), kp["kp_valid"]) + common, {})

    def side(kf):
        sel = np.nonzero(kf.kp_mp >= 0)[0]
        ids = kf.kp_mp[sel]
        pc = mp.mp_pos[ids] @ kf.R.T + kf.t
        return (f(pc), u8(mp.mp_desc[ids]), b(mp.mp_valid[ids]), f(kf.xy_un[sel]),
                i(kf.octave[sel]), f(mp.mp_max_dist[ids]))

    p1, d1, v1, xy1, o1, m1 = side(k1)
    p2, d2, v2, xy2, o2, m2 = side(k2)
    R12 = k1.R @ k2.R.T
    t12 = k1.t - R12 @ k2.t
    sim3 = ((p1, d1, v1, p2, d2, v2, 1.0, f(R12), f(t12),
             torch.zeros(p1.shape[0], dtype=torch.bool, device=dev), tr.cam, tr.scale_factors),
            dict(kp_xy1=xy1, kp_xy2=xy2, kp_octave1=o1, kp_octave2=o2, max_dist1=m1,
                 max_dist2=m2, img_wh=tr.img_wh))
    return {"fuse_by_projection": fuse, "search_by_projection_reloc": reloc,
            "search_by_sim3": sim3}, (len(kids), n_mp, int(k1.valid.sum()))


def phase_search_api(sys_, dev):
    """[search-api]: ``fuse_by_projection``, ``search_by_projection_reloc``
    and ``search_by_sim3`` through their entry points on the [system] map
    (the counts cleared before and read after: K3 once, once and twice, K18
    once, for the reloc search), each bit-equal to the searches through
    K3's and K18's plain versions on the card.  Returns the launches."""
    inputs, (n_kf, n_mp, n_kp) = search_api_inputs(sys_, dev)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    got = {name: getattr(matcher, name)(*a, **kw) for name, (a, kw) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"hamming_best2": 4, "match_epilogue": 1}
    if launches != want:
        raise AssertionError(f"[search-api] launches {launches}, expected {want}")
    with plain_matcher():
        plain = {name: getattr(matcher, name)(*a, **kw) for name, (a, kw) in inputs.items()}
    for name, out in got.items():
        line = (f"[search-api] {name} on the [system] map ({n_kf} keyframes, {n_mp} points; "
                f"{n_kp} keypoints): {int((out >= 0).sum())} matches of {out.shape[0]}, "
                f"bit-equal to the plain path {torch.equal(out, plain[name])}")
        if not torch.equal(out, plain[name]) or int((out >= 0).sum()) == 0:
            raise AssertionError(line)
        print(line, flush=True)
    return launches


def _distinct(results) -> int:
    """The number of distinct results among calls (bytes of every output)."""
    return len({b"".join(t.detach().cpu().contiguous().numpy().tobytes() for t in r)
                for r in results})


def phase_det(dev, vi_call) -> dict:
    """[det]: K13 on [parity]'s essential graph, K14 on the [loop] map's GBA
    problem and K14<KB8> on the [loop-kb8] map's, and over ``MESH_SHARDS``
    shards of the card K30 on the [loop] map's problem and K31 on the
    essential graph, then K32 on [vi-loop-mesh]'s GBA call (``vi_call``, its
    one-view points fixed) over its shards and K33 on the [loop] map's
    problem with its observations sharded, K35 on [ba-stereo]'s Kp 32
    stereo problem, K36 (marginalize and sparsify at n = 30) and K29 on
    [parity-mesh]'s ``PLACE_K`` x ``PLACE_W`` block over the shards,
    ``DET_CALLS`` calls each on one input: they sum in a fixed order (the
    shards in shard order), so each gives one result."""
    prob = pose_graph_problem(np.random.default_rng(8), dev)
    pg = [pose_graph.optimize_pose_graph(prob, n_iters=15) for _ in range(DET_CALLS)]
    mesh = dmesh.Mesh([dev] * MESH_SHARDS)
    prob_n = pad_graph(prob, mesh.size)
    pgs = [dpg.optimize_sharded_pose_graph(mesh, prob_n, n_iters=15) for _ in range(DET_CALLS)]
    sb = {}
    for kb8 in (False, True):
        mp, _, _, _ = looped_map(dev, kb8=kb8)
        gprob = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
        cam = loop_camera(kb8)
        sb[kb8] = [tuple(sharded_ba.optimize_schur(gprob, cam)) for _ in range(DET_CALLS)]
        if not kb8:
            gprob_n = global_ba.build_global_problem(mp, [1.0] * 8, mesh.size, None, dev)[0]
            sbs = [tuple(sharded_ba.optimize_schur(gprob_n, cam, mesh=mesh))
                   for _ in range(DET_CALLS)]
            pcs = [tuple(sharded_ba.optimize_sharded(mesh, gprob, cam)) for _ in range(DET_CALLS)]
    vmesh, vprob, vcam, vkw = vi_call
    vprob = one_view_fixed(vprob)
    vis = [tuple(sharded_ba.optimize_vi_sharded(vmesh, vprob, vcam, **vkw))
           for _ in range(DET_CALLS)]
    _, p, cam, bf, sv = ba_stereo_cases(dev)[1]   # schur_dense, stereo, Kp 32
    dns = [tuple(ba.optimize(p, cam, BA_ITERS, BA_CG, bf=bf, solver=sv)) for _ in range(DET_CALLS)]
    *pa, qp = place_problem(np.random.default_rng(15), PLACE_K, PLACE_W, PLACE_NNZ)
    pblocks = [kfb.shard_kf_axis(mesh, kfb.pad_to_mesh(a, mesh.size)) for a in pa]
    qp = torch.from_numpy(qp).to(dev)
    pls = [tuple(torch.cat(x) for x in kfb.sharded_place_scores(mesh, *pblocks, qp))
           for _ in range(DET_CALLS)]
    del pblocks
    H = information(30, 60).to(dev)
    mgs = [(mg.marginalize(H, 0, 14), mg.sparsify(H, 0, 14, 15, 29)) for _ in range(DET_CALLS)]
    torch.cuda.synchronize()
    out = {}
    for name, res in (("pose_graph", pg), ("ba_schur", sb[False]), ("ba_schur_kb8", sb[True]),
                      ("ba_schur_sharded", sbs), ("pose_graph_sharded", pgs),
                      ("vi_ba_sharded", vis), ("ba_pcg_sharded", pcs), ("ba_schur_dense", dns),
                      ("marginal", mgs), ("place_dense", pls)):
        n = _distinct(res)
        print(f"[det] {name}: {n} distinct result(s) over {DET_CALLS} calls on one input",
              flush=True)
        if n != 1:
            raise AssertionError(f"[det] {name}: {n} distinct results over {DET_CALLS} calls")
        out[name] = n
    return out


# [parity-clahe]: the procedural texture at these shapes with these (clip
# limit, tiles), and a constant image; K27's time at the demos' 640x480
CLAHE_SHAPES = ((480, 640), (512, 512), (501, 753))
CLAHE_SETTINGS = ((3.0, 8), (40.0, 8), (3.0, 4))
# [parity-grid] / [demo_frame]: a 1500-feature extraction of a 512x512 frame
GRID_SIZE = 512
GRID_FEATURES = 1500


def phase_parity_clahe(dev) -> dict:
    """[parity-clahe]: K27 against ``clahe_plain`` on the card, outputs and
    LUTs bit-equal, on the procedural texture at 640x480, 512x512 and
    501x753 (rows and columns past the last whole tile) with clip 3 and 40
    (no clipping) and 8 and 4 tiles, and on a constant image; timed at
    640x480, clip 3, 8 tiles."""
    from extractorb_tpu_torch.utils import clahe as clahe_mod

    tex = pf.procedural_texture()
    images = [(f"{w}x{h}", np.ascontiguousarray(tex[:h, :w])) for h, w in CLAHE_SHAPES]
    images.append(("constant 640x480", np.full((480, 640), 77, np.uint8)))
    n = 0
    for name, img in images:
        x = torch.from_numpy(img).to(dev)
        for clip, tiles in CLAHE_SETTINGS if name[0] != "c" else CLAHE_SETTINGS[:1]:
            out, lut = clahe_mod.clahe_with_lut(x, clip, tiles)
            want_lut = clahe_mod.clahe_lut_plain(x, clip, tiles)
            want = clahe_mod.clahe_apply_plain(x, want_lut, tiles)
            d_lut = int((lut != want_lut).sum())
            d_out = int((out != want).sum())
            if d_lut or d_out:
                raise AssertionError(f"[parity-clahe] {name} clip {clip} tiles {tiles}: {d_out} "
                                     f"pixels and {d_lut} LUT entries differ from plain")
            n += 1
    x = torch.from_numpy(images[0][1]).to(dev)
    H, W = x.shape
    # in: the image; out: the image (the LUTs stay inside the call); per
    # pixel 4 LUT reads and ~20 float operations, per tile 256 bins x ~6
    stats = {"clahe": record(0.0, cuda_ms(lambda: clahe_mod.clahe(x)),
                             cuda_ms(lambda: clahe_mod.clahe_plain(x)), 2 * H * W,
                             20 * H * W + 64 * 256 * 6)}
    print(f"[parity-clahe] K27 bit-equal to the plain version (outputs and LUTs) on {n} "
          f"inputs; {W}x{H}: {stats['clahe']['ms']:.4f} ms a call, plain "
          f"{stats['clahe']['plain_ms']:.3f} ms, bound {stats['clahe']['bound_ms']:.6f} ms "
          f"({stats['clahe']['bound_by']})", flush=True)
    return stats


def grid_extraction(dev):
    """The keypoints of a ``GRID_FEATURES``-feature extraction of a 512x512
    crop of the procedural texture, on ``dev``: (xy, valid, octave, bounds)."""
    img = np.ascontiguousarray(pf.procedural_texture()[:GRID_SIZE, :GRID_SIZE])
    f = ORBExtractor(ORBConfig(n_features=GRID_FEATURES, max_kps_per_level=4096),
                     img.shape, dev)(torch.from_numpy(img).to(dev))
    bounds = torch.tensor([0.0, GRID_SIZE, 0.0, GRID_SIZE], dtype=torch.float32, device=dev)
    return f.xy, f.valid, f.octave, bounds


def phase_parity_grid(dev) -> dict:
    """[parity-grid]: K28's three entry points against their plain versions
    on the card, bit-equal, on a 1500-feature extraction's keypoints and on
    ``pf.grid_cases`` (points outside and on the bounds, 100 in one cell of
    capacity 8, none valid), ``strict`` both ways, the level-gate queries of
    tests/test_grid.py; timed on the extraction's keypoints."""
    from extractorb_tpu_torch.frontend import grid as grid_mod

    cases = {name: tuple(torch.from_numpy(a).to(dev) for a in c[:4]) + (c[4],)
             for name, c in pf.grid_cases().items()}
    cases["extraction"] = grid_extraction(dev) + (16,)
    for name, (xy, valid, octave, bounds, cap) in cases.items():
        for strict in (True, False):
            got = grid_mod.pos_in_grid(xy, bounds, valid, strict=strict)
            want = grid_mod.pos_in_grid_plain(xy, bounds, valid, strict=strict)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"[parity-grid] grid_pos differs on {name} ({strict})")
        got = grid_mod.assign_features_to_grid(xy, bounds, valid, cell_capacity=cap)
        want = grid_mod.assign_features_to_grid_plain(xy, bounds, valid, cell_capacity=cap)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"[parity-grid] grid_assign differs on {name}")
        for q in pf.GRID_AREA_QUERIES:
            if not torch.equal(grid_mod.features_in_area_mask(xy, octave, valid, *q),
                               grid_mod.features_in_area_mask_plain(xy, octave, valid, *q)):
                raise AssertionError(f"[parity-grid] grid_area differs on {name} {q}")
    xy, valid, octave, bounds, cap = cases["extraction"]
    n, cells = xy.shape[0], grid_mod.FRAME_GRID_ROWS * grid_mod.FRAME_GRID_COLS
    q = (GRID_SIZE / 2, GRID_SIZE / 2, 50.0, 0, 0)
    # bytes: keypoints (8 B) and flags in, the outputs out; ops ~10 a point
    stats = {
        "grid_pos": record(0.0, cuda_ms(lambda: grid_mod.pos_in_grid(xy, bounds, valid)),
                           cuda_ms(lambda: grid_mod.pos_in_grid_plain(xy, bounds, valid)),
                           n * (8 + 1) + 16 + n * (8 + 1), 10 * n),
        "grid_assign": record(
            0.0, cuda_ms(lambda: grid_mod.assign_features_to_grid(xy, bounds, valid)),
            cuda_ms(lambda: grid_mod.assign_features_to_grid_plain(xy, bounds, valid)),
            n * (8 + 1) + 16 + 4 * cells * (cap + 1), 12 * n),
        "grid_area": record(
            0.0, cuda_ms(lambda: grid_mod.features_in_area_mask(xy, octave, valid, *q)),
            cuda_ms(lambda: grid_mod.features_in_area_mask_plain(xy, octave, valid, *q)),
            n * (8 + 4 + 1) + n, 8 * n),
    }
    print(f"[parity-grid] K28 bit-equal to the plain versions on {len(cases)} cases "
          f"({int(valid.sum())} keypoints of {n} slots in the extraction); "
          + ", ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f})"
                      for k, v in stats.items()), flush=True)
    return stats


# the kernels each demo must launch on the card
DEMO_KERNELS = {
    "demo_clahe": ("clahe",),
    "demo_clahe_keypoint": ("clahe",) + EXTRACT_KERNELS,
    "demo_orb_extractor": ("clahe",) + EXTRACT_KERNELS,
    "demo_distribute_oct_tree": ("pyramid", "fast_detect", "kp_collect", "octree_select"),
    "demo_whole_extractor": EXTRACT_KERNELS,
    "demo_frame": EXTRACT_KERNELS + ("grid_assign", "grid_pos", "grid_area", "vocab_words"),
    "demo_matcher": EXTRACT_KERNELS + ("hamming_best2", "match_epilogue", "two_view"),
}


def phase_demos() -> dict:
    """[demos]: every demo's ``main`` on the card at its JAX default budget
    (1500 features, 1000 for the oct-tree and whole-extractor demos; 640x480,
    512x512 for frame and matcher), the launch counts set to 0 before each
    and read after it: each demo launched the kernels it should, and what it
    computed holds (contrast up, the budget distributed, every keypoint in
    the grid, the pair's yaw and baseline direction recovered)."""
    import importlib

    paths = {}
    for name, want in DEMO_KERNELS.items():
        module = importlib.import_module(f"extractorb_tpu_torch.demos.{name}")
        print(f"[demos] {name}:", flush=True)
        kernels.LAUNCHES.clear()
        res = module.main([])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in want if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"[demos] {name} never launched {missing}: {launches}")
        print(f"[demos] {name} launches {launches}", flush=True)
        paths[f"demos/{name}"] = launches
        if name == "demo_clahe" and not res["enhanced"].std() > res["image"].std():
            raise AssertionError("[demos] demo_clahe: the contrast did not rise")
        if name == "demo_distribute_oct_tree" and res["total"] != 1000:
            raise AssertionError(f"[demos] {name}: {res['total']} keypoints distributed")
        if name == "demo_frame" and not (res["counts"].sum() == res["in_grid"]
                                         == res["n_keypoints"] > 1000):
            raise AssertionError(f"[demos] demo_frame: {res['n_keypoints']} keypoints, "
                                 f"{res['in_grid']} in the grid, {res['counts'].sum()} counted")
        if name == "demo_matcher":
            check_demo_pair(res)
    return paths


def check_demo_pair(res):
    """The matcher demo's reconstruction recovers the default pair's yaw
    within 0.3 degrees and its baseline's direction within 3 degrees."""
    from extractorb_tpu_torch.demos._common import PAIR_T21, PAIR_YAW_DEG

    if not res["success"]:
        raise AssertionError(f"[demos] demo_matcher: no reconstruction: {res}")
    t_true = np.asarray(PAIR_T21, np.float64) / np.linalg.norm(PAIR_T21)
    yaw = float(np.degrees(np.arcsin(np.clip(res["R21"][0, 2], -1.0, 1.0))))
    cos_t = float(res["t21"] @ t_true)
    if abs(yaw - PAIR_YAW_DEG) > 0.3 or cos_t < np.cos(np.radians(3.0)):
        raise AssertionError(f"[demos] demo_matcher: yaw {yaw:.3f} deg (true {PAIR_YAW_DEG}), "
                             f"baseline direction cos {cos_t:.5f}")
    print(f"[demos] demo_matcher: yaw {yaw:.3f} deg (true {PAIR_YAW_DEG}), baseline "
          f"direction cos {cos_t:.5f}", flush=True)


def kb8_config(width: int = KB8_SIZE, height: int = KB8_SIZE,
               n_features: int = KB8_FEATURES) -> SLAMConfig:
    """[system]'s configuration through TUM-VI's KB8 fisheye (scaled to the
    image), monocular, no vocabulary."""
    fx, fy, cx, cy, k1, k2, k3, k4 = pf.kb8_camera(width, height)
    cam = CameraConfig(model="KannalaBrandt8", fx=fx, fy=fy, cx=cx, cy=cy, k1=k1, k2=k2, k3=k3,
                       k4=k4, width=width, height=height)
    return dataclasses.replace(system_config(width, height, n_features), camera=cam)


def kb8_rig_config(sensor: str = "stereo", width: int = KB8_SIZE, height: int = KB8_SIZE,
                   n_features: int = KB8_FEATURES) -> SLAMConfig:
    """The fisheye rig of [stereo-kb8] ("stereo": [kb8]'s configuration) and
    [vi-stereo-kb8] ("imu-stereo": [vi-kb8]'s): both cameras TUM-VI's KB8
    calibration, the right one 0.101 m along x (``pf.KB8_RIG_T_LR``), bf =
    190.97 x 0.101 and ThDepth 35 (tests/test_stereo_fisheye.py:135-143),
    both scaled to the image, the lapping band the whole width."""
    base = kb8_config if sensor == "stereo" else vi_kb8_config
    cfg = base(width, height, n_features)
    cam = dataclasses.replace(cfg.camera, bf=190.97 * KB8_BASELINE * width / KB8_SIZE,
                              th_depth=KB8_TH_DEPTH)
    return dataclasses.replace(cfg, camera=cam, camera2=dataclasses.replace(cam, bf=0.0),
                               T_lr=pf.KB8_RIG_T_LR, sensor=sensor)


def vi_kb8_config(width: int = KB8_SIZE, height: int = KB8_SIZE,
                  n_features: int = KB8_FEATURES) -> SLAMConfig:
    """[vi]'s configuration through TUM-VI's KB8 camera (imu-monocular)."""
    cam = dataclasses.replace(kb8_config(width, height, n_features).camera, fps=pf.VI_FPS)
    return dataclasses.replace(vi_config(width, height, n_features), camera=cam)


def kb8_frames(n: int = SYS_FRAMES, size: int = KB8_SIZE):
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), n, SYS_SPEED, size, size,
                                          camera="kb8")
    return frames, poses


def _fisheye_pnp_scene(rng, N: int, matched: float = 0.8, out_frac: float = 0.3):
    """MLPnP at the relocalization shape: N keypoint slots, ``matched`` of
    them matched to map points 2-8 m away over more than a hemisphere
    (bearings up to ~100 degrees off the axis, as the 512x512 KB8 camera
    sees), ``out_frac`` of those with a random bearing."""
    dirs = rng.normal(size=(N, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) * 0.8 - 0.15
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    R = pf.so3_exp_np([0.2, -0.3, 0.1]).astype(np.float32)
    t = np.array([0.4, -0.2, 0.6], np.float32)
    pc = (dirs * rng.uniform(2, 8, N)[:, None]).astype(np.float32)
    p3d = ((pc - t) @ R).astype(np.float32)
    bear = pc / np.linalg.norm(pc, axis=1, keepdims=True)
    out = rng.random(N) < out_frac
    noise = rng.normal(size=(N, 3))
    bear[out] = noise[out] / np.linalg.norm(noise[out], axis=1, keepdims=True)
    return p3d, bear.astype(np.float32), rng.random(N) < matched


def phase_parity_kb8(dev) -> dict:
    """[parity-kb8]: K4<KB8> and K6<KB8> against their plain versions at
    [kb8]'s shapes (two pose problems of the 1500-feature extractor's 1628
    slots; run_ba's init-shaped problem), poses within 1e-4 and the same
    inliers; K25's RANSAC with the same winner as its plain version (the
    first maximum), the same mask and pose within 1e-5, and its refinement
    within 1e-5.  The sets whose counts differ are printed: a set with a
    repeated index leaves a two-dimensional null space, which Jacobi and
    LAPACK resolve differently."""
    rng = np.random.default_rng(11)
    kb8 = pf.kb8_camera(KB8_SIZE, KB8_SIZE)
    cam = track_device.kb8_project(*kb8)
    N = KB8_FEATURES + 8 * 16
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    stats = {}

    # K4<KB8>: two mono problems, 20% gross outliers, points to ~60 degrees
    R0, t0, pts, obs, isig, val, _ = pf.synthetic_pose_problems(rng, 2, N, *kb8[:4], kb8=kb8)
    args = [t(a, torch.float32) for a in (R0, t0, pts, obs, isig)] + [t(val, torch.bool)]
    rk = pose_opt.optimize_pose(*args, cam)
    rp = pose_opt.optimize_pose_plain(*args, cam)
    d = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
    if d > 1e-4 or not torch.equal(rk.inliers, rp.inliers):
        raise AssertionError(f"pose_lm<KB8>: pose error {d:.2e}, inliers equal "
                             f"{torch.equal(rk.inliers, rp.inliers)}")
    # work: the pinhole count plus ~150 operations a valid observation and
    # LM iteration for the KB8 projection in Dual<3> (atan2, sqrt, the
    # polynomial and its three tangents)
    nbytes, ops = pose_lm_work(2, N, int(val.sum()), stereo_rows=False)
    stats["pose_lm_kb8"] = record(d, cuda_ms(lambda: pose_opt.optimize_pose(*args, cam)),
                                  cuda_ms(lambda: pose_opt.optimize_pose_plain(*args, cam)),
                                  nbytes + 16, ops + 40 * 150 * int(val.sum()))
    print(f"[parity-kb8] pose_lm<KB8> B=2 N={N}: max |dR|,|dt| {d:.2e}, inliers equal; "
          f"{stats['pose_lm_kb8']['ms']:.4f} ms a call", flush=True)
    trace_later("pose_lm_kb8", ("pose_lm", (*args, cam), {}),
                lambda r: device_note(stats["pose_lm_kb8"], r, f"pose_lm<KB8> B=2 N={N}"))

    # K6<KB8>: run_ba's init-shaped problem, 12 LM x 40 PCG
    prob = ba_problem(np.random.default_rng(1), dev, kb8=kb8)
    bk = ba.optimize(prob, cam, n_iters=12, cg_iters=40)
    bp = ba.optimize_plain(prob, cam, n_iters=12, cg_iters=40)
    d = max(float((bk.R - bp.R).abs().max()), float((bk.t - bp.t).abs().max()))
    dp = float((bk.points - bp.points).abs().max())
    if d > 1e-4 or not torch.equal(bk.inliers, bp.inliers):
        raise AssertionError(f"ba_pcg<KB8>: poses {d:.2e}, points {dp:.2e}, inliers equal "
                             f"{torch.equal(bk.inliers, bp.inliers)}")
    Ob, Pb, Kb = prob.obs_kf.shape[0], prob.points.shape[0], prob.R.shape[0]
    stats["ba_pcg_kb8"] = record(
        d, cuda_ms(lambda: ba.optimize(prob, cam, 12, 40), reps=5),
        cuda_ms(lambda: ba.optimize_plain(prob, cam, 12, 40), reps=2),
        Ob * (4 + 4 + 8 + 4 + 1) + Pb * (12 + 1) + Kb * (48 + 1) + Kb * 48 + Pb * 12 + Ob + 4
        + 16, 12 * int(prob.obs_valid.sum()) * (150 + 2 * 150 + 40 * 80))
    print(f"[parity-kb8] ba_pcg<KB8> K={Kb} P={Pb} O={Ob}: poses within {d:.2e} (points "
          f"{dp:.2e}), inliers equal ({int(bk.inliers.sum())})", flush=True)

    # K25: RANSAC on 256 sets, then the refinement on its inliers
    p3d, bear, valid = _fisheye_pnp_scene(rng, N)
    a = [t(p3d, torch.float32), t(bear, torch.float32), t(valid, torch.bool)]
    sets = pnp.sample_pnp_sets(3, torch.from_numpy(valid)).to(dev)
    H = sets.shape[0]
    ck, cp = (torch.empty(H, dtype=torch.int32, device=dev) for _ in range(2))
    run_k = lambda: pnp.mlpnp_ransac(*a, sets, min_inliers=12, counts_out=ck)
    run_p = lambda: pnp.mlpnp_ransac_plain(*a, sets, min_inliers=12, counts_out=cp)
    rk, rp = run_k(), run_p()
    d = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
    winner, winner_p = int(torch.argmax(ck)), int(torch.argmax(cp))   # first maximum
    same = (winner == winner_p and int(rk.n_inliers) == int(rp.n_inliers)
            and torch.equal(rk.inliers, rp.inliers) and bool(rk.ok) == bool(rp.ok))
    differ = (ck != cp).cpu().numpy()
    repeated = np.array([len(set(r)) < 6 for r in sets.cpu().numpy().tolist()])
    if not same or not d <= 1e-5 or not bool(rk.ok):
        raise AssertionError(f"mlpnp_ransac: winner {winner}/{winner_p}, n_inliers "
                             f"{int(rk.n_inliers)}/{int(rp.n_inliers)}, masks equal "
                             f"{torch.equal(rk.inliers, rp.inliers)}, |dR|,|dt| {d:.2e}, counts "
                             f"differ on {int(differ.sum())} sets, {int((differ & ~repeated).sum())}"
                             " of them without a repeated index")
    nv = int(valid.sum())
    # work: per hypothesis ~25k float64 operations (the 12x12 normal matrix
    # of 12 rows 1.7k, its Jacobi eigenproblem ~9 n^3 = 15.6k, the tangent
    # bases, the sign, the 3x3 SVD ~5k); ~20 float32 operations per
    # (hypothesis, valid slot) of scoring and the winner's mask.  In: points,
    # bearings, mask, sets; out: R, t, mask, count, ok
    stats["mlpnp_ransac"] = record(d, cuda_ms(run_k), cuda_ms(run_p, reps=5),
                                   N * (12 + 12 + 1) + H * 6 * 4 + 48 + N + 5,
                                   20 * (H + 1) * nv, ops64=25000 * H)
    info = torch.full((N,), float(1.0 * kb8[0] ** 2), device=dev)
    use = a[2] & rk.inliers
    Rk, tk = pnp.mlpnp_refine(rk.R, rk.t, a[0], a[1], info, use)
    Rq, tq = pnp.mlpnp_refine_plain(rk.R, rk.t, a[0], a[1], info, use)
    dr = max(float((Rk - Rq).abs().max()), float((tk - tq).abs().max()))
    if not dr <= 1e-5:
        raise AssertionError(f"mlpnp_refine: |dR|,|dt| {dr:.2e}")
    n_use = int(use.sum())
    # work: 8 Gauss-Newton steps of ~400 float64 operations per used slot
    # (tangent basis, residual, Jacobian, the 27 sums) and the 6x6 solve
    stats["mlpnp_refine"] = record(
        dr, cuda_ms(lambda: pnp.mlpnp_refine(rk.R, rk.t, a[0], a[1], info, use)),
        cuda_ms(lambda: pnp.mlpnp_refine_plain(rk.R, rk.t, a[0], a[1], info, use), reps=5),
        48 + N * (12 + 12 + 4 + 1) + 48, 0, ops64=8 * (400 * n_use + 500))
    print(f"[parity-kb8] mlpnp_ransac N={N} H={H}: the same winner {winner} "
          f"({int(rk.n_inliers)} of {nv} matched), inlier mask equal, max |dR|,|dt| {d:.2e}; "
          f"counts differ on {int((differ & repeated).sum())} of the {int(repeated.sum())} sets "
          f"with a repeated index and on {int((differ & ~repeated).sum())} of the others; "
          f"mlpnp_refine on {n_use} inliers within {dr:.2e}", flush=True)
    return stats


def phase_kb8(frames, poses, dev):
    """[kb8]: ``System.track_monocular`` through the KB8 camera at 512x512
    and 1500 features over [system]'s 30 frames from a cold map (counts set
    to 0 before it and read after): init by frame 2, every later frame OK,
    >= 4 keyframes, > 500 map points, ATE after Sim3 alignment under 0.05 x
    the scene scale; every pose solve and BA through the KB8 instantiations
    of K4 and K6, no undistortion, no PnP."""
    host_ms, kf_frames, event_ms = [], [], []

    def on_frame(k, st, dt, kf, _):
        host_ms.append(dt * 1e3)
        if kf:
            kf_frames.append(k)

    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    with _TwoViewRecorder() as rec:
        sys_, states = run_system(frames, dev, on_frame, kb8_config(), event_ms=event_ms)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    replays = kernels.GRAPH_LAUNCHES["track_step"]
    first_ok, ate, scale = check_system(sys_, states, poses)
    tr = sys_.tracker
    want = {"pose_lm_kb8": launches.get("pose_lm", 0), "ba_pcg_kb8": launches.get("ba_pcg", 0),
            "ba_pcg": tr.stats["ba"], "two_view": tr.stats["two_view"]}
    bad = {n: (launches.get(n, 0), w) for n, w in want.items() if launches.get(n, 0) != w or not w}
    missing = [n for n in VISUAL_KERNELS if n not in ("stereo_match", "pnp_ransac")
               and launches.get(n, 0) == 0]
    stray = {n: launches[n] for n in ("undistort", "pnp_ransac", "mlpnp_ransac", "stereo_match")
             if launches.get(n, 0)}
    if bad or missing or stray or not replays:
        raise AssertionError(f"[kb8] launches {launches}: (got, want) {bad}, never launched "
                             f"{missing}, stray {stray}, graph replays {replays}")
    for k, (st, ms) in enumerate(zip(states, host_ms)):
        print(f"[kb8] frame {k:2d}: {ms:8.2f} ms host {event_ms[k]:8.2f} ms events  "
              f"{st.name:15s}{'  keyframe event' if k in kf_frames else ''}", flush=True)
    steady = [k for k in range(first_ok + 2, len(states)) if k not in kf_frames]
    kfs = [k for k in kf_frames if k > first_ok]
    med = lambda v, ks: statistics.median([v[k] for k in ks]) if ks else float("nan")
    print(f"[kb8] init at frame {first_ok}, {sys_.n_keyframes()} keyframes, "
          f"{sys_.n_map_points()} map points, ATE {ate:.4f} m (scene scale {scale:.3f} m); "
          f"ordinary frames median {med(host_ms, steady):.2f} ms host / "
          f"{med(event_ms, steady):.2f} ms events, keyframe events {med(host_ms, kfs):.2f} / "
          f"{med(event_ms, kfs):.2f} ms; {replays} graph replays", flush=True)
    print(f"[kb8] launches {launches}", flush=True)
    return launches, rec.results, sys_, states


def phase_kb8_reference(frames, card_inits, card_sys, card_states):
    """[kb8-reference]: the init and three tracked frames of [kb8] through
    the port's CPU plain path with the same draws: the same states and
    keyframes, R21/t21 within 1e-3 and the triangulated masks agreeing on
    >= 99%, poses within 1e-3."""
    first_ok = int(round(card_sys.tracker.trajectory[1][0] * 30.0))
    n = first_ok + 4
    with _TwoViewRecorder() as rec:
        cpu_sys, cpu_states = run_system(frames[:n], torch.device("cpu"), cfg=kb8_config())
    g, c = card_inits[-1], rec.results[-1]
    d = max(float(np.abs(g["R21"] - c["R21"]).max()), float(np.abs(g["t21"] - c["t21"]).max()))
    agree = float((g["is_triangulated"] == c["is_triangulated"]).mean())
    kf_ids = lambda s: sorted(kf.frame_id for kf in s.tracker.atlas.current.keyframes.values()
                              if kf.frame_id < n)
    if (d > 1e-3 or agree < 0.99 or list(cpu_states) != list(card_states[:n])
            or kf_ids(cpu_sys) != kf_ids(card_sys)):
        raise AssertionError(f"[kb8-reference] init |dR21|,|dt21| {d:.2e}, masks agree "
                             f"{agree:.4f}, states {cpu_states} / {card_states[:n]}, keyframes "
                             f"{kf_ids(cpu_sys)} / {kf_ids(card_sys)}")
    dp = 0.0
    for (ts, Rg, tg), (_, Rc, tc) in zip(card_sys.tracker.trajectory, cpu_sys.tracker.trajectory):
        dp = max(dp, float(np.abs(Rg - Rc).max()), float(np.abs(tg - tc).max()))
    if dp > 1e-3:
        raise AssertionError(f"[kb8-reference] card vs CPU poses {dp:.2e}")
    print(f"[kb8-reference] frames 0-{n - 1}: the same states and keyframes as the CPU plain "
          f"path, init |dR21|,|dt21| {d:.2e}, triangulated masks agree {agree:.4f}, poses "
          f"within {dp:.2e}", flush=True)


def phase_reloc_kb8(frames, poses, dev):
    """[reloc-kb8]: [kb8] with frames 14-15 black: LOST, relocalized through
    MLPnP (K25's RANSAC and refinement, one each per PnP call of the
    tracker; K10 never) on the first real frame or the next, then OK to the
    end, ATE within the [kb8] limit."""
    sys_, states, launches = run_recovery("[reloc-kb8]", pf.blackout(frames, RELOC_BLACK), dev,
                                          cfg=kb8_config())
    first_real = RELOC_BLACK[-1] + 1
    back = next((k for k in range(first_real, len(states)) if states[k] == TrackState.OK), None)
    n_pnp = sys_.tracker.stats["pnp"]
    if (states[RELOC_BLACK[0]] not in (TrackState.LOST, TrackState.RECENTLY_LOST)
            or back is None or back > first_real + 1
            or any(s != TrackState.OK for s in states[back:])):
        raise AssertionError(f"[reloc-kb8] states {[s.name for s in states]}")
    if (launches.get("mlpnp_ransac", 0) != n_pnp or launches.get("mlpnp_refine", 0) != n_pnp
            or n_pnp == 0 or launches.get("pnp_ransac", 0) or not sys_.tracker.stats["reloc_ok"]):
        raise AssertionError(f"[reloc-kb8] launches {launches}, the tracker counted {n_pnp} PnP "
                             "calls")
    ate, scale = pf.trajectory_ate(sys_.tracker.trajectory, poses)
    if not np.isfinite(ate) or ate > 0.05 * max(scale, 1.0):
        raise AssertionError(f"[reloc-kb8] ATE {ate:.4f} m over a scene scale of {scale:.3f} m")
    print(f"[reloc-kb8] OK again at frame {back} through MLPnP ({n_pnp} PnP calls), "
          f"{sys_.n_keyframes()} keyframes, ATE {ate:.4f} m (scene scale {scale:.3f} m)",
          flush=True)
    return launches


# ------------------------------------------------------- the fisheye rig


def rig_frames(n: int = SYS_FRAMES, size: int = KB8_SIZE):
    """[stereo-kb8]'s frames: [system]'s motion seen by the fisheye rig."""
    return pf.render_kb8_stereo_sequence(pf.procedural_texture(), n, SYS_SPEED, size, size)


def vi_rig_frames(n: int = VI_KB8_FRAMES, size: int = KB8_SIZE):
    """[vi-stereo-kb8]'s and [vi-kb8]'s frames: [vi]'s trajectory in the rig's
    scene (left and right images, poses)."""
    return pf.render_vi_kb8_stereo_sequence(pf.procedural_texture(), n, size, size)


def _k26_inputs(left, right, dev, cfg):
    """The tracker's K26 inputs of one rig frame: both images extracted on
    the card (1628 slots a side at 1500 features), the lapping masks."""
    ext = ORBExtractor(cfg.orb, left.shape, dev)
    fl, fr = ext(torch.from_numpy(left).to(dev)), ext(torch.from_numpy(right).to(dev))
    lap_l = stereo.lapping_mask(fl.xy, 0.0, float(cfg.camera.width), fl.valid)
    lap_r = stereo.lapping_mask(fr.xy, 0.0, float(cfg.camera2.width), fr.valid)
    sigma2 = [s * s for s in track_device.scale_factors(cfg.orb)]
    return fl, fr, lap_l, lap_r, sigma2


def phase_parity_stereo_kb8(left, right, right_rot, rig_rot, dev) -> dict:
    """[parity-stereo-kb8]: K26 against its plain version on the card at the
    tracker's shapes: [stereo-kb8]'s frame 0, and the same left image with a
    right camera turned 0.8 degrees about y (R_rl != I).  The best column
    and the candidate mask bit-equal, right_idx equal where both agree on
    validity, p3d within 1e-5 relative on the rows valid in both; the rows
    whose validity differs (Jacobi against LAPACK's SVD, both float64) must
    sit within 1e-4 of a gate, and their count is printed, as is p3d's
    distance from JAX's float32 SVD of the same rows."""
    from extractorb_tpu_torch.core import camera as pcam
    cfg = kb8_rig_config()
    cam = KannalaBrandt8.from_config(cfg.camera)
    tr = System(cfg, device=torch.device("cpu")).tracker
    stats = {}
    for tag, r_img, (R_rl, t_rl) in (("rig", right, (tr.R_rl, tr.t_rl)),
                                     ("R_rl != I", right_rot, rig_rot)):
        fl, fr, lap_l, lap_r, sigma2 = _k26_inputs(left, r_img, dev, cfg)
        args = (cam, cam, fl.xy, fl.octave, fl.desc, lap_l, fr.xy, fr.octave, fr.desc, lap_r,
                R_rl, t_rl, sigma2)
        k = stereo.compute_stereo_fisheye_matches(*args)
        p = stereo.compute_stereo_fisheye_matches_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k.best_idx, p.best_idx) and torch.equal(k.candidate, p.candidate)):
            raise AssertionError(f"[parity-stereo-kb8] {tag}: best columns equal "
                                 f"{torch.equal(k.best_idx, p.best_idx)}, candidates equal "
                                 f"{torch.equal(k.candidate, p.candidate)}")
        vk, vp = k.valid, p.valid
        both = vk & vp
        scale = p.p3d[both].norm(dim=1)
        rel = float(((k.p3d[both] - p.p3d[both]).abs().amax(1) / scale).max()) if both.any() \
            else 0.0
        bi = p.best_idx.long()
        s2 = torch.as_tensor(np.float32(sigma2), device=dev)
        lvl = lambda o: o.long().clamp(0, len(sigma2) - 1)
        R_t, t_t = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (R_rl, t_rl))
        terms = pcam.triangulation_terms(cam, cam, fl.xy, fr.xy[bi], R_t, t_t)
        margin = pcam.triangulation_gate_margin(terms, s2[lvl(fl.octave)], s2[lvl(fr.octave[bi])])
        differ = (vk != vp) & p.candidate
        n_diff, n_edge = int(differ.sum()), int((differ & (margin < 1e-4)).sum())
        same_idx = torch.equal(k.right_idx[vk == vp], p.right_idx[vk == vp].to(torch.int32))
        # K26's distance from JAX's solve of the same rows, a float32 SVD
        p32 = pcam.triangulation_terms(cam, cam, fl.xy, fr.xy[bi], R_t, t_t,
                                       svd_dtype=torch.float32).p3d
        rel32 = float(((k.p3d[both] - p32[both]).abs().amax(1) / scale).max()) if both.any() \
            else 0.0
        if not rel <= 1e-5 or n_edge != n_diff or not same_idx or int(both.sum()) < 100:
            raise AssertionError(f"[parity-stereo-kb8] {tag}: p3d within {rel:.2e} relative, "
                                 f"{n_diff} validity flips ({n_edge} at a gate edge), right_idx "
                                 f"equal {same_idx}, {int(both.sum())} valid")
        print(f"[parity-stereo-kb8] {tag}: NL={fl.xy.shape[0]} NR={fr.xy.shape[0]}, "
              f"{int(p.candidate.sum())} candidates (bit-equal), {int(both.sum())} valid in both, "
              f"p3d within {rel:.2e} relative ({rel32:.2e} from a float32 SVD, JAX's solve); "
              f"gate-edge flips: {n_diff}", flush=True)
        if tag != "rig":
            continue
        NL, NR = fl.xy.shape[0], fr.xy.shape[0]
        m_args = (fl.desc, lap_l, fr.desc, lap_r)
        # work: NL x NR lapping pairs of 8 XOR, 8 popcount and 8 adds, the
        # top-2 insert; in: descriptors and masks, out: 3 int32 and a flag
        pairs = int(lap_l.sum()) * int(lap_r.sum())
        stats["stereo_fisheye_match"] = record(
            0.0, cuda_ms(lambda: stereo.fisheye_match(*m_args)),
            cuda_ms(lambda: stereo.fisheye_best2_plain(*m_args)),
            (NL + NR) * 33 + NL * 13, 28 * pairs)
        t_args = (cam, cam, fl.xy, fr.xy, k.best_idx, k.candidate, fl.octave, fr.octave, R_rl,
                  t_rl, sigma2)
        nc = int(k.candidate.sum())
        # work per candidate: two 10-step Newton unprojections and two
        # projections (~700 float32 operations) and the 4x4 A^T A and its
        # Jacobi eigenproblem (~3000 float64); in: both sides' pixels and
        # octaves, the columns and candidates; out: p3d, depth, valid, index
        stats["fisheye_triangulate"] = record(
            rel, cuda_ms(lambda: stereo.fisheye_triangulate(*t_args)),
            cuda_ms(lambda: stereo.fisheye_triangulate_plain(*t_args)),
            NL * (8 + 4 + 4 + 1) + NR * 12 + NL * (12 + 4 + 1 + 4), 700 * nc, ops64=3000 * nc)
    return stats


def _parity_inertial_kb8(tag, rec, stats):
    """K20<KB8> and K22<KB8> against their plain versions at their first
    calls in a run (``rec``): states within 1e-4, inliers equal, K20's points
    seen by three or more keyframes within 1e-3 m, K22's H within 1e-4 (1e-3
    marginalised); times recorded the first time (K20's with the one-view
    points fixed)."""
    def err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    out = []
    if rec.calls["vi_ba"]:
        # the IMU initialisation's full VI BA.  Its map's points seen by one
        # keyframe (the rig's close points) have rank-2 blocks, on which a
        # float32 PCG breaks down (ROADMAP C.2, as [vi-loop]'s GBA), and the
        # points the triangulation program made through the pinhole K (C.2)
        # are ill-conditioned: two float32 PCG solves part there by metres,
        # each as far from the float64 solve as from the other.  So: with
        # the one-view points fixed, the states within 1e-4, the inliers
        # equal and the points seen by three or more keyframes within 1e-3 m
        # (all points' deviation printed beside both solves' distance from
        # the float64 one), and with every point fixed the states within
        # 1e-4 and the inliers equal
        args, kw = rec.calls["vi_ba"][0]
        prob, cam = args[0], args[1]
        it, cg = kw.get("n_iters", 8), kw.get("cg_iters", 50)
        states = ("Rwb", "twb", "v", "bg", "ba")
        run = lambda f, q: f(q, cam, n_iters=it, cg_iters=cg)
        n_obs = torch.bincount(prob.obs_mp[prob.obs_valid].long(),
                               minlength=prob.points.shape[0])
        q = prob._replace(fixed_mp=prob.fixed_mp | (n_obs < 2))
        vk, vp = run(sin.optimize_vi_ba, q), run(sin.optimize_vi_ba_plain, q)
        v64 = run(sin.optimize_vi_ba_plain, sin._cast(q, torch.float64))
        d = err([getattr(vk, f) for f in states], [getattr(vp, f) for f in states])
        dpt = [float((a.points.double() - b.points.double()).abs().max())
               for a, b in ((vk, vp), (vk, v64), (vp, v64))]
        qa = prob._replace(fixed_mp=torch.ones_like(prob.fixed_mp))
        ak, ap = run(sin.optimize_vi_ba, qa), run(sin.optimize_vi_ba_plain, qa)
        da = err([getattr(ak, f) for f in states], [getattr(ap, f) for f in states])
        m3 = ~q.fixed_mp & (n_obs >= 3)
        dp3 = float((vk.points - vp.points)[m3].abs().max()) if bool(m3.any()) else 0.0
        if d > 1e-4 or da > 1e-4 or not dp3 <= 1e-3 or int(m3.sum()) < 100 or \
                not torch.equal(vk.inliers, vp.inliers) or \
                not torch.equal(ak.inliers, ap.inliers) or not isinstance(cam, KannalaBrandt8):
            raise AssertionError(f"{tag} vi_ba<KB8>: states {d:.2e} apart with the one-view "
                                 f"points fixed (the {int(m3.sum())} points seen by 3+ keyframes "
                                 f"{dp3:.2e}, all {dpt[0]:.2e}), {da:.2e} with every point "
                                 f"fixed, inliers equal {torch.equal(vk.inliers, vp.inliers)} / "
                                 f"{torch.equal(ak.inliers, ap.inliers)}, camera {cam}")
        K, P, O = prob.Rwb.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]
        if "vi_ba_kb8" not in stats:
            ov = int(prob.obs_valid.sum())
            stats["vi_ba_kb8"] = record(
                max(d, dp3), cuda_ms(lambda: run(sin.optimize_vi_ba, q), reps=5),
                cuda_ms(lambda: run(sin.optimize_vi_ba_plain, q), reps=1),
                K * (84 + 1168 + 3) + P * 13 + O * 21 + 48 + K * 84 + P * 12 + O + 4 + 16,
                it * (ov * (150 + 2 * 150 + cg * 80) + K * (2 * 16 * 2500 + cg * 2 * 15 * 30 * 2)
                      + P * cg * 30))
            vi_cluster_record(q, cam, it, cg, vk, f"{tag} vi_ba<KB8>", stats["vi_ba_kb8"])
        out.append(f"vi_ba<KB8> K={K} P={P} O={O} ({it} LM x {cg} PCG), the "
                   f"{int((n_obs == 1).sum())} one-view points fixed: states within {d:.2e}, "
                   f"inliers equal, the {int(m3.sum())} points seen by 3+ keyframes within "
                   f"{dp3:.2e}, all points {dpt[0]:.2e} apart (K20 {dpt[1]:.2e}, plain "
                   f"{dpt[2]:.2e} from the float64 solve); every point fixed: states within "
                   f"{da:.2e}")
    for key, joint in (("pose_inertial", False), ("pose_inertial_joint", True)):
        if not rec.calls[key]:
            continue
        args, kw = rec.calls[key][0]
        fk = sin.optimize_pose_inertial_last_frame if joint else sin.optimize_pose_inertial
        fp = (sin.optimize_pose_inertial_last_frame_plain if joint
              else sin.optimize_pose_inertial_plain)
        rk, rp = fk(*args, **kw), fp(*args, **kw)
        fields = ("Rwb", "twb", "v", "bg", "ba")
        d = err([getattr(rk, f) for f in fields], [getattr(rp, f) for f in fields])
        hrel = float((rk.H - rp.H).abs().max() / rp.H.abs().max())
        if d > 1e-4 or not torch.equal(rk.inliers, rp.inliers) or \
                hrel > (1e-3 if joint else 1e-4) or not isinstance(args[13], KannalaBrandt8):
            raise AssertionError(f"{tag} {key}<KB8>: max deviation {d:.2e}, H {hrel:.2e}, "
                                 f"inliers equal {torch.equal(rk.inliers, rp.inliers)}")
        if f"{key}_kb8" not in stats:
            N, nv = args[7].shape[0], int(args[10].sum())
            n = 30 if joint else 15
            stats[f"{key}_kb8"] = record(
                max(d, hrel), cuda_ms(lambda: fk(*args, **kw), reps=10),
                cuda_ms(lambda: fp(*args, **kw), reps=1), 592 * 4 + N * 25 + 246 * 4 + N + 4 + 16,
                41 * (nv * (150 + 2 * 150) + (3 if joint else 1) * 16 * 2500 + n ** 3 // 3))
        out.append(f"{key}<KB8> N={args[7].shape[0]} within {d:.2e} (H {hrel:.2e})")
    print(f"{tag} at the first calls: " + "; ".join(out), flush=True)


def phase_stereo_kb8(left, right, poses, dev):
    """[stereo-kb8]: ``System.track_stereo`` on the fisheye rig at 512x512 /
    1500 features over [system]'s 30 frames, from a cold map (counts set to
    0 before it and read after): every frame after the stereo initialisation
    OK, camera-centre error < 0.08 m unaligned, path length within 5%, K26's
    two kernels once per frame (the tracker's count), every pose solve and
    BA through KB8, no K9, no two-view init, no fused frame."""
    host_ms, kf_frames, init = [], [], []

    def on_frame(k, st, dt, kf, s):
        host_ms.append(dt * 1e3)
        if kf:
            kf_frames.append(k)
        init.extend([_init_map(s)] if k == 0 else [])

    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    sys_, states = run_system(left, dev, on_frame, kb8_rig_config(), right)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr, n = sys_.tracker, len(left)
    first_ok = next((k for k, s in enumerate(states) if s == TrackState.OK), None)
    err, ratio = pf.metric_error(tr.trajectory, poses)
    bad = [k for k in range(first_ok or 0, n) if states[k] != TrackState.OK]
    if (first_ok is None or bad or sys_.n_keyframes() < 3 or not err < 0.08
            or abs(ratio - 1.0) >= 0.05):
        raise AssertionError(f"[stereo-kb8] states {[s.name for s in states]}, "
                             f"{sys_.n_keyframes()} keyframes, metric error {err:.4f} m, path "
                             f"ratio {ratio:.4f}")
    want = {"stereo_fisheye_match": tr.stats["stereo_match"],
            "fisheye_triangulate": tr.stats["stereo_match"], "ba_pcg": tr.stats["ba"],
            "ba_pcg_kb8": tr.stats["ba"], "pose_lm_kb8": launches.get("pose_lm", 0),
            "tri_search": tr.stats["tri_groups"], **{k: 2 * n for k in EXTRACT_KERNELS}}
    got = {k: (launches.get(k, 0), v) for k, v in want.items() if launches.get(k, 0) != v}
    stray = {k: launches[k] for k in ("stereo_match", "two_view", "undistort", "pose_lm_stereo")
             if launches.get(k, 0)}
    if got or stray or tr.stats["stereo_match"] != n or tr.n_fused_frames \
            or kernels.GRAPH_LAUNCHES["track_step"] or not launches.get("pose_lm"):
        raise AssertionError(f"[stereo-kb8] launches (got, want) {got}, stray {stray}, "
                             f"fused {tr.n_fused_frames}")
    for k, (st, ms) in enumerate(zip(states, host_ms)):
        print(f"[stereo-kb8] frame {k:2d}: {ms:8.2f} ms host clock  {st.name:4s}"
              f"{'  keyframe event' if k in kf_frames else ''}", flush=True)
    steady = [ms for k, ms in enumerate(host_ms) if k > first_ok + 1 and k not in kf_frames]
    print(f"[stereo-kb8] init at frame {first_ok}, {sys_.n_keyframes()} keyframes, "
          f"{sys_.n_map_points()} map points, metric error {err:.4f} m, path ratio "
          f"{ratio:.4f}; legacy-frame median {statistics.median(steady):.2f} ms host clock",
          flush=True)
    print(f"[stereo-kb8] launches {launches}", flush=True)
    return launches, sys_, states, init[0]


def _init_map(sys_):
    """The stereo initialisation's points by keypoint: (N,3) positions,
    NaN where keyframe 0's keypoint made no point."""
    mp = sys_.tracker.atlas.current
    kp = mp.keyframes[0].kp_mp
    return np.where((kp >= 0)[:, None], mp.mp_pos[np.maximum(kp, 0)], np.nan)


def phase_stereo_kb8_reference(left, right, card_sys, card_states, card_init):
    """[stereo-kb8-reference]: [stereo-kb8]'s first 5 frames on the CPU plain
    path: the same states and keyframes, the initial map's points within
    1e-4 relative where both made one (K26's float64 Jacobi against the
    float64 SVD: a point on a gate edge may be made by one only), poses
    within 1e-3."""
    n, init = 5, []
    cpu_sys, cpu_states = run_system(left[:n], torch.device("cpu"), cfg=kb8_rig_config(),
                                     second=right[:n], on_frame=lambda k, st, dt, kf, s:
                                     init.extend([_init_map(s)] if k == 0 else []))
    kf_ids = lambda s: sorted(kf.frame_id for kf in s.tracker.atlas.current.keyframes.values()
                              if kf.frame_id < n)
    made_c, made_g = ~np.isnan(init[0][:, 0]), ~np.isnan(card_init[:, 0])
    both = made_c & made_g
    pc, pg = init[0][both], card_init[both]
    rel = float((np.abs(pc - pg).max(1) / np.linalg.norm(pc, axis=1)).max())
    only = int((made_c != made_g).sum())
    dp = max(max(float(np.abs(Rg - Rc).max()), float(np.abs(tg - tc).max()))
             for (_, Rg, tg), (_, Rc, tc) in zip(card_sys.tracker.trajectory[:n],
                                                 cpu_sys.tracker.trajectory))
    if (list(cpu_states) != list(card_states[:n]) or kf_ids(cpu_sys) != kf_ids(card_sys)
            or not rel <= 1e-4 or only > 0.01 * int(both.sum()) or not dp <= 1e-3):
        raise AssertionError(f"[stereo-kb8-reference] states {cpu_states} / {card_states[:n]}, "
                             f"keyframes {kf_ids(cpu_sys)} / {kf_ids(card_sys)}, init points "
                             f"{rel:.2e} relative ({only} made by one side only), poses {dp:.2e}")
    print(f"[stereo-kb8-reference] frames 0-{n - 1}: the CPU plain path's states and keyframes; "
          f"{int(both.sum())} initial points within {rel:.2e} relative ({only} made by one side "
          f"only), poses within {dp:.2e}", flush=True)


def phase_vi_kb8(tag, left, right, dev, stats):
    """[vi-stereo-kb8] (``right`` given: ``track_stereo(l, r, ts, imu=...)``
    on the rig, sensor imu-stereo) and [vi-kb8] (``track_monocular(img, ts,
    imu=...)``, imu-monocular) over [vi]'s trajectory through TUM-VI's KB8
    camera at 512x512 / 1500 features: the IMU initialised, |s - 1| < 0.05
    (rig) or < 0.35 (mono), ATE < 0.25 m, every frame OK (rig) or the last
    4 (mono); every K20 and K22 launch through KB8 and equal to the
    tracker's counts, K26 once per rig frame, fused inertial frames (mono)
    or none (rig), every fused frame but its step key's first two a replay
    of the inertial step's graph (mono); on the rig K20<KB8> and K22<KB8>
    held to their plain versions at their first calls (the mono run's are
    held on [graph-vi]'s eager run)."""
    host_ms, inited = [], []
    cfg = kb8_rig_config("imu-stereo") if right is not None else vi_kb8_config()

    def on_frame(k, st, dt, sys_):
        host_ms.append(dt * 1e3)
        inited.append(sys_.tracker.atlas.current.imu_initialized)

    kernels.LAUNCHES.clear()
    kernels.GRAPH_LAUNCHES.clear()
    before = graph_counts(cached_graph(cfg, dev))
    with (_InertialRecorder() if right is not None else contextlib.nullcontext()) as rec:
        torch.cuda.synchronize()
        sys_, states = run_vi(left, dev, cfg=cfg, on_frame=on_frame, rights=right)
        sys_.flush()
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tr, st = sys_.tracker, sys_.tracker.stats
    ate, scale = pf.vi_ate_scale(tr.final_trajectory())
    init_at = inited.index(True) if any(inited) else None
    n_pi = st["pose_inertial"] + st["pose_inertial_joint"] + st["fused_inertial"]
    want = {"vi_ba": st["vi_ba"], "vi_ba_kb8": st["vi_ba"], "inertial_init": st["inertial_init"],
            "pose_inertial": n_pi, "pose_inertial_kb8": n_pi,
            "pose_inertial_joint_kb8": launches.get("pose_inertial_joint", 0),
            "stereo_fisheye_match": st["stereo_match"], "fisheye_triangulate": st["stereo_match"]}
    bad = {k: (launches.get(k, 0), v) for k, v in want.items() if launches.get(k, 0) != v}
    rig = right is not None
    ok_states = (all(s == TrackState.OK for s in states) if rig
                 else all(s == TrackState.OK for s in states[-4:]))
    fused_ok = tr.n_fused_frames == 0 if rig else tr.n_fused_frames >= 1
    bound = VI_STEREO_MAX_SCALE_ERR if rig else VI_MAX_SCALE_ERR
    if (init_at is None or not ok_states or bad or not fused_ok or not launches.get("vi_ba")
            or not launches.get("pose_inertial") or (rig and st["stereo_match"] != len(left))
            or not abs(scale - 1.0) < bound or not ate < VI_MAX_ATE):
        raise AssertionError(f"{tag} states {[s.name for s in states]}, IMU init at {init_at}, "
                             f"scale {scale:.4f}, ATE {ate:.4f} m, fused {tr.n_fused_frames}, "
                             f"launches (got, want) {bad}")
    for k, (s_, ms) in enumerate(zip(states, host_ms)):
        print(f"{tag} frame {k:2d}: {ms:8.2f} ms host clock  {s_.name:15s}"
              f"{'  IMU initialised' if k == init_at else ''}", flush=True)
    print(f"{tag} IMU initialised at frame {init_at}, {sys_.n_keyframes()} keyframes, "
          f"{tr.n_fused_frames} fused inertial frames, scale {scale:.4f} (|s - 1| < {bound}), "
          f"ATE {ate:.4f} m (< {VI_MAX_ATE})", flush=True)
    print(f"{tag} launches {launches}", flush=True)
    if rig:
        _parity_inertial_kb8(tag, rec, stats)
    else:
        graph = inertial_graph_counts(tag, sys_, before)
        print(f"{tag} inertial step graph: {graph['eager']} eager, {graph['captures']} "
              f"capture(s), {graph['replays']} replays for {graph['fused']} fused frames",
              flush=True)
    return launches


def main() -> int:
    t_start = time.perf_counter()
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
    phase_extract_launches(step.extractor, frames[0], dev)
    stats.update(phase_parity_stereo(sys_frames[0], sys_rights[0], sys_depths[0], dev))
    stats.update(phase_parity_k5_k8(sys_frames, sys_poses, dev))
    stats.update(phase_parity_pnp(dev))
    stats.update(phase_parity_loop(sys_frames, train_vocab(sys_frames, dev), dev))
    paths = {}
    results, paths["track"] = phase_main_path(step, frames, depths, poses, dev)
    phase_reference(step, results, frames, depths, poses)
    graph_visual = phase_graph_vs_eager(frames, depths, poses, dev)
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
    frames_vi, _ = vi_frames()
    paths["vi"], vi_states, vi_init, vi_kfs, vi_traj = phase_vi(frames_vi, dev)
    vi_rec, graph_vi = phase_graph_vi("[vi]", frames_vi, vi_config(), dev)
    stats.update(phase_parity_inertial(vi_rec, dev))
    phase_vi_reference(frames_vi, vi_states, vi_init, vi_kfs, vi_traj)
    vs_left, vs_right = vi_stereo_frames()
    paths["vi_stereo"], vs_rec, vs_states, vs_init, vs_kfs, vs_traj = phase_vi_stereo(
        vs_left, vs_right, dev)
    phase_vi_stereo_reference(vs_left, vs_right, vs_states, vs_init, vs_kfs, vs_traj)
    paths["vi_loop"], vi_graph, vi_gba, _ = phase_vi_loop(dev)
    stats.update(phase_parity_vi_loop(vi_graph, vs_rec, stats, dev))
    stats["vi_ba"].update(phase_parity_vi_gba(vi_gba))
    fr1, fr1_poses = fr1_frames()
    stats.update(phase_parity_undistort(fr1, dev))
    paths["pipelined"], _ = phase_pipelined(fr1, fr1_poses, dev)
    paths["pipelined_stereo"] = phase_pipelined_depth("stereo", sys_frames, sys_rights,
                                                      sys_poses, dev)
    paths["pipelined_rgbd"] = phase_pipelined_depth("rgbd", sys_frames, sys_depths, sys_poses,
                                                    dev)
    paths["pipelined_vi"] = phase_pipelined_vi(frames_vi, dev)
    stats.update(phase_parity_kb8(dev))
    kb8_seq, kb8_poses = kb8_frames()
    paths["kb8"], kb8_inits, kb8_sys, kb8_states = phase_kb8(kb8_seq, kb8_poses, dev)
    phase_kb8_reference(kb8_seq, kb8_inits, kb8_sys, kb8_states)
    paths["reloc_kb8"] = phase_reloc_kb8(kb8_seq, kb8_poses, dev)
    rig_l, rig_r, rig_poses = rig_frames()
    T_rot = np.eye(4)
    T_rot[:3, :3] = pf.so3_exp_np([0.0, np.deg2rad(0.8), 0.0]).T   # R_rl turned 0.8 deg about y
    T_rot[0, 3] = KB8_BASELINE
    right_rot = pf.render_kb8_stereo_sequence(pf.procedural_texture(), 1, SYS_SPEED, KB8_SIZE,
                                              KB8_SIZE, T_lr=T_rot)[1][0]
    stats.update(phase_parity_stereo_kb8(rig_l[0], rig_r[0], right_rot,
                                         pf.rig_extrinsics(T_rot), dev))
    paths["stereo_kb8"], rig_sys, rig_states, rig_init = phase_stereo_kb8(rig_l, rig_r,
                                                                          rig_poses, dev)
    phase_stereo_kb8_reference(rig_l, rig_r, rig_sys, rig_states, rig_init)
    vi_l, vi_r, _ = vi_rig_frames()
    paths["vi_stereo_kb8"] = phase_vi_kb8("[vi-stereo-kb8]", vi_l, vi_r, dev, stats)
    paths["vi_kb8"] = phase_vi_kb8("[vi-kb8]", vi_l, None, dev, stats)
    vi_kb8_rec, graph_vi_kb8 = phase_graph_vi("[vi-kb8]", vi_l, vi_kb8_config(), dev)
    _parity_inertial_kb8("[vi-kb8]", vi_kb8_rec, stats)
    loop_rec = _LoopRecorder()
    paths["loop_kb8"] = phase_loop(dev, kb8=True, rec=loop_rec)
    stats.update(phase_parity_loop_kb8(loop_rec, dev))
    paths["merge_kb8"] = phase_merge(dev, kb8=True)
    paths["vi_loop_kb8"], _, _, _ = phase_vi_loop(dev, kb8=True)
    stats.update(phase_parity_clahe(dev))
    stats.update(phase_parity_grid(dev))
    paths.update(phase_demos())
    t_mesh = time.perf_counter()
    paths["loop_mesh"], loop_graph = phase_loop_mesh(dev)
    stats.update(phase_parity_mesh(loop_graph, dev))
    paths["vi_loop_mesh"], vi_mesh_call = phase_vi_loop_mesh(dev)
    paths["mesh_api"] = phase_mesh_api(dev)
    stats.update(phase_parity_mesh_rest(vi_mesh_call, dev))
    t_last = time.perf_counter()
    paths["ba_stereo"], st = phase_ba_stereo(dev)
    stats.update(st)
    paths["marginal"], st = phase_parity_marginal(dev)
    stats.update(st)
    paths["search_api"] = phase_search_api(card_sys, dev)
    print(f"[search-api] [ba-stereo], [parity-marginal] and [search-api] in "
          f"{time.perf_counter() - t_last:.1f} s", flush=True)
    det = phase_det(dev, vi_mesh_call)
    print(f"[parity-mesh] the mesh phases and [det] in {time.perf_counter() - t_mesh:.1f} s",
          flush=True)
    run_traces()
    # K4 stages each problem in a CTA's shared memory up to its limit: the
    # largest N any path gave it, mono and with the stereo u, against what
    # fits; then its global route above the limit
    limits = {st: pose_opt.pose_lm_max_n(st, dev) for st in (False, True)}
    largest = dict(pose_opt.LARGEST_N)
    print(f"[parity] pose_lm: the largest N of the run {largest} (mono, stereo), the staging "
          f"limits {limits}", flush=True)
    if not all(0 < largest[st] for st in (False, True)):
        raise AssertionError(f"pose_lm: the largest N {largest}: a kind was never launched")
    k4_global = phase_pose_lm_global(dev)
    phase_graph_bounds(stats, {"[graph]": (graph_visual, False),
                               "[graph-vi] [vi]": (graph_vi, False),
                               "[graph-vi] [vi-kb8]": (graph_vi_kb8, True)})
    count = lambda n: {p: l.get(n, 0) for p, l in paths.items()}
    rows = []
    for n, (src, rep) in KERNELS.items():
        by_path = count(n)
        row = dict(name=n, route="cuda", source=src, replaces=rep,
                   launches=sum(by_path.values()), launches_by_path=by_path)
        row.update({k: v for k, v in stats[n].items() if k not in ("bytes", "ops")})
        if n == "ba_pcg":   # K6 <stereo> and <stereo, CamKB8> beside the mono rows
            for tag, key in (("stereo", "ba_pcg_stereo"), ("stereo_kb8", "ba_pcg_stereo_kb8")):
                st = stats[key]
                row.update({f"{tag}_launches": sum(count(key).values()), f"{tag}_ms": st["ms"],
                            f"{tag}_plain_ms": st["plain_ms"], f"{tag}_bound_ms": st["bound_ms"],
                            f"{tag}_bound_by": st["bound_by"],
                            f"{tag}_max_abs_err": st["max_abs_err"]})
        if n == "ba_schur_dense":   # schur_dense's largest window beside Kp 32
            st = stats["ba_schur_dense_kp64"]
            row.update({f"kp64_{k}": v for k, v in st.items() if k not in ("bytes", "ops")})
        if n == "pose_lm":
            st = stats["pose_lm_stereo"]
            row.update(stereo_launches=sum(count("pose_lm_stereo").values()),
                       stereo_ms=st["ms"], stereo_plain_ms=st["plain_ms"],
                       stereo_bound_ms=st["bound_ms"], stereo_max_abs_err=st["max_abs_err"])
        if n in ("pose_lm", "ba_pcg", "vi_ba", "pose_inertial", "sim3_ransac", "sim3_optimize",
                 "ba_schur"):   # KB8 beside the pinhole
            st = stats[f"{n}_kb8"]
            row.update(kb8_launches=sum(count(f"{n}_kb8").values()), kb8_ms=st["ms"],
                       kb8_plain_ms=st["plain_ms"], kb8_bound_ms=st["bound_ms"],
                       kb8_bound_by=st["bound_by"], kb8_max_abs_err=st["max_abs_err"])
        if n == "vi_ba":   # the cluster against the passes one by one, KB8 beside
            for pre, key in (("", "vi_ba"), ("kb8_", "vi_ba_kb8")):
                row.update({pre + k: stats[key][k] for k in (
                    "kernels_per_call", "parent_launches_per_call", "passes_kernels_per_call",
                    "passes_ms", "device_ms")})
        if n == "pose_lm":   # device ms from a profiler trace beside each wrapper ms
            row.update(stereo_device_ms=stats["pose_lm_stereo"]["device_ms"],
                       kb8_device_ms=stats["pose_lm_kb8"]["device_ms"],
                       largest_n=largest, staging_limit=limits, global_route=k4_global)
        if n in det:
            row.update(distinct_results=det[n], distinct_results_calls=DET_CALLS)
        if f"{n}_kb8" in det:
            row.update(kb8_distinct_results=det[f"{n}_kb8"])
        if n == "pose_inertial":   # the row is the legacy variant; the joint one beside it
            st = stats["pose_inertial_joint"]
            row.update(joint_launches=sum(count("pose_inertial_joint").values()),
                       joint_ms=st["ms"], joint_plain_ms=st["plain_ms"],
                       joint_bound_ms=st["bound_ms"], joint_max_abs_err=st["max_abs_err"],
                       joint_replaces="extractorb_tpu/solver/inertial.py:683 + "
                                      "extractorb_tpu/solver/marginal.py:23")
            st = stats["pose_inertial_joint_kb8"]
            row.update(joint_kb8_launches=sum(count("pose_inertial_joint_kb8").values()),
                       joint_kb8_ms=st["ms"], joint_kb8_plain_ms=st["plain_ms"],
                       joint_kb8_bound_ms=st["bound_ms"], joint_kb8_max_abs_err=st["max_abs_err"])
        rows.append(row)
    print(f"[done] every phase in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--trace":
        sys.exit(trace_main(sys.argv[2]))
    sys.exit(main())
