"""Pipelined stereo and RGB-D tracking (``tracking.pipeline_depth = 3``):
the port's ``System.track_stereo`` / ``track_rgbd`` against the JAX
``System`` at the same depth, on the CPU (the JAX package's
``tests/test_slam_stereo_rgbd.py:193-257`` on the procedural texture).

The scene, rig and configuration are ``tests/depth_system.py``'s (320x240,
1000 features, baseline 0.1 m, ThDepth 40, ``max_frames`` 8, 15 frames
from a cold map).  Both packages initialise on frame 0, keep every frame
OK, run the fused step from frame 1 on with the stereo residual, insert the
same keyframes, and the port's metric error stays within 1.05x the JAX
run's + 1 mm, under the JAX test's bounds (0.15 m stereo, 0.1 m RGB-D, the
path length within 7% / 6%).
"""

import numpy as np
import pytest

import port_fixtures as pf
from depth_system import N_FRAMES, jax_and_port_runs
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

DEPTH = 3
BOUNDS = {"stereo": (0.15, 0.07), "rgbd": (0.1, 0.06)}   # tests/test_slam_stereo_rgbd.py


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def runs(request):
    out = jax_and_port_runs(request.param, depth=DEPTH)
    out["sensor"] = request.param
    return out


def test_states_and_keyframes_equal_jax(runs):
    assert [s.name for s in runs["pstates"]] == [s.name for s in runs["jstates"]]
    assert all(s == TrackState.OK for s in runs["pstates"])
    assert runs["init_points"][0] == runs["init_points"][1] > 500
    kf = lambda s: sorted(k.frame_id for k in s.tracker.atlas.current.keyframes.values())
    assert kf(runs["psys"]) == kf(runs["jsys"]) and len(kf(runs["psys"])) >= 2
    assert len(runs["psys"].tracker.trajectory) == len(runs["jsys"].tracker.trajectory) == N_FRAMES
    assert runs["psys"].tracker.n_fused_frames >= N_FRAMES - 3


def test_metric_error_within_jax_bound(runs):
    err_p, ratio_p = pf.metric_error(runs["psys"].tracker.final_trajectory(), runs["poses"])
    err_j, _ = pf.metric_error(runs["jsys"].tracker.final_trajectory(), runs["poses"])
    max_err, max_ratio = BOUNDS[runs["sensor"]]
    assert err_p <= 1.05 * err_j + 1e-3, (err_p, err_j)
    assert err_p < max_err and abs(ratio_p - 1.0) < max_ratio, (err_p, ratio_p)


def test_poses_within_1e3_of_jax(runs):
    for (ts, Rp, tp), (tj, Rj, tjj) in zip(runs["psys"].tracker.trajectory,
                                           runs["jsys"].tracker.trajectory):
        assert ts == tj
        d = max(float(np.abs(Rp - np.asarray(Rj)).max()), float(np.abs(tp - np.asarray(tjj)).max()))
        assert d < 1e-3, (ts, d)
