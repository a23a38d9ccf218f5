"""The port's ``System.track_rgbd`` (plain path, CPU) against the JAX
``System`` on one rendered RGB-D sequence, and the map conversions of a
JAX RGB-D map.

320x240, 1000 features, the renderer's metric depth, bf = 25 (f = 250,
the virtual 0.1 m baseline), ThDepth 40, ``TrackingConfig(max_frames=8)``,
15 frames of the two-plane scene at speed 0.04 from a cold map.  Both
must initialise on frame 0 with the same number of map points, keep every
frame OK and insert the same keyframes; the port's largest camera-centre
error (metric, no alignment) must stay within 1.05 x the JAX run's + 1 mm
(see test_torch_system_stereo.py on the window BA's free scale).

With frames 9-10 black both lose track on frame 9, relocalize on frame 11
against the same map (K3, K10 and K4 with the stereo rows) with the same
pose within 1e-3, and stay within the same error bound.
"""

import numpy as np
import pytest
import torch

import port_fixtures as pf
from depth_system import jax_and_port_runs
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

SENSOR = "rgbd"
BLACK = (9, 10)


@pytest.fixture(scope="module")
def runs():
    return jax_and_port_runs(SENSOR)


@pytest.fixture(scope="module")
def occluded():
    return jax_and_port_runs(SENSOR, black=BLACK)


def test_same_init_states_and_keyframes(runs):
    assert runs["jstates"][0].name == "OK" and runs["pstates"][0] == TrackState.OK
    assert runs["init_points"][0] == runs["init_points"][1] > 500
    assert all(s == TrackState.OK for s in runs["pstates"])
    assert all(s.name == "OK" for s in runs["jstates"])
    assert runs["psys"].n_keyframes() == runs["jsys"].n_keyframes() >= 2
    assert len(runs["psys"].tracker.trajectory) == len(runs["jsys"].tracker.trajectory)


def test_metric_error_within_jax_bound(runs):
    err_p, ratio_p = pf.metric_error(runs["psys"].tracker.trajectory, runs["poses"])
    err_j, _ = pf.metric_error(runs["jsys"].tracker.trajectory, runs["poses"])
    assert err_p <= 1.05 * err_j + 1e-3, (err_p, err_j)
    assert err_p < 0.08 and abs(ratio_p - 1.0) < 0.05
    assert runs["psys"].tracker.stats["stereo_match"] == 0


def test_keyframe_depths_match_jax(runs):
    """Every keyframe's depth and virtual right coordinate equal the JAX
    keyframe's: both sample the same depth map at the same keypoints."""
    jm, pm = runs["jsys"].tracker.atlas.current, runs["psys"].tracker.atlas.current
    assert sorted(jm.keyframes) == sorted(pm.keyframes)
    for k, kf in pm.keyframes.items():
        np.testing.assert_array_equal(kf.depth, np.asarray(jm.keyframes[k].depth))
        np.testing.assert_array_equal(kf.ur, np.asarray(jm.keyframes[k].ur))


def test_jax_rgbd_map_converts_both_ways(runs):
    """A JAX RGB-D map carries its keyframes' ur/depth into the port and
    back; a mono keyframe keeps None."""
    jmap = runs["jsys"].tracker.atlas.current
    state = interop.map_to_numpy(jmap)
    port = interop.map_from_numpy(state, torch.device("cpu"))
    back = interop.map_to_numpy(port)
    for k, kf in port.keyframes.items():
        np.testing.assert_array_equal(kf.ur, np.asarray(jmap.keyframes[k].ur))
        np.testing.assert_array_equal(kf.depth, np.asarray(jmap.keyframes[k].depth))
        np.testing.assert_array_equal(back["keyframes"][k]["depth"], kf.depth)
    kd = dict(state["keyframes"][0], ur=None, depth=None)
    kf = interop.keyframe_from_numpy(kd, torch.device("cpu"))
    assert kf.ur is None and kf.depth is None
    assert interop.keyframe_to_numpy(kf)["ur"] is None


def test_relocalizes_after_black_frames_like_jax(occluded):
    states = [s.name for s in occluded["pstates"]]
    assert states == [s.name for s in occluded["jstates"]]
    assert states[9:11] == ["LOST", "LOST"] and all(s == "OK" for s in states[11:])
    pose = lambda sys_: next((R, t) for ts, R, t in sys_.tracker.trajectory
                             if round(ts * 30) == 11)
    (Rp, tp), (Rj, tj) = pose(occluded["psys"]), pose(occluded["jsys"])
    np.testing.assert_allclose(Rp, np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tp, np.asarray(tj), atol=1e-3)
    assert occluded["psys"].tracker.stats["reloc_ok"] == 1
    assert occluded["psys"].n_keyframes() == occluded["jsys"].n_keyframes()
    err_p, _ = pf.metric_error(occluded["psys"].tracker.trajectory, occluded["poses"])
    err_j, _ = pf.metric_error(occluded["jsys"].tracker.trajectory, occluded["poses"])
    assert err_p <= 1.05 * err_j + 1e-3 and err_p < 0.08, (err_p, err_j)
