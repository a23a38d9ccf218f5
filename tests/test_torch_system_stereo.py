"""The port's ``System.track_stereo`` (plain path, CPU) against the JAX
``System`` on one rendered stereo sequence.

320x240, 1000 features (StereoInitialization needs more than 500
keypoints), a rectified rig with a 0.1 m baseline (bf = 25 at f = 250),
ThDepth 40 (thDepth 4 m: the 3 m poster is close, the 5 m wall far),
``TrackingConfig(max_frames=8)``, 15 frames of the two-plane scene at
speed 0.04 from a cold map.  Both must initialise on frame 0 with the
same number of map points, keep every frame OK and insert the same
keyframes; the port's largest camera-centre error (metric, no alignment)
must stay within 1.05 x the JAX run's + 1 mm.

The window BA of both packages builds mono problems for every sensor,
with one fixed keyframe, so its scale is free: later keyframes let the
two runs drift apart along it by float noise (PERF.md).  Eight frames
between keyframes keep that to one window BA here.
"""

import numpy as np
import pytest
import torch

import port_fixtures as pf
from depth_system import jax_and_port_runs
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

SENSOR = "stereo"


@pytest.fixture(scope="module")
def runs():
    return jax_and_port_runs(SENSOR)


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
    # one stereo match per frame, on the host path (frames 0-1) and in the fused step
    assert runs["psys"].tracker.stats["stereo_match"] == len(runs["poses"])


def test_keyframes_carry_the_stereo_channels(runs):
    """Every keyframe has ur/depth, equal to JAX's on the init keyframe."""
    jm, pm = runs["jsys"].tracker.atlas.current, runs["psys"].tracker.atlas.current
    for kf in pm.keyframes.values():
        assert kf.ur is not None and (kf.depth > 0).sum() > 100
    j0, p0 = jm.keyframes[0], pm.keyframes[0]
    np.testing.assert_array_equal(p0.depth, np.asarray(j0.depth))
    np.testing.assert_array_equal(p0.ur, np.asarray(j0.ur))
