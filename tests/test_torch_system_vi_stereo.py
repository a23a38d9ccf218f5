"""The port's stereo-inertial ``System.track_stereo(left, right, ts,
imu=...)`` (plain path, CPU) against the JAX ``System`` on one rendered
sequence.

The visual-inertial scene of ``port_fixtures`` (tests/test_vi_e2e.py's
analytic trajectory, 100 Hz IMU, 10 fps) seen by a rectified rig with the
right camera 0.1 m along x (``render_vi_stereo_sequence``), 31 frames at
320x240 with 500 features, ``chip_smoke.vi_stereo_config`` (the [vi] IMU,
bf = fx x 0.1, ThDepth 40), from a cold map: stereo initialisation on
frame 0, pre-init keyframes at >= 4 Hz, the first InitializeIMU stage after
1 s with the scale fixed (K21's fix_scale branch, then the full VI BA), and
every frame after it through the legacy inertial solve (the JAX module's
fused inertial step is monocular only).  The IMU initialises on frame 27;
the frames after it include a keyframe event (frame 30) with its local
inertial BA.

Both must initialise on the same frame and the IMU on the same frame, agree
on every state and keyframe count, run no fused frame, and reach an ATE
within 1.05 x JAX's + 1 mm.  Both loop closers keep ``fix_scale`` False for
imu-stereo (the JAX tracker's rule; ORB-SLAM3 fixes the scale there: ROADMAP
C, a matched reference fault).  The port's session loads in JAX with the
same IMU state.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import IMUConfig as JIMUConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch.slam.system import System
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

W, H, NF, N_FRAMES = 320, 240, 500, 31


def jax_config(cfg) -> JSLAMConfig:
    c, i = cfg.camera, cfg.imu
    return JSLAMConfig(
        orb=JORBConfig(n_features=cfg.orb.n_features),
        camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
                             fps=c.fps, bf=c.bf, th_depth=c.th_depth),
        imu=JIMUConfig(noise_gyro=i.noise_gyro, noise_acc=i.noise_acc, gyro_walk=i.gyro_walk,
                       acc_walk=i.acc_walk, frequency=i.frequency),
        tracking=JTrackingConfig(max_frames=cfg.tracking.max_frames), sensor=cfg.sensor)


def run(sys_, left, right):
    states, inited = [], []
    for k, (a, b) in enumerate(zip(left, right)):
        ts = k / pf.VI_FPS
        imu = pf.imu_window((k - 1) / pf.VI_FPS, ts) if k else None
        states.append(sys_.track_stereo(a, b, ts, imu=imu).name)
        inited.append(bool(sys_.tracker.atlas.current.imu_initialized))
    sys_.flush()
    return dict(sys=sys_, states=states, inited=inited)


@pytest.fixture(scope="module")
def runs():
    left, right, _ = pf.render_vi_stereo_sequence(pf.procedural_texture(), N_FRAMES, W, H)
    cfg = chip_smoke.vi_stereo_config(W, H, NF)
    return run(JSystem(jax_config(cfg)), left, right), run(System(cfg, device="cpu"), left, right)


def first(flags):
    return next(k for k, f in enumerate(flags) if f)


def test_same_init_states_keyframes_and_no_fused_frame(runs):
    j, p = runs
    assert p["states"] == j["states"] and all(s == "OK" for s in p["states"])
    assert first(p["inited"]) == first(j["inited"]) <= N_FRAMES - 4
    jt, pt = j["sys"].tracker, p["sys"].tracker
    assert [ts for ts, _, _ in pt.trajectory] == [ts for ts, _, _ in jt.trajectory]
    assert p["sys"].n_keyframes() == j["sys"].n_keyframes() >= 10
    assert pt.n_fused_frames == jt.n_fused_frames == 0
    # every frame after the init takes the legacy inertial solve
    assert pt.stats["pose_inertial"] + pt.stats["pose_inertial_joint"] >= \
        N_FRAMES - 2 - first(p["inited"])
    assert pt.stats["inertial_init"] == 1 and pt.stats["stereo_match"] == N_FRAMES
    # the init's full VI BA and at least one local inertial BA after it
    assert pt.stats["vi_ba"] >= 2, pt.stats


def test_ate_and_metric_scale(runs):
    j, p = runs
    ate_p, s_p = pf.vi_ate_scale(p["sys"].tracker.final_trajectory())
    ate_j, s_j = pf.vi_ate_scale(j["sys"].tracker.final_trajectory())
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    assert abs(s_p - 1.0) < 0.05 and ate_p < 0.25, (s_p, ate_p)


def test_loop_closer_fix_scale_is_false_as_in_jax(runs):
    """The matched reference fault: the JAX tracker fixes the loop closer's
    scale only for 'stereo' and 'rgbd', so an imu-stereo map's Sim3 loop
    verification estimates a scale."""
    j, p = runs
    assert j["sys"].tracker.loop_closer.fix_scale is False
    assert p["sys"].tracker.loop_closer.fix_scale is False
    assert p["sys"].tracker.loop_closer.imu_calib is p["sys"].tracker.imu_calib


def test_session_round_trip_into_jax(runs, tmp_path):
    """The port's stereo-inertial session loads in JAX with the same IMU
    state and stereo channels, and JAX's loads back in the port."""
    from extractorb_tpu.slam import checkpoint as jckpt
    from extractorb_tpu_torch.slam import checkpoint as ckpt

    tr = runs[1]["sys"].tracker
    cfg = chip_smoke.vi_stereo_config(W, H, NF)
    path = str(tmp_path / "vi_stereo_session.npz")
    ckpt.save_session(tr, path)
    back = jckpt.load_session(path, jax_config(cfg))
    assert back.atlas.current.imu_initialized and back.imu_queue.t == tr.imu_queue.t
    np.testing.assert_array_equal(back.cur_bias, tr.cur_bias)
    for k, kf in tr.atlas.current.keyframes.items():
        jk = back.atlas.current.keyframes[k]
        assert jk.prev_kf == kf.prev_kf
        np.testing.assert_array_equal(np.asarray(jk.depth), kf.depth)
        np.testing.assert_array_equal(np.asarray(jk.v), kf.v)
        if kf.preint is not None:
            np.testing.assert_array_equal(np.asarray(jk.preint.C), np.asarray(kf.preint.C))
    np.testing.assert_array_equal(np.asarray(back.last_frame.ur), tr.last_frame.ur)
    again = str(tmp_path / "vi_stereo_jax.npz")
    jckpt.save_session(back, again)
    tr2 = ckpt.load_session(again, cfg, device="cpu")
    assert tr2.inertial and tr2.atlas.current.imu_initialized
    assert tr2.imu_queue.t == tr.imu_queue.t and tr2._prev_kf_id == tr._prev_kf_id


def test_tracker_tensors_keep_0_dim_fields():
    """The legacy inertial solve hands K22 the frame's preintegration through
    ``Tracker._t``; its 0-dim dT must stay 0-dim (K22's packing refuses a
    (1,) dT, which np.ascontiguousarray would make)."""
    tr = System(chip_smoke.vi_stereo_config(W, H, NF), device="cpu").tracker
    assert tr._t(np.float32(0.1)).shape == ()
    assert tr._t(np.zeros((2, 3), np.float32)).shape == (2, 3)


@pytest.mark.gpu
def test_card_path_runs_no_plain_counterpart(cuda_device, monkeypatch):
    """On a card the stereo-inertial path runs K9 and K19-K22 and never
    their plain versions: the scene at full width through the IMU
    initialisation with those made to raise."""
    from extractorb_tpu_torch import kernels
    from extractorb_tpu_torch.frontend import stereo
    from extractorb_tpu_torch.imu import preintegration as pre
    from extractorb_tpu_torch.solver import inertial as sin
    from extractorb_tpu_torch.solver import marginal

    def boom(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((stereo, "compute_stereo_matches_plain"),
                      (pre, "integrate_batch_plain"), (sin, "optimize_vi_ba_plain"),
                      (sin, "inertial_only_plain"), (sin, "optimize_pose_inertial_plain"),
                      (sin, "optimize_pose_inertial_last_frame_plain"),
                      (marginal, "marginalize")):
        monkeypatch.setattr(mod, name, boom)
    left, right, _ = pf.render_vi_stereo_sequence(pf.procedural_texture(), 32)
    kernels.LAUNCHES.clear()
    sys_, states = chip_smoke.run_vi(left, cuda_device, rights=right)
    torch.cuda.synchronize()
    tr = sys_.tracker
    assert tr.atlas.current.imu_initialized and states[-1] == TrackState.OK
    assert tr.n_fused_frames == 0
    for name in ("stereo_match", "preint", "vi_ba", "inertial_init", "pose_inertial"):
        assert kernels.LAUNCHES[name] > 0, name
