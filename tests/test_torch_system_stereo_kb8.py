"""The fisheye stereo rig: the port's ``System.track_stereo(left, right,
ts)`` with a KB8 ``camera2`` (plain path, CPU) against the JAX ``System``.

The scene is [system]'s two-plane motion (speed 0.04, ts = k / 30) at 0.3 of
its depth (``pf.render_kb8_stereo_sequence``: wall 1.5 m, poster 0.9 m, the
wall's texture wrapped so it fills the field of view) seen by TUM-VI's rig
(``chip_smoke.kb8_rig_config``: KB8 on both sides, 0.101 m along x, bf =
190.97 x 0.101, ThDepth 35, the lapping band the whole width), cut to a
256x256 image with the calibration halved, 500 features and 12 frames from
a cold map.  Both initialise on frame 0 from the triangulated points
(``Frame.p3d_stereo``) and take every later frame through the legacy path
(the JAX tracker never fuses a rig frame).

Held: the same states, init frame, initial map points (their count, and
their positions within 1e-4 relative: the plain float64 SVD against JAX's
float32 one) and
keyframe ids; poses within 1e-3 through the first keyframe event that runs the triangulation program
(frame 3); the metric error (largest camera-centre error, unaligned) within
1.05x JAX's + 1 mm.  Past that event the poses part: the program
triangulates raw fisheye pixels through the pinhole K in both packages (a
matched reference fault, ROADMAP C.2), where the rays meet badly and the
two packages' rounding moves its points; the window BAs carry that into the
poses (within 1.5e-6 through frame 5, 7.5 mm apart at frame 11, both 0.048 m
from the truth).  And the refusal that remains, ``camera2`` beside a
pinhole camera (ROADMAP A.12.5), beside the KB8 camera with a vocabulary,
refused until loop closing ran through KB8 (A.12.3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu import config as jc
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch.config import CameraConfig
from extractorb_tpu_torch.slam.system import System
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, NF, N_FRAMES, SPEED = 256, 500, 12, 0.04


def jax_config(cfg) -> jc.SLAMConfig:
    """The JAX package's configuration of a port one (cameras, ORB,
    tracking, IMU and the rig)."""
    cam = lambda c: None if c is None else jc.CameraConfig(**dataclasses.asdict(c))
    imu = None if cfg.imu is None else jc.IMUConfig(**dataclasses.asdict(cfg.imu))
    return jc.SLAMConfig(orb=jc.ORBConfig(n_features=cfg.orb.n_features),
                         camera=cam(cfg.camera), camera2=cam(cfg.camera2), T_lr=cfg.T_lr,
                         imu=imu, tracking=jc.TrackingConfig(max_frames=cfg.tracking.max_frames),
                         sensor=cfg.sensor)


def init_points(sys_):
    mp = sys_.tracker.atlas.current
    return np.asarray(mp.mp_pos)[np.flatnonzero(np.asarray(mp.mp_valid))]


@pytest.fixture(scope="module")
def runs():
    left, right, poses = pf.render_kb8_stereo_sequence(pf.procedural_texture(), N_FRAMES, SPEED,
                                                       W, W)
    cfg = chip_smoke.kb8_rig_config("stereo", W, W, NF)
    jsys, jstates = JSystem(jax_config(cfg)), []
    for k in range(N_FRAMES):
        jstates.append(jsys.track_stereo(left[k], right[k], k / 30.0).name)
        if k == 0:
            jinit = init_points(jsys)
    jsys.flush()
    pinit, tri = [], []

    def on_frame(k, st, dt, kf, s):
        pinit.extend([init_points(s)] if k == 0 else [])
        tri.append(s.tracker.stats["tri_groups"])

    psys, pstates = chip_smoke.run_system(left, torch.device("cpu"), cfg=cfg, second=right,
                                          on_frame=on_frame)
    return dict(poses=poses, jsys=jsys, jstates=jstates, psys=psys,
                pstates=[s.name for s in pstates], jinit=jinit, pinit=pinit[0],
                first_tri=tri.index(1))


def test_rig_states_init_and_keyframes_match_jax(runs):
    tr = runs["psys"].tracker
    assert tr.cam_r is not None and tr.is_fisheye
    np.testing.assert_allclose(tr.t_rl, runs["jsys"].tracker.t_rl)
    assert runs["pstates"] == runs["jstates"] and all(s == "OK" for s in runs["pstates"])
    assert tr.stats["stereo_match"] == N_FRAMES and tr.n_fused_frames == 0
    kf_ids = lambda s: sorted(kf.frame_id for kf in s.tracker.atlas.current.keyframes.values())
    assert kf_ids(runs["psys"]) == kf_ids(runs["jsys"]) and len(kf_ids(runs["psys"])) >= 3


def test_initial_map_points_match_jax(runs):
    """Stereo initialisation makes a map point of each keypoint with a
    triangulated depth, at its ``p3d_stereo``."""
    p, j = runs["pinit"], runs["jinit"]
    assert len(p) == len(j) > 100
    np.testing.assert_array_less(np.abs(p - j).max(1),
                                 1e-4 * np.linalg.norm(j, axis=1) + 1e-30)


def test_poses_and_metric_error_match_jax(runs):
    jt, pt = runs["jsys"].tracker.trajectory, runs["psys"].tracker.trajectory
    assert [ts for ts, _, _ in pt] == [ts for ts, _, _ in jt]
    n = runs["first_tri"] + 1
    assert 0 < n < N_FRAMES
    dp = max(max(float(np.abs(Rp - Rj).max()), float(np.abs(tp - tj).max()))
             for (_, Rp, tp), (_, Rj, tj) in zip(pt[:n], jt[:n]))
    assert dp < 1e-3, dp
    err_p, path_p = pf.metric_error(pt, runs["poses"])
    err_j, _ = pf.metric_error(jt, runs["poses"])
    assert err_p <= 1.05 * err_j + 1e-3, (err_p, err_j)


def refused(case):
    """The rig's configuration made into one the port refused: the KB8
    camera with a vocabulary (refused until loop closing ran through KB8),
    or ``camera2`` beside a pinhole camera (still refused)."""
    from extractorb_tpu_torch.place.vocab import Vocabulary

    cfg = chip_smoke.kb8_rig_config("stereo", W, W, NF)
    if case == "kb8-vocab":
        return dataclasses.replace(cfg, sensor="monocular"), Vocabulary.train(
            np.random.default_rng(0).integers(0, 256, (300, 32), dtype=np.uint8), k=4, L=2)
    pinhole = dataclasses.replace(chip_smoke.camera_config(W, W), bf=cfg.camera.bf)
    return dataclasses.replace(cfg, camera=pinhole), None


@pytest.mark.parametrize("case,item", [("kb8-vocab", "A.12.3"), ("camera2-pinhole", "A.12.4")])
def test_remaining_refusals(case, item):
    """``camera2`` beside a pinhole camera still raises (ROADMAP A.12.5: the
    rig of A.12.4 is KB8 only); the KB8 camera with a vocabulary, the last
    refusal of A.12.3, now constructs, its loop closer on the KB8 camera
    (tests/test_torch_system_loop_kb8.py runs it)."""
    cfg, voc = refused(case)
    assert isinstance(cfg.camera2, CameraConfig)
    if case == "kb8-vocab":
        tr = System(cfg, vocab=voc, device="cpu").tracker
        assert tr.is_fisheye and tr.loop_closer.db is not None and tr.loop_closer.cam is tr.cam
        return
    with pytest.raises(NotImplementedError, match=item):
        System(cfg, vocab=voc, device="cpu")
