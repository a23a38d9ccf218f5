"""The port's monocular-inertial ``System.track_monocular(img, ts, imu=...)``
(plain path, CPU) against the JAX ``System`` on one rendered sequence.

tests/test_vi_e2e.py's analytic trajectory and 100 Hz IMU (the numpy
renderer of ``port_fixtures`` on the procedural texture), 320x240, 500
features, ``IMUConfig`` as ``test_vi_e2e._vi_cfg`` (max_frames 3), 34 frames
at 10 fps from a cold map: the pre-init keyframes at >= 4 Hz, the first
InitializeIMU stage with its full VI BA (K21, K20's plain versions), then
IMU-predicted frames on the fused inertial step (K22 joint), local inertial
BAs at keyframe events.  Frames 27 and 29-31 are forced through the legacy
path in both packages (``_fused_applicable`` patched), so the legacy
inertial solve runs in both variants and a keyframe frame's prior meets
the next fused frame.  The port's two-view sets are JAX's
(``two_view.sample_sets`` patched).

Both must initialise on the same frame pair and the IMU on the same frame,
agree on every state, keyframe count and fused inertial frame, and on
which fused frames reuse the last legacy solve's marginalisation prior:
the JAX step checks only the frame id, not the map version, so a prior
taken before a keyframe insertion is reused after it (ROADMAP C, a matched
reference fault).  Metric scale within 1e-3 of JAX's; ATE within 1.05 x
JAX's + 1 mm and inside test_vi_e2e's bounds (|s - 1| < 0.35, 0.25 m).
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
from extractorb_tpu.slam.tracking import Tracker as JTracker
from extractorb_tpu_torch.geometry import two_view
from extractorb_tpu_torch.slam.tracking import Tracker, TrackState
from test_torch_two_view import jax_sets
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

W, H, NF, N_FRAMES = 320, 240, 500, 34
LEGACY = (27, 29, 30, 31)   # frames forced through the legacy path in both packages


def jax_config(cfg) -> JSLAMConfig:
    c, i = cfg.camera, cfg.imu
    return JSLAMConfig(
        orb=JORBConfig(n_features=cfg.orb.n_features),
        camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
                             fps=c.fps),
        imu=JIMUConfig(noise_gyro=i.noise_gyro, noise_acc=i.noise_acc, gyro_walk=i.gyro_walk,
                       acc_walk=i.acc_walk, frequency=i.frequency),
        tracking=JTrackingConfig(max_frames=cfg.tracking.max_frames), sensor=cfg.sensor)


def instrument(m, cls, log):
    """Record, per fused frame, whether the step takes the last legacy
    solve's prior (the JAX rule: its frame id is the previous frame's) and
    whether that prior predates the current map version; force LEGACY frames
    through the legacy path."""
    fused, applicable = cls._track_fused, cls._fused_applicable

    def track_fused(self, img, ts, *a, **kw):
        mh, last, mp = self._marg_prior, self.last_frame, self.atlas.current
        used = mh is not None and mh[0] == last.frame_id
        log.append((self._next_frame_id, used, used and mh[1] != (mp.mid, mp.version)))
        return fused(self, img, ts, *a, **kw)

    m.setattr(cls, "_track_fused", track_fused)
    m.setattr(cls, "_fused_applicable",
              lambda self: self._next_frame_id not in LEGACY and applicable(self))


def run(System, cfg, frames, log, **kw):
    sys_ = System(cfg, **kw)
    states, inited = [], []
    for k, img in enumerate(frames):
        ts = k / pf.VI_FPS
        imu = pf.imu_window((k - 1) / pf.VI_FPS, ts) if k else None
        states.append(sys_.track_monocular(img, ts, imu=imu).name)
        inited.append(bool(sys_.tracker.atlas.current.imu_initialized))
    sys_.flush()
    return dict(sys=sys_, states=states, inited=inited, fused=log)


@pytest.fixture(scope="module")
def runs():
    frames, _ = pf.render_vi_sequence(pf.procedural_texture(), N_FRAMES, W, H)
    cfg = chip_smoke.vi_config(W, H, NF)
    with pytest.MonkeyPatch.context() as m:
        jlog, plog = [], []
        instrument(m, JTracker, jlog)
        jrun = run(JSystem, jax_config(cfg), frames, jlog)
        instrument(m, Tracker, plog)
        m.setattr(two_view, "sample_sets",
                  lambda seed, valid, n_sets=200: torch.from_numpy(jax_sets(seed, valid, n_sets)
                                                                   .copy()))
        from extractorb_tpu_torch.slam.system import System
        prun = run(System, cfg, frames, plog, device="cpu")
    return jrun, prun


def first(flags):
    return next(k for k, f in enumerate(flags) if f)


def test_same_init_states_keyframes_and_fused_frames(runs):
    j, p = runs
    assert p["states"] == j["states"]
    k0 = first([s == "OK" for s in j["states"]])
    assert k0 <= 2 and all(s == "OK" for s in p["states"][k0:])
    assert first(p["inited"]) == first(j["inited"]) <= N_FRAMES - 5
    jt, pt = j["sys"].tracker, p["sys"].tracker
    assert [ts for ts, _, _ in pt.trajectory] == [ts for ts, _, _ in jt.trajectory]
    assert p["sys"].n_keyframes() == j["sys"].n_keyframes() >= 10
    assert pt.n_fused_frames == jt.n_fused_frames >= 1
    assert [f for f, _, _ in p["fused"]] == [f for f, _, _ in j["fused"]]
    assert pt.stats["fused_inertial"] == pt.n_fused_frames
    # both legacy inertial variants ran
    assert pt.stats["pose_inertial"] >= 1 and pt.stats["pose_inertial_joint"] >= 1


def test_prior_reuse_matches_jax(runs):
    """The reference fault of the fused inertial step: the prior is reused
    when its frame id matches, even after a keyframe changed the map."""
    j, p = runs
    assert p["fused"] == j["fused"]
    assert any(stale for _, _, stale in p["fused"])
    assert p["sys"].tracker.stats["fused_prior"] == sum(u for _, u, _ in p["fused"])


def test_metric_scale_and_ate(runs):
    j, p = runs
    ate_p, s_p = pf.vi_ate_scale(p["sys"].tracker.final_trajectory())
    ate_j, s_j = pf.vi_ate_scale(j["sys"].tracker.final_trajectory())
    assert abs(s_p - s_j) < 1e-3, (s_p, s_j)
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    assert abs(s_p - 1.0) < 0.35 and ate_p < 0.25, (s_p, ate_p)


def test_session_round_trip_into_jax(runs, tmp_path):
    """The port's inertial session loads in JAX with the same IMU state."""
    from extractorb_tpu.slam import checkpoint as jckpt
    from extractorb_tpu_torch.slam import checkpoint as ckpt

    tr = runs[1]["sys"].tracker
    path = str(tmp_path / "vi_session.npz")
    ckpt.save_session(tr, path)
    back = jckpt.load_session(path, jax_config(chip_smoke.vi_config(W, H, NF)))
    assert back.atlas.current.imu_initialized and back.imu_queue.t == tr.imu_queue.t
    np.testing.assert_array_equal(back.cur_bias, tr.cur_bias)
    for k, kf in tr.atlas.current.keyframes.items():
        jk = back.atlas.current.keyframes[k]
        assert jk.prev_kf == kf.prev_kf
        if kf.preint is not None:
            np.testing.assert_array_equal(np.asarray(jk.preint.C), np.asarray(kf.preint.C))


@pytest.mark.gpu
def test_card_path_runs_no_plain_inertial_version(cuda_device, monkeypatch):
    """On a card the inertial path runs K19-K22 and never their plain
    versions: [vi]'s scene at full width through the first IMU
    initialisation and a few fused inertial frames with those made to raise."""
    from extractorb_tpu_torch import kernels
    from extractorb_tpu_torch.imu import preintegration as pre
    from extractorb_tpu_torch.solver import inertial as sin
    from extractorb_tpu_torch.solver import marginal

    def boom(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((pre, "integrate_batch_plain"), (sin, "optimize_vi_ba_plain"),
                      (sin, "inertial_only_plain"), (sin, "optimize_pose_inertial_plain"),
                      (sin, "optimize_pose_inertial_last_frame_plain"),
                      (marginal, "marginalize")):
        monkeypatch.setattr(mod, name, boom)
    frames, _ = chip_smoke.vi_frames(n=32)
    kernels.LAUNCHES.clear()
    sys_, states = chip_smoke.run_vi(frames, cuda_device)
    torch.cuda.synchronize()
    tr = sys_.tracker
    assert tr.atlas.current.imu_initialized and states[-1] == TrackState.OK
    assert tr.n_fused_frames >= 1
    for name in ("preint", "vi_ba", "inertial_init", "pose_inertial"):
        assert kernels.LAUNCHES[name] > 0, name
