"""Checkpoints between the JAX package and the port
(``extractorb_tpu_torch/slam/checkpoint.py``, the same npz format).

A JAX ``System`` tracks the 320x240 / 500-feature two-plane sequence of
``test_torch_system.py`` (max_frames 6) from a cold map.  Its map loads in
the port with every array equal and the port's file loads back in JAX; its
session taken mid-sequence, or while LOST, loads in both packages, which
then track the rest of the frames the same way (states, trajectory, ATE
within 1.05 x the JAX continuation's + 1 mm, the relocalization frame).
Files with IMU state or keyframe-database entries raise
``NotImplementedError`` with their ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.slam import checkpoint as jckpt
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch.config import TrackingConfig
from extractorb_tpu_torch.slam import checkpoint as ckpt
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES, SPEED, MAX_FRAMES = 320, 240, 500, 20, 0.04, 6
CUT = 10          # the mid-sequence session is saved after frames 0..CUT-1
LOST_AT = 14      # the LOST session: frame 14 black, saved after it
CPU = torch.device("cpu")


def configs():
    cfg = dataclasses.replace(chip_smoke.system_config(W, H, NF),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES))
    c = cfg.camera
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                       camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=W, height=H),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES))
    return cfg, jcfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JAX runs and the files they saved: a session after frame CUT-1, a map
    after frame 13, and a session saved while LOST (frame 14 black)."""
    d = tmp_path_factory.mktemp("ckpt")
    images, _, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H)
    _, jcfg = configs()
    out = dict(images=images, poses=poses, session=str(d / "session.npz"),
               map=str(d / "map.npz"), lost=str(d / "lost.npz"), dir=d)
    jsys = JSystem(jcfg)
    for k in range(LOST_AT):
        jsys.track_monocular(images[k], k / 30.0)
        if k == CUT - 1:
            jckpt.save_session(jsys.tracker, out["session"])
    jsys.flush()
    out["jmap"] = jsys.tracker.atlas.current
    jckpt.save_map(out["jmap"], out["map"])
    jsys.track_monocular(np.zeros_like(images[LOST_AT]), LOST_AT / 30.0)
    assert jsys.state.name == "LOST"
    jckpt.save_session(jsys.tracker, out["lost"])
    return out


def assert_maps_equal(a, b):
    """Every array and scalar of two maps (either package's) equal."""
    n = a._next_mp
    assert n == b._next_mp and a._next_kf == b._next_kf and a.mid == b.mid
    assert a.version == b.version and a.scale_factor == b.scale_factor
    for name in ("mp_pos", "mp_desc", "mp_normal", "mp_max_dist", "mp_valid", "mp_first_kf",
                 "mp_visible", "mp_found"):
        np.testing.assert_array_equal(getattr(a, name)[:n], getattr(b, name)[:n], err_msg=name)
    assert a.obs == b.obs and sorted(a.dead_kfs) == sorted(b.dead_kfs)
    assert sorted(a.keyframes) == sorted(b.keyframes)
    for k, ka in a.keyframes.items():
        kb = b.keyframes[k]
        for name in ("R", "t", "xy_un", "octave", "angle", "desc", "valid", "kp_mp"):
            np.testing.assert_array_equal(np.asarray(getattr(ka, name)),
                                          np.asarray(getattr(kb, name)), err_msg=name)
        for name in ("xy", "response", "angle", "octave", "size", "desc", "valid"):
            np.testing.assert_array_equal(np.array(getattr(ka.feats, name)),
                                          np.array(getattr(kb.feats, name)), err_msg=name)
        assert (ka.frame_id, ka.timestamp, ka.parent, ka.prev_kf) == \
            (kb.frame_id, kb.timestamp, kb.parent, kb.prev_kf)


def test_map_files_cross_both_ways(files):
    jmap = files["jmap"]
    port = ckpt.load_map(files["map"], device="cpu")
    assert_maps_equal(jmap, port)
    assert port.keyframes[0].feats.desc.device == CPU
    back = str(files["dir"] / "port_map.npz")
    ckpt.save_map(port, back)
    assert_maps_equal(jckpt.load_map(back), jmap)
    za, zb = np.load(files["map"]), np.load(back)
    assert sorted(za.keys()) == sorted(zb.keys())
    for k in za.keys():
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def continue_both(files, path, first: int, last: int = N_FRAMES):
    """Load ``path`` in both packages and track frames first..last-1."""
    cfg, jcfg = configs()
    jtr = jckpt.load_session(path, jcfg)
    ptr = ckpt.load_session(path, cfg, device="cpu")
    images = files["images"]
    jstates = [jtr.track(images[k], k / 30.0).name for k in range(first, last)]
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        pstates = [ptr.track(images[k], k / 30.0).name for k in range(first, last)]
    jtr.flush()
    ptr.flush()
    return jtr, ptr, jstates, pstates


def test_jax_session_resumes_in_port(files):
    jtr, ptr, jstates, pstates = continue_both(files, files["session"], CUT)
    assert pstates == jstates and all(s == "OK" for s in pstates)
    assert len(ptr.trajectory) == len(jtr.trajectory) == N_FRAMES
    assert len(ptr.atlas.current.keyframes) == len(jtr.atlas.current.keyframes)
    ate_p, scale = pf.trajectory_ate(ptr.trajectory, files["poses"])
    ate_j, _ = pf.trajectory_ate(jtr.trajectory, files["poses"])
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    assert ate_p <= 0.05 * max(scale, 1.0)
    # and the port's own session of the end state loads in JAX
    path = str(files["dir"] / "port_session.npz")
    ckpt.save_session(ptr, path)
    back = jckpt.load_session(path, configs()[1])
    assert back.state.name == "OK" and len(back.trajectory) == len(ptr.trajectory)
    assert back.last_frame.frame_id == ptr.last_frame.frame_id
    assert_maps_equal(back.atlas.current, ptr.atlas.current)


def test_session_saved_while_lost_relocalizes_in_both(files):
    jtr, ptr, jstates, pstates = continue_both(files, files["lost"], LOST_AT + 1)
    assert ptr._frames_lost == 0 and ptr.stats["reloc_ok"] == 1
    assert pstates == jstates
    assert pstates[0] == "OK" and all(s == "OK" for s in pstates)
    (_, Rp, tp), (_, Rj, tj) = (next(e for e in tr.trajectory if round(e[0] * 30) == LOST_AT + 1)
                                for tr in (ptr, jtr))
    np.testing.assert_allclose(Rp, np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tp, np.asarray(tj), atol=1e-3)


@pytest.mark.parametrize("extra,item", [
    ({"imuq_t": np.zeros(3)}, "A.11"),
    ({"m0_kf0_preint_dR": np.eye(3)}, "A.11"),
    ({"m0_kf0_imu_gyro": np.zeros((2, 3))}, "A.11"),
    ({"imu_initialized": True}, "A.11"),
    ({"db_keys": np.zeros(1, np.int64)}, "A.9"),
], ids=["imu-queue", "preintegration", "imu-window", "imu-initialized", "database"])
def test_unported_sessions_raise(files, extra, item):
    z = dict(np.load(files["session"]))
    extra = dict(extra)
    if extra.pop("imu_initialized", False):
        z["m0_map_meta"] = z["m0_map_meta"].copy()
        z["m0_map_meta"][2] = 1
    z.update(extra)
    path = str(files["dir"] / f"unported_{item}.npz")
    np.savez_compressed(path, **z)
    with pytest.raises(NotImplementedError, match=item):
        ckpt.load_session(path, configs()[0], device="cpu")


def test_load_without_device_needs_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_session(files["session"], configs()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_map(files["map"])
