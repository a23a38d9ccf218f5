"""The port's tracking recovery (plain path, CPU) against the JAX System:
LOST, relocalization, Atlas recovery and RECENTLY_LOST.

320x240, 500 features, ``TrackingConfig(max_frames=6)``, 24 frames of the
two-plane scene at speed 0.04 from a cold map, with frames blacked out
(``port_fixtures.blackout``): tracking fails on them and must recover.
Both packages get JAX's two-view and PnP draws (``depth_system.
patch_jax_draws``), so they initialise and relocalize from the same
hypotheses.

(a) Frames 14-15 black: both go LOST on 14, relocalize on 16 (against
    the map's three newest keyframes: K3 match, K10 PnP, K4) with the
    same pose within 1e-3, and end with the same keyframes; the port's ATE
    stays within 1.05 x the JAX run's + 1 mm.
(b) Frames 14-21 black: the sixth failed LOST frame (20) starts a new
    Atlas map and drops the failed one (4 keyframes < 10); both then
    re-initialise on the same frames.
(c) RECENTLY_LOST on a mature map: a JAX session after frame 13 whose map
    is padded to 12 keyframes (copies of its 4, with their observations)
    loads into both packages; with ``time_recently_lost`` 0.05 s, black
    frames 14-16 hold RECENTLY_LOST for two frames, drop to LOST on the
    third, and frame 17 relocalizes.
(d) The same session with frames 14-22 black: after the drop to LOST the
    sixth failed LOST frame (22) starts a new Atlas map and keeps the
    failed one (12 keyframes >= 10).
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
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES, SPEED, MAX_FRAMES = 320, 240, 500, 24, 0.04, 6
BLACK_A = (14, 15)
BLACK_B = tuple(range(14, 22))


def configs(time_recently_lost: float = 5.0):
    """The port's and the JAX package's configuration of these runs."""
    cfg = dataclasses.replace(
        chip_smoke.system_config(W, H, NF),
        tracking=TrackingConfig(max_frames=MAX_FRAMES, time_recently_lost=time_recently_lost))
    c = cfg.camera
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                       camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=W, height=H),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES,
                                                time_recently_lost=time_recently_lost))
    return cfg, jcfg


@pytest.fixture(scope="module")
def frames():
    images, _, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H)
    return images, poses


def trace(sys_):
    """What the runs are compared on after each frame."""
    tr = sys_.tracker
    return (tr.state.name, len(tr.atlas.maps), tr.atlas.current.mid,
            len(tr.atlas.current.keyframes))


def run_both(frames, black):
    images, poses = frames
    images = pf.blackout(images, black)
    cfg, jcfg = configs()
    jsys = JSystem(jcfg)
    jtrace = []
    for k, img in enumerate(images):
        jsys.track_monocular(img, k / 30.0)
        jtrace.append(trace(jsys))
    jsys.flush()
    ptrace = []
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        psys, _ = chip_smoke.run_system(images, torch.device("cpu"), cfg=cfg,
                                        on_frame=lambda k, st, dt, kf, s: ptrace.append(trace(s)))
    return dict(poses=poses, jsys=jsys, psys=psys, jtrace=jtrace, ptrace=ptrace)


@pytest.fixture(scope="module")
def occluded(frames):
    return run_both(frames, BLACK_A)


@pytest.fixture(scope="module")
def recovered(frames):
    return run_both(frames, BLACK_B)


def pose_at(sys_, k):
    return next((R, t) for ts, R, t in sys_.tracker.trajectory if round(ts * 30) == k)


def test_lost_and_relocalized_like_jax(occluded):
    pt, jt = occluded["ptrace"], occluded["jtrace"]
    assert pt == jt
    states = [s for s, *_ in pt]
    assert states[13] == "OK" and states[14:16] == ["LOST", "LOST"]
    assert all(s == "OK" for s in states[16:])
    (Rp, tp), (Rj, tj) = pose_at(occluded["psys"], 16), pose_at(occluded["jsys"], 16)
    np.testing.assert_allclose(Rp, np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tp, np.asarray(tj), atol=1e-3)
    stats = occluded["psys"].tracker.stats
    assert stats["reloc"] == 2 and stats["reloc_ok"] == 1 and stats["pnp"] >= 1
    assert occluded["psys"].n_keyframes() == occluded["jsys"].n_keyframes()


def test_ate_through_the_loss_within_jax_bound(occluded):
    ptraj, jtraj = occluded["psys"].tracker.trajectory, occluded["jsys"].tracker.trajectory
    assert [round(ts * 30) for ts, _, _ in ptraj] == [round(ts * 30) for ts, _, _ in jtraj]
    ate_p, scale = pf.trajectory_ate(ptraj, occluded["poses"])
    ate_j, _ = pf.trajectory_ate(jtraj, occluded["poses"])
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    assert ate_p <= 0.05 * max(scale, 1.0)


def test_atlas_recovery_like_jax(recovered):
    pt, jt = recovered["ptrace"], recovered["jtrace"]
    assert pt == jt
    states = [s for s, *_ in pt]
    assert states[14:20] == ["LOST"] * 6
    # the sixth failed LOST frame starts map 1 and drops map 0 (4 keyframes)
    assert pt[19][1:3] == (1, 0) and pt[20] == ("NO_IMAGES_YET", 1, 1, 0)
    assert states[-1] == "OK" and pt[-1][3] >= 2
    stats = recovered["psys"].tracker.stats
    assert stats["two_view"] >= 2 and stats["reloc_ok"] == 0
    assert len(recovered["psys"].tracker.trajectory) == len(recovered["jsys"].tracker.trajectory)


def _pad_keyframes(jtracker, n_total: int):
    """Copy the JAX map's keyframes (in id order, with their observations)
    until it holds ``n_total``: a mature map for the RECENTLY_LOST gate."""
    mp = jtracker.atlas.current
    base = [mp.keyframes[k] for k in sorted(mp.keyframes)]
    i = 0
    while len(mp.keyframes) < n_total:
        src = base[i % len(base)]
        kf = dataclasses.replace(src, kid=-1, kp_mp=src.kp_mp.copy(), R=src.R.copy(),
                                 t=src.t.copy(), loop_edges=[])
        mp.add_keyframe(kf)
        for kp in np.where(kf.kp_mp >= 0)[0]:
            mid = int(kf.kp_mp[kp])
            if mp.mp_valid[mid]:
                mp.add_observation(mid, kf.kid, int(kp))
            else:
                kf.kp_mp[kp] = -1
        i += 1


@pytest.fixture(scope="module")
def mature(frames, tmp_path_factory):
    """A JAX session after frame 13 whose map holds 12 keyframes."""
    images, _ = frames
    _, jcfg = configs(time_recently_lost=0.05)
    jsys = JSystem(jcfg)
    for k in range(14):
        jsys.track_monocular(images[k], k / 30.0)
    jsys.flush()
    _pad_keyframes(jsys.tracker, 12)
    path = str(tmp_path_factory.mktemp("reloc") / "mature.npz")
    jckpt.save_session(jsys.tracker, path)
    return path


def resume_both(mature, images, first: int):
    """Load the mature session in both packages and track images[first:]."""
    cfg, jcfg = configs(time_recently_lost=0.05)
    jtr = jckpt.load_session(mature, jcfg)
    ptr = ckpt.load_session(mature, cfg, device="cpu")
    last = len(images)
    jstates = [jtr.track(images[k], k / 30.0).name for k in range(first, last)]
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        pstates = [ptr.track(images[k], k / 30.0).name for k in range(first, last)]
    return jtr, ptr, jstates, pstates


def test_recently_lost_like_jax(frames, mature):
    images = pf.blackout(frames[0][:21], (14, 15, 16))
    jtr, ptr, jstates, pstates = resume_both(mature, images, 14)
    assert pstates == jstates
    assert pstates[:4] == ["RECENTLY_LOST", "RECENTLY_LOST", "LOST", "OK"]
    assert all(s == "OK" for s in pstates[4:])
    assert ptr._lost_ts == pytest.approx(14 / 30.0) and ptr.stats["reloc_ok"] == 1
    assert len(ptr.atlas.current.keyframes) == len(jtr.atlas.current.keyframes)
    assert TrackState(ptr.state.value) == TrackState.OK


def test_atlas_recovery_keeps_a_mature_map_like_jax(frames, mature):
    images = pf.blackout(frames[0], range(14, 23))
    jtr, ptr, jstates, pstates = resume_both(mature, images, 14)
    assert pstates == jstates
    assert pstates[:9] == ["RECENTLY_LOST"] * 2 + ["LOST"] * 6 + ["NO_IMAGES_YET"]
    for tr in (ptr, jtr):
        assert [m.mid for m in tr.atlas.maps] == [0, 1] and tr.atlas.current.mid == 1
        assert len(tr.atlas.maps[0].keyframes) == 12 and tr._frames_lost == 0
    assert ptr.stats["reloc_ok"] == 0
