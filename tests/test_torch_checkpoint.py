"""Checkpoints between the JAX package and the port
(``extractorb_tpu_torch/slam/checkpoint.py``, the same npz format).

A JAX ``System`` tracks the 320x240 / 500-feature two-plane sequence of
``test_torch_system.py`` (max_frames 6) from a cold map.  Its map loads in
the port with every array equal and the port's file loads back in JAX; its
session taken mid-sequence, or while LOST, loads in both packages, which
then track the rest of the frames the same way (states, trajectory, ATE
within 1.05 x the JAX continuation's + 1 mm, the relocalization frame).
Keyframe-database entries cross both ways.  An inertial JAX session (the
visual one loaded as imu-monocular, with a measurement queue, keyframe
preintegrations and raw windows, the staging flags and the tracker's IMU
chain filled in) loads in the port and the port's save loads back in JAX,
each piece equal after both trips.
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


@pytest.fixture(scope="module")
def inertial_files(files):
    """A JAX inertial session: the visual session loaded as imu-monocular,
    its IMU state filled in, saved; then loaded in the port and saved
    again.  Returns the JAX tracker, the port tracker and the JAX tracker
    reloaded from the port's file."""
    from extractorb_tpu.imu import preintegration as jpre
    from extractorb_tpu.imu.calib import ImuCalib as JImuCalib
    from test_torch_system_vi import jax_config

    vcfg = chip_smoke.vi_config(W, H, NF)
    jvcfg = jax_config(vcfg)
    jtr = jckpt.load_session(files["session"], jvcfg)
    jtr.grab_imu(pf.imu_window(0.0, 0.45))
    calib = JImuCalib.from_config(jvcfg.imu)
    mp = jtr.atlas.current
    kids = sorted(mp.keyframes)
    rng = np.random.default_rng(0)
    for a, b in zip(kids[:-1], kids[1:]):
        kf = mp.keyframes[b]
        kf.prev_kf = a
        kf.imu_meas = jtr.imu_queue.raw_window(0.05 * a, 0.05 * b + 0.03)
        bias = rng.normal(0, 0.01, 6).astype(np.float32)
        g, acc, dt = kf.imu_meas
        kf.preint = jpre.integrate(g, acc, dt, np.ones(len(dt), bool), bias, calib.noise_gyro,
                                   calib.noise_acc, calib.walk_gyro, calib.walk_acc)
        kf.v, kf.bg, kf.ba = (rng.normal(0, 0.1, 3).astype(np.float32) for _ in range(3))
    mp.imu_initialized, mp.imu_ba1 = True, True
    jtr._prev_kf_id, jtr.last_kf_ts, jtr.first_kf_ts = kids[-1], 0.3, 0.0
    jtr.cur_bias = np.arange(6, dtype=np.float32) * 1e-3
    jpath, ppath = str(files["dir"] / "jax_vi.npz"), str(files["dir"] / "port_vi.npz")
    jckpt.save_session(jtr, jpath)
    ptr = ckpt.load_session(jpath, vcfg, device="cpu")
    ckpt.save_session(ptr, ppath)
    return jtr, ptr, jckpt.load_session(ppath, jvcfg)


def _imu_pieces(tr, part):
    """The piece of a tracker's IMU state ``part`` as numpy."""
    mp = tr.atlas.current
    kfs = [mp.keyframes[k] for k in sorted(mp.keyframes)]
    if part == "queue":
        return [np.asarray(a) for a in tr.imu_queue.snapshot()]
    if part == "preint":
        return [np.asarray(getattr(kf.preint, f)) for kf in kfs if kf.preint is not None
                for f in ("dR", "dV", "dP", "C", "JRg", "JVg", "JVa", "JPg", "JPa", "dT", "bias")]
    if part == "imu_meas":
        return [np.asarray(a) for kf in kfs if kf.imu_meas is not None for a in kf.imu_meas] + \
            [np.asarray([kf.prev_kf for kf in kfs])]
    return [np.asarray([mp.imu_initialized, mp.imu_ba1, mp.imu_ba2]), np.asarray(tr.cur_bias),
            np.asarray([tr._prev_kf_id, tr.last_kf_ts, tr.first_kf_ts])] + \
        [np.asarray(a) for kf in kfs for a in (kf.v, kf.bg, kf.ba) if a is not None]


@pytest.mark.parametrize("part", ["queue", "preint", "imu_meas", "init_flags"])
def test_inertial_session_round_trips(inertial_files, part):
    """Each piece of an inertial session's IMU state is equal in JAX, in the
    port after loading the JAX file, and in JAX after loading the port's."""
    jtr, ptr, back = inertial_files
    ref = _imu_pieces(jtr, part)
    assert ref and len(ref) == len(_imu_pieces(ptr, part)) == len(_imu_pieces(back, part))
    for a, b, c in zip(ref, _imu_pieces(ptr, part), _imu_pieces(back, part)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ptr.inertial and ptr.imu_queue is not None


def test_load_without_device_needs_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_session(files["session"], configs()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_map(files["map"])


def test_database_entries_cross_both_ways(files):
    """A session's keyframe-database entries (db_keys, db_lens, db_words,
    db_weights) saved by the port load in JAX and back, entry for entry."""
    from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
    from extractorb_tpu_torch import interop
    from extractorb_tpu_torch.slam.loop_closing import encode_dbid

    cfg, jcfg = configs()
    mp = files["jmap"]
    descs = np.concatenate([np.asarray(kf.desc)[np.asarray(kf.valid)]
                            for kf in mp.keyframes.values()])
    jvoc = JVocabulary.train(descs, k=6, L=3, seed=0)
    voc = interop.vocab_from_numpy(interop.vocab_to_numpy(jvoc))
    tr = ckpt.load_session(files["session"], cfg, vocab=voc, device="cpu")
    tm = tr.atlas.current
    for k, kf in tm.keyframes.items():
        tr.loop_closer.db.add(encode_dbid(tm.mid, k), kf.desc, valid=kf.valid)
    assert len(tr.loop_closer.db) >= 2
    path = str(files["dir"] / "port_db_session.npz")
    ckpt.save_session(tr, path)
    jtr = jckpt.load_session(path, jcfg, vocab=jvoc)
    back = str(files["dir"] / "jax_db_session.npz")
    jckpt.save_session(jtr, back)
    tr2 = ckpt.load_session(back, cfg, vocab=voc, device="cpu")
    for db in (jtr.loop_closer.db, tr2.loop_closer.db):
        assert sorted(db.entries) == sorted(tr.loop_closer.db.entries)
        for key, (ids, w) in tr.loop_closer.db.entries.items():
            np.testing.assert_array_equal(db.entries[key][0], ids)
            np.testing.assert_array_equal(db.entries[key][1], w)
    # without a vocabulary the entries are not loaded
    assert ckpt.load_session(path, cfg, device="cpu").loop_closer.db is None
