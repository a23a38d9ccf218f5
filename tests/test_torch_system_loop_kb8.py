"""The port's System with a vocabulary through TUM-VI's KB8 fisheye (plain
path, CPU) against the JAX System: an Atlas merge from pixels, a
relocalization whose candidate the keyframe database picks, and the
session with its database through the shared npz format.

The 40-frame out-and-back sweep of ``test_torch_system_loop.py``
(``port_fixtures.render_loop_sequence(..., camera="kb8")``: the wall
wrapped to fill the fisheye's view) through TUM-VI's KB8 camera scaled to
320x320, 800 features (500 leave the map after the blackout too thin to
track), a keyframe every frame and ``time_recently_lost`` 0.05 s, frames
19-28 black, tracked through frame 35: the first map (10 or more
keyframes) is kept, a second one starts after the blackout, and place
recognition welds it into the first through K12 and K14's KB8 paths (their
plain versions here).  Both packages get the same vocabulary (k=8, L=3,
trained on every fifth frame) and JAX's two-view, PnP and Sim3 draws.

The KB8 runs of the two packages part after the first triangulation (the
program applies the pinhole K to raw fisheye pixels in both: ROADMAP C.2),
so the runs are held as ``test_torch_system_vi_kb8.py`` holds them: a
witness JAX run whose triangulated points each move by one float32 ulp
(over the first ``WITNESS_FRAMES`` frames) marks the frame where JAX parts
from itself (its poses move by 1e-4: frame 4, 2.3e-4, then 1.3e-3 at frame
6); the port's poses agree with JAX's within 1e-3 before it.  The events agree frame by
frame (state, Atlas maps, current map, merges), the keyframe count within
one, the welded keyframe ids are the same, and the port's ATE stays within
1.05x the JAX run's + 1 mm.  Then a frame of the return sweep relocalizes
in both against the welded map (the database's candidates, MLPnP K25 on a
card): the same candidates, the same reference keyframe, and poses that
differ by no more than the two runs' tracked poses of that frame (13 mm;
the pinhole test's 3 mm where those are closer).
Last, the port's session (the KB8 Atlas and its database) loads in JAX and
back, entry for entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu import config as jc
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import checkpoint as jckpt
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import TrackingConfig
from extractorb_tpu_torch.slam import checkpoint as ckpt
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam.system import System
from test_torch_system_stereo_kb8 import jax_config
from test_torch_system_vi_kb8 import nudge_jax_triangulation
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, NF, N_FRAMES, N_RUN, MAX_FRAMES = 320, 800, 40, 36, 1
BLACK = tuple(range(19, 29))
RELOC_FRAME = 34
WITNESS_FRAMES = 12


def trace(sys_):
    tr = sys_.tracker
    return (tr.state.name, len(tr.atlas.maps), tr.atlas.current.mid,
            tr.loop_closer.n_merges, len(tr.atlas.current.keyframes))


def run(sys_, images, m):
    """Track ``images``; per frame the trace and the pose as tracked, and
    the keyframe ids of each weld."""
    welded, out, poses = [], [], []
    after = sys_.tracker._after_map_merge
    m.setattr(sys_.tracker, "_after_map_merge",
              lambda info, frame: (welded.append(sorted(info["kf_remap"].values())),
                                   after(info, frame)))
    for k, img in enumerate(images):
        sys_.track_monocular(img, k / 30.0)
        out.append(trace(sys_))
        f = sys_.tracker.last_frame
        poses.append(None if f is None or f.R is None else (np.array(f.R), np.array(f.t)))
    sys_.flush()
    return dict(sys=sys_, trace=out, poses=poses, welded=welded)


@pytest.fixture(scope="module")
def runs():
    frames, poses = pf.render_loop_sequence(pf.wide_texture(512), N_FRAMES, W, W, camera="kb8")
    voc = chip_smoke.train_vocab(frames, torch.device("cpu"), n_features=NF)
    jvoc = JVocabulary(**{k: v for k, v in interop.vocab_to_numpy(voc).items()})
    cfg = dataclasses.replace(chip_smoke.kb8_config(W, W, NF),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES,
                                                      time_recently_lost=0.05))
    jcfg = dataclasses.replace(jax_config(cfg),
                               tracking=jc.TrackingConfig(max_frames=MAX_FRAMES,
                                                          time_recently_lost=0.05))
    images = pf.blackout(frames, BLACK)[:N_RUN]
    out = dict(frames=frames, poses=poses, cfg=cfg, jcfg=jcfg, voc=voc, jvoc=jvoc)
    with pytest.MonkeyPatch.context() as m:
        out["jax"] = run(JSystem(jcfg, vocab=jvoc), images, m)
    with pytest.MonkeyPatch.context() as m:
        nudge_jax_triangulation(m)
        out["witness"] = run(JSystem(jcfg, vocab=jvoc), images[:WITNESS_FRAMES], m)
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        out["port"] = run(System(cfg, vocab=voc, device="cpu"), images, m)
    return out


def parts(a, b, tol=1e-3):
    """The first frame whose poses differ by more than ``tol``."""
    for k, (x, y) in enumerate(zip(a, b)):
        if (x is None) != (y is None) or (x is not None and not (
                np.allclose(x[0], y[0], atol=tol) and np.allclose(x[1], y[1], atol=tol))):
            return k
    return min(len(a), len(b))


def test_kb8_merge_from_pixels_matches_jax(runs):
    jt, tt = runs["jax"]["trace"], runs["port"]["trace"]
    assert [t[:4] for t in tt] == [t[:4] for t in jt]
    assert all(abs(a[4] - b[4]) <= 1 for a, b in zip(tt, jt))
    assert max(t[4] for t in tt[:BLACK[0]]) >= 10        # the first map is kept
    assert any(t[1] == 2 for t in tt)                   # a second map before the weld
    assert tt[-1][0] == "OK" and tt[-1][1] == 1 and tt[-1][3] >= 1
    assert runs["port"]["welded"] == runs["jax"]["welded"] and runs["port"]["welded"]
    # the poses agree within 1e-3 up to the frame where JAX moves by 1e-4
    # under one ulp (frame 4 at this size: 2.3e-4 there, 1.3e-3 two frames on)
    jp, pp = runs["jax"]["poses"], runs["port"]["poses"]
    split = parts(jp, runs["witness"]["poses"], tol=1e-4)
    assert split >= 2 and parts(jp, pp) >= split
    ate = lambda pkg: pf.trajectory_ate(runs[pkg]["sys"].tracker.final_trajectory(),
                                        runs["poses"])[0]
    assert ate("port") <= 1.05 * ate("jax") + 1e-3
    assert ate("port") < chip_smoke.MERGE_MAX_ATE


def test_kb8_bow_relocalization_matches_jax(runs):
    """A return-sweep frame relocalizes against the welded map in both
    packages through the database's candidates and MLPnP."""
    img = runs["frames"][RELOC_FRAME]
    out = []
    for pkg, enc, dec in (("jax", jlc.encode_dbid, jlc.decode_dbid),
                          ("port", lc.encode_dbid, lc.decode_dbid)):
        tr = runs[pkg]["sys"].tracker
        with pytest.MonkeyPatch.context() as m:
            if pkg == "port":
                patch_jax_draws(m)
            frame = tr._make_frame(img, 5.0)
            atlas = tr.atlas

            def covis(key):
                mid, k = dec(key)
                mp = atlas.map_by_mid(mid)
                return [enc(mid, n) for n, _ in mp.covisible_keyframes(k, 1)[:10]]

            cands = tr.loop_closer.db.query(frame.desc, valid=frame.valid, n_best=5,
                                            covis_fn=covis, rel_score_ratio=0.75)
            ok = tr._relocalize(frame)
        out.append(([dec(k)[1] for k, _ in cands], ok, tr.ref_kf, frame.R, frame.t))
    (jc_, jok, jref, jR, jt), (tc, tok, tref, tR, tt) = out
    assert tc == jc_ and tc
    assert tok and jok and tref == jref and tref in tc[:5]
    # the two welded maps differ (their runs parted after the first
    # triangulation): the relocalized poses differ by no more than the two
    # runs' tracked poses of that frame do, or 3 mm
    (aR, at), (bR, bt) = runs["jax"]["poses"][RELOC_FRAME], runs["port"]["poses"][RELOC_FRAME]
    tol = max(3e-3, float(np.abs(aR - bR).max()), float(np.abs(at - bt).max()))
    np.testing.assert_allclose(tR, np.asarray(jR), atol=tol)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=tol)


def test_kb8_session_with_database_crosses_both_ways(runs, tmp_path):
    """The port's KB8 session (its welded Atlas and keyframe database) loads
    in JAX and, saved there, back in the port: keyframes, points and the
    database's entries unchanged."""
    tr = runs["port"]["sys"].tracker
    path, back = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_session(tr, path)
    jtr = jckpt.load_session(path, runs["jcfg"], vocab=runs["jvoc"])
    jckpt.save_session(jtr, back)
    tr2 = ckpt.load_session(back, runs["cfg"], vocab=runs["voc"], device="cpu")
    assert type(tr2.cam) is type(tr.cam) and tr2.is_fisheye
    for other in (jtr, tr2):
        assert len(other.atlas.maps) == len(tr.atlas.maps)
        a, b = tr.atlas.current, other.atlas.current
        assert sorted(b.keyframes) == sorted(a.keyframes)
        for k in a.keyframes:
            np.testing.assert_array_equal(np.asarray(b.keyframes[k].R), a.keyframes[k].R)
        np.testing.assert_array_equal(np.flatnonzero(np.asarray(b.mp_valid)),
                                      np.flatnonzero(a.mp_valid))
        db, ref = other.loop_closer.db, tr.loop_closer.db
        assert sorted(db.entries) == sorted(ref.entries) and ref.entries
        for key, (ids, w) in ref.entries.items():
            np.testing.assert_array_equal(db.entries[key][0], ids)
            np.testing.assert_array_equal(db.entries[key][1], w)


@pytest.mark.parametrize("sensor", ["monocular", "stereo", "imu-monocular", "imu-stereo"])
def test_kb8_with_vocabulary_constructs(sensor):
    """TUM-VI's four KB8 configurations take a vocabulary: the closer gets
    the KB8 camera, the database, the rig's fixed scale and the IMU
    calibration of the inertial sensors."""
    from extractorb_tpu_torch.core.camera import KannalaBrandt8
    from extractorb_tpu_torch.place.vocab import Vocabulary

    cfg = {"monocular": chip_smoke.kb8_config, "imu-monocular": chip_smoke.vi_kb8_config}.get(
        sensor, lambda w, h, n: chip_smoke.kb8_rig_config(sensor, w, h, n))(W, W, NF)
    voc = Vocabulary.train(np.random.default_rng(0).integers(0, 256, (300, 32), dtype=np.uint8),
                           k=4, L=2)
    tr = System(cfg, vocab=voc, device="cpu").tracker
    cl = tr.loop_closer
    assert isinstance(cl.cam, KannalaBrandt8) and cl.cam is tr.cam and cl.db is not None
    assert cl.fix_scale == (sensor == "stereo")
    assert (cl.imu_calib is not None) == sensor.startswith("imu")
