"""The port's System with a vocabulary (plain path, CPU) against the JAX
System: an Atlas merge from pixels, and a relocalization whose candidate
the keyframe database picks.

The 40-frame out-and-back sweep of ``tests/test_loop_from_pixels.py``
(``port_fixtures.render_loop_sequence``, the procedural wall) at 320x240
and 500 features, a keyframe every frame and ``time_recently_lost`` 0.05 s,
with frames 19-28 black, tracked through frame 35: the first map (more
than 10 keyframes) is kept, a second one starts after the blackout, and
place recognition welds it into the first.  Both packages get the same
vocabulary (k=8, L=3, trained on every fifth frame) and JAX's two-view,
PnP and Sim3 draws.  The runs agree frame by frame on the state, the
Atlas maps and the merges, and on the keyframe count within one (a
KeyFrameCulling decision near its 90% threshold may fall a frame apart
with the float summation order), weld the same keyframe ids, and the
port's ATE stays within 1.05x the JAX run's + 1 mm.  Then a frame of the
return sweep relocalizes in both against the welded map: the same
database candidates, the same reference keyframe, poses within 3 mm (the
two maps' points differ by the float noise of 36 frames).
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
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import TrackingConfig
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam.system import System
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES, N_RUN, MAX_FRAMES = 320, 240, 500, 40, 36, 1
BLACK = tuple(range(19, 29))
RELOC_FRAME = 34


def trace(sys_):
    tr = sys_.tracker
    return (tr.state.name, len(tr.atlas.maps), tr.atlas.current.mid,
            tr.loop_closer.n_merges, len(tr.atlas.current.keyframes))


@pytest.fixture(scope="module")
def runs():
    frames, poses = pf.render_loop_sequence(pf.wide_texture(512), N_FRAMES, W, H)
    voc = chip_smoke.train_vocab(frames, torch.device("cpu"), n_features=NF)
    jvoc = JVocabulary(**{k: v for k, v in interop.vocab_to_numpy(voc).items()})
    cfg = dataclasses.replace(chip_smoke.system_config(W, H, NF),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES,
                                                      time_recently_lost=0.05))
    c = cfg.camera
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                       camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=W, height=H),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES, time_recently_lost=0.05))
    images = pf.blackout(frames, BLACK)[:N_RUN]
    out = dict(frames=frames, poses=poses)
    for pkg in ("jax", "port"):
        with pytest.MonkeyPatch.context() as m:
            welded = []
            if pkg == "jax":
                sys_ = JSystem(jcfg, vocab=jvoc)
            else:
                patch_jax_draws(m)
                sys_ = System(cfg, vocab=voc, device="cpu")
            after = sys_.tracker._after_map_merge
            m.setattr(sys_.tracker, "_after_map_merge",
                      lambda info, frame: (welded.append(sorted(info["kf_remap"].values())),
                                           after(info, frame)))
            tr_ = []
            for k, img in enumerate(images):
                sys_.track_monocular(img, k / 30.0)
                tr_.append(trace(sys_))
            sys_.flush()
        out[pkg] = dict(sys=sys_, trace=tr_, welded=welded)
    return out


def test_merge_from_pixels_matches_jax(runs):
    jt, tt = runs["jax"]["trace"], runs["port"]["trace"]
    assert [t[:4] for t in tt] == [t[:4] for t in jt]
    assert all(abs(a[4] - b[4]) <= 1 for a, b in zip(tt, jt))
    assert tt[-1][0] == "OK" and tt[-1][1] == 1 and tt[-1][3] >= 1
    assert any(t[1] == 2 for t in tt)          # a second map before the weld
    assert runs["port"]["welded"] == runs["jax"]["welded"] and runs["port"]["welded"]
    ate = lambda pkg: pf.trajectory_ate(runs[pkg]["sys"].tracker.final_trajectory(),
                                        runs["poses"])[0]
    assert ate("port") <= 1.05 * ate("jax") + 1e-3
    assert ate("port") < chip_smoke.MERGE_MAX_ATE


def test_bow_relocalization_matches_jax(runs):
    """A return-sweep frame relocalizes against the welded map in both
    packages: the database's candidates (covisibility groups within 0.75x
    of the best) are the same and non-empty, and so are the chosen
    reference keyframe and the pose."""
    img = runs["frames"][RELOC_FRAME]
    out = []
    for pkg, enc, dec in (("jax", jlc.encode_dbid, jlc.decode_dbid),
                          ("port", lc.encode_dbid, lc.decode_dbid)):
        sys_ = runs[pkg]["sys"]
        tr = sys_.tracker
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
    (jc, jok, jref, jR, jt), (tc, tok, tref, tR, tt) = out
    assert tc == jc and tc
    assert tok and jok and tref == jref and tref in tc[:5]
    np.testing.assert_allclose(tR, np.asarray(jR), atol=3e-3)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=3e-3)
