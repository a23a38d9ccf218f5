"""A global BA applied while pipelined frames are in flight: the port's
``System`` against the JAX ``System`` at ``pipeline_depth`` 3 (ROADMAP
C.8).

Both trackers carry the same small vocabulary, so every keyframe goes
through the loop closer, whose ``process_keyframe`` polls an in-flight
global BA first (``LoopCloser.poll_gba``).  After frame ``GBA_AT`` the
test dispatches the full-map GBA through each closer's own ``_run_gba``
(JAX on a one-device mesh, as ``tests/test_torch_async_gba.py``); a CPU
solve is ready at once, so the next keyframe, created inside a
``_confirm_pipe``, applies it while frames predicted before it are still
in flight.  Neither package replays those frames:
the apply sets neither ``velocity = None`` nor ``_vi_stage_fired``, which
the ``stale`` rule reads (the JAX package's order, a matched reference
fault, ROADMAP C.2).  Held: one GBA applied in each, inside a
confirmation, with the same number of frames in flight; the same replays;
states frame by frame and keyframe ids equal; poses of the frames from
the apply on within 1e-3 of JAX's.

The scene is ``tests/test_torch_system.py``'s (320x240, 500 features,
speed 0.04) with ``max_frames`` 4; the port draws JAX's two-view sets.
"""

import dataclasses
import types

import numpy as np
import pytest

import chip_smoke
import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.dist import global_ba as jgba
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import TrackingConfig
from extractorb_tpu_torch.place.vocab import Vocabulary
from extractorb_tpu_torch.slam.system import System
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES, SPEED, MAX_FRAMES, DEPTH = 320, 240, 500, 14, 0.04, 4, 3
GBA_AT = 6


def run(pkg: str, frames):
    """One package's System over ``frames`` with the GBA dispatched after
    frame ``GBA_AT``; returns its states, the poses of the trajectory,
    the keyframes' frame ids and what the spies saw."""
    voc = Vocabulary.train(np.random.default_rng(0).integers(0, 256, (400, 32), dtype=np.uint8),
                           k=4, L=2)
    cfg = dataclasses.replace(chip_smoke.system_config(W, H, NF),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES,
                                                      pipeline_depth=DEPTH))
    seen = dict(applied_in_confirm=[], replays=0, confirming=False)
    with pytest.MonkeyPatch.context() as m:
        if pkg == "jax":
            c = cfg.camera
            jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                               camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
                                                    width=W, height=H),
                               tracking=JTrackingConfig(max_frames=MAX_FRAMES,
                                                        pipeline_depth=DEPTH))
            m.setattr(jgba, "dmesh", types.SimpleNamespace(make_mesh=lambda: jmesh.make_mesh(1)))
            sys_ = JSystem(jcfg, vocab=JVocabulary(**interop.vocab_to_numpy(voc)))
        else:
            patch_jax_draws(m)
            sys_ = System(cfg, vocab=voc, device="cpu")
        tr = sys_.tracker
        closer = tr.loop_closer
        confirm, poll, replay = tr._confirm_pipe, closer.poll_gba, tr._replay

        def spy_confirm(*a, **k):
            seen["confirming"] = True
            try:
                return confirm(*a, **k)
            finally:
                seen["confirming"] = False

        def spy_poll(mp, force=False):
            n = closer.n_gba_applied
            poll(mp, force)
            if closer.n_gba_applied > n:
                seen["applied_in_confirm"].append(seen["confirming"])
                seen["applied_at_kf"] = max(k.frame_id for k in mp.keyframes.values())
                seen["in_flight"] = len(tr._pipe)

        def spy_replay(entries):
            seen["replays"] += 1
            return replay(entries)

        m.setattr(tr, "_confirm_pipe", spy_confirm)
        m.setattr(closer, "poll_gba", spy_poll)
        m.setattr(tr, "_replay", spy_replay)
        states = []
        for k, img in enumerate(frames):
            states.append(sys_.track_monocular(img, k / 30.0).name)
            if k == GBA_AT:
                closer._run_gba(tr.atlas.current)
                seen["dispatched"] = closer.pending_gba is not None
        sys_.flush()
    kf_ids = sorted(kf.frame_id for kf in tr.atlas.current.keyframes.values())
    traj = {round(ts * 30.0): (np.asarray(R), np.asarray(t)) for ts, R, t in tr.trajectory}
    return dict(states=states, kf_ids=kf_ids, traj=traj, seen=seen,
                n_applied=closer.n_gba_applied)


@pytest.fixture(scope="module")
def runs():
    frames, _, _ = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H)
    return {pkg: run(pkg, frames) for pkg in ("jax", "port")}


def test_gba_applied_mid_pipe_like_jax(runs):
    j, p = runs["jax"], runs["port"]
    for r in (j, p):
        assert r["seen"]["dispatched"] and r["n_applied"] == 1
        # applied by poll_gba inside a confirmation, with frames predicted
        # before it still in flight
        assert r["seen"]["applied_in_confirm"] == [True]
        assert r["seen"]["in_flight"] > 0
    assert p["seen"]["in_flight"] == j["seen"]["in_flight"]
    assert p["seen"]["applied_at_kf"] == j["seen"]["applied_at_kf"]
    assert p["seen"]["replays"] == j["seen"]["replays"]
    assert p["states"] == j["states"]
    assert all(s == "OK" for s in p["states"][1:])
    assert p["kf_ids"] == j["kf_ids"]
    assert sorted(p["traj"]) == sorted(j["traj"]) == list(range(N_FRAMES))
    for k in range(p["seen"]["applied_at_kf"], N_FRAMES):
        np.testing.assert_allclose(p["traj"][k][0], j["traj"][k][0], atol=1e-3)
        np.testing.assert_allclose(p["traj"][k][1], j["traj"][k][1], atol=1e-3)
