"""The asynchronous global BA of the port against the JAX package's
(``tests/test_async_gba.py``; reference: the transient
RunGlobalBundleAdjustment thread, mbStopGBA and the spanning-tree
propagation to keyframes created during the solve, LoopClosing.cc:1013+231
and :2430+8-66).

Both packages build the same constructed map (``pf.build_looped_map``,
seed 0) and dispatch the full-map BA through their ``LoopCloser._run_gba``,
the call that closes a loop's correction (the JAX side on a one-device
mesh).  Two keyframes of the outbound pass are held fixed, so its solve
has no gauge freedom left, and its other keyframes are moved by the same
draws of a few cm, so the solve has work to do.  (Each return keyframe
sees only landmarks of its own, which fix nothing: the return pass is
left where it is, with zero residuals, and the solve leaves it there.)
Then, as in the JAX tests: a keyframe and a landmark created while the
solve is in flight follow their parent's correction; a second dispatch
supersedes the first, and one solve is applied; a solve whose map was
replaced is dropped and changes nothing.  Keyframe poses and
point positions of the two packages agree within 1e-3 after the apply.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch

import port_fixtures as pf
from extractorb_tpu.dist import global_ba as jgba
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.frontend.extractor import Features as JFeatures
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam.map import KeyFrame as JKeyFrame
from extractorb_tpu.slam.map import SLAMMap as JSLAMMap
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import global_ba as tgba
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

FX, CX, CY = 500.0, 320.0, 240.0
N_CAP = 512
FIXED = {0, 1}     # two keyframes of the outbound pass
MOVED = {2, 3, 4, 5}  # the rest of it


def jproject(pc):
    return jnp.stack([FX * pc[0] / pc[2] + CX, FX * pc[1] / pc[2] + CY], -1).reshape(2)


def jfeats(d, xy, v):
    n = len(v)
    return JFeatures(xy=jnp.asarray(xy), response=jnp.zeros(n), angle=jnp.zeros(n),
                     octave=jnp.zeros(n, jnp.int32), size=jnp.full(n, 31.0),
                     desc=jnp.asarray(d), valid=jnp.asarray(v))


def tfeats(d, xy, v):
    n = len(v)
    return interop.features_from_numpy(
        dict(xy=xy, response=np.zeros(n, np.float32), angle=np.zeros(n, np.float32),
             octave=np.zeros(n, np.int32), size=np.full(n, 31.0, np.float32), desc=d, valid=v),
        torch.device("cpu"))


PACKAGES = {"jax": (JSLAMMap, JKeyFrame, jfeats), "port": (SLAMMap, KeyFrame, tfeats)}


def setup(monkeypatch):
    """The same map in both packages, the keyframes ``MOVED`` by the same
    draws, each with a closer that dispatches its GBA asynchronously (with
    ``FIXED`` held)."""
    monkeypatch.setattr(jgba, "dmesh", types.SimpleNamespace(make_mesh=lambda: jmesh.make_mesh(1)))
    for mod in (jgba, tgba):
        real = mod.dispatch_global_ba
        monkeypatch.setattr(mod, "dispatch_global_ba",
                            lambda *a, real=real, **k: real(*a, **{**k, "fixed_ids": FIXED}))
    out = {}
    for pkg, (SM, KF, feats) in PACKAGES.items():
        mp = pf.build_looped_map(0, SM, KF, feats)[0]
        rng = np.random.default_rng(1)
        for k in sorted(MOVED):
            mp.keyframes[k].t = (mp.keyframes[k].t + rng.normal(0, 0.01, 3)).astype(np.float32)
        closer = jlc.LoopCloser(None, jproject, async_gba=True) if pkg == "jax" else \
            lc.LoopCloser(None, Pinhole(FX, FX, CX, CY), device="cpu")
        out[pkg] = (mp, closer)
    return out


def add_child_keyframe(mp, KF, feats, parent_id: int, dx: float = 0.12):
    """A keyframe created after the dispatch, child of ``parent_id`` a
    known step along x, and a landmark referenced to it
    (tests/test_async_gba.py:_add_child_keyframe)."""
    par = mp.keyframes[parent_id]
    R = par.R.copy()
    t = par.t.copy() + np.array([-dx, 0, 0], np.float32)
    z = np.zeros(N_CAP, bool)
    kf = KF(kid=-1, frame_id=999, timestamp=99.0, R=R, t=t,
            feats=feats(np.zeros((N_CAP, 32), np.uint8), np.zeros((N_CAP, 2), np.float32), z),
            xy_un=np.zeros((N_CAP, 2), np.float32), octave=np.zeros(N_CAP, np.int32),
            angle=np.zeros(N_CAP, np.float32), desc=np.zeros((N_CAP, 32), np.uint8), valid=z,
            kp_mp=np.full(N_CAP, -1, np.int32), parent=parent_id)
    mp.add_keyframe(kf)
    pos = (-R.T @ t + np.array([0, 0, 5], np.float32)).astype(np.float32)
    mid = mp.add_point(pos, np.zeros(32, np.uint8), np.zeros(3), 10.0, kf.kid)
    mp.add_observation(mid, kf.kid, 0)
    return kf, mid


def assert_maps_agree(jm, tm):
    assert sorted(jm.keyframes) == sorted(tm.keyframes)
    for k in jm.keyframes:
        np.testing.assert_allclose(tm.keyframes[k].R, jm.keyframes[k].R, atol=1e-3)
        np.testing.assert_allclose(tm.keyframes[k].t, jm.keyframes[k].t, atol=1e-3)
    n = jm._next_mp
    assert tm._next_mp == n
    np.testing.assert_array_equal(tm.mp_valid[:n], jm.mp_valid[:n])
    np.testing.assert_allclose(tm.mp_pos[:n][tm.mp_valid[:n]], jm.mp_pos[:n][jm.mp_valid[:n]],
                               atol=1e-3)


def test_gba_propagates_to_keyframes_created_in_flight(monkeypatch):
    maps = setup(monkeypatch)
    for pkg, (mp, closer) in maps.items():
        _, KF, feats = PACKAGES[pkg]
        closer._run_gba(mp)
        assert closer.pending_gba is not None, pkg
        parent_id = max(MOVED)
        kf, mid = add_child_keyframe(mp, KF, feats, parent_id)
        par = mp.keyframes[parent_id]
        R_rel = kf.R @ par.R.T
        t_rel = kf.t - R_rel @ par.t
        cam_before = kf.R @ mp.mp_pos[mid] + kf.t
        t_par = par.t.copy()
        closer.finish(mp)
        assert closer.n_gba_applied == 1 and closer.pending_gba is None, pkg
        par = mp.keyframes[parent_id]
        R_rel2 = kf.R @ par.R.T
        np.testing.assert_allclose(R_rel2, R_rel, atol=1e-5)
        np.testing.assert_allclose(kf.t - R_rel2 @ par.t, t_rel, atol=1e-5)
        assert mp.mp_valid[mid]
        np.testing.assert_allclose(kf.R @ mp.mp_pos[mid] + kf.t, cam_before, atol=1e-3)
        # the solve moved the parent, so the child's pose was corrected
        assert np.abs(par.t - t_par).max() > 1e-4, pkg
    assert_maps_agree(maps["jax"][0], maps["port"][0])


def test_gba_superseded_by_new_correction(monkeypatch):
    maps = setup(monkeypatch)
    for pkg, (mp, closer) in maps.items():
        closer._run_gba(mp)
        first = closer.pending_gba
        assert first is not None, pkg
        closer._run_gba(mp)    # a fresh correction dispatches anew
        assert closer.pending_gba is not first, pkg
        closer.finish(mp)
        assert closer.n_gba_applied == 1 and closer.pending_gba is None, pkg
    assert_maps_agree(maps["jax"][0], maps["port"][0])


def test_gba_dropped_when_map_changes(monkeypatch):
    for pkg, (mp, closer) in setup(monkeypatch).items():
        closer._run_gba(mp)
        assert closer.pending_gba is not None, pkg
        mp.mid = mp.mid + 1000    # the active map was replaced
        poses = {k: (kf.R.copy(), kf.t.copy()) for k, kf in mp.keyframes.items()}
        pos = mp.mp_pos.copy()
        closer.finish(mp)
        assert closer.pending_gba is None and closer.n_gba_applied == 0, pkg
        for k, (R0, t0) in poses.items():
            np.testing.assert_array_equal(mp.keyframes[k].R, R0)
            np.testing.assert_array_equal(mp.keyframes[k].t, t0)
        np.testing.assert_array_equal(mp.mp_pos, pos)
