"""Monocular tracking through the KB8 fisheye camera: the port's
``System.track_monocular`` (plain path, CPU) against the JAX ``System``,
and the fisheye branch of relocalization (MLPnP) against the JAX
tracker's.

The frames are the two-plane scene at speed 0.04 rendered through
TUM-VI's 512x512 KB8 camera (``pf.render_sequence(..., camera="kb8")``:
each pixel's ray by its own float64 Newton inversion of the model, a
constant background where a ray meets no plane), 400 features,
``max_frames`` 6, 15 frames from a cold map; the port draws JAX's
two-view and PnP sets (``patch_jax_draws``).  Held: the same init pair,
every later frame OK, the same keyframes and the same number of initial
map points, per-frame map-point counts within 2%, and the port's ATE
after Sim3 alignment within 1.05x the JAX run's + 1 mm.

The two reference faults of a KB8 map that the port matches (ROADMAP
C.2) are pinned here: the two-view initialisation runs the pinhole-K H/F
on raw fisheye pixels (the same init and initial points as JAX), and the
triangulation program (K7) builds P1/P2, F12 and its gate from the pinhole
K: on the JAX map right before the first keyframe event after
initialisation (carried across with ``interop``), both packages'
triangulation give the same matches and gates, and the same points to 1%
(median within 1e-4: pinhole rays through raw fisheye pixels meet badly,
and the float32 DLT amplifies rounding there).  The
fuse program on that map (K3's boxes through the KB8 projection) gives the
same matches.

Relocalization: ``tests/test_recently_lost.py:121-190``'s scene (240
points up to 55 degrees off the axis, 2-8 m away, a query pose 0.5 m and
7 degrees away) through both trackers' ``_relocalize``: the port unprojects
to bearings and runs MLPnP (not ``ransac_pnp``), and lands within JAX's
bounds of the truth (2e-2 rotation, 5e-2 translation) and within 1e-3 of
JAX's pose.
"""

import dataclasses

import jax.numpy as jnp
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
from extractorb_tpu.frontend.extractor import Features as JFeatures
from extractorb_tpu.slam import local_mapping as jlm
from extractorb_tpu.slam import map as jmap
from extractorb_tpu.slam import tracking as jtracking
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import CameraConfig, ORBConfig, SLAMConfig, TrackingConfig
from extractorb_tpu_torch.core.camera import KannalaBrandt8
from extractorb_tpu_torch.slam import local_mapping as lm
from extractorb_tpu_torch.slam import map as pmap
from extractorb_tpu_torch.slam import tracking as ptracking
from extractorb_tpu_torch.slam.tracking import TrackState
from extractorb_tpu_torch.solver import pnp
from test_torch_local_mapping import jax_map
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W = H = 512
NF, N_FRAMES, SPEED, MAX_FRAMES = 400, 15, 0.04, 6
KB8 = pf.kb8_camera(W, H)
CAM = dict(model="KannalaBrandt8", width=W, height=H,
           **dict(zip(("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"), KB8)))


def first_ok(states):
    return next(k for k, s in enumerate(states) if s.name == "OK")


@pytest.fixture(scope="module")
def runs():
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H,
                                          camera="kb8")
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF), camera=JCameraConfig(**CAM),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES))
    cap = {}
    orig = jlm.LocalMapper.process_keyframe

    def spy(self, mp, kf_id, defer_fetch=False):
        if not cap and len(mp.keyframes) > 2:
            cap.update(pre=interop.map_to_numpy(mp), kf=kf_id, project=self.project,
                       sf=self.scale_factors, isig=self.inv_sigma2, K=self.K)
        return orig(self, mp, kf_id, defer_fetch)

    jsys, jstates, jpoints = JSystem(jcfg), [], []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jlm.LocalMapper, "process_keyframe", spy)
        for k, img in enumerate(frames):
            jstates.append(jsys.track_monocular(img, k / 30.0))
            jpoints.append(jsys.n_map_points())
    jsys.flush()
    cfg = SLAMConfig(orb=ORBConfig(n_features=NF), camera=CameraConfig(**CAM),
                     tracking=TrackingConfig(max_frames=MAX_FRAMES))
    ppoints = []
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        psys, pstates = chip_smoke.run_system(
            frames, torch.device("cpu"), cfg=cfg,
            on_frame=lambda k, st, dt, kf, s: ppoints.append(s.n_map_points()))
    return dict(poses=poses, jsys=jsys, jstates=jstates, jpoints=jpoints, psys=psys,
                pstates=pstates, ppoints=ppoints, cap=cap)


def test_camera_and_raw_keypoints(runs):
    tr = runs["psys"].tracker
    assert isinstance(tr.cam, KannalaBrandt8) and tr.is_fisheye and not tr.has_dist
    assert runs["jsys"].tracker.is_fisheye and not runs["jsys"].tracker.has_dist


def test_same_init_states_and_keyframes(runs):
    js, ps = runs["jstates"], runs["pstates"]
    k0 = first_ok(js)
    assert first_ok(ps) == k0 <= 2
    assert all(s == TrackState.OK for s in ps[k0:])
    assert all(s.name == "OK" for s in js[k0:])
    jt, pt = runs["jsys"].tracker.trajectory, runs["psys"].tracker.trajectory
    assert [ts for ts, _, _ in pt] == [ts for ts, _, _ in jt]
    kf_ids = lambda s: sorted(kf.frame_id for kf in s.tracker.atlas.current.keyframes.values())
    assert kf_ids(runs["psys"]) == kf_ids(runs["jsys"]) and len(kf_ids(runs["psys"])) >= 3
    # the init (pinhole-K H/F on raw fisheye pixels in both, ROADMAP C.2)
    # makes the same points
    assert runs["ppoints"][k0] == runs["jpoints"][k0] > 100
    for a, b in zip(runs["ppoints"], runs["jpoints"]):
        assert abs(a - b) <= 0.02 * b


def test_ate_within_jax_bound(runs):
    ate_p, _ = pf.trajectory_ate(runs["psys"].tracker.trajectory, runs["poses"])
    ate_j, _ = pf.trajectory_ate(runs["jsys"].tracker.trajectory, runs["poses"])
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    stats = runs["psys"].tracker.stats
    assert stats["two_view"] == 1 and stats["ba"] >= 2 and stats["tri_groups"] >= 2


def mappers(cap):
    j = jlm.LocalMapper(cap["project"], cap["sf"], cap["isig"], cap["K"])
    p = lm.LocalMapper(KannalaBrandt8(*KB8), cap["sf"], cap["isig"], cap["K"], "cpu")
    return j, p


def test_triangulation_on_a_kb8_pair_matches_jax(runs):
    """K7 with the pinhole K on raw fisheye pixels, in both packages."""
    cap = runs["cap"]
    assert cap, "the JAX run reached no keyframe event after initialisation"
    np.testing.assert_allclose(cap["K"], [[KB8[0], 0, KB8[2]], [0, KB8[1], KB8[3]], [0, 0, 1]],
                               rtol=1e-6)
    jm, pm = mappers(cap)
    jt = jm._create_new_points_dispatch(jax_map(cap["pre"]), cap["kf"])
    pt = pm._create_new_points_dispatch(interop.map_from_numpy(cap["pre"], "cpu"), cap["kf"])
    assert len(jt) == len(pt) >= 1
    n_ok = 0
    for (jg, jres), (pg, pres) in zip(jt, pt):
        assert [k.kid for k in jg] == [k.kid for k in pg]
        jm12, jX, jok = (np.asarray(a)[: len(jg)] for a in jres)
        pm12, pX, pok = (a.numpy() for a in pres)
        np.testing.assert_array_equal(pm12, jm12)
        np.testing.assert_array_equal(pok, jok)
        # pinhole rays through raw fisheye pixels meet badly, so the
        # float32 DLT amplifies rounding: the same points to 1%, most to 1e-4
        d = np.abs(pX[pok] - jX[jok]).max(1)
        assert np.median(d) <= 1e-4
        np.testing.assert_allclose(pX[pok], jX[jok], rtol=1e-2, atol=1e-4)
        n_ok += int(pok.sum())
    assert n_ok > 20


def test_fuse_on_a_kb8_map_matches_jax(runs):
    """The fuse program's boxes through the KB8 projection."""
    cap = runs["cap"]
    jm, pm = mappers(cap)
    jf = jm._fuse_dispatch(jax_map(cap["pre"]), cap["kf"])
    pfz = pm._fuse_dispatch(interop.map_from_numpy(cap["pre"], "cpu"), cap["kf"])
    assert len(jf) == len(pfz) >= 1
    n_match = 0
    for (jjobs, jmatch), (pjobs, pmatch) in zip(jf, pfz):
        assert [t for t, _ in jjobs] == [t for t, _ in pjobs]
        got = pmatch.numpy()
        np.testing.assert_array_equal(got, np.asarray(jmatch)[: got.shape[0], : got.shape[1]])
        n_match += int((got >= 0).sum())
    assert n_match >= 1   # the first event after init has few points to fuse


# ------------------------------------------------------ fisheye reloc


def reloc_scene(rng):
    """tests/test_recently_lost.py:136-190's scene: bearings up to 55
    degrees off the axis, depths 2-8 m, a keyframe at the origin seeing
    all of them and a query pose 0.5 m and 7 degrees away."""
    n = 240
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(0, np.deg2rad(55), n)
    bear = np.stack([np.sin(el) * np.cos(az), np.sin(el) * np.sin(az), np.cos(el)], -1)
    pts = (bear * rng.uniform(2.0, 8.0, n)[:, None]).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    Rq = pf.so3_exp_np([0.06, -0.10, 0.04]).astype(np.float32)
    Cq = np.array([0.4, -0.25, 0.3], np.float32)
    return pts, desc, (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), \
        (Rq, (-Rq @ Cq).astype(np.float32))


def observe(pts, R, t):
    pc = pts @ R.T + t
    uv = pf.kb8_project_np(pc, KB8).astype(np.float32)
    ok = (pc[:, 2] > 0.1) & (uv[:, 0] > 8) & (uv[:, 0] < 504) & (uv[:, 1] > 8) & (uv[:, 1] < 504)
    return uv, np.where(ok)[0]


def padded(desc, xy, n_cap=512):
    n = len(desc)
    xy_p = np.zeros((n_cap, 2), np.float32)
    xy_p[:n] = xy
    d = np.zeros((n_cap, 32), np.uint8)
    d[:n] = desc
    v = np.zeros(n_cap, bool)
    v[:n] = True
    feats = dict(xy=xy_p, response=np.zeros(n_cap, np.float32), angle=np.zeros(n_cap, np.float32),
                 octave=np.zeros(n_cap, np.int32), size=np.full(n_cap, 31.0, np.float32),
                 desc=d, valid=v)
    return feats, xy_p, d, v


def relocalize(pkg, scene):
    pts, desc, (R0, t0), (Rq, tq) = scene
    if pkg == "jax":
        cfg = JSLAMConfig(orb=JORBConfig(n_features=500), camera=JCameraConfig(**CAM))
        tr, M, feats_of = jtracking.Tracker(cfg), jmap, lambda f: JFeatures(
            **{k: jnp.asarray(v) for k, v in f.items()})
    else:
        cfg = SLAMConfig(orb=ORBConfig(n_features=500), camera=CameraConfig(**CAM))
        tr, M = ptracking.Tracker(cfg, device="cpu"), pmap
        feats_of = lambda f: interop.features_from_numpy(f, "cpu")
    Frame = jtracking.Frame if pkg == "jax" else ptracking.Frame
    mp = tr.atlas.current
    uv0, vis0 = observe(pts, R0, t0)
    f, xy, d, v = padded(desc[vis0], uv0[vis0])
    kf = M.KeyFrame(kid=-1, frame_id=0, timestamp=0.0, R=R0, t=t0, feats=feats_of(f), xy_un=xy,
                    octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32), desc=d,
                    valid=v, kp_mp=np.full(512, -1, np.int32))
    mp.add_keyframe(kf)
    for row, p in enumerate(vis0):
        mid = mp.add_point(pts[p], desc[p], np.zeros(3), 10.0, kf.kid)
        mp.add_observation(mid, kf.kid, row)
    for p in range(mp._next_mp):
        mp.update_point_stats(p)
    uvq, visq = observe(pts, Rq, tq)
    f, xy, d, v = padded(desc[visq], uvq[visq])
    frame = Frame(frame_id=1, timestamp=1.0, feats=feats_of(f), xy_un=xy,
                  octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32), desc=d,
                  valid=v, kp_mp=np.full(512, -1, np.int32))
    tr.state = TrackState.LOST if pkg == "port" else jtracking.TrackState.LOST
    return tr._relocalize(frame), frame, tr


def test_fisheye_relocalization_matches_jax():
    scene = reloc_scene(np.random.default_rng(0))
    _, _, _, (Rq, tq) = scene
    ok_j, fj, _ = relocalize("jax", scene)
    calls = []
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        for name in ("mlpnp_ransac", "mlpnp_refine", "ransac_pnp"):
            real = getattr(pnp, name)
            m.setattr(pnp, name, lambda *a, real=real, name=name, **k: (calls.append(name),
                                                                        real(*a, **k))[1])
        ok_p, fp, tr = relocalize("port", scene)
    assert ok_j and ok_p
    assert "ransac_pnp" not in calls and calls[:2] == ["mlpnp_ransac", "mlpnp_refine"]
    assert tr.stats["pnp"] == tr.stats["reloc"] == 1
    np.testing.assert_allclose(fp.R, Rq, atol=2e-2)
    np.testing.assert_allclose(fp.t, tq, atol=5e-2)
    np.testing.assert_allclose(fp.R, np.asarray(fj.R), atol=1e-3)
    np.testing.assert_allclose(fp.t, np.asarray(fj.t), atol=1e-3)


def test_kb8_pose_opt_in_the_step(runs):
    """The tracking step's pose solves and searches take the KB8 camera
    (the JAX step's ``project_for_camera``)."""
    from extractorb_tpu_torch.slam import track_device as td
    step = td.get_track_step(CameraConfig(**CAM), ORBConfig(n_features=NF), (H, W), 1024, 256,
                             "cpu")
    assert step.cam == KannalaBrandt8(*KB8) and not step.has_dist
    with pytest.raises(NotImplementedError, match="A.12"):
        td.TrackStep(dataclasses.replace(CameraConfig(**CAM), bf=40.0), ORBConfig(n_features=NF),
                     (H, W), 1024, 256, "cpu", depth_mode="stereo")
