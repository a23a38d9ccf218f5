"""Loop closing and Atlas merging of the port through TUM-VI's KB8 fisheye
against the JAX package's, on the constructed maps of
``test_torch_loop_closing.py`` and ``test_torch_inertial_loop.py`` with
their keypoints in the fisheye image (``port_fixtures.build_looped_map(
camera=...)``: the landmarks projected through the KB8 model).

Both packages build the same map from the same seed and run their
``LoopCloser`` keyframe by keyframe with the same vocabulary, the JAX one
with the KB8 projection closure (``extractorb_tpu/slam/track_device.py
:kb8_project``); the port draws its Sim3 sets as JAX does
(``depth_system.patch_jax_draws``).

- The Sim3 route, with and without a fixed scale (the stereo rig's
  closer fixes it): the same closing keyframe, one loop, the same map
  points left after the fuse, the port's essential graph JAX's plus the
  LoopConnections edges (ROADMAP C) and JAX's solver on it giving the
  port's corrected poses (1e-4); the dispatched GBA (K14<KB8> on a card)
  applies at ``finish``.  A scrambled loop closes in neither.
- The 4-DoF route on the inertial map: the same closing keyframe, the 4-DoF
  graph held as in the pinhole test, roll and pitch kept, one inertial GBA
  through the KB8 camera (K20<KB8> on a card), the port's closing keyframe
  within half its drift (JAX's graph, without the LoopConnections edges,
  pulls it back past that here).
- An inertial Atlas merge: the same weld keyframe, one map, the inertial
  weld's window within 1e-3 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import imu_frontend as jfront
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam import merge as jmg
from extractorb_tpu.slam.map import Atlas as JAtlas
from extractorb_tpu.slam.track_device import kb8_project as j_kb8
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import KannalaBrandt8
from extractorb_tpu_torch.slam import imu_frontend as front
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam import merge as mg
from extractorb_tpu_torch.slam.map import Atlas
from extractorb_tpu_torch.solver import pose_graph as pg
from test_torch_inertial_loop import CALIB, JCALIB, KIND, centre, integrator, spy
from test_torch_loop_closing import SHIFT, THRESHOLDS, edges_of, scramble
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

KB8 = pf.kb8_camera()
CAM = KannalaBrandt8(*KB8)
JPROJ = j_kb8(*KB8)
IMG_WH = (512, 512)


def closer(pkg, desc, fix_scale=False, imu=False, inv_sigma2=None):
    voc = JVocabulary.train(desc, k=8, L=3, seed=0)
    if pkg == "jax":
        return jlc.LoopCloser(voc, JPROJ, img_wh=IMG_WH,
                              thresholds=jlc.LoopThresholds(**THRESHOLDS), fix_scale=fix_scale,
                              inv_sigma2=inv_sigma2, imu_calib=JCALIB if imu else None)
    return lc.LoopCloser(interop.vocab_from_numpy(interop.vocab_to_numpy(voc)), CAM,
                         img_wh=IMG_WH, thresholds=lc.LoopThresholds(**THRESHOLDS),
                         fix_scale=fix_scale, inv_sigma2=inv_sigma2,
                         imu_calib=CALIB if imu else None, device="cpu")


def run_both(fix_scale=False, scrambled=False, inertial=False):
    """Both closers over the KB8 looped map until one closes: per package
    the map, closer, closing keyframe, calls of the graph solvers and the
    GBAs, and the true centres."""
    out = {}
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        for pkg in ("jax", "port"):
            SM, KF, feats = KIND[pkg]
            mp, _, desc, centres = pf.build_looped_map(
                0, SM, KF, feats, return_shift=SHIFT, camera=KB8, inertial=inertial,
                preintegrate=integrator(pkg) if inertial else None)
            if scrambled:
                scramble(mp, np.random.default_rng(1))
            drift = {k: float(np.linalg.norm(centre(kf) - centres[k]))
                     for k, kf in mp.keyframes.items()}
            log = {"sim3": [], "4dof": [], "gba": []}
            gmod = jpg if pkg == "jax" else pg
            spy(m, gmod, "optimize_pose_graph", log["sim3"])
            spy(m, gmod, "optimize_pose_graph_4dof", log["4dof"])
            spy(m, jfront if pkg == "jax" else front, "full_inertial_ba", log["gba"])
            cl = closer(pkg, desc, fix_scale, inertial)
            closed = None
            for kid in sorted(mp.keyframes):
                if cl.process_keyframe(mp, kid):
                    closed = kid
                    break
            out[pkg] = dict(mp=mp, closer=cl, closed=closed, log=log, centres=centres,
                            drift=drift)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["sim3", "fix-scale"])
def sim3_loop(request):
    return request.param, run_both(fix_scale=request.param)


def test_kb8_loop_closes_as_jax(sim3_loop):
    fix_scale, r = sim3_loop
    j, p = r["jax"], r["port"]
    assert j["closed"] is not None and p["closed"] == j["closed"]
    assert p["closer"].n_loops == j["closer"].n_loops == 1
    assert int(p["mp"].mp_valid.sum()) == int(j["mp"].mp_valid.sum()) < p["mp"]._next_mp
    assert not p["log"]["4dof"] and not j["log"]["4dof"]
    # one essential graph each: the port's is JAX's plus LoopConnections
    # edges measured with the corrected poses
    assert len(j["log"]["sim3"]) == len(p["log"]["sim3"]) == 1
    (jargs, _, _), = j["log"]["sim3"]
    (pargs, (tR, tt, ts, _), _), = p["log"]["sim3"]
    je, te = edges_of(jargs[0]), edges_of(pargs[0])
    R0, t0 = pargs[0].R.numpy(), pargs[0].t.numpy()
    extra = 0
    for key, (Rm, tm, _) in te.items():
        got = je.get(key) or je.get(key[::-1])
        if got is not None and np.allclose(Rm, got[0], atol=1e-6) and \
                np.allclose(tm, got[1], atol=1e-6):
            continue
        i, k = key
        np.testing.assert_allclose(Rm, R0[k] @ R0[i].T, atol=1e-5)
        np.testing.assert_allclose(tm, t0[k] - Rm @ t0[i], atol=1e-5)
        extra += 1
    assert extra > 0 and all(k in te or k[::-1] in te for k in je)
    jR, jt, js, _ = jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(*[jnp.asarray(a.numpy()) for a in pargs[0]]), n_iters=15,
        fix_scale=fix_scale)
    for a, b in ((tR, jR), (tt, jt), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    k = p["closed"]
    err = float(np.linalg.norm(centre(p["mp"].keyframes[k]) - p["centres"][k]))
    assert err < 0.5 * p["drift"][k]
    cl = p["closer"]
    assert cl.pending_gba is not None and cl.n_gba_applied == 0
    cl.finish(p["mp"])
    assert cl.n_gba_applied == 1 and cl.pending_gba is None


def test_kb8_false_loop_rejected():
    r = run_both(scrambled=True)
    assert r["jax"]["closed"] is None and r["port"]["closed"] is None
    assert r["port"]["closer"].n_loops == r["jax"]["closer"].n_loops == 0


def test_kb8_inertial_loop_takes_the_4dof_route_as_jax():
    r = run_both(inertial=True)
    j, p = r["jax"], r["port"]
    assert j["closed"] is not None and p["closed"] == j["closed"]
    assert p["closer"].n_loops == j["closer"].n_loops == 1
    for q in (j, p):
        assert len(q["log"]["4dof"]) == 1 and not q["log"]["sim3"]
        assert len(q["log"]["gba"]) == 1 and q["closer"].pending_gba is None
    # the port keeps the correction of the closing keyframe; the JAX graph,
    # without the LoopConnections edges, pulls it back part of the way
    # (here to more than half its drift: ROADMAP C)
    k = p["closed"]
    err = {pkg: float(np.linalg.norm(centre(r[pkg]["mp"].keyframes[k]) - r[pkg]["centres"][k]))
           for pkg in ("jax", "port")}
    assert err["port"] < 0.5 * p["drift"][k] and err["port"] < err["jax"]
    # the port's inertial GBA projects through the KB8 camera
    assert p["log"]["gba"][0][0][2] is CAM
    (pargs, (R, t, _), _), = p["log"]["4dof"]
    pd = {f: np.asarray(getattr(pargs[0], f)) for f in pargs[0]._fields}
    jR, jt, _ = jpg.optimize_pose_graph_4dof(
        jpg.PoseGraph4DoFProblem(**{f: jnp.asarray(v) for f, v in pd.items()}), 15)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    g0, g1 = pf.gravity_in_cameras(pd["R"]), pf.gravity_in_cameras(R.numpy())
    assert np.abs(g1 - g0).max() < 1e-5
    assert int(p["mp"].mp_valid.sum()) == int(j["mp"].mp_valid.sum())


def merge_run(pkg, m):
    """The KB8 return pass as a second inertial Atlas map in a turned and
    moved world, welded into the first (test_torch_inertial_loop.py's
    merge_run through the KB8 camera)."""
    SM, KF, feats = KIND[pkg]
    atlas = (JAtlas if pkg == "jax" else Atlas)()
    keep = atlas.current
    atlas.create_new_map()
    drop = atlas.current
    _, _, desc, _ = pf.build_looped_map(0, SM, KF, feats, return_shift=SHIFT, inertial=True,
                                        preintegrate=integrator(pkg), maps=(keep, drop),
                                        camera=KB8)
    pf.move_world(drop, pf.so3_exp_np([0.0, 0.0, 0.3]), np.array([0.4, -0.2, 0.05]))
    welds = []
    spy(m, jmg if pkg == "jax" else mg, "weld_inertial_bundle_adjustment", welds)
    cl = closer(pkg, desc, imu=True, inv_sigma2=(1.0,) * 8)
    for kid in sorted(keep.keyframes):
        assert not cl.process_keyframe(keep, kid, atlas=atlas)
    info = None
    for n, kid in enumerate(sorted(drop.keyframes)):
        info = cl.process_keyframe(drop, kid, atlas=atlas if n >= 2 else None)
        if info:
            break
    return atlas, cl, info, welds


def test_kb8_inertial_merge_matches_jax():
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        ja, jcl, jinfo, jwelds = merge_run("jax", m)
        pa, pcl, pinfo, pwelds = merge_run("port", m)
    assert jinfo and pinfo and pinfo["kf_cur"] == jinfo["kf_cur"]
    assert pcl.n_merges == jcl.n_merges == 1 and len(pa.maps) == len(ja.maps) == 1
    assert len(jwelds) == len(pwelds) == 1 and bool(pwelds[0][1]) and bool(jwelds[0][1])
    assert pwelds[0][0][2] is CAM
    jm, pm = ja.current, pa.current
    assert pm.imu_initialized and sorted(pm.keyframes) == sorted(jm.keyframes)
    window, k = [], pinfo["kf_cur"]
    while k in pm.keyframes and len(window) < 10:
        window.append(k)
        k = pm.keyframes[k].prev_kf
    assert len(window) >= 3
    for k in window:
        for f in ("R", "t", "v"):
            np.testing.assert_allclose(getattr(pm.keyframes[k], f),
                                       np.asarray(getattr(jm.keyframes[k], f)), atol=1e-3,
                                       err_msg=f"keyframe {k} {f}")
