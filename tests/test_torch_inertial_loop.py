"""Loop closing and Atlas merging on inertial maps: the port's
``LoopCloser`` with an IMU calibration against the JAX package's.

Both packages build the inertial looped map of ``port_fixtures``
(``build_looped_map(inertial=True)``: an out-and-back pass in a
gravity-aligned world whose return half drifts in yaw and translation, with
the prev_kf chain, velocities, zero biases and 100 Hz preintegrated windows
of the true motion) from the same seed at the size of
``test_torch_loop_closing.py``, and run their closers keyframe by keyframe
with the same vocabulary; the port draws its Sim3 sets as JAX does
(``depth_system.patch_jax_draws``).

- Loop: the same keyframe closes the loop in both; both solve the 4-DoF
  essential graph (no Sim3 graph) and run the synchronous inertial GBA (no
  dispatched Schur GBA).  The port's graph is JAX's plus the LoopConnections
  edges measured at the corrected poses (ROADMAP C), so the packages are
  held stage by stage: JAX's 4-DoF solver on the port's graph gives the
  port's poses (1e-4), the port's solve leaves every keyframe's roll and
  pitch (1e-5), the port's inertial GBA on JAX's loop-corrected map builds
  JAX's problem and follows its float32 solve, and the closer's own GBA
  call, in float64 on both sides, is JAX's solve (1e-6, points included).
  The closing keyframe ends within half its drift in both.
- Merge: the return pass as a second Atlas map, in a world turned by a yaw
  and moved; both closers weld it into the first at the same keyframe and
  run the inertial weld (the local inertial BA over the seam's window), the
  welded window within 1e-3 of JAX's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.config import IMUConfig as JIMUConfig
from extractorb_tpu.imu.calib import ImuCalib as JImuCalib
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import imu_frontend as jfront
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam import merge as jmg
from extractorb_tpu.slam.map import Atlas as JAtlas
from extractorb_tpu.slam.map import KeyFrame as JKeyFrame
from extractorb_tpu.slam.map import SLAMMap as JSLAMMap
from extractorb_tpu.solver import inertial as jsin
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import IMUConfig
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import global_ba
from extractorb_tpu_torch.imu.calib import ImuCalib
from extractorb_tpu_torch.slam import imu_frontend as front
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam import merge as mg
from extractorb_tpu_torch.slam.map import Atlas, KeyFrame, SLAMMap
from extractorb_tpu_torch.solver import inertial as sin
from extractorb_tpu_torch.solver import pose_graph as pg
from test_torch_imu_frontend import port_map
from test_torch_loop_closing import CX, CY, FX, SHIFT, THRESHOLDS, jfeats, jproject, tfeats
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

IMU = dict(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6, acc_walk=1e-5, frequency=100.0)
JCALIB = JImuCalib.from_config(JIMUConfig(**IMU))
CALIB = ImuCalib.from_config(IMUConfig(**IMU))
CPU = torch.device("cpu")
KIND = {"jax": (JSLAMMap, JKeyFrame, jfeats), "port": (SLAMMap, KeyFrame, tfeats)}


def integrator(pkg):
    zero = np.zeros(6, np.float32)
    if pkg == "jax":
        return lambda meas: jfront.integrate_raw_host(meas, zero, JCALIB)
    return lambda meas: front.integrate_raw_host(meas, zero, CALIB, CPU)


def closer(pkg, desc, inv_sigma2=None):
    voc = JVocabulary.train(desc, k=8, L=3, seed=0)
    if pkg == "jax":
        return jlc.LoopCloser(voc, jproject, thresholds=jlc.LoopThresholds(**THRESHOLDS),
                              inv_sigma2=inv_sigma2, imu_calib=JCALIB)
    return lc.LoopCloser(interop.vocab_from_numpy(interop.vocab_to_numpy(voc)),
                         Pinhole(FX, FX, CX, CY), thresholds=lc.LoopThresholds(**THRESHOLDS),
                         inv_sigma2=inv_sigma2, imu_calib=CALIB, device="cpu")


def spy(m, module, name, log, before=None):
    """Record each call of ``module.name``: (args, result) and, with
    ``before``, ``before(args)`` taken ahead of the call."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        pre = before(args) if before is not None else None
        res = real(*args, **kwargs)
        log.append((args, res, pre))
        return res
    m.setattr(module, name, wrapped)


def centre(kf):
    return -kf.R.T @ kf.t


@pytest.fixture(scope="module")
def loops():
    """Both closers over the inertial looped map until one closes."""
    out = {}
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        for pkg, graph_mod, sim3_mod, inertial_mod, gba_mod in (
                ("jax", jpg, jpg, jfront, None), ("port", pg, pg, front, global_ba)):
            SM, KF, feats = KIND[pkg]
            mp, _, desc, centres = pf.build_looped_map(
                0, SM, KF, feats, return_shift=SHIFT, inertial=True,
                preintegrate=integrator(pkg))
            drift = {k: float(np.linalg.norm(centre(kf) - centres[k]))
                     for k, kf in mp.keyframes.items()}
            log = {"4dof": [], "sim3": [], "gba": [], "schur": [], "viba": []}
            spy(m, graph_mod, "optimize_pose_graph_4dof", log["4dof"])
            spy(m, jsin if pkg == "jax" else sin, "optimize_vi_ba", log["viba"])
            spy(m, sim3_mod, "optimize_pose_graph", log["sim3"])
            spy(m, inertial_mod, "full_inertial_ba", log["gba"],
                before=lambda a: copy.deepcopy(a[0]) if isinstance(a[0], JSLAMMap) else None)
            if gba_mod is not None:
                spy(m, gba_mod, "dispatch_global_ba", log["schur"])
            cl = closer(pkg, desc)
            closed = None
            for kid in sorted(mp.keyframes):
                if cl.process_keyframe(mp, kid):
                    closed = kid
                    break
            out[pkg] = dict(mp=mp, closer=cl, closed=closed, log=log, centres=centres,
                            drift=drift)
    return out


def test_same_loop_through_the_inertial_routes(loops):
    j, p = loops["jax"], loops["port"]
    assert j["closed"] is not None and p["closed"] == j["closed"]
    assert p["closer"].n_loops == j["closer"].n_loops == 1
    for r in (j, p):
        assert len(r["log"]["4dof"]) == 1 and not r["log"]["sim3"]
        assert len(r["log"]["gba"]) == 1 and r["log"]["gba"][0][0][0] is r["mp"]
        assert r["closer"].pending_gba is None
        k = r["closed"]
        err = float(np.linalg.norm(centre(r["mp"].keyframes[k]) - r["centres"][k]))
        assert err < 0.5 * r["drift"][k]
    assert not p["log"]["schur"]
    assert int(p["mp"].mp_valid.sum()) == int(j["mp"].mp_valid.sum())


def test_4dof_graph_matches_jax_and_keeps_roll_and_pitch(loops):
    """JAX's graph plus the LoopConnections edges; JAX's 4-DoF solver on
    the port's graph gives the port's poses; roll and pitch unmoved."""
    (jargs, _, _), = loops["jax"]["log"]["4dof"]
    (pargs, (R, t, _), _), = loops["port"]["log"]["4dof"]
    jprob, prob = jargs[0], pargs[0]
    as_np = lambda q: {f: np.asarray(getattr(q, f)) for f in q._fields}
    jd, pd = as_np(jprob), as_np(prob)
    edges = lambda d: {(int(i), int(k)): (R_, t_, float(w)) for i, k, R_, t_, w in
                       zip(d["edge_i"], d["edge_j"], d["m_R"], d["m_t"], d["weight"])}
    je, pe = edges(jd), edges(pd)
    assert all(k in pe or k[::-1] in pe for k in je)
    corrected = 0
    for (i, k), (Rm, tm, w) in pe.items():
        got = je.get((i, k)) or je.get((k, i))
        if got is not None and np.allclose(Rm, got[0], atol=1e-6) and \
                np.allclose(tm, got[1], atol=1e-6):
            assert w == got[2]
            continue
        # a LoopConnections edge: measured at the corrected poses
        np.testing.assert_allclose(Rm, pd["R"][k] @ pd["R"][i].T, atol=1e-5)
        np.testing.assert_allclose(tm, pd["t"][k] - Rm @ pd["t"][i], atol=1e-5)
        corrected += 1
    assert corrected > 0
    np.testing.assert_array_equal(pd["fixed"], jd["fixed"])
    jR, jt, _ = jpg.optimize_pose_graph_4dof(
        jpg.PoseGraph4DoFProblem(**{f: jnp.asarray(v) for f, v in pd.items()}), 15)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    g0, g1 = pf.gravity_in_cameras(pd["R"]), pf.gravity_in_cameras(R.numpy())
    assert np.abs(g1 - g0).max() < 1e-5


def jax_viba(p):
    """A JAX ``VIBAProblem`` with the port problem's values (float64 ones
    need JAX's x64 mode)."""
    f = lambda a: jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
    chain = jsin.InertialChain(**{g: f(getattr(p.chain, g)) for g in p.chain._fields})
    return jsin.VIBAProblem(**{k: chain if k == "chain" else f(getattr(p, k)) for k in p._fields})


def test_inertial_gba_matches_jax(loops):
    """The inertial GBA after the loop (full_inertial_ba, 7 LM x 40 PCG).

    The port's full_inertial_ba on JAX's loop-corrected map (taken just
    before JAX's GBA) builds JAX's VI BA problem, and its float32 solve
    follows JAX's: most points of the constructed map are seen by one
    keyframe, so their damped 3x3 blocks are rank 2 + lambda; in float32
    rounding makes some indefinite at lambda = 1e-4, PCG breaks down and both
    packages' first two candidates are NaN and rejected (ROADMAP C: a
    matched reference fault).  Which later candidates are not finite
    depends on rounding, so the float32 solves are held through the first
    accepted step (3 iterations): keyframe states within 1e-3.

    The closer's own call (the port's problem) in float64 on both sides is
    the same solve: every state and point within 1e-6 after all 7
    iterations, inliers equal.  It is also the witness for the NaN: on that
    problem the first candidate is NaN in float32 and finite in float64."""
    (_, _, before), = loops["jax"]["log"]["gba"]
    cam = Pinhole(FX, FX, CX, CY)

    def solve(n_iters):
        got = {"jax": [], "port": []}
        with pytest.MonkeyPatch.context() as m:
            spy(m, jsin, "optimize_vi_ba", got["jax"])
            spy(m, sin, "optimize_vi_ba", got["port"])
            jfront.full_inertial_ba(copy.deepcopy(before), JCALIB, jproject, n_iters=n_iters)
            front.full_inertial_ba(port_map(before), CALIB, cam, n_iters=n_iters, device="cpu")
        return got

    got = solve(3)
    (jargs, jres, _), = got["jax"]
    (pargs, pres, _), = got["port"]
    jprob, prob = jargs[0], pargs[0]
    for f in prob._fields:
        a, b = getattr(prob, f), getattr(jprob, f)
        if f == "chain":
            for g in a._fields:
                np.testing.assert_allclose(getattr(a, g).numpy(), np.asarray(getattr(b, g)),
                                           rtol=1e-5, atol=1e-6, err_msg=f"chain.{g}")
        elif f in ("prior_g", "prior_a"):
            assert a == b
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f)
    for f in ("Rwb", "twb", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(pres, f).numpy(), np.asarray(getattr(jres, f)),
                                   atol=1e-3, err_msg=f)
    # the overflowed first candidate, in both
    one = solve(1)
    assert np.isnan(float(one["jax"][0][1].cost)) and np.isnan(float(one["port"][0][1].cost))
    # the closer's 7 iterations end finite in both
    assert all(np.isfinite(kf.t).all() and np.isfinite(kf.v).all()
               for r in ("jax", "port") for kf in loops[r]["mp"].keyframes.values())

    # the closer's own call, in float64 on both sides
    (pargs, _, _), = loops["port"]["log"]["viba"]
    p64 = sin._cast(pargs[0], torch.float64)
    r64 = sin.optimize_vi_ba_plain(p64, cam, n_iters=7, cg_iters=40)
    with jax.enable_x64(True):
        j64 = jsin.optimize_vi_ba(jax_viba(p64), jproject, n_iters=7, cg_iters=40)
        for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
            assert np.asarray(getattr(j64, f)).dtype == np.float64
            np.testing.assert_allclose(getattr(r64, f).numpy(), np.asarray(getattr(j64, f)),
                                       atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(r64.inliers.numpy(), np.asarray(j64.inliers))
    first64 = float(sin.optimize_vi_ba_plain(p64, cam, n_iters=1, cg_iters=40).cost)
    first32 = float(sin.optimize_vi_ba_plain(pargs[0], cam, n_iters=1, cg_iters=40).cost)
    assert np.isfinite(first64) and np.isnan(first32)
    assert float(r64.cost) < first64


def merge_run(pkg, m):
    """The return pass as a second Atlas map in a turned and moved world,
    welded into the first by the closer.  Returns (atlas, closer, merge
    info, the seam window's keyframe ids, inertial weld calls)."""
    SM, KF, feats = KIND[pkg]
    atlas = (JAtlas if pkg == "jax" else Atlas)()
    keep = atlas.current
    atlas.create_new_map()
    drop = atlas.current
    _, _, desc, _ = pf.build_looped_map(0, SM, KF, feats, return_shift=SHIFT, inertial=True,
                                        preintegrate=integrator(pkg), maps=(keep, drop))
    pf.move_world(drop, pf.so3_exp_np([0.0, 0.0, 0.3]), np.array([0.4, -0.2, 0.05]))
    welds = []
    spy(m, jmg if pkg == "jax" else mg, "weld_inertial_bundle_adjustment", welds)
    cl = closer(pkg, desc, inv_sigma2=(1.0,) * 8)
    for kid in sorted(keep.keyframes):
        assert not cl.process_keyframe(keep, kid, atlas=atlas)
    info = None
    for n, kid in enumerate(sorted(drop.keyframes)):
        # the first keyframes of the new map enter the database only, so the
        # weld's temporal window holds three of them
        info = cl.process_keyframe(drop, kid, atlas=atlas if n >= 2 else None)
        if info:
            break
    return atlas, cl, info, welds


def test_inertial_merge_matches_jax():
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        ja, jcl, jinfo, jwelds = merge_run("jax", m)
        pa, pcl, pinfo, pwelds = merge_run("port", m)
    assert jinfo and pinfo and pinfo["kf_cur"] == jinfo["kf_cur"]
    assert pcl.n_merges == jcl.n_merges == 1 and len(pa.maps) == len(ja.maps) == 1
    assert len(jwelds) == len(pwelds) == 1 and bool(pwelds[0][1]) and bool(jwelds[0][1])
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
