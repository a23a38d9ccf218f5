"""Loop closing of the port over a device mesh against its one-shard run and
against the JAX package's on its virtual 8-device CPU mesh, on the
constructed map of ``tests/test_loop_closing.py``
(``port_fixtures.build_looped_map``, the return pass half a step off).

The port's ``LoopCloser`` runs under ``use_devices([cpu] * 8)`` with
``sharded_graph_min_edges`` 1 and its database's device backend: the
places scored by dense histograms on 8 shards, the essential graph solved
edge-sharded (its edges padded to a multiple of 8) and the post-loop GBA
dispatched over 8 landmark shards; the JAX closer the same on its 8
devices (``tests/test_sharded_loop_graph.py``'s threshold of 1).  The loop
closes at the keyframe pair of the port's one-shard run and of JAX's,
with the keyframe centres and rotations at the loop event within 2e-3 of
the one-shard run's (the JAX test's tolerance), and the GBA it dispatched
applies at ``finish`` with its cost at float32 rounding; its distance from
JAX's one-device solve is within the spread a one-ulp move of the points
gives JAX's own solve (ROADMAP C.9).  Against JAX the
graph is checked as
``tests/test_torch_loop_closing.py`` does: the port's edges are JAX's plus
the reference's LoopConnections edges measured with the corrected poses
(ROADMAP C), and JAX's edge-sharded solver on the port's graph gives the
port's corrected poses.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu.dist import sharded_pose_graph as jspg
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam.map import KeyFrame as JKeyFrame
from extractorb_tpu.slam.map import SLAMMap as JSLAMMap
from extractorb_tpu.solver import ba as jba
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import global_ba, kf_blocks
from extractorb_tpu_torch.dist import mesh as dmesh
from extractorb_tpu_torch.dist import sharded_pose_graph as dpg
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap
from test_torch_loop_closing import FX, CX, CY, SHIFT, THRESHOLDS, edges_of, jfeats, jproject, \
    tfeats
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

CPU8 = [torch.device("cpu")] * 8


def spy(m, module, name, log):
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        res = real(*args, **kwargs)
        log.append((args, kwargs, res))
        return res
    m.setattr(module, name, wrapped)


def close_loop(mp, closer):
    for kid in sorted(mp.keyframes):
        if closer.process_keyframe(mp, kid):
            return kid
    return None


def port_run(devices):
    """The port's closer on the CPU over ``devices`` (None: one shard,
    the default threshold, the host database) until a loop closes; the
    GBA applied at ``finish``.  Returns the keyframes' poses before
    ``finish``, the map after it, the closing keyframe and the calls of
    the sharded paths."""
    log = {"graph": [], "sharded_graph": [], "gba": [], "places": []}
    with pytest.MonkeyPatch.context() as m, \
            (dmesh.use_devices(devices) if devices else contextlib.nullcontext()):
        patch_jax_draws(m)
        spy(m, lc.pg, "optimize_pose_graph", log["graph"])
        spy(m, dpg, "optimize_sharded_pose_graph", log["sharded_graph"])
        spy(m, global_ba, "optimize_schur", log["gba"])
        spy(m, kf_blocks, "sharded_place_scores", log["places"])
        mp, _, desc, _ = pf.build_looped_map(0, SLAMMap, KeyFrame, tfeats, return_shift=SHIFT)
        voc = interop.vocab_from_numpy(interop.vocab_to_numpy(
            JVocabulary.train(desc, k=8, L=3, seed=0)))
        closer = lc.LoopCloser(voc, Pinhole(FX, FX, CX, CY),
                               thresholds=lc.LoopThresholds(**THRESHOLDS), device="cpu")
        if devices:
            closer.sharded_graph_min_edges = 1
            closer.db.enable_device_backend(dmesh.make_mesh())
        kid = close_loop(mp, closer)
        before = {k: (kf.R.copy(), kf.t.copy()) for k, kf in mp.keyframes.items()}
        n_gba = closer.n_gba_applied
        closer.finish(mp)
    return dict(mp=mp, before=before, kid=kid, closer=closer, log=log,
                gba_applied=closer.n_gba_applied - n_gba)


@pytest.fixture(scope="module")
def runs():
    out = {"mesh": port_run(CPU8), "one": port_run(None)}
    graphs = []
    with pytest.MonkeyPatch.context() as m:
        spy(m, jspg, "optimize_sharded_pose_graph", graphs)
        mp, _, desc, _ = pf.build_looped_map(0, JSLAMMap, JKeyFrame, jfeats, return_shift=SHIFT)
        closer = jlc.LoopCloser(JVocabulary.train(desc, k=8, L=3, seed=0), jproject,
                                thresholds=jlc.LoopThresholds(**THRESHOLDS))
        closer.sharded_graph_min_edges = 1
        closer.db.enable_device_backend(jmesh.make_mesh(8))
        out["jax"] = dict(mp=mp, kid=close_loop(mp, closer), closer=closer, graphs=graphs)
    return out


def centre(R, t):
    return -R.T @ t


def test_mesh_run_takes_the_sharded_paths(runs):
    log = runs["mesh"]["log"]
    assert log["places"] and all(a[0].size == 8 for a, _, _ in log["places"])
    assert not log["graph"] and len(log["sharded_graph"]) == 1
    (mesh, prob), _, _ = log["sharded_graph"][0]
    E = int(prob.edge_valid.sum())
    assert mesh.size == 8 and prob.edge_i.shape[0] == -(-E // 8) * 8
    assert len(log["gba"]) == 1 and log["gba"][0][1]["mesh"].size == 8
    gprob = log["gba"][0][0][0]
    assert gprob.points.shape[0] % 8 == 0 and gprob.obs_kf.shape[0] % (8 * 128) == 0
    assert runs["mesh"]["gba_applied"] == 1
    one = runs["one"]["log"]
    assert not one["places"] and not one["sharded_graph"] and len(one["graph"]) == 1
    assert one["gba"][0][1]["mesh"].size == 1


def test_mesh_closes_as_one_shard(runs):
    """The same loop as the one-shard run, the corrected keyframes within
    2e-3.  The GBA applied at ``finish`` ends at float32 rounding on this
    self-consistent map (cost ~1e-6 over ~2000 observations), where its
    poses are not unique: a one-ulp move of its points moves JAX's own
    solve by ~7e-2 (``test_gba_distance_from_jax_within_one_ulp_witness``,
    ROADMAP C.9), so after it only the costs are held."""
    a, b = runs["mesh"], runs["one"]
    assert a["kid"] is not None and a["kid"] == b["kid"]
    assert a["closer"].n_loops == b["closer"].n_loops == 1
    pair = lambda r: (r["kid"], r["mp"].keyframes[r["kid"]].loop_edges[-1])
    assert pair(a) == pair(b)
    assert set(a["before"]) == set(b["before"])
    for k in a["before"]:
        (Ra, ta), (Rb, tb) = a["before"][k], b["before"][k]
        np.testing.assert_allclose(centre(Ra, ta), centre(Rb, tb), atol=2e-3)
        np.testing.assert_allclose(Ra, Rb, atol=2e-3)
    for r in (a, b):
        res = r["log"]["gba"][0][2]
        assert r["gba_applied"] == 1 and float(res.cost) < 1e-4


def test_gba_distance_from_jax_within_one_ulp_witness(runs):
    """ROADMAP C.9, closed by this witness.  The one-shard run's GBA problem
    (10 LM steps) solved by JAX's ``optimize_schur_sharded`` on one device,
    and again with every free point moved up by one float32 ulp: the map
    is self-consistent (cost ~1e-6 at the end) and its float32 solve is
    ill-conditioned, so the LM accept decisions part with rounding (JAX
    accepts at step 3 where the port rejects; both end at rounding).
    JAX's own one-ulp spread in the poses (~6.9e-2) reaches the port's
    distance from JAX (~4.5e-2), so the port is held to it by that bound
    and both costs at rounding."""
    (args, kw, res), = runs["one"]["log"]["gba"]
    p = args[0]
    jm = jmesh.make_mesh(1)

    def jax_gba(points):
        q = p._replace(points=points)
        return jsba.optimize_schur_sharded(jm, jba.BAProblem(*[jnp.asarray(a.numpy())
                                                              for a in q[:10]]),
                                           jproject, n_iters=kw["n_iters"])

    free = ~p.fixed_mp
    nudged = p.points.clone()
    nudged[free] = torch.nextafter(nudged[free], torch.tensor(float("inf")))
    j0, j1 = jax_gba(p.points), jax_gba(nudged)
    dist = lambda R, t, j: max(float(np.abs(np.asarray(R) - np.asarray(j.R)).max()),
                               float(np.abs(np.asarray(t) - np.asarray(j.t)).max()))
    port, witness = dist(res.R.numpy(), res.t.numpy(), j0), dist(j1.R, j1.t, j0)
    assert 0.0 < port <= witness, (port, witness)
    assert max(float(res.cost), float(j0.cost), float(j1.cost)) < 1e-4


def test_mesh_closes_as_jax(runs):
    """JAX's closer with its sharded graph and dense places: the same
    closing keyframe; the port's graph is JAX's plus the LoopConnections
    edges, and JAX's edge-sharded solver gives the port's poses."""
    a, jx = runs["mesh"], runs["jax"]
    assert jx["kid"] is not None and a["kid"] == jx["kid"]
    assert jx["closer"].n_loops == 1 and len(jx["graphs"]) == 1
    (jmesh8, jprob), _, _ = jx["graphs"][0]
    (_, tprob), _, (tR, tt, ts, _) = a["log"]["sharded_graph"][0]
    je, te = edges_of(jprob), edges_of(tprob)
    R0, t0 = tprob.R.numpy(), tprob.t.numpy()
    extra = 0
    for key, (Rm, tm_, _) in te.items():
        got = je.get(key) or je.get(key[::-1])
        if got is not None and np.allclose(Rm, got[0], atol=1e-6) and \
                np.allclose(tm_, got[1], atol=1e-6):
            continue
        i, j = key
        np.testing.assert_allclose(Rm, R0[j] @ R0[i].T, atol=1e-5)
        np.testing.assert_allclose(tm_, t0[j] - Rm @ t0[i], atol=1e-5)
        extra += 1
    assert extra > 0 and all(k in te or k[::-1] in te for k in je)
    jR, jt, js, _ = jspg.optimize_sharded_pose_graph(
        jmesh8, jpg.PoseGraphProblem(*[jnp.asarray(x.numpy()) for x in tprob]), n_iters=15)
    for x, y in ((tR, jR), (tt, jt), (ts, js)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)
    for i, k in enumerate(sorted(a["before"])):
        R, t = a["before"][k]
        np.testing.assert_allclose(R, np.asarray(jR[i]), atol=1e-3)
        np.testing.assert_allclose(t, np.asarray(jt[i]) / float(js[i]), atol=1e-3)
