"""Loop closing of the port (``extractorb_tpu_torch/slam/loop_closing.py``)
against the JAX package's, on the constructed map of
``tests/test_loop_closing.py`` (``port_fixtures.build_looped_map``).

Both packages build the same map from the same seed and run their
``LoopCloser`` keyframe by keyframe with the same trained vocabulary; the
port draws its Sim3 RANSAC sets as JAX does from the same seeds
(``depth_system.patch_jax_draws``).  A true
loop closes on the same keyframe in both, with the same number of map
points left after the duplicates are fused.  The port's essential graph
is JAX's plus the reference's LoopConnections edges, which the JAX graph
lacks (ROADMAP C): the test checks that every other edge is JAX's, that
the extra ones are measured with the corrected poses, and that JAX's
``optimize_pose_graph`` solving the port's graph gives the port's
corrected keyframe poses within 1e-3.  With those edges the port keeps
the correction of the closing keyframe that the JAX graph partly undoes.
The port's dispatched GBA applies at ``finish``.  A loop of scrambled
geometry closes in neither.

The return pass runs half a step off the outbound one
(``return_shift``): where two keyframes coincide the Sim3 scale between
them is not observable, and float32 rounding, which differs between the
packages, decides the refined scale.
"""

import jax.numpy as jnp
import numpy as np
import torch

import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.frontend.extractor import Features as JFeatures
from extractorb_tpu.place.vocab import Vocabulary as JVocabulary
from extractorb_tpu.slam import loop_closing as jlc
from extractorb_tpu.slam.map import KeyFrame as JKeyFrame
from extractorb_tpu.slam.map import SLAMMap as JSLAMMap
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.slam import loop_closing as lc
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

FX, CX, CY = 500.0, 320.0, 240.0
SHIFT = 0.15
THRESHOLDS = dict(n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60)


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


def scramble(mp, rng):
    """Permute the return pass's duplicate landmarks: the same appearance,
    geometry consistent with no Sim3 (tests/test_loop_closing.py:148)."""
    ids = [p for p in range(mp._next_mp) if mp.mp_valid[p] and mp.obs.get(p)
           and min(mp.obs[p]) >= len(mp.keyframes) // 2]
    mp.mp_pos[ids] = mp.mp_pos[ids][rng.permutation(len(ids))]
    for p in ids:
        mp.update_point_stats(p)


def spy(monkeypatch, module, got: list):
    """Record each ``optimize_pose_graph`` call's problem and result."""
    real = module.optimize_pose_graph

    def wrapped(prob, *args, **kwargs):
        res = real(prob, *args, **kwargs)
        got.append((prob, res))
        return res
    monkeypatch.setattr(module, "optimize_pose_graph", wrapped)


def run_both(monkeypatch, scrambled: bool):
    """Both closers over the keyframes of the same map until one closes;
    returns the (map, closer, closing keyframe or None, essential-graph
    calls) of each package."""
    out = []
    for SM, KF, feats, pkg in ((JSLAMMap, JKeyFrame, jfeats, "jax"),
                               (SLAMMap, KeyFrame, tfeats, "port")):
        mp, _, desc, _ = pf.build_looped_map(0, SM, KF, feats, return_shift=SHIFT)
        if scrambled:
            scramble(mp, np.random.default_rng(1))
        graphs = []
        if pkg == "jax":
            spy(monkeypatch, jpg, graphs)
            closer = jlc.LoopCloser(JVocabulary.train(desc, k=8, L=3, seed=0), jproject,
                                    thresholds=jlc.LoopThresholds(**THRESHOLDS))
        else:
            patch_jax_draws(monkeypatch)
            spy(monkeypatch, lc.pg, graphs)
            voc = interop.vocab_from_numpy(interop.vocab_to_numpy(JVocabulary.train(desc, k=8,
                                                                                    L=3, seed=0)))
            closer = lc.LoopCloser(voc, Pinhole(FX, FX, CX, CY),
                                   thresholds=lc.LoopThresholds(**THRESHOLDS), device="cpu")
        closed = None
        for kid in sorted(mp.keyframes):
            if closer.process_keyframe(mp, kid):
                closed = kid
                break
        out.append((mp, closer, closed, graphs))
    return out


def edges_of(prob):
    """{(i, j): (m_R, m_t, weight)} of a pose-graph problem's valid edges."""
    a = [np.asarray(x) for x in (prob.edge_i, prob.edge_j, prob.m_R, prob.m_t, prob.weight,
                                 prob.edge_valid)]
    return {(int(i), int(j)): (R, t, float(w)) for i, j, R, t, w, v in zip(*a) if v}


def test_loop_close_constructed(monkeypatch):
    (jm, jcl, jk, jg), (tm, tcl, tk, tg) = run_both(monkeypatch, scrambled=False)
    assert jk is not None and tk == jk
    assert tcl.n_loops == jcl.n_loops == 1
    assert int(tm.mp_valid.sum()) == int(jm.mp_valid.sum()) < tm._next_mp
    # one essential graph each: the port's is JAX's plus LoopConnections
    # edges measured with the corrected poses (the graph's start poses)
    assert len(jg) == len(tg) == 1
    (jprob, _), (tprob, (tR, tt, ts, _)) = jg[0], tg[0]
    je, te = edges_of(jprob), edges_of(tprob)
    R0, t0 = tprob.R.numpy(), tprob.t.numpy()
    extra = 0
    for key, (Rm, tm_, w) in te.items():
        got = je.get(key) or je.get(key[::-1])
        if got is not None and np.allclose(Rm, got[0], atol=1e-6) and \
                np.allclose(tm_, got[1], atol=1e-6):
            continue
        i, j = key
        np.testing.assert_allclose(Rm, R0[j] @ R0[i].T, atol=1e-5)
        np.testing.assert_allclose(tm_, t0[j] - Rm @ t0[i], atol=1e-5)
        extra += 1
    assert extra > 0
    assert all(k in te or k[::-1] in te for k in je)
    # JAX's solver on the port's graph gives the port's corrected poses
    jprob_t = jpg.PoseGraphProblem(*[jnp.asarray(a.numpy()) for a in tprob])
    jR, jt, js, _ = jpg.optimize_pose_graph(jprob_t, n_iters=15)
    for a, b in ((tR, jR), (tt, jt), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for i, k in enumerate(sorted(tm.keyframes)):
        # the map's keyframes after the GBA was dispatched (not applied)
        np.testing.assert_allclose(tm.keyframes[k].R, np.asarray(jR[i]), atol=1e-3)
        np.testing.assert_allclose(tm.keyframes[k].t, np.asarray(jt[i]) / float(js[i]),
                                   atol=1e-3)
    assert jk in tm.keyframes[tm.keyframes[jk].loop_edges[0]].loop_edges
    # the drift of the last keyframe shrank; the GBA was dispatched and
    # applies at finish
    centres = pf.build_looped_map(0, SLAMMap, KeyFrame, tfeats, return_shift=SHIFT)[3]
    last = tm.keyframes[max(tm.keyframes)]
    assert np.linalg.norm(-last.R.T @ last.t - centres[last.kid]) < 0.1
    assert tcl.pending_gba is not None and tcl.n_gba_applied == 0
    tcl.finish(tm)
    assert tcl.n_gba_applied == 1 and tcl.pending_gba is None


def test_loop_connections_keep_the_correction(monkeypatch):
    """With the reference's loop-connection edges (measured with the
    corrected poses) the closing keyframe keeps its correction; the JAX
    graph measures the same pairs with its pre-correction pose and pulls
    it back part of the way."""
    (jm, _, jk, _), (tm, tcl, tk, _) = run_both(monkeypatch, scrambled=False)
    assert tk == jk and tcl.n_loops == 1
    centres = pf.build_looped_map(0, SLAMMap, KeyFrame, tfeats, return_shift=SHIFT)[3]
    err = lambda mp: float(np.linalg.norm(-mp.keyframes[jk].R.T @ mp.keyframes[jk].t
                                          - centres[jk]))
    assert err(tm) < 0.005 and err(tm) < 0.5 * err(jm)


def test_false_loop_rejected(monkeypatch):
    (jm, jcl, jk, _), (tm, tcl, tk, _) = run_both(monkeypatch, scrambled=True)
    assert jk is None and tk is None
    assert tcl.n_loops == jcl.n_loops == 0


def test_database_keys():
    key = lc.encode_dbid(3, 17)
    assert key == jlc.encode_dbid(3, 17) and lc.decode_dbid(key) == (3, 17)
