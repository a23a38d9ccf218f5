"""The device mesh of the port (``extractorb_tpu_torch/dist/``) against the
JAX package's ``dist/`` on its virtual 8-device CPU mesh.

The port's mesh is one process driving an ordered list of devices; here
``use_devices([cpu] * 8)`` gives it the JAX suite's eight shards.  The same
seeded numpy inputs go through both: the dense place scores (K29's plain
version) within 1e-5 with the counts and the -inf rows equal, the
covisibility gather bit-equal, a keyframe database with the device backend
against JAX's with it and against the port's host pass (the same ids,
scores within 1e-5, after an erase and a rekey), ``relayout_for_schur``
bit-equal on 4 and 8 shards, the landmark-sharded Schur GBA on
``make_mesh(4)`` within 1e-3 of ``optimize_schur_sharded`` and of the
port's one-shard solve, and the edge-sharded essential graph on 8 shards
within 1e-4 of JAX's, both ways of ``fix_scale``.  On a card, K29, K30 and
K31 hold to their plain versions over shards that share the card, and K30
and K31 give one result over 20 calls on one input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from extractorb_tpu.dist import kf_blocks as jkfb
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu.dist import sharded_pose_graph as jspg
from extractorb_tpu.place.database import KeyFrameDatabase as JDatabase
from extractorb_tpu.solver import ba as jba
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.dist import kf_blocks as kfb
from extractorb_tpu_torch.dist import mesh as dmesh
from extractorb_tpu_torch.dist import sharded_ba, sharded_pose_graph
from extractorb_tpu_torch.place.database import KeyFrameDatabase
from extractorb_tpu_torch.slam import imu_frontend
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap
import port_fixtures as pf
from test_torch_inertial_loop import CALIB, integrator
from test_torch_loop_closing import tfeats
from test_torch_sim3 import CAM, gba_problem, jproject
from test_torch_vocab import groups, vocabs  # noqa: F401  (pytest fixture)
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def j(a):
    return jnp.asarray(a.numpy())


# ------------------------------------------------------------------ mesh


def test_mesh_devices_and_shard_sum():
    assert dmesh.make_mesh(device="cpu").devices == (CPU,)
    with dmesh.use_devices(CPU8):
        m = dmesh.make_mesh()
        assert m.shape == {"shard": 8} and m.size == 8 and m.devices == tuple(CPU8)
        assert dmesh.make_mesh(4).shape == {"shard": 4}
        with dmesh.use_devices([CPU] * 2):
            assert dmesh.make_mesh().size == 2
        assert dmesh.make_mesh().size == 8
    assert dmesh.make_mesh(device="cpu").size == 1
    # shard order: shard 0 first, the sum of float32 partials in that order
    parts = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
             torch.tensor([-1e8])]
    assert float(dmesh.shard_sum(parts)) == float((parts[0] + parts[1]) + parts[2]) == 0.0
    x = torch.ones(3)
    assert dmesh.shard_sum([x]) is x


# ------------------------------------------------- keyframe blocks (K29)


def place_inputs():
    """tests/test_dist_ba.py:156-166's inputs (the last three rows invalid),
    and one row with no word of the query's."""
    hists, has_word, valid, q = chip_smoke.place_problem(np.random.default_rng(0), 24, 64)
    q[has_word[7]] = 0.0
    return hists, has_word, valid, q


@pytest.mark.parametrize("K", [24, 21])
def test_place_scores_match_jax(K):
    """K29's plain version against JAX's on 8 shards; K = 21 is padded to
    the mesh (the padded rows invalid)."""
    hists, has_word, valid, q = place_inputs()
    hists, has_word, valid = (kfb.pad_to_mesh(a[:K], 8) for a in (hists, has_word, valid))
    jm = jmesh.make_mesh(8)
    js, jc = jkfb.sharded_place_scores(jm, *[jkfb.shard_kf_axis(jm, jnp.asarray(a))
                                             for a in (hists, has_word, valid)], jnp.asarray(q))
    with dmesh.use_devices(CPU8):
        m = dmesh.make_mesh()
        blocks = [kfb.shard_kf_axis(m, a) for a in (hists, has_word, valid)]
        assert [b.shape[0] for b in blocks[0]] == [3] * 8
        ts, tc = kfb.sharded_place_scores(m, *blocks, torch.from_numpy(q))
        ps, pc = kfb.sharded_place_scores_plain(m, *blocks, torch.from_numpy(q))
    ts, tc, js, jc = kfb.gather_host(ts), kfb.gather_host(tc), np.asarray(js), np.asarray(jc)
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))
    np.testing.assert_array_equal(np.isinf(ts), ~valid)
    np.testing.assert_allclose(ts[valid], js[valid], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc, jc)
    assert tc[7] == 0 and tc.dtype == np.int32
    assert np.array_equal(kfb.gather_host(ps), ts) and np.array_equal(kfb.gather_host(pc), tc)
    assert int(np.argmax(ts)) == 5


def test_place_launch_plan():
    """K29's launches: one per device, its shards in shard order with their
    rows' offsets into one allocation; more than 64 shards of one device in
    groups of 64.  On a mesh of CPU devices the plan is one entry, and the
    scores come back per shard as the plain version's."""
    with dmesh.use_devices(CPU8):
        m = dmesh.make_mesh()
        assert kfb.place_launch_plan(m.devices, [3] * 8) == [
            (CPU, [(s, 3 * s) for s in range(8)], 24)]
        hists, has_word, valid, q = place_inputs()
        blocks = [kfb.shard_kf_axis(m, a) for a in (hists, has_word, valid)]
        ts, tc = kfb.sharded_place_scores(m, *blocks, torch.from_numpy(q))
    assert [t.shape[0] for t in ts] == [c.shape[0] for c in tc] == [3] * 8
    for s in range(8):
        ps, pc = kfb.place_scores_plain(blocks[0][s], blocks[1][s], blocks[2][s],
                                        torch.from_numpy(q))
        assert torch.equal(ts[s], ps) and torch.equal(tc[s], pc)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert kfb.place_launch_plan([c0, c1, c0, CPU, c1], [4, 4, 5, 4, 0]) == [
        (c0, [(0, 0), (2, 4)], 9), (c1, [(1, 0), (4, 4)], 4), (CPU, [(3, 0)], 4)]
    plan = kfb.place_launch_plan([c0] * 130, [2] * 130)
    assert [(d, len(items), total) for d, items, total in plan] == [
        (c0, 64, 128), (c0, 64, 128), (c0, 2, 4)]
    assert plan[1][1][:2] == [(64, 0), (65, 2)] and plan[2][1] == [(128, 0), (129, 2)]


def test_all_gather_kf_blocks_bit_equal():
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 256, (24, 32, 32), np.uint8)
    idx = np.array([5, 17, 2, 23, 0], np.int32)
    jm = jmesh.make_mesh(8)
    want = np.asarray(jkfb.all_gather_kf_blocks(jm, jkfb.shard_kf_axis(jm, jnp.asarray(desc)),
                                                jnp.asarray(idx)))
    with dmesh.use_devices(CPU8):
        m = dmesh.make_mesh()
        got = kfb.all_gather_kf_blocks(m, kfb.shard_kf_axis(m, desc), torch.from_numpy(idx))
    assert len(got) == 8
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)
    np.testing.assert_array_equal(want, desc[idx])


@pytest.mark.parametrize("mode", ["plain", "covis", "reloc", "min-score"])
def test_database_device_backend(vocabs, mode):
    """tests/test_place_sharded.py for the port: JAX's database with its
    device backend on 8 devices, the port's on 8 CPU shards and the port's
    host pass, after an erase and a rekey, in every query mode."""
    _, jv, tv = vocabs
    rng = np.random.default_rng(7)
    kfs, covis = groups(18, rng)
    jdb, tdb, hdb = JDatabase(jv), KeyFrameDatabase(tv, device="cpu"), \
        KeyFrameDatabase(tv, device="cpu")
    jdb.enable_device_backend(jmesh.make_mesh(8))
    with dmesh.use_devices(CPU8):
        tdb.enable_device_backend(dmesh.make_mesh())
    for i, d in enumerate(kfs):
        valid = rng.random(400) < 0.95
        for db in (jdb, tdb, hdb):
            db.add(i, d, valid)
    q = kfs[2].copy()
    q[rng.random(400) < 0.2] = rng.integers(0, 256, 32, dtype=np.uint8)
    assert tdb.query(q, n_best=5)   # the arena before the mutations
    for db in (jdb, tdb, hdb):
        db.erase(5)
        db.rekey(6, 60)
    kw = {"plain": dict(exclude={2}, n_best=5),
          "covis": dict(exclude={2, 3}, n_best=3, covis_fn=covis),
          "reloc": dict(n_best=5, covis_fn=covis, rel_score_ratio=0.75),
          "min-score": dict(exclude={2}, covis_fn=covis,
                            min_score=jdb.min_score_against([10, 14, 99], q))}[mode]
    jr, tr, hr = jdb.query(q, **kw), tdb.query(q, **kw), hdb.query(q, **kw)
    assert jr and [k for k, _ in tr] == [k for k, _ in jr] == [k for k, _ in hr]
    for other in (jr, hr):
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in other], rtol=0, atol=1e-5)
    assert tdb._dev_arena[0][0].shape[0] == 3   # 17 entries padded to 24 rows on 8 shards


def test_unported_refusals(monkeypatch):
    """The three functions the mesh lacked run on 4 CPU shards (they are
    held to JAX in tests/test_torch_dist_vi.py and
    tests/test_torch_inertial_loop_mesh.py): the full inertial BA of a small
    inertial map goes through ``optimize_vi_sharded``.  The sharded BAs
    once refused the stereo residual: ``optimize_sharded`` and
    ``optimize_schur`` now ignore ``obs_ur`` as JAX does (ROADMAP C.2),
    bit for bit their results without it."""
    with dmesh.use_devices([CPU] * 4):
        m = dmesh.make_mesh()
        desc = np.random.default_rng(2).integers(0, 256, (8, 16, 32), np.uint8)
        counts = kfb.sharded_loop_candidate_match(
            m, kfb.shard_kf_axis(m, desc), kfb.shard_kf_axis(m, np.ones((8, 16), bool)),
            torch.from_numpy(desc[5]), torch.ones(16, dtype=torch.bool))
        assert int(np.argmax(kfb.gather_host(counts))) == 5
        p = gba_problem()
        p = p._replace(**{f: getattr(p, f)[:p.obs_kf.shape[0] // 4 * 4]
                          for f in ("obs_kf", "obs_mp", "obs_uv", "inv_sigma2", "obs_valid")})
        res = sharded_ba.optimize_sharded(m, p, CAM, n_iters=2, cg_iters=5)
        assert bool(torch.isfinite(res.points).all()) and res.inliers.shape == p.obs_kf.shape
        ps = p._replace(obs_ur=p.obs_uv[:, 0] - 5.0)
        st = sharded_ba.optimize_sharded(m, ps, CAM, n_iters=2, cg_iters=5)
        assert all(torch.equal(a, b) for a, b in zip(st, res))
        calls = []
        real = sharded_ba.optimize_vi_sharded
        monkeypatch.setattr(sharded_ba, "optimize_vi_sharded",
                            lambda *a, **k: calls.append(a) or real(*a, **k))
        mp = pf.build_looped_map(0, SLAMMap, KeyFrame, tfeats, n_kf=6, n_pts=80, inertial=True,
                                 preintegrate=integrator("port"))[0]
        imu_frontend.full_inertial_ba(mp, CALIB, CAM, n_iters=2, cg_iters=5, mesh=m,
                                      device="cpu")
        assert len(calls) == 1 and calls[0][0] is m and calls[0][1].points.shape[0] % 4 == 0
        assert all(np.isfinite(kf.t).all() for kf in mp.keyframes.values())
        mono = sharded_ba.optimize_schur(p, CAM, n_iters=2, cg_iters=5)
        st = sharded_ba.optimize_schur(ps, CAM, n_iters=2, cg_iters=5)
        assert all(torch.equal(a, b) for a, b in zip(st, mono))


# ------------------------------------------------------ landmark-sharded GBA


def jprob(p):
    return jba.BAProblem(*[j(a) for a in p[:10]])


@pytest.mark.parametrize("n", [4, 8])
def test_relayout_for_schur_bit_equal(n):
    p = gba_problem()
    t = sharded_ba.relayout_for_schur(p, n)
    jr = jsba.relayout_for_schur(jprob(p), n)
    for name in jba.BAProblem._fields:
        a, b = getattr(t, name), getattr(jr, name)
        if b is None:   # the stereo column
            assert a is None
            continue
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert t.obs_kf.shape[0] % (128 * n) == 0 and t.points.shape[0] % n == 0


@pytest.fixture(scope="module")
def schur4():
    p = sharded_ba.relayout_for_schur(gba_problem(), 4)
    with dmesh.use_devices(CPU8):
        r = sharded_ba.optimize_schur(p, CAM, mesh=dmesh.make_mesh(4))
    return p, r


def test_sharded_schur_matches_jax(schur4):
    p, r = schur4
    jr = jsba.optimize_schur_sharded(jmesh.make_mesh(4), jprob(p), jproject)
    # JAX rebuilds the shard problems without obs_ur: a stereo column changes nothing
    jst = jsba.optimize_schur_sharded(jmesh.make_mesh(4), jprob(p)._replace(
        obs_ur=j(p.obs_uv[:, 0] - 5.0)), jproject)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jst, jr))
    for name in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(r, name).numpy(), np.asarray(getattr(jr, name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(jr.inliers))
    assert float(r.cost) == pytest.approx(float(jr.cost), rel=1e-3)


def test_sharded_schur_matches_one_shard(schur4):
    p, r = schur4
    one = sharded_ba.optimize_schur(p, CAM)
    for name in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(r, name).numpy(), getattr(one, name).numpy(),
                                   atol=1e-3, err_msg=name)
    assert torch.equal(r.inliers, one.inliers)
    assert float(r.cost) == pytest.approx(float(one.cost), rel=1e-3)
    assert float(r.cost) < 0.9 * float(sharded_ba.optimize_schur(p, CAM, n_iters=0).cost)


# ------------------------------------------------------ edge-sharded graph


def padded_graph(n: int, dev=CPU):
    """chip_smoke.pose_graph_problem(K=40) padded with invalid edges to a
    multiple of n."""
    return chip_smoke.pad_graph(chip_smoke.pose_graph_problem(np.random.default_rng(9), dev,
                                                              K=40), n)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sharded_pose_graph_matches_jax(fix_scale):
    p = padded_graph(8)
    with dmesh.use_devices(CPU8):
        R, t, s, c = sharded_pose_graph.optimize_sharded_pose_graph(dmesh.make_mesh(), p,
                                                                    fix_scale=fix_scale)
    jR, jt, js, jc = jspg.optimize_sharded_pose_graph(
        jmesh.make_mesh(8), jpg.PoseGraphProblem(*[j(a) for a in p]), fix_scale=fix_scale)
    for a, b in ((R, jR), (t, jt), (s, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert float(c) == pytest.approx(float(jc), rel=1e-3)
    if fix_scale:
        assert torch.equal(s, torch.ones_like(s))


# ------------------------------------------------------ card (K29-K31)


# K29's card cases: (keyframes, words); "ragged-rows" gives some CTAs 9
# rows (the grid is one CTA a multiple-processor, the tile 8 rows), and a
# CTA rows of two shards
PLACE_CASES = {"test-size": (24, 64), "odd-width": (24, 1003), "ragged-rows": (1101, 256),
               "two-devices": (24, 64), "20-calls": (1101, 8192)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PLACE_CASES))
def test_place_kernel_matches_plain(cuda_device, case):
    """K29 against its plain version on 4 shards, one launch per card and
    query: at the test size, with W % 16 != 0 (every row and q on the plain
    loads), with rows that do not fill the tiles, with the shards split over
    two devices of a mesh (the card and a second card, else the CPU), and
    20 calls on one input giving one result."""
    K, W = PLACE_CASES[case]
    if case == "test-size":
        hists, has_word, valid, q = place_inputs()
    else:
        hists, has_word, valid, q = chip_smoke.place_problem(np.random.default_rng(2), K, W)
    other = torch.device("cuda", 1) if torch.cuda.device_count() > 1 else CPU
    devs = [cuda_device, other] * 2 if case == "two-devices" else [cuda_device] * 4
    with dmesh.use_devices(devs):
        m = dmesh.make_mesh()
        blocks = [kfb.shard_kf_axis(m, kfb.pad_to_mesh(a, 4)) for a in (hists, has_word, valid)]
        n0 = kernels.LAUNCHES["place_dense"]
        ks, kc = kfb.sharded_place_scores(m, *blocks, torch.from_numpy(q))
        assert kernels.LAUNCHES["place_dense"] - n0 == len({d for d in devs if d.type == "cuda"})
        assert [s.device for s in ks] == [c.device for c in kc] == list(m.devices)
        ps, pc = kfb.sharded_place_scores_plain(m, *blocks, torch.from_numpy(q))
        for _ in range(19 if case == "20-calls" else 0):
            s2, c2 = kfb.sharded_place_scores(m, *blocks, torch.from_numpy(q))
            assert all(torch.equal(a, b) for a, b in zip(s2 + c2, ks + kc))
    ok = kfb.gather_host(blocks[2])
    ks, ps = kfb.gather_host(ks), kfb.gather_host(ps)
    np.testing.assert_array_equal(np.isinf(ks), np.isinf(ps))
    np.testing.assert_array_equal(np.isinf(ks), ~ok)
    np.testing.assert_allclose(ks[ok], ps[ok], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(kfb.gather_host(kc), kfb.gather_host(pc))


@pytest.mark.gpu
def test_sharded_kernels_match_plain(cuda_device):
    p = sharded_ba.relayout_for_schur(gba_problem(cuda_device), 4)
    pg_ = padded_graph(4, cuda_device)
    with dmesh.use_devices([cuda_device] * 4):
        m = dmesh.make_mesh()
        bk = sharded_ba.optimize_schur(p, CAM, mesh=m)
        bp = sharded_ba.optimize_schur_plain(p, CAM, mesh=m)
        gk = sharded_pose_graph.optimize_sharded_pose_graph(m, pg_)
        gp = sharded_pose_graph.optimize_sharded_pose_graph_plain(m, chip_smoke.graph_f64(pg_))
    for name in ("R", "t", "points"):
        assert float((getattr(bk, name) - getattr(bp, name)).abs().max()) <= 1e-3, name
    assert torch.equal(bk.inliers, bp.inliers)
    for a, b in zip(gk[:3], gp[:3]):
        assert float((a.double() - b).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_sharded_kernels_deterministic(cuda_device):
    """K30 and K31 with fixed-order sums over 4 shards of one card: 20 calls
    on one input, one result each."""
    p = sharded_ba.relayout_for_schur(gba_problem(cuda_device), 4)
    pg_ = padded_graph(4, cuda_device)
    with dmesh.use_devices([cuda_device] * 4):
        m = dmesh.make_mesh()
        b0 = sharded_ba.optimize_schur(p, CAM, mesh=m)
        g0 = sharded_pose_graph.optimize_sharded_pose_graph(m, pg_)
        for _ in range(19):
            b = sharded_ba.optimize_schur(p, CAM, mesh=m)
            assert all(torch.equal(getattr(b, f), getattr(b0, f)) for f in b._fields)
            g = sharded_pose_graph.optimize_sharded_pose_graph(m, pg_)
            assert all(torch.equal(x, y) for x, y in zip(g, g0))
