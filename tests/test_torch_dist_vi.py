"""The rest of the port's device mesh (``dist/sharded_ba.py``'s
``relayout_point_sharded``, ``optimize_vi_sharded`` and
``optimize_sharded``, ``dist/kf_blocks.py``'s
``sharded_loop_candidate_match``) against the JAX package on its virtual
8-device CPU mesh.

The port's shards are ``use_devices([cpu] * 8)``; the same seeded numpy
inputs go through both packages.

- ``relayout_point_sharded`` bit-equal to JAX's at 4 and 8 shards, and on a
  problem with padding (points padded to the mesh, invalid observations).
- The plain 8-shard VI BA on ``tests/test_inertial.py::_vi_problem(rng(3),
  n_kf=6, n_pts=128, perturb=1.0)`` within 1e-4 of JAX's
  ``optimize_vi_sharded`` on 8 devices (states and points, inliers equal),
  and within JAX's own 1-against-8 tolerances of the port's one-shard solve
  (``tests/test_dist_ba.py:346-353``); on one shard it is the one-device
  solve, bit for bit.
- The plain 8-shard joint-PCG BA on ``tests/test_dist_ba.py::build_problem``
  with two keyframes fixed within 1e-4 of JAX's ``optimize_sharded``.  As
  JAX builds it, one keyframe fixed, the monocular problem keeps its scale
  free: JAX's own 1-, 2- and 4-device solves part from its 8-device solve
  in translation and points, so the port is held within that spread,
  its rotations within 1e-4, its cost within 1e-5 and its inliers equal.
- The plain candidate match: counts equal to JAX's on
  ``tests/test_dist_ba.py:191``'s case and on seeded cases with tied
  descriptors, masked keyframe rows and masked query rows.
- On a card (``-m gpu``): K32, K33 and K34 against their plain versions on
  4 shards of the card (K32 also through the KB8 camera), K32 and K33 20
  calls on one input for one result.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extractorb_tpu.dist import kf_blocks as jkfb
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu_torch import interop, kernels
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import kf_blocks as kfb
from extractorb_tpu_torch.dist import mesh as dmesh
from extractorb_tpu_torch.dist import sharded_ba
from extractorb_tpu_torch.solver import inertial as sin
from extractorb_tpu_torch.solver.ba import BAProblem
from test_dist_ba import build_problem
from test_inertial import _vi_problem
from test_solver import CX, CY, FX, FY, project
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

CPU8 = [torch.device("cpu")] * 8
NORM = Pinhole(1.0, 1.0, 0.0, 0.0)   # the JAX VI tests' normalised projection
CAM = Pinhole(FX, FY, CX, CY)
OBS = ("obs_kf", "obs_mp", "obs_uv", "inv_sigma2", "obs_valid")
STATES = ("Rwb", "twb", "v", "bg", "ba", "points")


def vi_problem(n_pts: int = 128):
    return _vi_problem(np.random.default_rng(3), n_kf=6, n_pts=n_pts, perturb=1.0)


def padded(prob, n: int, extra_obs: int = 40):
    """``prob`` with ``extra_obs`` invalid observations appended and its
    points padded to a multiple of ``n`` (fixed, at z = 1), as
    ``full_inertial_ba`` pads a bucketed problem for the mesh."""
    P = prob.points.shape[0]
    P_pad = -(-P // n) * n
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:P] = np.asarray(prob.points)
    fmp = np.ones(P_pad, bool)
    fmp[:P] = np.asarray(prob.fixed_mp)
    pad = lambda a, fill: np.concatenate([np.asarray(a), np.full((extra_obs,) + a.shape[1:], fill,
                                                                 np.asarray(a).dtype)])
    return prob._replace(points=jnp.asarray(pts), fixed_mp=jnp.asarray(fmp),
                         obs_kf=jnp.asarray(pad(prob.obs_kf, 0)),
                         obs_mp=jnp.asarray(pad(prob.obs_mp, 0)),
                         obs_uv=jnp.asarray(pad(prob.obs_uv, 0.0)),
                         inv_sigma2=jnp.asarray(pad(prob.inv_sigma2, 1.0)),
                         obs_valid=jnp.asarray(pad(prob.obs_valid, False)))


def relaid(prob, n: int):
    """``prob`` (JAX) in the landmark-sharded layout of n shards, by JAX's
    ``relayout_point_sharded``."""
    out = jsba.relayout_point_sharded(*[np.asarray(getattr(prob, f)) for f in OBS],
                                      prob.points.shape[0], n)
    return prob._replace(**{f: jnp.asarray(a) for f, a in zip(OBS, out)})


# ------------------------------------------------------------- relayout


@pytest.mark.parametrize("n,n_pts", [(4, 128), (8, 128), (8, 123)])
def test_relayout_point_sharded_bit_equal(n, n_pts):
    prob, _, _ = vi_problem(n_pts)
    if n_pts % n:
        prob = padded(prob, n)
    args = [np.asarray(getattr(prob, f)) for f in OBS]
    P = prob.points.shape[0]
    want = jsba.relayout_point_sharded(*args, P, n)
    got = sharded_ba.relayout_point_sharded(*args, P, n)
    for name, a, b in zip(OBS, got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got[0].shape[0] % (128 * n) == 0 and int(got[4].sum()) == int(args[4].sum())
    with pytest.raises(ValueError):
        sharded_ba.relayout_point_sharded(*args, P + 1, n)


# ------------------------------------------------------ the sharded VI BA


@pytest.fixture(scope="module")
def vi8():
    prob, vproject, truth = vi_problem()
    prob8 = relaid(prob, 8)
    jr = jsba.optimize_vi_sharded(jmesh.make_mesh(8), prob8, vproject, n_iters=8, cg_iters=50)
    tp = interop.viba_problem_from_numpy(prob8, "cpu")
    with dmesh.use_devices(CPU8):
        r8 = sharded_ba.optimize_vi_sharded(dmesh.make_mesh(), tp, NORM, n_iters=8, cg_iters=50)
    return tp, jr, r8, truth


def test_plain_vi_sharded_matches_jax(vi8):
    _, jr, r8, truth = vi8
    for f in STATES:
        np.testing.assert_allclose(getattr(r8, f).numpy(), np.asarray(getattr(jr, f)), atol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(r8.inliers.numpy(), np.asarray(jr.inliers))
    assert float(r8.cost) == pytest.approx(float(jr.cost), rel=1e-3)
    assert np.abs(r8.twb.numpy() - truth[1]).max() < 0.03


def test_plain_vi_sharded_matches_one_shard(vi8):
    """JAX's 1-against-8 check (tests/test_dist_ba.py:346-353) on the
    port: the one-shard solve of the same layout, and on one shard the
    n-shard plain solve is the one-device solve bit for bit."""
    tp, _, r8, _ = vi8
    r1 = sin.optimize_vi_ba_plain(tp, NORM, n_iters=8, cg_iters=50)
    for f, tol in (("twb", 5e-3), ("Rwb", 5e-3), ("v", 2e-2)):
        np.testing.assert_allclose(getattr(r8, f).numpy(), getattr(r1, f).numpy(), atol=tol,
                                   err_msg=f)
    m1 = sharded_ba.optimize_vi_sharded(dmesh.make_mesh(device="cpu"), tp, NORM, n_iters=8,
                                        cg_iters=50)
    assert all(torch.equal(getattr(m1, f), getattr(r1, f)) for f in sin.VIBAResult._fields)


def test_vi_sharded_checks_the_layout():
    prob, _, _ = vi_problem(123)
    tp = interop.viba_problem_from_numpy(prob, "cpu")
    with dmesh.use_devices(CPU8), pytest.raises(ValueError):
        sharded_ba.optimize_vi_sharded(dmesh.make_mesh(), tp, NORM)


# ------------------------------------------------- the joint-PCG BA


def ba_problem(n_fixed: int):
    prob, _ = build_problem(np.random.default_rng(0))
    fk = np.zeros(prob.R.shape[0], bool)
    fk[:n_fixed] = True
    prob = prob._replace(fixed_kf=jnp.asarray(fk))
    return prob, BAProblem(*[torch.from_numpy(np.array(a)) for a in prob[:10]])


def port_sharded(tp, **kw):
    with dmesh.use_devices(CPU8):
        return sharded_ba.optimize_sharded(dmesh.make_mesh(), tp, CAM, **kw)


def test_optimize_sharded_defaults_are_jax():
    for fn in (sharded_ba.optimize_sharded, sharded_ba.optimize_sharded_plain):
        sig = inspect.signature(fn).parameters
        assert sig["n_iters"].default == 10 and sig["cg_iters"].default == 40


def test_plain_sharded_ba_matches_jax():
    """Two keyframes fixed: no gauge freedom, within 1e-4 of JAX."""
    prob, tp = ba_problem(2)
    jr = jsba.optimize_sharded(jmesh.make_mesh(8), prob, project)
    tr = port_sharded(tp)
    # both ignore obs_ur (JAX rebuilds the shard problems without it; ROADMAP C.2)
    ur = prob.obs_uv[:, 0] - 5.0
    jst = jsba.optimize_sharded(jmesh.make_mesh(8), prob._replace(obs_ur=ur), project)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jst, jr))
    tst = port_sharded(tp._replace(obs_ur=torch.from_numpy(np.asarray(ur))))
    assert all(torch.equal(a, b) for a, b in zip(tst, tr))
    for f in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), atol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert float(tr.cost) == pytest.approx(float(jr.cost), rel=1e-5)


def test_plain_sharded_ba_within_jax_spread():
    """JAX's problem (one keyframe fixed): its scale is free, and JAX's own
    1-, 2- and 4-device solves part from its 8-device solve in translation
    and points (by up to ~4e-3 and ~3e-2).  The port's 8-shard solve stays
    within that spread of JAX's 8-device solve."""
    prob, tp = ba_problem(1)
    j8 = jsba.optimize_sharded(jmesh.make_mesh(8), prob, project)
    js = [jsba.optimize_sharded(jmesh.make_mesh(n), prob, project) for n in (1, 2, 4)]
    tr = port_sharded(tp)
    d = lambda a, b, f: float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
    as_np = lambda r: r._replace(**{f: getattr(r, f).numpy() for f in ("R", "t", "points")})
    tn = as_np(tr)
    for f in ("t", "points"):
        assert d(tn, j8, f) <= max(d(j, j8, f) for j in js), f
    assert d(tn, j8, "R") <= 1e-4
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(j8.inliers))
    assert float(tr.cost) == pytest.approx(float(j8.cost), rel=1e-5)


# -------------------------------------------- the candidate match (K34)


def candidate_case(seed: int, K: int = 16, N: int = 64, Nq: int = 64):
    """Random descriptors with keyframe 11's copied into the query; with
    seed > 0 also tied descriptors (a query row at equal distance from two
    of a keyframe's, a keyframe row at equal distance from two query rows),
    a keyframe with every descriptor masked and masked query rows."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, (K, N, 32), np.uint8)
    valid = np.ones((K, N), bool)
    q = desc[11, :Nq].copy()
    qv = np.ones(Nq, bool)
    if seed:
        desc[3, 9] = desc[3, 5]                  # two keyframe rows tie for query row 2
        q[2] = desc[3, 5]
        q[40] = q[41] = desc[6, 7]               # two query rows tie for keyframe row 7
        desc[2, 20:30] = q[:10]
        valid[4] = False                         # a keyframe with nothing valid
        valid[11, ::5] = False
        qv[rng.random(Nq) < 0.1] = False
        desc[8, :] = desc[8, 0]                  # one descriptor repeated: every row ties
        q[50] = desc[8, 0]
    return desc, valid, q, qv


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_candidate_match_matches_jax(seed):
    desc, valid, q, qv = candidate_case(seed)
    jm = jmesh.make_mesh(8)
    want = np.asarray(jkfb.sharded_loop_candidate_match(
        jm, jkfb.shard_kf_axis(jm, jnp.asarray(desc)), jkfb.shard_kf_axis(jm, jnp.asarray(valid)),
        jnp.asarray(q), jnp.asarray(qv)))
    with dmesh.use_devices(CPU8):
        m = dmesh.make_mesh()
        blocks = [kfb.shard_kf_axis(m, a) for a in (desc, valid)]
        got = kfb.sharded_loop_candidate_match(m, *blocks, torch.from_numpy(q),
                                               torch.from_numpy(qv))
    assert len(got) == 8 and all(g.dtype == torch.int32 and g.shape == (2,) for g in got)
    got = kfb.gather_host(got)
    np.testing.assert_array_equal(got, want)
    assert int(np.argmax(got)) == 11 and got[4] == 0


# ------------------------------------------------------ card (K32-K34)


@pytest.mark.gpu
def test_sharded_kernels_match_plain(cuda_device):
    prob, _, _ = vi_problem()
    vp = interop.viba_problem_from_numpy(relaid(prob, 4), cuda_device)
    _, bp = ba_problem(2)
    bp = BAProblem(*[a.to(cuda_device) for a in bp[:10]])
    desc, valid, q, qv = candidate_case(1)
    with dmesh.use_devices([cuda_device] * 4):
        m = dmesh.make_mesh()
        vk = sharded_ba.optimize_vi_sharded(m, vp, NORM, n_iters=8, cg_iters=40)
        vpl = sin.optimize_vi_ba_plain(vp, NORM, n_iters=8, cg_iters=40, mesh=m)
        bk = sharded_ba.optimize_sharded(m, bp, CAM)
        bpl = sharded_ba.optimize_sharded_plain(m, bp, CAM)
        blocks = [kfb.shard_kf_axis(m, a) for a in (desc, valid)]
        qt = (torch.from_numpy(q), torch.from_numpy(qv))
        ck = kfb.gather_host(kfb.sharded_loop_candidate_match(m, *blocks, *qt))
        cp = kfb.gather_host(kfb.sharded_loop_candidate_match_plain(m, *blocks, *qt))
    for f in STATES:
        assert float((getattr(vk, f) - getattr(vpl, f)).abs().max()) <= 1e-4, f
    assert torch.equal(vk.inliers, vpl.inliers)
    for f in ("R", "t", "points"):
        assert float((getattr(bk, f) - getattr(bpl, f)).abs().max()) <= 1e-4, f
    assert torch.equal(bk.inliers, bpl.inliers)
    np.testing.assert_array_equal(ck, cp)


@pytest.mark.gpu
def test_sharded_vi_kb8_kernel_matches_plain(cuda_device):
    """K32 through the KB8 camera (``CamKB8``) on
    tests/test_torch_inertial_kb8.py's problem (padded to 4 shards) against
    its plain 4-shard solve."""
    from test_torch_inertial_kb8 import CAM as KB8_CAM, vi_ba_case

    vp = interop.viba_problem_from_numpy(relaid(padded(vi_ba_case(1.0, (0, 2)), 4), 4),
                                         cuda_device)
    before = kernels.LAUNCHES["vi_ba_sharded_kb8"]
    with dmesh.use_devices([cuda_device] * 4):
        m = dmesh.make_mesh()
        k = sharded_ba.optimize_vi_sharded(m, vp, KB8_CAM, n_iters=6, cg_iters=40)
        p = sin.optimize_vi_ba_plain(vp, KB8_CAM, n_iters=6, cg_iters=40, mesh=m)
    assert kernels.LAUNCHES["vi_ba_sharded_kb8"] == before + 1
    for f in STATES:
        assert float((getattr(k, f) - getattr(p, f)).abs().max()) <= 1e-4, f
    assert torch.equal(k.inliers, p.inliers)


@pytest.mark.gpu
def test_sharded_kernels_deterministic(cuda_device):
    """K32 and K33 over 4 shards of one card: 20 calls on one input, one
    result each."""
    prob, _, _ = vi_problem()
    vp = interop.viba_problem_from_numpy(relaid(prob, 4), cuda_device)
    _, bp = ba_problem(1)
    bp = BAProblem(*[a.to(cuda_device) for a in bp[:10]])
    with dmesh.use_devices([cuda_device] * 4):
        m = dmesh.make_mesh()
        v0 = sharded_ba.optimize_vi_sharded(m, vp, NORM)
        b0 = sharded_ba.optimize_sharded(m, bp, CAM)
        for _ in range(19):
            v = sharded_ba.optimize_vi_sharded(m, vp, NORM)
            assert all(torch.equal(getattr(v, f), getattr(v0, f)) for f in v._fields)
            b = sharded_ba.optimize_sharded(m, bp, CAM)
            assert all(torch.equal(getattr(b, f), getattr(b0, f)) for f in b._fields)
