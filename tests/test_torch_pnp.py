"""The port's RANSAC PnP (``solver/pnp.py``, plain path on the CPU) against
the JAX package's, and kernel K10 against the plain version on a card.

Scenes as ``tests/test_pnp.py:_scene``: points 4-9 m in front of the
camera, normalized image coordinates, 30% gross outliers, pixel noise
0.001 (about half a pixel at f = 500) or none.  Both packages get JAX's
draw: ``jax.random.categorical`` over the valid mask from
``PRNGKey(seed)``, as ``ransac_pnp`` draws it.

Tolerances: with no noise every hypothesis of 6 distinct inliers is the
true pose, so the port's float64 minimal solves agree with JAX's (run in
float64) within 1e-4.  With noise a hypothesis' pose depends on the control-point
basis by O(noise), so the winner and its refinement are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.solver import pnp as jpnp
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.solver import pnp
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

NORMALIZED = Pinhole(1.0, 1.0, 0.0, 0.0)


scene = pf.pnp_scene


def jax_pnp_sets(seed: int, valid, n_hyp: int = pnp.N_HYPOTHESES) -> np.ndarray:
    """The minimal sets ``jpnp.ransac_pnp`` draws from ``PRNGKey(seed)``."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    idx = jax.random.categorical(jax.random.PRNGKey(seed), logits[None, None, :], axis=-1,
                                 shape=(n_hyp, pnp.MIN_SAMPLE))
    return np.asarray(idx)


def port_result(pts, xy, valid, sets, **kw):
    r = pnp.ransac_pnp(torch.from_numpy(pts), torch.from_numpy(xy), torch.from_numpy(valid),
                       torch.from_numpy(np.asarray(sets, np.int64)), **kw)
    return {k: v.numpy() for k, v in r._asdict().items()}


def angle_deg(Ra, Rb) -> float:
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.fixture
def jax_x64():
    """JAX in float64 for one test (restored after it)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("n,out_frac", [(200, 0.0), (1128, 0.3)])
def test_hypotheses_match_jax_without_noise(n, out_frac, jax_x64):
    """Every set of 6 distinct inliers: the port's EPnP against JAX's run
    in float64 (in float32 JAX's own error reaches 2e-4 on some sets of
    these scenes; the port's float64 solve stays within 1e-4 of the true
    rotation)."""
    pts, xy, R, _, out_idx = scene(np.random.default_rng(n), n, out_frac, noise=0.0)
    sets = jax_pnp_sets(7, np.ones(n, bool))
    keep = np.array([len(set(s)) == 6 for s in sets]) & ~np.isin(sets, out_idx).any(1)
    assert keep.sum() >= 20
    Rp, tp = pnp.minimal_poses(torch.from_numpy(pts), torch.from_numpy(xy),
                               torch.from_numpy(sets[keep].astype(np.int64)))
    p64, x64 = (jnp.asarray(a[sets[keep]].astype(np.float64)) for a in (pts, xy))
    Rj, tj = jax.vmap(jpnp._epnp_pose)(p64, x64)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rp.numpy(), np.broadcast_to(R, Rp.shape), atol=1e-4)


@pytest.mark.parametrize("n,seed", [(200, 0), (1128, 1)])
def test_winner_matches_jax_with_noise(n, seed):
    """ok, the winner's inlier count and mask (<= 1% of the valid entries
    apart), then the winner refined by each package's pose optimiser
    (R, t within 1e-4, masks <= 1% apart).  The raw winners' poses are not
    held: two hypotheses of equal count can both win (the first wins), and
    a hypothesis' pose depends on its control-point basis by O(noise)
    (ROADMAP C); in scene(default_rng(300)) with seed 0 the two winners'
    rotations agree within 3e-5 but their depths differ by 0.013."""
    pts, xy, _, _, _ = scene(np.random.default_rng(100 + n + seed), n)
    valid = np.ones(n, bool)
    valid[::17] = False
    th, min_inl = 3.0 / 500.0, 12
    jr = jpnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
                         jax.random.PRNGKey(seed), th=th, min_inliers=min_inl)
    pr = pnp.ransac_pnp(torch.from_numpy(pts), torch.from_numpy(xy), torch.from_numpy(valid),
                        torch.from_numpy(jax_pnp_sets(seed, valid).astype(np.int64)), th=th,
                        min_inliers=min_inl)
    assert bool(pr.ok) == bool(jr.ok) is True
    assert abs(int(pr.n_inliers) - int(jr.n_inliers)) <= 0.01 * valid.sum()
    assert int((pr.inliers.numpy() != np.asarray(jr.inliers)).sum()) <= 0.01 * valid.sum()
    assert not pr.inliers.numpy()[~valid].any()
    jref = jpnp.refine_pnp(jr, jnp.asarray(pts), jnp.asarray(xy), lambda pc: pc[:2] / pc[2])
    pref = pnp.refine_pnp(pr, torch.from_numpy(pts), torch.from_numpy(xy), NORMALIZED)
    np.testing.assert_allclose(pref.R.numpy(), np.asarray(jref.R), atol=1e-4)
    np.testing.assert_allclose(pref.t.numpy(), np.asarray(jref.t), atol=1e-4)
    assert int((pref.inliers.numpy() != np.asarray(jref.inliers)).sum()) <= 0.01 * valid.sum()


def test_refine_matches_jax():
    pts, xy, _, _, _ = scene(np.random.default_rng(5), 200)
    valid = np.ones(200, bool)
    jr = jpnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
                         jax.random.PRNGKey(1))
    jref = jpnp.refine_pnp(jr, jnp.asarray(pts), jnp.asarray(xy), lambda pc: pc[:2] / pc[2])
    start = pnp.PnPResult(*(torch.from_numpy(np.array(a)) for a in jr))
    pref = pnp.refine_pnp(start, torch.from_numpy(pts), torch.from_numpy(xy), NORMALIZED)
    np.testing.assert_allclose(pref.R.numpy(), np.asarray(jref.R), atol=1e-4)
    np.testing.assert_allclose(pref.t.numpy(), np.asarray(jref.t), atol=1e-4)
    assert np.array_equal(pref.inliers.numpy(), np.asarray(jref.inliers))


# ------------------------------------ tests/test_pnp.py's checks, on the port


def test_ransac_pnp_recovers_pose():
    pts, xy, R, t, out_idx = scene(np.random.default_rng(0), 200, 0.3)
    valid = torch.ones(200, dtype=torch.bool)
    sets = pnp.sample_pnp_sets(0, valid)
    res = pnp.ransac_pnp(torch.from_numpy(pts), torch.from_numpy(xy), valid, sets)
    assert bool(res.ok) and int(res.n_inliers) > 100
    assert angle_deg(res.R.numpy(), R) < 2.0
    assert np.linalg.norm(res.t.numpy() - t) < 0.1
    assert res.inliers.numpy()[out_idx].mean() < 0.2
    refined = pnp.refine_pnp(res, torch.from_numpy(pts), torch.from_numpy(xy), NORMALIZED)
    assert angle_deg(refined.R.numpy(), R) < 0.5
    assert np.linalg.norm(refined.t.numpy() - t) < 0.02


def test_ransac_pnp_rejects_garbage():
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(-1, 1, (100, 3)).astype(np.float32))
    xy = torch.from_numpy(rng.uniform(-1, 1, (100, 2)).astype(np.float32))
    valid = torch.ones(100, dtype=torch.bool)
    res = pnp.ransac_pnp(pts, xy, valid, pnp.sample_pnp_sets(2, valid), min_inliers=30)
    assert not bool(res.ok)


def test_ransac_pnp_respects_valid_mask():
    rng = np.random.default_rng(3)
    pts, xy, _, _, _ = scene(rng, 200, 0.0)
    valid = np.zeros(200, bool)
    valid[:50] = True
    xy[50:] = rng.uniform(-3, 3, (150, 2))
    sets = pnp.sample_pnp_sets(3, torch.from_numpy(valid))
    assert bool(torch.from_numpy(valid)[sets].all())
    res = port_result(pts, xy, valid, sets.numpy())
    assert bool(res["ok"]) and not res["inliers"][~valid].any()


def test_epnp_beats_dlt_under_noise():
    """EPnP against the 6-point DLT at 2.5 px of noise (f = 500): a larger
    consensus set and a pose within 1.5 degrees, unrefined."""
    rng = np.random.default_rng(4)
    n = 150
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)],
                   -1).astype(np.float32)
    R = pf.so3_exp_np([0.15, -0.1, 0.08]).astype(np.float32)
    t = np.array([0.4, -0.2, 0.6], np.float32)
    pc = pts @ R.T + t
    sigma = 2.5 / 500.0
    xy = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, sigma, (n, 2))).astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)

    def run(solver, seed):
        return pnp.ransac_pnp(torch.from_numpy(pts), torch.from_numpy(xy), valid,
                              pnp.sample_pnp_sets(seed, valid, 128), th=3 * sigma, solver=solver)

    ep = [run("epnp", s) for s in range(5)]
    dl = [run("dlt", s) for s in range(5)]
    ep_inl = np.mean([int(r.n_inliers) for r in ep])
    dl_inl = np.mean([int(r.n_inliers) for r in dl])
    assert ep_inl > dl_inl * 1.15, (ep_inl, dl_inl)
    assert ep_inl > 0.75 * n
    assert np.mean([angle_deg(r.R.numpy(), R) for r in ep]) < 1.5


def test_sampler_and_degenerate_inputs():
    """Sets are drawn with replacement from the valid entries only (from all
    of them when none is valid), seeded; empty, all-invalid and degenerate
    (one repeated point) inputs give ok false and no NaN winner over a
    finite hypothesis."""
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 9, 20]] = True
    sets = pnp.sample_pnp_sets(11, valid)
    assert sets.shape == (256, 6) and sets.dtype == torch.int64
    assert set(sets.unique().tolist()) == {3, 9, 20}
    assert torch.equal(sets, pnp.sample_pnp_sets(11, valid))
    assert pnp.sample_pnp_sets(11, torch.zeros(50, dtype=torch.bool)).max() < 50
    empty = pnp.ransac_pnp(torch.zeros(0, 3), torch.zeros(0, 2), torch.zeros(0, dtype=torch.bool),
                           pnp.sample_pnp_sets(0, torch.zeros(0, dtype=torch.bool)))
    assert not bool(empty.ok) and int(empty.n_inliers) == 0 and empty.inliers.numel() == 0
    pts, xy, _, _, _ = scene(np.random.default_rng(6), 60, 0.0)
    none_valid = port_result(pts, xy, np.zeros(60, bool), pnp.sample_pnp_sets(
        1, torch.zeros(60, dtype=torch.bool)).numpy())
    assert not bool(none_valid["ok"]) and int(none_valid["n_inliers"]) == 0
    sets = np.full((256, 6), 4, np.int64)
    sets[7:] = pnp.sample_pnp_sets(2, torch.ones(60, dtype=torch.bool))[7:].numpy()
    mixed = port_result(pts, xy, np.ones(60, bool), sets)
    assert bool(mixed["ok"]) and np.isfinite(mixed["R"]).all()


# ------------------------------------------------------------ card (K10)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", pnp.SOLVERS)
def test_kernel_matches_plain(cuda_device, solver):
    """K10 against the plain version on the card at the relocalization shape
    (1128 slots, 256 sets, th = 3 / fx): ok, n_inliers and the inlier mask
    equal, the winner's pose within 1e-4; then the degenerate inputs."""
    pts, xy, _, _, _ = scene(np.random.default_rng(9), 1128)
    valid = np.random.default_rng(10).random(1128) < 0.8
    dev = cuda_device
    args = [torch.from_numpy(a).to(dev) for a in (pts, xy, valid)]
    sets = pnp.sample_pnp_sets(5, args[2])
    before = kernels.LAUNCHES["pnp_ransac"]
    rk = pnp.ransac_pnp(*args, sets, th=3 / 500, min_inliers=12, solver=solver)
    rp = pnp.ransac_pnp_plain(*args, sets, th=3 / 500, min_inliers=12, solver=solver)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pnp_ransac"] == before + 1
    assert bool(rk.ok) == bool(rp.ok) and int(rk.n_inliers) == int(rp.n_inliers)
    assert torch.equal(rk.inliers, rp.inliers)
    assert float((rk.R - rp.R).abs().max()) <= 1e-4 and float((rk.t - rp.t).abs().max()) <= 1e-4
    for n, v in ((0, np.zeros(0, bool)), (40, np.zeros(40, bool))):
        a = [torch.zeros(n, 3, device=dev), torch.zeros(n, 2, device=dev),
             torch.from_numpy(v).to(dev)]
        r = pnp.ransac_pnp(*a, pnp.sample_pnp_sets(0, a[2]), solver=solver)
        torch.cuda.synchronize()
        assert not bool(r.ok) and int(r.n_inliers) == 0
