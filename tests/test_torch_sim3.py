"""The Sim3 maps, Sim3 estimation, the essential graph and the global BA
of the port against the JAX package's (``core/lie.py``,
``geometry/sim3.py``, ``solver/pose_graph.py``, ``dist/sharded_ba.py``).

The same seeded numpy inputs go through both: the Sim3 maps and their
forward-mode Jacobians at zero within 1e-5, Horn within 1e-5, the RANSAC
with JAX's draws patched in (the same count and mask, the Sim3 within
1e-4), OptimizeSim3 with and without a fixed scale, the pose graph with
and without a fixed scale (poses within 1e-4) and the one-shard Schur GBA
against ``optimize_schur_sharded`` on a one-device mesh (within 1e-3).  On
a card, K12-K14 hold to their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.core import lie as jlie
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu.geometry import sim3 as jsim3
from extractorb_tpu.solver import ba as jba
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch.core import lie
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import sharded_ba
from extractorb_tpu_torch.geometry import sim3
from extractorb_tpu_torch.solver import pose_graph
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
CAM = Pinhole(FX, FY, CX, CY)
CPU = torch.device("cpu")


def jproject(pc):
    return jnp.stack([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY], -1).reshape(2)


def jax_sim3_sets(seed: int, valid, n_hyp: int = sim3.N_HYPOTHESES) -> np.ndarray:
    """The 3-point sets ``jsim3.solve_sim3_ransac`` draws from PRNGKey(seed)."""
    valid = jnp.asarray(np.asarray(valid))

    def sample(k):
        p = jax.random.uniform(k, (valid.shape[0],)) + (~valid) * 10.0
        return jnp.argsort(p)[:3]

    return np.asarray(jax.vmap(sample)(jax.random.split(jax.random.PRNGKey(seed), n_hyp)))


def t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype)


# ------------------------------------------------------------- Lie maps


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.5], ids=["zero", "tiny", "small", "large"])
def test_sim3_maps_and_jacobians(scale):
    rng = np.random.default_rng(1)
    xi = (rng.normal(0, 1, (16, 7)) * scale).astype(np.float32)
    jR, jt, js = jax.vmap(jlie.sim3_exp)(jnp.asarray(xi))
    R, tt, s = lie.sim3_exp(t(xi))
    for a, b in ((R, jR), (tt, jt), (s, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(lie.sim3_log(R, tt, s).numpy(),
                               np.asarray(jax.vmap(jlie.sim3_log)(jR, jt, js)), atol=1e-5)
    np.testing.assert_allclose(lie.so3_log(R).numpy(), np.asarray(jlie.so3_log(jR)), atol=1e-5)
    np.testing.assert_allclose(lie.normalize_rotation(R).numpy(),
                               np.asarray(jlie.normalize_rotation(jR)), atol=1e-5)
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(lie.quat_to_rot(t(q)).numpy(), np.asarray(jlie.quat_to_rot(q)),
                               atol=1e-6)
    # forward-mode Jacobian of log(Exp(d) S) at d = 0, finite at S = I
    f_t = lambda d: lie.sim3_log(*lie.sim3_compose(*lie.sim3_exp(d), R[0], tt[0], s[0]))
    f_j = lambda d: jlie.sim3_log(*jlie.sim3_compose(*jlie.sim3_exp(d), jR[0], jt[0], js[0]))
    Jt = torch.func.jacfwd(f_t)(torch.zeros(7)[None])[0, :, 0]
    Jj = jax.jacfwd(f_j)(jnp.zeros(7))
    assert np.isfinite(Jt.numpy()).all()
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-4)


# ----------------------------------------------------------------- Sim3


def test_horn_sim3():
    rng = np.random.default_rng(2)
    p1, p2, _, _, _, _ = chip_smoke.sim3_scene(rng, 40, out_frac=0.0)
    for fix in (False, True):
        R, tt, s = sim3.horn_sim3(t(p1), t(p2), fix)
        jR, jt, js = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
        assert float(s) == pytest.approx(float(js), abs=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_with_jax_draws(fix_scale):
    rng = np.random.default_rng(3)
    p1, p2, uv1, uv2, val, _ = chip_smoke.sim3_scene(rng, 512)
    if fix_scale:   # a rigid scene: the fixed scale is the true one
        p2 = ((p2 - p2.mean(0)) / 1.3 + p2.mean(0)).astype(np.float32)
        uv2 = np.stack([FX * p2[:, 0] / p2[:, 2] + CX, FY * p2[:, 1] / p2[:, 2] + CY], -1)
        uv2 = uv2.astype(np.float32)
    seed = 11
    j = jsim3.solve_sim3_ransac(jax.random.PRNGKey(seed), *map(jnp.asarray, (p1, p2, uv1, uv2, val)),
                                jproject, fix_scale)
    r = sim3.solve_sim3_ransac(t(jax_sim3_sets(seed, val).astype(np.int64)),
                               *map(t, (p1, p2, uv1, uv2, val)), CAM, fix_scale)
    assert bool(r.success) == bool(j.success)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))
    assert int(r.n_inliers) == int(np.asarray(j.inliers).sum()) > 100
    np.testing.assert_allclose(r.R12.numpy(), np.asarray(j.R12), atol=1e-4)
    np.testing.assert_allclose(r.t12.numpy(), np.asarray(j.t12), atol=1e-4)
    assert float(r.s12) == pytest.approx(float(j.s12), abs=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3(fix_scale):
    rng = np.random.default_rng(4)
    p1, p2, uv1, uv2, val, (R, tt, s) = chip_smoke.sim3_scene(rng, 300, out_frac=0.1)
    Ri, ti, si = R.T, -(R.T @ tt) / s, 1.0 / s
    R0 = (pf.so3_exp_np([0.02, 0.0, -0.01]) @ Ri).astype(np.float32)
    t0 = (ti + np.array([0.05, 0.0, -0.03])).astype(np.float32)
    s0 = np.float32(si * 1.03)
    j = jsim3.optimize_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0),
                            *map(jnp.asarray, (p1, p2, uv1, uv2, val)), jproject, fix_scale)
    r = sim3.optimize_sim3(t(R0), t(t0), torch.tensor(s0), *map(t, (p1, p2, uv1, uv2, val)), CAM,
                           fix_scale)
    assert int(r.n_in) == int(j.n_in) > 150
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_allclose(r.R12.numpy(), np.asarray(j.R12), atol=1e-4)
    np.testing.assert_allclose(r.t12.numpy(), np.asarray(j.t12), atol=1e-4)
    assert float(r.s12) == pytest.approx(float(j.s12), abs=1e-4)


# ----------------------------------------------------------- pose graph


def graph(rng):
    p = chip_smoke.pose_graph_problem(rng, CPU, K=40, extra=3)
    return p, jpg.PoseGraphProblem(*[jnp.asarray(a.numpy()) for a in p])


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_pose_graph(fix_scale):
    p, jp = graph(np.random.default_rng(5))
    R, tt, s, c = pose_graph.optimize_pose_graph(p, n_iters=15, fix_scale=fix_scale)
    jR, jt, js, jc = jpg.optimize_pose_graph(jp, n_iters=15, fix_scale=fix_scale)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
    assert float(c) == pytest.approx(float(jc), rel=1e-3)
    if fix_scale:
        assert torch.equal(s, torch.ones_like(s))


# ------------------------------------------------------------ global BA


def gba_problem(dev=CPU):
    """A window-BA-shaped problem (chip_smoke.ba_problem: two fixed
    keyframes pin the gauge, 5% gross outliers) as one shard."""
    return chip_smoke.ba_problem(np.random.default_rng(6), dev, n_kf=6, n_pts=300, Kp=8,
                                 Pp=384, Op=2048)


def test_schur_gba_matches_one_device_mesh():
    p = gba_problem()
    r = sharded_ba.optimize_schur(p, CAM)
    jp = jba.BAProblem(*[jnp.asarray(a.numpy()) for a in p[:10]])
    j = jsba.optimize_schur_sharded(jmesh.make_mesh(1), jp, jproject)
    np.testing.assert_allclose(r.R.numpy(), np.asarray(j.R), atol=1e-3)
    np.testing.assert_allclose(r.t.numpy(), np.asarray(j.t), atol=1e-3)
    np.testing.assert_allclose(r.points.numpy(), np.asarray(j.points), atol=1e-3)
    assert float(r.cost) == pytest.approx(float(j.cost), rel=1e-3)
    assert float(r.cost) < 0.9 * float(sharded_ba.optimize_schur(p, CAM, n_iters=0).cost)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))
    with pytest.raises(NotImplementedError, match="A.14"):
        sharded_ba.optimize_schur(p, CAM, world_size=4)


# ------------------------------------------------------------ card (K12-K14)


@pytest.mark.gpu
def test_sim3_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(7)
    p1, p2, uv1, uv2, val, _ = chip_smoke.sim3_scene(rng)
    args = [t(a).to(cuda_device) for a in (p1, p2, uv1, uv2, val)]
    sets = sim3.sample_sim3_sets(2, torch.from_numpy(val)).to(cuda_device)
    rk = sim3.solve_sim3_ransac(sets, *args, CAM)
    rp = sim3.solve_sim3_ransac_plain(sets, *args, CAM)
    assert torch.equal(rk.inliers, rp.inliers) and int(rk.n_inliers) == int(rp.n_inliers)
    assert float((rk.R12 - rp.R12).abs().max()) <= 1e-5
    for fix in (False, True):
        ok, op = (f(rp.R12, rp.t12, rp.s12, *args, CAM, fix)
                  for f in (sim3.optimize_sim3, sim3.optimize_sim3_plain))
        assert int(ok.n_in) == int(op.n_in)
        assert float((ok.R12 - op.R12).abs().max()) <= 1e-4
        assert float((ok.t12 - op.t12).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_pose_graph_and_schur_kernels_match_plain(cuda_device):
    p = chip_smoke.pose_graph_problem(np.random.default_rng(8), cuda_device)
    p64 = pose_graph.PoseGraphProblem(*[a.double() if a.is_floating_point() else a for a in p])
    dist = lambda x, y: max(float((a.double() - b.double()).abs().max()) for a, b in zip(x, y))
    for fix in (False, True):
        # K13 computes in float64: its plain version is the float64 solve,
        # and it ends no farther from it than the float32 plain solve
        gk = pose_graph.optimize_pose_graph(p, fix_scale=fix)
        g64 = pose_graph.optimize_pose_graph_plain(p64, fix_scale=fix)
        g32 = pose_graph.optimize_pose_graph_plain(p, fix_scale=fix)
        assert dist(gk[:3], g64[:3]) <= min(1e-4, dist(g32[:3], g64[:3]))
    gb = gba_problem(cuda_device)
    bk, bp = sharded_ba.optimize_schur(gb, CAM), sharded_ba.optimize_schur_plain(gb, CAM)
    assert float((bk.points - bp.points).abs().max()) <= 1e-3
    assert float((bk.t - bp.t).abs().max()) <= 1e-3
