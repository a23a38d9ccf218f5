"""MLPnP of the port (``solver/pnp.py``: ``mlpnp_ransac``,
``mlpnp_refine``) against the JAX package's on ``tests/test_pnp.py:132-190``'s
scenes: bearings spread over more than a hemisphere (many past 80 degrees
off the axis), and bearings with 30% gross outliers.

The port is handed JAX's draws (``jax.random.categorical`` from the same
key, as ``ransac_pnp``).  Hypothesis by hypothesis, ``mlpnp_poses`` holds
JAX's ``_mlpnp_pose`` within 2e-4 on every set of six distinct outlier-free
samples (the port solves in float64, JAX in float32; a set with a repeated
index leaves a two-dimensional null space, and a set with an outlier an
inconsistent system whose smallest singular vector float32 resolves
poorly: both may solve elsewhere, and stay rotations).  The RANSAC winners
have the same count and inlier mask, and the refinements agree within
1e-4.  On a card K25 holds to its plain version: the same counts per
hypothesis, hence the same winner, the same mask, and the refined pose
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.solver import pnp as jpnp
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.solver import pnp
from test_torch_pnp import jax_pnp_sets
from torch_card import cuda_device  # noqa: F401  (pytest fixture)


def off_axis_scene(rng):
    """tests/test_pnp.py:132: 120 points over more than a hemisphere."""
    N = 120
    dirs = rng.normal(size=(N, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:, 2] = np.abs(dirs[:, 2]) * 0.4 - 0.1
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return _scene(rng, dirs, [0.2, -0.3, 0.1], [0.4, -0.2, 0.6], 0)


def outlier_scene(rng):
    """tests/test_pnp.py:173: 100 points, 30 bearings replaced by noise."""
    N = 100
    dirs = rng.normal(size=(N, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.3
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return _scene(rng, dirs, [0.1, 0.2, -0.1], [-0.3, 0.1, 0.2], 30)


def _scene(rng, dirs, w, t, n_out):
    N = len(dirs)
    depth = rng.uniform(2, 8, N)[:, None]
    R_gt = pf.so3_exp_np(w).astype(np.float32)
    t_gt = np.array(t, np.float32)
    pc = (dirs * depth).astype(np.float32)
    p3d = ((pc - t_gt) @ R_gt).astype(np.float32)
    bear = (pc / np.linalg.norm(pc, axis=1, keepdims=True)).astype(np.float32)
    out = np.zeros(N, bool)
    if n_out:
        idx = rng.choice(N, n_out, replace=False)
        bear[idx] = rng.normal(size=(n_out, 3)).astype(np.float32)
        bear[idx] /= np.linalg.norm(bear[idx], axis=1, keepdims=True)
        out[idx] = True
    return p3d, bear.astype(np.float32), np.ones(N, bool), out, (R_gt, t_gt)


SCENES = {"off-axis": (off_axis_scene, 0), "outliers": (outlier_scene, 1)}


def T(a, dev="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_hypotheses_match_jax(scene):
    make, seed = SCENES[scene]
    p3d, bear, valid, out, _ = make(np.random.default_rng(0))
    sets = jax_pnp_sets(seed, valid)
    Rj, tj = jax.vmap(lambda r: jpnp._mlpnp_pose(jnp.asarray(p3d)[r], jnp.asarray(bear)[r]))(
        jnp.asarray(sets))
    Rp, tp = pnp.mlpnp_poses(T(p3d), T(bear), T(sets.astype(np.int64)))
    good = np.array([len(set(s)) == 6 for s in sets]) & ~out[sets].any(1)
    assert good.sum() >= 20
    dR = np.abs(np.asarray(Rj) - Rp.numpy()).max(axis=(1, 2))
    dt = np.abs(np.asarray(tj) - tp.numpy()).max(1)
    assert dR[good].max() <= 2e-4 and dt[good].max() <= 2e-4 * max(1.0, np.abs(tj).max())
    RtR = Rp.numpy().transpose(0, 2, 1) @ Rp.numpy()
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ransac_and_refine_match_jax(scene):
    make, seed = SCENES[scene]
    p3d, bear, valid, out, (R_gt, t_gt) = make(np.random.default_rng(0))
    j = jpnp.mlpnp_ransac(jnp.asarray(p3d), jnp.asarray(bear), jnp.asarray(valid),
                          jax.random.PRNGKey(seed))
    p = pnp.mlpnp_ransac(T(p3d), T(bear), T(valid), T(jax_pnp_sets(seed, valid).astype(np.int64)))
    assert bool(p.ok) and bool(j.ok)
    assert int(p.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=1e-4)
    if out.any():
        assert not (p.inliers.numpy() & out).any()
    info = np.full(len(valid), 1e4, np.float32)
    use = valid & np.asarray(j.inliers)
    Rj, tj = jpnp.mlpnp_refine(j.R, j.t, jnp.asarray(p3d), jnp.asarray(bear), jnp.asarray(info),
                               jnp.asarray(use))
    Rp, tp = pnp.mlpnp_refine(p.R, p.t, T(p3d), T(bear), T(info), T(use))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-4)
    ang = np.degrees(np.arccos(np.clip((np.trace(Rp.numpy() @ R_gt.T) - 1) / 2, -1, 1)))
    assert ang < 0.2 and np.linalg.norm(tp.numpy() - t_gt) < 0.02


def test_bad_sets_solve_to_nan():
    p3d, bear, valid, _, _ = off_axis_scene(np.random.default_rng(0))
    p3d[3] = np.nan
    sets = np.array([[0, 1, 2, 4, 5, 6], [0, 1, 2, 3, 4, 5], [0, 1, 2, 4, 5, 999]])
    R, t = pnp.mlpnp_poses(T(p3d), T(bear), T(sets))
    assert torch.isfinite(R[0]).all() and torch.isnan(R[1:]).all() and torch.isnan(t[1:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_matches_plain(scene, cuda_device):
    make, seed = SCENES[scene]
    p3d, bear, valid, _, _ = make(np.random.default_rng(0))
    sets = pnp.sample_pnp_sets(seed, T(valid))
    args = [T(a, cuda_device) for a in (p3d, bear, valid)] + [sets.to(cuda_device)]
    n0 = kernels.LAUNCHES["mlpnp_ransac"]
    k = pnp.mlpnp_ransac(*args)
    q = pnp.mlpnp_ransac_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mlpnp_ransac"] == n0 + 1
    assert int(k.n_inliers) == int(q.n_inliers) and bool(k.ok) == bool(q.ok)
    assert torch.equal(k.inliers, q.inliers)
    assert float((k.R - q.R).abs().max()) <= 1e-5
    info = torch.full((len(valid),), 1e4, device=cuda_device)
    Rk, tk = pnp.mlpnp_refine(k.R, k.t, args[0], args[1], info, k.inliers)
    Rq, tq = pnp.mlpnp_refine_plain(k.R, k.t, args[0], args[1], info, k.inliers)
    assert float((Rk - Rq).abs().max()) <= 1e-5 and float((tk - tq).abs().max()) <= 1e-5
