"""Bundle adjustment of the PyTorch port (plain path) against the JAX
package, on problems padded the way ``run_ba`` pads them (Kp 32, Pp 2048,
Op 8192: padded keyframes and points fixed, padded observations invalid).

The scenes are ``tests/test_solver.py:make_ba_scene`` with 20 gross
outliers.  Two keyframes are fixed, so the problem has no gauge freedom
left: with one fixed keyframe the scale is free, and the two solvers'
rounding walks along it (their costs still agree).  Tolerances: R, t and
points within 1e-3, chi2 inliers agree on >= 99.5% of the observations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extractorb_tpu.core import lie as jlie
from extractorb_tpu.solver import ba as jba
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.solver import ba
from test_solver import CX, CY, FX, FY, make_ba_scene, project
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

CAM = Pinhole(FX, FY, CX, CY)
KP, PP, OP = 32, 2048, 8192


def padded_problem(seed: int, n_kf: int):
    rng = np.random.default_rng(seed)
    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=n_kf, n_mp=150)
    K, P, O = len(Rs), len(pts), len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    obs_uv[rng.choice(O, 20, replace=False)] += 40.0
    Rs_n, ts_n = Rs.copy(), ts.copy()
    for k in range(2, K):
        dR, dt = jlie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    R_p = np.tile(np.eye(3, dtype=np.float32), (KP, 1, 1))
    R_p[:K] = Rs_n
    pts_p = pad(pts_n, PP)
    pts_p[P:, 2] = 1.0
    fixed_kf = np.ones(KP, bool)
    fixed_kf[2:K] = False
    isig = np.ones(OP, np.float32)
    isig[:O] = 1.2 ** (-2.0 * rng.integers(0, 3, O))
    return dict(R=R_p, t=pad(ts_n.astype(np.float32), KP), points=pts_p,
                obs_kf=pad(obs_kf, OP), obs_mp=pad(obs_mp, OP), obs_uv=pad(obs_uv, OP),
                inv_sigma2=isig, obs_valid=pad(np.ones(O, bool), OP),
                fixed_kf=fixed_kf, fixed_mp=np.arange(PP) >= P)


@pytest.mark.parametrize("seed,n_kf,n_iters,cg_iters", [(0, 4, 12, 40), (1, 8, 5, 25)],
                         ids=["init-budget", "window-budget"])
def test_optimize_matches_jax(seed, n_kf, n_iters, cg_iters):
    arrs = padded_problem(seed, n_kf)
    j = jba.optimize(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}), project,
                     n_iters=n_iters, cg_iters=cg_iters)
    j = jax.tree_util.tree_map(np.asarray, j)
    p = ba.optimize(ba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrs.items()}), CAM,
                    n_iters=n_iters, cg_iters=cg_iters)
    np.testing.assert_allclose(p.R.numpy(), j.R, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p.t.numpy(), j.t, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p.points.numpy(), j.points, atol=1e-3, rtol=0)
    assert (p.inliers.numpy() == j.inliers).mean() >= 0.995
    # fixed and padded blocks stay where they were (up to the final
    # re-orthonormalization of every rotation); outliers are found
    np.testing.assert_allclose(p.R.numpy()[:2], arrs["R"][:2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(p.t.numpy()[:2], arrs["t"][:2])
    np.testing.assert_array_equal(p.points.numpy()[arrs["fixed_mp"]],
                                  arrs["points"][arrs["fixed_mp"]])
    assert int(p.inliers.sum()) <= int(arrs["obs_valid"].sum()) - 15
    np.testing.assert_allclose(float(p.cost), float(j.cost), rtol=1e-4)


def test_unported_options_raise():
    """The options the port once refused now run and hold to JAX: the
    stereo rows (every valid observation's ur at bf 40, cg) and
    ``schur_dense`` (mono), on the init-budget problem.  ``schur_dense``
    runs in float64 on both sides: in float32 XLA's and LAPACK's dense LU
    round differently.  (Their cases with KB8 and fixed points are in
    tests/test_torch_ba_stereo.py.)"""
    arrs = padded_problem(0, 4)
    z = np.einsum("oij,oj->oi", arrs["R"][arrs["obs_kf"]], arrs["points"][arrs["obs_mp"]])[:, 2] \
        + arrs["t"][arrs["obs_kf"]][:, 2]
    ur = np.where(arrs["obs_valid"], arrs["obs_uv"][:, 0] - 40.0 / z, -1.0).astype(np.float32)
    f64 = lambda a: {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in a.items()}
    for a, kw in (({**arrs, "obs_ur": ur}, dict(bf=40.0)), (f64(arrs), dict(solver="schur_dense"))):
        with jax.enable_x64(a["R"].dtype == np.float64):
            j = jba.optimize(jba.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()}), project,
                             n_iters=12, cg_iters=40, **kw)
            j = jax.tree_util.tree_map(np.asarray, j)
        p = ba.optimize(ba.BAProblem(**{k: torch.from_numpy(v) for k, v in a.items()}), CAM,
                        n_iters=12, cg_iters=40, **kw)
        for f in ("R", "t", "points"):
            np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                       atol=1e-3, rtol=0, err_msg=f)
        assert (p.inliers.numpy() == np.asarray(j.inliers)).mean() >= 0.995
        np.testing.assert_allclose(float(p.cost), float(j.cost), rtol=1e-4)


@pytest.mark.gpu
def test_optimize_kernel_matches_plain(cuda_device):
    arrs = padded_problem(0, 6)
    prob = ba.BAProblem(**{k: torch.from_numpy(v).to(cuda_device) for k, v in arrs.items()})
    k = ba.optimize(prob, CAM, n_iters=12, cg_iters=40)
    p = ba.optimize_plain(prob, CAM, n_iters=12, cg_iters=40)
    for a, b in ((k.R, p.R), (k.t, p.t), (k.points, p.points)):
        assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(k.inliers, p.inliers)
