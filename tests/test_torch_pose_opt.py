"""Pose optimisation, Lie and camera helpers of the PyTorch port against the JAX package.

The mono problems come from ``port_fixtures.synthetic_pose_problems``:
bounded inlier noise and 20% gross outliers, so no residual of the
solution lies within 1e-3 of the chi2 threshold and the inlier sets must
match exactly.  R and t agree within 1e-4 (float32 solvers that sum in
different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import port_fixtures as pf
from extractorb_tpu.core import camera as jcamera
from extractorb_tpu.core import lie as jlie
from extractorb_tpu.slam.track_device import pinhole_project as j_pinhole
from extractorb_tpu.solver import pose_opt as jpo
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.config import CameraConfig
from extractorb_tpu_torch.core import lie
from extractorb_tpu_torch.core.camera import Pinhole, undistort_points_pinhole
from extractorb_tpu_torch.solver import pose_opt
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

FX, CX, CY = 500.0, 320.0, 240.0
CAM = Pinhole(FX, FX, CX, CY)
N = 400


def _problems(seed, B=2):
    return pf.synthetic_pose_problems(np.random.default_rng(seed), B, N, FX, FX, CX, CY)


def _jax_solve(R0, t0, pts, obs, isig, valid, obs_ur=None, bf=0.0):
    kw = {} if obs_ur is None else dict(obs_ur=jnp.asarray(obs_ur), bf=bf)
    r = jpo.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(obs),
                          jnp.asarray(isig), jnp.asarray(valid), j_pinhole(FX, FX, CX, CY), **kw)
    return np.asarray(r.R), np.asarray(r.t), np.asarray(r.inliers), int(r.n_inliers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose_mono_matches_jax(seed):
    R0, t0, pts, obs, isig, valid, (R_true, t_true) = _problems(seed)
    got = pose_opt.optimize_pose(*(torch.from_numpy(a) for a in (R0, t0, pts, obs, isig, valid)),
                                 CAM)
    for b in range(R0.shape[0]):
        R, t, inl, n = _jax_solve(R0[b], t0[b], pts[b], obs[b], isig[b], valid[b])
        np.testing.assert_allclose(got.R[b].numpy(), R, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.t[b].numpy(), t, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.inliers[b].numpy(), inl)
        assert int(got.n_inliers[b]) == n
        # and the solution is the truth: the outliers are rejected
        np.testing.assert_allclose(R, R_true[b], atol=2e-3)
        assert 0.7 * N < n < 0.85 * N


def test_optimize_pose_stereo_plain_matches_jax():
    """The stereo residual of the plain version (K4's reference)."""
    R0, t0, pts, obs, isig, valid, _ = _problems(5, B=1)
    rng = np.random.default_rng(5)
    bf = 40.0
    pc = np.einsum("ij,nj->ni", R0[0], pts[0]) + t0[0]
    ur = (obs[0, :, 0] - bf / pc[:, 2] + rng.normal(0, 0.3, N)).astype(np.float32)
    ur[rng.random(N) < 0.4] = -1.0
    R, t, inl, _ = _jax_solve(R0[0], t0[0], pts[0], obs[0], isig[0], valid[0], obs_ur=ur, bf=bf)
    got = pose_opt.optimize_pose(*(torch.from_numpy(a) for a in (R0, t0, pts, obs, isig, valid)),
                                 CAM, obs_ur=torch.from_numpy(ur[None]), bf=bf)
    np.testing.assert_allclose(got.R[0].numpy(), R, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.t[0].numpy(), t, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.inliers[0].numpy(), inl)


@pytest.mark.parametrize("fn", ["so3_exp", "so3_right_jacobian", "so3_left_jacobian"])
def test_so3_functions_match_jax(fn):
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(0, 1, (20, 3)), rng.normal(0, 1e-6, (5, 3))]).astype(np.float32)
    np.testing.assert_allclose(getattr(lie, fn)(torch.from_numpy(w)).numpy(),
                               np.asarray(getattr(jlie, fn)(jnp.asarray(w))), atol=1e-6)


def test_se3_exp_and_orthonormalize_match_jax():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    R, t = lie.se3_exp(torch.from_numpy(xi))
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)
    Rn = (R + torch.from_numpy(rng.normal(0, 1e-3, (20, 3, 3)).astype(np.float32)))
    np.testing.assert_allclose(lie.orthonormalize(Rn).numpy(),
                               np.asarray(jlie.orthonormalize(jnp.asarray(Rn.numpy()))), atol=1e-6)


def test_pinhole_camera_matches_jax():
    """Pinhole K, unproject, the step's projection and the radial-tangential
    undistortion (ORB-SLAM3 TUM1.yaml coefficients) against the JAX package."""
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    pc = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500),
                   rng.uniform(1, 8, 500)], -1).astype(np.float32)
    dist = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    jcam = jcamera.Pinhole(*(jnp.float32(v) for v in (FX, FX, CX, CY)))
    assert Pinhole.from_config(CameraConfig(fx=FX, fy=FX, cx=CX, cy=CY)) == CAM
    np.testing.assert_array_equal(CAM.K().numpy(), np.asarray(jcam.K()))
    np.testing.assert_allclose(CAM.unproject(torch.from_numpy(uv)).numpy(),
                               np.asarray(jcam.unproject(jnp.asarray(uv))), rtol=1e-6)
    np.testing.assert_allclose(CAM.project(torch.from_numpy(pc)).numpy(),
                               np.asarray(jax.vmap(j_pinhole(FX, FX, CX, CY))(jnp.asarray(pc))),
                               rtol=0, atol=1e-4)
    got = undistort_points_pinhole(torch.from_numpy(uv), CAM, dist).numpy()
    want = np.asarray(jcamera.undistort_points_pinhole(jnp.asarray(uv), jcam,
                                                       jnp.asarray(dist, jnp.float32)))
    # a few float32 ulps at 640 px (6.1e-5): the port's coefficients are
    # Python floats, the JAX package's float32 arrays
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-4)
    assert np.abs(got - uv).max() > 1.0  # the distortion is not negligible


def _stereo_ur(R0, t0, pts, obs, seed, bf=40.0):
    """Right-image u of every observation (bounded noise), -1 on 40%."""
    rng = np.random.default_rng(seed)
    pc = np.einsum("bij,bnj->bni", R0, pts) + t0[:, None]
    ur = (obs[..., 0] - bf / pc[..., 2] + rng.uniform(-0.5, 0.5, obs.shape[:2])).astype(np.float32)
    ur[rng.random(ur.shape) < 0.4] = -1.0
    return ur


@pytest.mark.gpu
def test_pose_lm_kernel_matches_plain(cuda_device):
    """K4 against its plain version, mono and with the stereo rows."""
    probs = _problems(0, B=4)
    args = [torch.from_numpy(a).to(cuda_device) for a in probs[:6]]
    got = pose_opt.optimize_pose(*args, CAM)
    want = pose_opt.optimize_pose_plain(*args, CAM)
    assert float((got.R - want.R).abs().max()) <= 1e-4
    assert float((got.t - want.t).abs().max()) <= 1e-4
    assert torch.equal(got.inliers, want.inliers)
    ur = torch.from_numpy(_stereo_ur(*probs[:4], seed=7)).to(cuda_device)
    before = kernels.LAUNCHES["pose_lm_stereo"]
    got = pose_opt.optimize_pose(*args, CAM, obs_ur=ur, bf=40.0)
    assert kernels.LAUNCHES["pose_lm_stereo"] == before + 1
    want = pose_opt.optimize_pose_plain(*args, CAM, obs_ur=ur, bf=40.0)
    assert float((got.R - want.R).abs().max()) <= 1e-4
    assert float((got.t - want.t).abs().max()) <= 1e-4
    assert torch.equal(got.inliers, want.inliers)
