"""The KB8 fisheye camera of the port against the JAX package's
(``core/camera.py:KannalaBrandt8``), and K4's and K6's plain versions
through it against the JAX solvers with the ``kb8_project`` closure.

The camera is TUM-VI's 512x512 calibration (``tests/test_camera.py:26-31``)
on that file's inputs: projection within 1e-5 px (points past 90 degrees
included), unprojection within 1e-6 in bearing, and the Jacobian the plain
solvers take in closed form against ``jax.jacfwd`` of the JAX projection,
on the optical axis too (0 there, the JAX guard's branch).  The pose
problems are ``port_fixtures.synthetic_pose_problems`` through KB8 (points
to about 60 degrees off the axis, 20% gross outliers): R and t within 1e-4
and the same inliers.  The BA problem is ``chip_smoke.ba_problem`` through
KB8: poses within 1e-4 (99% of the points within 1e-3).  On a card
K4<KB8> and K6<KB8> hold to their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.core.camera import KannalaBrandt8 as JKannalaBrandt8
from extractorb_tpu.slam.track_device import kb8_project as j_kb8
from extractorb_tpu.solver import ba as jba
from extractorb_tpu.solver import pose_opt as jpo
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.config import CameraConfig
from extractorb_tpu_torch.core.camera import KannalaBrandt8, camera_from_config
from extractorb_tpu_torch.solver import ba, pose_opt
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

TUMVI = dict(model="KannalaBrandt8", fx=190.978477, fy=190.973307, cx=254.931706,
             cy=256.897442, k1=0.003482389402, k2=0.000715034845, k3=-0.002053236141,
             k4=0.000202936736, width=512, height=512)
CAM = camera_from_config(CameraConfig(**TUMVI))
JCAM = JKannalaBrandt8.from_config(JCameraConfig(**TUMVI))
KB8 = pf.KB8_TUMVI


def jproject():
    return j_kb8(*KB8)


def test_camera_from_config():
    assert isinstance(CAM, KannalaBrandt8) and CAM.k == KB8[4:]
    assert camera_from_config(CameraConfig()).__class__.__name__ == "Pinhole"
    np.testing.assert_array_equal(CAM.K().numpy(), np.asarray(JCAM.K()))


def test_project_and_unproject_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(200, 3)) * [1.5, 1.5, 0] + [0, 0, 2.5]
    # past 90 degrees and behind the camera, on and near the axis
    pts = np.concatenate([pts, [[3.0, 0.5, -0.4], [0.2, 0.1, -3.0], [0, 0, 1.0], [1e-9, 0, 2.0],
                                [1e-4, -2e-4, 1.0]]]).astype(np.float32)
    got = CAM.project(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(JCAM.project(jnp.asarray(pts))), atol=1e-5, rtol=0)
    uv = rng.uniform(40, 470, size=(500, 2)).astype(np.float32)
    uv = np.concatenate([uv, [[CAM.cx, CAM.cy], [0.0, 0.0], [511.0, 511.0]]]).astype(np.float32)
    bear = CAM.unproject(torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(bear, np.asarray(JCAM.unproject(jnp.asarray(uv))), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(bear, axis=1), 1.0, atol=1e-6)
    # the corners see past 90 degrees
    assert bear[-1, 2] < 0 and bear[-2, 2] < 0


def test_jacobian_matches_jacfwd_on_and_off_the_axis():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-3, 3, (50, 3)) + [0, 0, 4.0],
                          [[0, 0, 1.0], [0, 0, 5.0], [2e-9, -1e-9, 1.0]]]).astype(np.float32)
    want = np.asarray(jax.vmap(jax.jacfwd(lambda p: JCAM.project(p)))(jnp.asarray(pts)))
    got = CAM.project_jac(torch.from_numpy(pts)).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(got[-3:], 0.0)   # r < 1e-8: the guard's constant


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_kb8_matches_jax(seed):
    R0, t0, pts, obs, isig, valid, (R_true, _) = pf.synthetic_pose_problems(
        np.random.default_rng(seed), 2, 400, *KB8[:4], kb8=KB8)
    got = pose_opt.optimize_pose(*(torch.from_numpy(a) for a in (R0, t0, pts, obs, isig, valid)),
                                 CAM)
    for b in range(2):
        r = jpo.optimize_pose(*(jnp.asarray(a[b]) for a in (R0, t0, pts, obs, isig, valid)),
                              jproject())
        np.testing.assert_allclose(got.R[b].numpy(), np.asarray(r.R), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.t[b].numpy(), np.asarray(r.t), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.inliers[b].numpy(), np.asarray(r.inliers))
        np.testing.assert_allclose(np.asarray(r.R), R_true[b], atol=2e-3)


def test_optimize_pose_kb8_refuses_the_stereo_rows():
    R0, t0, pts, obs, isig, valid, _ = pf.synthetic_pose_problems(
        np.random.default_rng(0), 1, 16, *KB8[:4], kb8=KB8)
    with pytest.raises(ValueError, match="pinhole"):
        pose_opt.optimize_pose(*(torch.from_numpy(a) for a in (R0, t0, pts, obs, isig, valid)),
                               CAM, obs_ur=torch.zeros(1, 16), bf=40.0)


def test_ba_kb8_matches_jax():
    p = chip_smoke.ba_problem(np.random.default_rng(3), torch.device("cpu"), n_kf=5, n_pts=300,
                              Kp=8, Pp=384, Op=2048, kb8=KB8)
    got = ba.optimize(p, CAM, n_iters=8, cg_iters=30)
    jp = jba.BAProblem(*[jnp.asarray(a.numpy()) for a in p[:10]])
    want = jba.optimize(jp, jproject(), n_iters=8, cg_iters=30)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4, rtol=0)
    # points: the far ones seen at wide angles are weakly constrained in
    # depth, where two float32 PCG solves part by a few cm (3 of 300 here)
    dp = np.abs(got.points.numpy() - np.asarray(want.points)).max(1)
    assert (dp <= 1e-3).mean() >= 0.99 and dp.max() < 0.1
    assert float(got.cost) == pytest.approx(float(want.cost), rel=1e-3)
    # the solve moved the free keyframes and rejected the gross outliers
    start = ba.optimize(p, CAM, n_iters=0)
    assert float(got.cost) < 0.5 * float(start.cost)
    assert (got.inliers.numpy() == np.asarray(want.inliers)).mean() >= 0.995


# ------------------------------------------------------------------ card


@pytest.mark.gpu
def test_kb8_kernels_match_plain(cuda_device):
    """K4<KB8> within 1e-4 of its plain version with the same inliers;
    K6<KB8> within 1e-4 on poses and one result over 20 calls."""
    dev = cuda_device
    arrs = pf.synthetic_pose_problems(np.random.default_rng(4), 2, 1128, *KB8[:4], kb8=KB8)[:6]
    args = [torch.from_numpy(a).to(dev) for a in arrs]
    n0 = kernels.LAUNCHES["pose_lm_kb8"]
    k = pose_opt.optimize_pose(*args, CAM)
    p = pose_opt.optimize_pose_plain(*args, CAM)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pose_lm_kb8"] == n0 + 1
    assert float((k.R - p.R).abs().max()) <= 1e-4 and float((k.t - p.t).abs().max()) <= 1e-4
    assert torch.equal(k.inliers, p.inliers)
    prob = chip_smoke.ba_problem(np.random.default_rng(3), dev, kb8=KB8)
    first = ba.optimize(prob, CAM)
    bp = ba.optimize_plain(prob, CAM)
    assert float((first.R - bp.R).abs().max()) <= 1e-4
    assert float((first.t - bp.t).abs().max()) <= 1e-4
    for _ in range(19):
        r = ba.optimize(prob, CAM)
        assert all(torch.equal(getattr(r, f), getattr(first, f)) for f in ba.BAResult._fields)
