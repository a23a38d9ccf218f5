"""The inertial solvers through the KB8 fisheye camera: the port's plain
``optimize_vi_ba``, ``optimize_pose_inertial`` and
``optimize_pose_inertial_last_frame`` with TUM-VI's 512x512 KB8 camera
against the JAX functions with the JAX tracker's KB8 projection closure
(``slam/track_device.py:kb8_project``), and (``-m gpu``) the KB8
instantiations of K20 and K22 against the plain versions.

The problems are ``tests/test_torch_inertial.py``'s (JAX
``tests/test_inertial.py``'s simulator) with every observation projected
through the KB8 model in pixels (float64, rounded to float32) and the
information scaled by 1 / fx^2, so a pixel residual weighs what the
normalised one did.  Each problem adds a point on a camera's optical axis:
in the VI BA one seen by the fixed keyframe 0 (its state the identity) and
fixed itself, so that observation stays at r = 0 (the projection's r < 1e-8
branch, where both Jacobians are 0) through every iteration; in the pose
solves one on the true current camera's axis.  The JAX solvers take the
projection's Jacobian by jacfwd in float32, the port's plain solvers in
closed form in float64 (ROADMAP C: the forward-mode and KB8 Jacobians).  Held
within tests/test_torch_inertial.py's tolerances: states and points within 1e-4, inlier
masks equal, the 15x15 Hessian within 1e-4 and the marginalised prior within
1e-3 relative.  The VI BA from the larger perturbation runs 10 LM steps: at
6 the solve is still moving, and the two Jacobians' rounding parts its far
points (13 m) by up to 6.5e-4 m there, 1.4e-5 m at 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.slam import track_device as jtd
from extractorb_tpu.solver import inertial as jvi
from extractorb_tpu_torch.core.camera import KannalaBrandt8
from extractorb_tpu_torch.solver import inertial as vi
from test_inertial import _vi_problem, simulate
from test_torch_inertial import fix_frames, pose_case, preint_to_torch, rel_err, t, viba_to_torch
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

KB8 = pf.kb8_camera(512, 512)
CAM = KannalaBrandt8(*KB8)
JPROJ = jtd.kb8_project(*KB8)
ISIG = np.float32(1e4 / KB8[0] ** 2)   # the normalised tests' 1e4, in pixels
AXIS = np.array([0.0, 0.0, 8.0])       # a point 8 m along a camera's optical axis


def kb8_uv(pb):
    return pf.kb8_project_np(pb, KB8).astype(np.float32)


def vi_ba_case(perturb, fixed=()):
    """The VI BA problem in KB8 pixels, with a fixed point on keyframe 0's
    axis (keyframe 0 is fixed at the identity rotation)."""
    rng = np.random.default_rng(3)
    prob, _, truth = _vi_problem(rng, perturb=perturb)
    if fixed:
        prob = fix_frames(prob, truth, fixed)
    Rwb, twb, _, pts = truth
    assert np.array_equal(np.asarray(prob.Rwb[0]), np.eye(3, dtype=np.float32))
    axis_pt = np.asarray(prob.twb[0], np.float64) + AXIS
    m = pts.shape[0]
    pts = np.concatenate([pts, axis_pt[None]]).astype(np.float32)
    obs_kf = np.asarray(prob.obs_kf).tolist()
    obs_mp = np.asarray(prob.obs_mp).tolist()
    for k in range(len(Rwb)):
        obs_kf.append(k)
        obs_mp.append(m)
    obs_kf, obs_mp = np.asarray(obs_kf, np.int32), np.asarray(obs_mp, np.int32)
    pb = np.einsum("oji,oj->oi", Rwb[obs_kf].astype(np.float64),
                   pts[obs_mp].astype(np.float64) - twb[obs_kf])
    O = len(obs_kf)
    fixed_mp = np.zeros(m + 1, bool)
    fixed_mp[m] = True
    start = np.concatenate([np.asarray(prob.points), axis_pt[None].astype(np.float32)])
    return prob._replace(
        points=jnp.asarray(start), obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(kb8_uv(pb)), inv_sigma2=jnp.full((O,), ISIG, jnp.float32),
        obs_valid=jnp.asarray(pb[:, 2] > 0.5), fixed_mp=jnp.asarray(fixed_mp))


@pytest.mark.parametrize("perturb,n_iters,cg_iters,fixed", [
    (1.0, 10, 60, ()), (0.5, 5, 30, (1,))])
def test_vi_ba_kb8_matches_jax(perturb, n_iters, cg_iters, fixed):
    prob = vi_ba_case(perturb, fixed)
    j = jvi.optimize_vi_ba(prob, JPROJ, n_iters=n_iters, cg_iters=cg_iters)
    p = vi.optimize_vi_ba(viba_to_torch(prob), CAM, n_iters=n_iters, cg_iters=cg_iters)
    for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
        assert np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max() < 1e-4, f
    assert np.array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert p.inliers[-len(prob.Rwb):].all()   # the axis point's observations


def kb8_pose_case(seed, joint):
    """``pose_case`` in KB8 pixels (the 20 outliers moved 0.1 fx), with a
    point on the true current camera's axis."""
    args, prior = pose_case(seed, joint)
    R0, t0, v0, bg0, ba0, prev, preint, pts, uv, isig, valid, Rcb, tcb = args
    R2, p2 = true_current_state()
    pts = np.concatenate([pts, (p2 + R2 @ AXIS)[None]]).astype(np.float32)
    pb = (pts.astype(np.float64) - p2) @ R2
    moved = np.abs(uv - pb[:-1, :2] / pb[:-1, 2:3]) > 1e-3
    uvk = kb8_uv(pb)
    uvk[:-1] += np.where(moved, np.float32(0.1 * KB8[0]), 0.0).astype(np.float32)
    valid = np.concatenate([valid, [True]])
    isig = np.full(len(pts), ISIG, np.float32)
    return (R0, t0, v0, bg0, ba0, prev, preint, pts, uvk, isig, valid, Rcb, tcb), prior


def true_current_state():
    """The true current state (R2, p2) of ``pose_case``'s scene."""
    kf_states, _ = simulate(n_kf=2)
    return np.asarray(kf_states[1][0], np.float64), np.asarray(kf_states[1][1], np.float64)


def run_pose_kb8(args, prior, joint, dev=None, plain=False):
    R0, t0, v0, bg0, ba0, prev, preint, pts, uv, isig, valid, Rcb, tcb = args
    if dev is None:
        jfn = jvi.optimize_pose_inertial_last_frame if joint else jvi.optimize_pose_inertial
        J = jnp.asarray
        return jfn(J(R0), J(t0), J(v0), J(bg0), J(ba0), tuple(map(J, prev)), preint, J(pts),
                   J(uv), J(isig), J(valid), J(Rcb), J(tcb), JPROJ,
                   prior=None if prior is None else (J(prior[0]), tuple(map(J, prior[1]))))
    if plain:
        fn = (vi.optimize_pose_inertial_last_frame_plain if joint
              else vi.optimize_pose_inertial_plain)
    else:
        fn = vi.optimize_pose_inertial_last_frame if joint else vi.optimize_pose_inertial
    T = lambda a: t(a, dev)
    kw = {} if prior is None or not joint else dict(prior=(T(prior[0]),
                                                           tuple(map(T, prior[1]))))
    return fn(T(R0), T(t0), T(v0), T(bg0), T(ba0), tuple(map(T, prev)),
              preint_to_torch(preint, dev), T(pts), T(uv), T(isig), T(valid), T(Rcb), T(tcb),
              CAM, **kw)


@pytest.mark.parametrize("joint,with_prior", [(False, False), (True, False), (True, True)])
def test_pose_inertial_kb8_matches_jax(joint, with_prior):
    args, prior = kb8_pose_case(1 + joint + with_prior, joint)
    prior = prior if with_prior else None
    j = run_pose_kb8(args, prior, joint)
    p = run_pose_kb8(args, prior, joint, dev="cpu")
    for f in ("Rwb", "twb", "v", "bg", "ba"):
        assert np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max() < 1e-4, f
    assert np.array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers) and bool(p.inliers[-1])
    assert rel_err(p.H, j.H) < (1e-3 if joint else 1e-4)


# --------------------------------------------------------- on the card


@pytest.mark.gpu
def test_vi_ba_kb8_kernel_matches_plain(cuda_device):
    prob = viba_to_torch(vi_ba_case(1.0, (0, 2)), cuda_device)
    k = vi.optimize_vi_ba(prob, CAM, n_iters=6, cg_iters=40)
    p = vi.optimize_vi_ba_plain(prob, CAM, n_iters=6, cg_iters=40)
    torch.cuda.synchronize()
    for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f
    assert torch.equal(k.inliers, p.inliers)
    again = vi.optimize_vi_ba(prob, CAM, n_iters=6, cg_iters=40)
    assert all(torch.equal(getattr(again, f), getattr(k, f)) for f in vi.VIBAResult._fields)


@pytest.mark.gpu
@pytest.mark.parametrize("joint,with_prior", [(False, False), (True, True)])
def test_pose_inertial_kb8_kernel_matches_plain(cuda_device, joint, with_prior):
    args, prior = kb8_pose_case(7, joint)
    prior = prior if with_prior else None
    k = run_pose_kb8(args, prior, joint, dev=cuda_device)
    p = run_pose_kb8(args, prior, joint, dev=cuda_device, plain=True)
    torch.cuda.synchronize()
    for f in ("Rwb", "twb", "v", "bg", "ba"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f
    assert torch.equal(k.inliers, p.inliers)
    assert rel_err(k.H.cpu(), p.H.cpu()) < (1e-3 if joint else 1e-4)
