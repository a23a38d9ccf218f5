"""The port's inertial solvers (``solver/inertial.py``: the plain versions of
K20, K21, K22) and ``solver/marginal.py`` against the JAX package.

The problems are JAX ``tests/test_inertial.py``'s analytic simulator
(``simulate``, ``preintegrate_segments``, ``_vi_problem``), fed to both
packages as the same numpy arrays.  States within 1e-4 (float32 solvers of
tens of steps whose sums run in another order), inlier masks equal, the
returned 15x15 Hessian within 1e-4 and the marginalised prior within 1e-3
relative of their largest entry (the Schur complement H_cc - H_cp H_pp^+ H_pc
of float32 blocks near 1e6 cancels about four bits).  ``marginalize`` / ``condition`` / ``sparsify`` on random
SPD blocks within 1e-4 relative.  The ``-m gpu`` cases hold K20-K22 to their
plain versions on the card and K6 to one result over 50 calls.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extractorb_tpu.core import lie as jlie
from extractorb_tpu.solver import inertial as jvi
from extractorb_tpu.solver import marginal as jmg
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.imu import preintegration as pre
from extractorb_tpu_torch.solver import ba
from extractorb_tpu_torch.solver import inertial as vi
from extractorb_tpu_torch.solver import marginal as mg
from test_inertial import G, _chain_from, _vi_problem, preintegrate_segments, simulate
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

NORM = Pinhole(1.0, 1.0, 0.0, 0.0)   # the JAX tests' normalised projection


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(a, dev="cpu"):
    return torch.from_numpy(np.array(a)).to(dev)


def chain_to_torch(c, dev="cpu") -> vi.InertialChain:
    return interop.chain_from_numpy(interop.chain_to_numpy(c), dev)


def preint_to_torch(p, dev="cpu") -> pre.Preintegrated:
    return interop.preint_from_numpy(interop.preint_to_numpy(p), dev)


def viba_to_torch(p, dev="cpu") -> vi.VIBAProblem:
    return interop.viba_problem_from_numpy(p, dev)


def test_interop_keeps_shapes():
    """The inertial conversions keep every field's shape (a 0-dim dT
    stays 0-dim, which the kernels' packing relies on)."""
    kf_states, segments = simulate(n_kf=3)
    jp = preintegrate_segments(segments)[0]
    for p in (preint_to_torch(jp), interop.preint_from_numpy(interop.preint_to_numpy(jp))):
        assert all(tuple(np.shape(getattr(p, f))) == tuple(np.shape(getattr(jp, f)))
                   for f in pre.Preintegrated._fields)
    assert vi.pack_preint(preint_to_torch(jp)).shape == (292,)
    chain = chain_to_torch(_chain_from(preintegrate_segments(segments), 3))
    assert vi.pack_preint(chain).shape == (3, 292) and chain.valid.dtype == torch.bool


# ---------------------------------------------------------------- marginal


@pytest.mark.parametrize("n,blk", [(30, (0, 14)), (15, (3, 8)), (21, (15, 20))])
def test_marginal_ops_match_jax(n, blk):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = (A @ A.T + n * np.eye(n)).astype(np.float32)
    s, e = blk
    ref = np.asarray(jmg.marginalize(jnp.asarray(H), s, e))
    assert rel_err(mg.marginalize(t(H), s, e), ref) < 1e-4
    assert np.array_equal(mg.condition(t(H), s, e).numpy(),
                          np.asarray(jmg.condition(jnp.asarray(H), s, e)))
    if e + 1 < n:
        sp = mg.sparsify(t(H), s, e, e + 1, n - 1)
        assert rel_err(sp, np.asarray(jmg.sparsify(jnp.asarray(H), s, e, e + 1, n - 1))) < 1e-4


# ------------------------------------------------------------ inertial only


def inertial_only_case(fix_scale=False):
    true_bg = np.array([0.003, -0.005, 0.002])
    true_ba = np.array([0.02, 0.01, -0.03])
    Rwg_true = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.08, 0.0], jnp.float64)))
    g_world = Rwg_true @ np.array([0.0, 0.0, -G])
    s_true = 2.5
    n_kf = 8
    kf_states, segments = simulate(n_kf=n_kf, bg=true_bg, ba=true_ba, g_world=g_world)
    chain = _chain_from(preintegrate_segments(segments), n_kf)
    Rwb = np.stack([s[0] for s in kf_states]).astype(np.float32)
    twb = (np.stack([s[1] for s in kf_states]) / s_true).astype(np.float32)
    v0 = (np.stack([s[2] for s in kf_states]) / s_true).astype(np.float32)
    Rwg0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.0], jnp.float32)))
    return Rwb, twb, v0, chain, Rwg0, dict(prior_g=1e2, prior_a=1e2, n_iters=40,
                                           fix_scale=fix_scale)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_only_matches_jax(fix_scale):
    Rwb, twb, v0, chain, Rwg0, kw = inertial_only_case(fix_scale)
    j = jvi.inertial_only(jnp.asarray(Rwb), jnp.asarray(twb), chain, jnp.asarray(v0),
                          jnp.zeros(6, jnp.float32), Rwg0=jnp.asarray(Rwg0), **kw)
    p = vi.inertial_only(t(Rwb), t(twb), chain_to_torch(chain), t(v0),
                         torch.zeros(6), Rwg0=t(Rwg0), **kw)
    assert abs(float(p.scale) - float(j.scale)) < 1e-4 * max(1.0, float(j.scale))
    for f in ("Rwg", "bg", "ba", "v"):
        assert np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max() < 1e-4, f


# -------------------------------------------------------------------- VI BA


def fix_frames(prob, truth, fixed):
    """``prob`` with the keyframes ``fixed`` held at their true states (a
    frame fixed at a perturbed state leaves the problem inconsistent and
    its CG far from converged) and the KF0 bias priors of FullInertialBA."""
    Rwb, twb, v, _ = truth
    fk = np.asarray(prob.fixed_kf).copy()
    fk[list(fixed)] = True
    R, tw, vv = (np.asarray(a).copy() for a in (prob.Rwb, prob.twb, prob.v))
    for k in fixed:
        R[k], tw[k], vv[k] = Rwb[k], twb[k], v[k]
    return prob._replace(fixed_kf=jnp.asarray(fk), Rwb=jnp.asarray(R), twb=jnp.asarray(tw),
                         v=jnp.asarray(vv), prior_g=1.0, prior_a=1e5)


@pytest.mark.parametrize("perturb,n_iters,cg_iters,fixed", [
    (1.0, 6, 40, ()), (1.0, 4, 30, (0, 2)), (0.5, 5, 30, (1,))])
def test_vi_ba_matches_jax(perturb, n_iters, cg_iters, fixed):
    rng = np.random.default_rng(3)
    prob, project, truth = _vi_problem(rng, perturb=perturb)
    if fixed:
        prob = fix_frames(prob, truth, fixed)
    j = jvi.optimize_vi_ba(prob, project, n_iters=n_iters, cg_iters=cg_iters)
    p = vi.optimize_vi_ba(viba_to_torch(prob), NORM, n_iters=n_iters, cg_iters=cg_iters)
    for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
        assert np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max() < 1e-4, f
    assert np.array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    for k in np.where(np.asarray(prob.fixed_kf))[0]:
        assert np.array_equal(p.twb[k].numpy(), np.asarray(prob.twb[k]))


# ------------------------------------------------------------ pose inertial


def pose_case(seed, joint, n_pts=150):
    rng = np.random.default_rng(seed)
    kf_states, segments = simulate(n_kf=2)
    preint = preintegrate_segments(segments)[0]
    R1, p1, v1 = [x.astype(np.float32) for x in map(np.asarray, kf_states[0])]
    R2, p2, v2 = [x.astype(np.float32) for x in map(np.asarray, kf_states[1])]
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(6, 14, n_pts)], -1).astype(np.float32)
    pb = (pts - p2) @ R2
    uv = (pb[:, :2] / pb[:, 2:3]).astype(np.float32)
    valid = pb[:, 2] > 0.5
    out = rng.choice(n_pts, 20, replace=False)
    uv[out] += 0.1
    dw = rng.normal(0, 0.02, 3)
    R0 = (R2 @ np.asarray(jlie.so3_exp(jnp.asarray(dw, jnp.float32)))).astype(np.float32)
    t0 = (p2 + rng.normal(0, 0.05, 3)).astype(np.float32)
    v0 = (v2 + rng.normal(0, 0.1, 3)).astype(np.float32)
    z3 = np.zeros(3, np.float32)
    prev = (R1, p1, v1, z3, z3)
    prior = None
    if joint:
        dwp = rng.normal(0, 0.01, 3)
        Rp0 = (R1 @ np.asarray(jlie.so3_exp(jnp.asarray(dwp, jnp.float32)))).astype(np.float32)
        prev = (Rp0, (p1 + rng.normal(0, 0.02, 3)).astype(np.float32), v1, z3, z3)
        A = rng.normal(size=(15, 15)).astype(np.float32)
        prior = ((A @ A.T * 1e3 + np.eye(15) * 1e5).astype(np.float32), (R1, p1, v1, z3, z3))
    args = (R0, t0, v0, z3, z3, prev, preint, pts, uv, np.full(n_pts, 1e4, np.float32), valid,
            np.eye(3, dtype=np.float32), z3)
    return args, prior


def run_pose(args, prior, joint, dev=None):
    R0, t0, v0, bg0, ba0, prev, preint, pts, uv, isig, valid, Rcb, tcb = args
    fn = vi.optimize_pose_inertial_last_frame if joint else vi.optimize_pose_inertial
    if dev is None:
        jfn = jvi.optimize_pose_inertial_last_frame if joint else jvi.optimize_pose_inertial
        J = jnp.asarray
        return jfn(J(R0), J(t0), J(v0), J(bg0), J(ba0), tuple(map(J, prev)), preint, J(pts),
                   J(uv), J(isig), J(valid), J(Rcb), J(tcb),
                   lambda pc: jnp.stack([pc[0] / pc[2], pc[1] / pc[2]], -1).reshape(2),
                   prior=None if prior is None else (J(prior[0]), tuple(map(J, prior[1]))))
    T = lambda a: t(a, dev)
    kw = {} if prior is None else dict(prior=(T(prior[0]), tuple(map(T, prior[1]))))
    return fn(T(R0), T(t0), T(v0), T(bg0), T(ba0), tuple(map(T, prev)),
              preint_to_torch(preint, dev), T(pts), T(uv), T(isig), T(valid), T(Rcb), T(tcb),
              NORM, **kw)


@pytest.mark.parametrize("joint,with_prior", [(False, False), (True, False), (True, True)])
def test_pose_inertial_matches_jax(joint, with_prior):
    """Both variants; the joint one with the default 1e4 I prior and with a
    given one (the non-joint variant's optional prior has no caller)."""
    args, prior = pose_case(1 + joint + with_prior, joint)
    prior = prior if with_prior else None
    j = run_pose(args, prior, joint)
    p = run_pose(args, prior, joint, dev="cpu")
    for f in ("Rwb", "twb", "v", "bg", "ba"):
        assert np.abs(getattr(p, f).numpy() - np.asarray(getattr(j, f))).max() < 1e-4, f
    assert np.array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers)
    assert rel_err(p.H, j.H) < (1e-3 if joint else 1e-4)


# --------------------------------------------------------- on the card


@pytest.mark.gpu
def test_inertial_init_kernel_matches_plain(cuda_device):
    Rwb, twb, v0, chain, Rwg0, kw = inertial_only_case()
    args = (t(Rwb, cuda_device), t(twb, cuda_device), chain_to_torch(chain, cuda_device),
            t(v0, cuda_device), torch.zeros(6, device=cuda_device))
    k = vi.inertial_only(*args, Rwg0=t(Rwg0, cuda_device), **kw)
    p = vi.inertial_only_plain(*args, Rwg0=t(Rwg0, cuda_device), solve_dtype=torch.float64,
                               **kw)
    torch.cuda.synchronize()
    assert abs(float(k.scale) - float(p.scale)) < 1e-4 * max(1.0, float(p.scale))
    for f in ("Rwg", "bg", "ba", "v"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f


class _Captured(Exception):
    pass


def engine_vi_problems(dev, kb8: bool = False) -> dict:
    """K20's problems as the engine builds them (``slam/imu_frontend.py``),
    by case: on ``chip_smoke``'s [vi-loop] map (or [vi-loop-kb8]'s) the
    local window at 6 x 40, the FullInertialBA at the init's 25 x 40 and
    at the post-loop 7 x 40; and the first K20 call of ``chip_smoke``'s
    stereo-inertial run (mono maps only); each with the points seen by one
    keyframe fixed.  Each value is (problem, camera, n_iters, cg_iters)."""
    import chip_smoke as cs

    calib = cs.ImuCalib.from_config(cs.vi_config().imu)
    mp = cs.inertial_looped_map(dev, calib, kb8=kb8)[0]
    cam = cs.loop_camera(kb8)
    probs, real = [], vi.optimize_vi_ba

    def spy(prob, cam_, **kw):
        probs.append((prob, cam_))
        if len(probs) == want:
            raise _Captured
        return real(prob, cam_, **kw)

    vi.optimize_vi_ba = spy
    try:
        want = 2
        with pytest.raises(_Captured):
            cs.imu_frontend.local_inertial_ba(mp, calib, cam, max(mp.keyframes), device=dev)
            cs.imu_frontend.full_inertial_ba(mp, calib, cam, n_iters=1, device=dev)
        # the points seen by one keyframe fixed: on the constructed maps their
        # rank-2 blocks break a float32 PCG down (chip_smoke's [vi-loop] GBA)
        fix = cs.one_view_fixed
        out = {"window-6x40": (fix(probs[0][0]), cam, 6, 40),
               "init-25x40": (fix(probs[1][0]), cam, 25, 40),
               "post-loop-7x40": (fix(probs[1][0]), cam, 7, 40)}
        if not kb8:
            want = 3
            left, right = cs.vi_stereo_frames(n=cs.VI_STEREO_FRAMES)
            with pytest.raises(_Captured):
                cs.run_vi(left, dev, rights=right)
            out["stereo-inertial"] = (fix(probs[2][0]), probs[2][1], 6, 40)
    finally:
        vi.optimize_vi_ba = real
    return out


_ENGINE = {}


def engine_vi_problem(dev, case: str, kb8: bool = False):
    if kb8 not in _ENGINE:
        _ENGINE[kb8] = engine_vi_problems(dev, kb8)
    return _ENGINE[kb8][case]


def check_vi_ba_kernel(prob, cam, n_iters, cg_iters, dev):
    """K20 within 1e-4 of its plain version (states and points) with the
    inliers equal, bit-equal to K32's passes launched one by one on one
    shard, and 20 calls on one input bit-identical."""
    from extractorb_tpu_torch.dist import mesh as dmesh
    from extractorb_tpu_torch.dist import sharded_ba

    k = vi.optimize_vi_ba(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
    p = vi.optimize_vi_ba_plain(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
    torch.cuda.synchronize()
    for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f
    assert torch.equal(k.inliers, p.inliers)
    one = sharded_ba.optimize_vi_sharded(dmesh.Mesh([dev]), prob, cam, n_iters=n_iters,
                                         cg_iters=cg_iters)
    assert all(torch.equal(getattr(one, f), getattr(k, f)) for f in vi.VIBAResult._fields)
    for _ in range(20):
        again = vi.optimize_vi_ba(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
        assert all(torch.equal(getattr(again, f), getattr(k, f)) for f in vi.VIBAResult._fields)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["simulator-6x40", "window-6x40", "init-25x40",
                                  "post-loop-7x40", "stereo-inertial"])
def test_vi_ba_kernel_matches_plain(cuda_device, case):
    """K20, one cluster launch a call, on the JAX tests' simulator problem
    and on the engine's own problems: [vi]'s local window, the init's
    FullInertialBA, the post-loop GBA (its well-posed part) and a
    stereo-inertial run's."""
    if case == "simulator-6x40":
        rng = np.random.default_rng(3)
        prob, _, truth = _vi_problem(rng, perturb=1.0)
        prob = viba_to_torch(fix_frames(prob, truth, (0, 2)), cuda_device)
        check_vi_ba_kernel(prob, NORM, 6, 40, cuda_device)
        return
    check_vi_ba_kernel(*engine_vi_problem(cuda_device, case), cuda_device)


# more points than K22 stages in its CTA's shared memory (about 8600 on an H100)
K22_ABOVE_LIMIT = 9600


@pytest.mark.gpu
@pytest.mark.parametrize("joint,with_prior,n_pts", [(False, False, 150), (True, True, 150),
                                                     (False, False, K22_ABOVE_LIMIT),
                                                     (True, True, K22_ABOVE_LIMIT)])
def test_pose_inertial_kernel_matches_plain(cuda_device, joint, with_prior, n_pts):
    """K22 against its plain version, with the points staged in shared
    memory and, above its staging limit, read from global memory."""
    args, prior = pose_case(7, joint, n_pts)
    prior = prior if with_prior else None
    assert (n_pts > vi.pose_inertial_max_n(joint, False, cuda_device)) == (n_pts > 150)
    k = run_pose(args, prior, joint, dev=cuda_device)
    T = lambda a: t(a, cuda_device)
    R0, t0, v0, bg0, ba0, prev, preint, pts, uv, isig, valid, Rcb, tcb = args
    fn = (vi.optimize_pose_inertial_last_frame_plain if joint
          else vi.optimize_pose_inertial_plain)
    kw = {} if prior is None else dict(prior=(T(prior[0]), tuple(map(T, prior[1]))))
    p = fn(T(R0), T(t0), T(v0), T(bg0), T(ba0), tuple(map(T, prev)),
           preint_to_torch(preint, cuda_device), T(pts), T(uv), T(isig), T(valid), T(Rcb), T(tcb),
           NORM, **kw)
    torch.cuda.synchronize()
    for f in ("Rwb", "twb", "v", "bg", "ba"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f
    assert torch.equal(k.inliers, p.inliers)
    assert rel_err(k.H.cpu(), p.H.cpu()) < (1e-3 if joint else 1e-4)


@pytest.mark.gpu
def test_ba_kernel_deterministic(cuda_device):
    """K6 with fixed-order sums: 50 calls on one problem, one result."""
    from test_torch_ba import CAM, padded_problem
    arrs = padded_problem(0, 6)
    prob = ba.BAProblem(**{k: torch.from_numpy(v).to(cuda_device) for k, v in arrs.items()})
    first = ba.optimize(prob, CAM, n_iters=12, cg_iters=40)
    for _ in range(49):
        r = ba.optimize(prob, CAM, n_iters=12, cg_iters=40)
        assert all(torch.equal(getattr(r, f), getattr(first, f)) for f in ba.BAResult._fields)
