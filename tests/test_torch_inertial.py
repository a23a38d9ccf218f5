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


def pose_case(seed, joint):
    rng = np.random.default_rng(seed)
    n_pts = 150
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


@pytest.mark.gpu
def test_vi_ba_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    prob, _, truth = _vi_problem(rng, perturb=1.0)
    prob = viba_to_torch(fix_frames(prob, truth, (0, 2)), cuda_device)
    k = vi.optimize_vi_ba(prob, NORM, n_iters=6, cg_iters=40)
    p = vi.optimize_vi_ba_plain(prob, NORM, n_iters=6, cg_iters=40)
    torch.cuda.synchronize()
    for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() < 1e-4, f
    assert torch.equal(k.inliers, p.inliers)
    again = vi.optimize_vi_ba(prob, NORM, n_iters=6, cg_iters=40)
    assert all(torch.equal(getattr(again, f), getattr(k, f)) for f in vi.VIBAResult._fields)


@pytest.mark.gpu
@pytest.mark.parametrize("joint,with_prior", [(False, False), (True, True)])
def test_pose_inertial_kernel_matches_plain(cuda_device, joint, with_prior):
    args, prior = pose_case(7, joint)
    prior = prior if with_prior else None
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
