"""Bundle adjustment: the g2o replacement (port of
``extractorb_tpu/solver/ba.py``, the ``cg`` solver with the mono residual).

One Levenberg-Marquardt solver over (poses, points).  Each LM step runs
preconditioned conjugate gradients with a matrix-free Hessian-vector
product over the observation list and a block-Jacobi preconditioner (the
damped 6x6 pose and 3x3 point blocks); the sparse normal equations are
never formed.  Jacobians are analytic (the JAX module takes them with
``jax.jacfwd``): for the right perturbation R Exp(delta), delta = (rho,
phi), with A = J_pi R, the residual r = obs - pi(R p + t) has
J_pose = [-A | A hat(p)] and J_point = -A.

``optimize`` launches kernel K6 (``csrc/ba_pcg.cu``) on CUDA tensors and
runs ``optimize_plain`` on the CPU.  The stereo residual (``obs_ur``) and
``solver="schur_dense"`` are not ported (ROADMAP A.8 / B.21).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import lie
from ..core.camera import Pinhole
from .robust import CHI2_MONO, DELTA_MONO, huber_weight


class BAProblem(NamedTuple):
    R: torch.Tensor            # (K,3,3) world->cam
    t: torch.Tensor            # (K,3)
    points: torch.Tensor       # (P,3)
    obs_kf: torch.Tensor       # (O,) int32
    obs_mp: torch.Tensor       # (O,) int32
    obs_uv: torch.Tensor       # (O,2) float32
    inv_sigma2: torch.Tensor   # (O,)
    obs_valid: torch.Tensor    # (O,) bool
    fixed_kf: torch.Tensor     # (K,) bool
    fixed_mp: torch.Tensor     # (P,) bool
    obs_ur: Optional[torch.Tensor] = None  # stereo: not ported


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    inliers: torch.Tensor      # (O,) bool after chi2 classification
    cost: torch.Tensor


def _check_problem(p: BAProblem, solver: str):
    if p.obs_ur is not None:
        raise NotImplementedError("ba.optimize: the stereo residual is not ported (ROADMAP A.8)")
    if solver != "cg":
        raise NotImplementedError(f"ba.optimize: solver={solver!r} is not ported, only 'cg' "
                                  "(ROADMAP B.21)")


def _gather(R, t, points, p: BAProblem):
    """Per-observation R, t and world point; invalid (padding) slots get a
    point 1 m in front of their camera, so they stay finite."""
    Rk, tk = R[p.obs_kf.long()], t[p.obs_kf.long()]
    pw = points[p.obs_mp.long()]
    d = torch.tensor([0.0, 0.0, 1.0], dtype=pw.dtype, device=pw.device) - tk
    safe = torch.stack([Rk[:, 0, i] * d[:, 0] + Rk[:, 1, i] * d[:, 1] + Rk[:, 2, i] * d[:, 2]
                        for i in range(3)], -1)
    return Rk, tk, torch.where(p.obs_valid[:, None], pw, safe)


def _camera_point(Rk, tk, pw):
    return torch.stack([Rk[:, i, 0] * pw[:, 0] + Rk[:, i, 1] * pw[:, 1] + Rk[:, i, 2] * pw[:, 2]
                        + tk[:, i] for i in range(3)], -1)


def _residual(pc, uv, cam: Pinhole):
    return torch.stack([uv[:, 0] - (cam.fx * pc[:, 0] / pc[:, 2] + cam.cx),
                        uv[:, 1] - (cam.fy * pc[:, 1] / pc[:, 2] + cam.cy)], -1)


def _residual_jac(R, t, points, p: BAProblem, cam: Pinhole):
    """Residuals (O,2), pose Jacobians (O,2,6), point Jacobians (O,2,3)."""
    Rk, tk, pw = _gather(R, t, points, p)
    pc = _camera_point(Rk, tk, pw)
    r = _residual(pc, p.obs_uv, cam)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    iz = 1.0 / z
    zero = torch.zeros_like(z)
    Jpi = torch.stack([torch.stack([cam.fx * iz, zero, -cam.fx * x * iz * iz], -1),
                       torch.stack([zero, cam.fy * iz, -cam.fy * y * iz * iz], -1)], -2)
    A = Jpi @ Rk                                                     # (O,2,3)
    Ap = torch.linalg.cross(A, pw[:, None, :].expand_as(A), dim=-1)  # A hat(p)
    return r, torch.cat([-A, Ap], -1), -A


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate), det guarded at 1e-20."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    rows = [torch.stack([c00, c10, c20], -1), torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1)]
    return torch.stack(rows, -2) * inv_det[..., None, None]


def _rho(c2, use_huber: bool):
    if not use_huber:
        return c2
    d2 = DELTA_MONO * DELTA_MONO
    return torch.where(c2 <= d2, c2, 2.0 * DELTA_MONO * torch.sqrt(c2) - d2)


def optimize_plain(p: BAProblem, cam: Pinhole, n_iters: int = 10, cg_iters: int = 40,
                   use_huber: bool = True, chi2_outlier: float = CHI2_MONO,
                   solver: str = "cg") -> BAResult:
    """Plain version of ``optimize`` (same arguments)."""
    _check_problem(p, solver)
    K, P = p.R.shape[0], p.points.shape[0]
    dt = p.points.dtype
    dev = p.points.device
    kf_i, mp_i = p.obs_kf.long(), p.obs_mp.long()
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    free_mp = (~p.fixed_mp).to(dt)[:, None]
    valid = p.obs_valid
    I6 = torch.eye(6, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)

    def total_cost(Rc, tc, pc_):
        Rk, tk, pw = _gather(Rc, tc, pc_, p)
        rr2 = _residual(_camera_point(Rk, tk, pw), p.obs_uv, cam)
        c2 = torch.sum(rr2 * rr2, -1) * p.inv_sigma2
        return torch.sum(torch.where(valid, _rho(c2, use_huber), 0.0))

    R, t, points = p.R, p.t, p.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = torch.tensor(float("inf"), dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Jp, Jl = _residual_jac(R, t, points, p, cam)
        chi2 = torch.sum(r * r, -1) * p.inv_sigma2
        w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
        w = w * p.inv_sigma2 * valid.to(dt)
        Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
        bp = torch.zeros(K, 6, dtype=dt, device=dev).index_add_(
            0, kf_i, torch.einsum("oif,oi->of", Jpw, r)) * free_kf
        bl = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
            0, mp_i, torch.einsum("oif,oi->of", Jlw, r)) * free_mp
        Hpp = torch.zeros(K, 6, 6, dtype=dt, device=dev).index_add_(
            0, kf_i, torch.einsum("oif,oig->ofg", Jpw, Jp))
        Hll = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(
            0, mp_i, torch.einsum("oif,oig->ofg", Jlw, Jl))
        Mp = torch.linalg.inv(Hpp + lam * I6)
        Ml = _inv3x3(Hll + lam * I3)

        def hv(vp, vl):
            vp, vl = vp * free_kf, vl * free_mp
            u = torch.einsum("oif,of->oi", Jp, vp[kf_i]) + torch.einsum("oif,of->oi", Jl, vl[mp_i])
            uw = u * w[:, None]
            hp = torch.zeros(K, 6, dtype=dt, device=dev).index_add_(
                0, kf_i, torch.einsum("oif,oi->of", Jp, uw)) * free_kf
            hl = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
                0, mp_i, torch.einsum("oif,oi->of", Jl, uw)) * free_mp
            return hp + lam * vp, hl + lam * vl

        def precond(vp, vl):
            return (torch.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    torch.einsum("pfg,pg->pf", Ml, vl) * free_mp)

        def dot(a, b):
            return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

        x = (torch.zeros_like(bp), torch.zeros_like(bl))
        rr = (bp, bl)
        z = precond(*rr)
        pdir = z
        rz = dot(rr, z)
        for _ in range(cg_iters):
            Ap = hv(*pdir)
            alpha = rz / torch.clamp(dot(pdir, Ap), min=1e-20)
            x = (x[0] + alpha * pdir[0], x[1] + alpha * pdir[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            z = precond(*rr)
            rz_new = dot(rr, z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            pdir = (z[0] + beta * pdir[0], z[1] + beta * pdir[1])
            rz = rz_new
        dp, dl = -x[0], -x[1]

        dR, dtr = lie.se3_exp(dp)
        Rn = R @ dR
        tn = (R @ dtr[..., None])[..., 0] + t
        pn = points + dl
        c_new = total_cost(Rn, tn, pn)
        c_old = torch.sum(torch.where(valid, _rho(chi2, use_huber), 0.0))
        better = c_new < c_old
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        points = torch.where(better, pn, points)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        cost = torch.minimum(c_new, c_old)
    R = lie.orthonormalize(R)
    Rk, tk, pw = _gather(R, t, points, p)
    r = _residual(_camera_point(Rk, tk, pw), p.obs_uv, cam)
    chi2 = torch.sum(r * r, -1) * p.inv_sigma2
    return BAResult(R=R, t=t, points=points, inliers=valid & (chi2 <= chi2_outlier), cost=cost)


def optimize(p: BAProblem, cam: Pinhole, n_iters: int = 10, cg_iters: int = 40,
             use_huber: bool = True, chi2_outlier: float = CHI2_MONO,
             solver: str = "cg") -> BAResult:
    """LM bundle adjustment of a padded problem.

    Replaces ``extractorb_tpu/solver/ba.py:optimize`` (solver "cg", mono).
    Fixed keyframes/points stay where they are (g2o's setFixed).  On CUDA
    tensors this launches K6: every LM and PCG step is enqueued without a
    host synchronisation (alpha, beta, the cost and lambda stay on the
    card).  On the CPU it runs ``optimize_plain``."""
    _check_problem(p, solver)
    if not p.points.is_cuda:
        return optimize_plain(p, cam, n_iters, cg_iters, use_huber, chi2_outlier, solver)
    K, P, O = p.R.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    dev = p.points.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    b8 = lambda a: a.to(torch.bool).contiguous()
    R, t, pts = f32(p.R).clone(), f32(p.t).clone(), f32(p.points).clone()
    args = [i32(p.obs_kf), i32(p.obs_mp), f32(p.obs_uv), f32(p.inv_sigma2), b8(p.obs_valid),
            b8(p.fixed_kf), b8(p.fixed_mp)]
    kernels.require_cuda("ba_pcg", R, t, pts, *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.ba_workspace_bytes(K, P, O, cg_iters)), dtype=torch.uint8,
                     device=dev)
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.ba_pcg_launch(
        R.data_ptr(), t.data_ptr(), pts.data_ptr(), *[a.data_ptr() for a in args], K, P, O,
        cam.fx, cam.fy, cam.cx, cam.cy, n_iters, cg_iters, int(use_huber), float(chi2_outlier),
        ws.data_ptr(), inl.data_ptr(), cost.data_ptr(), kernels.stream())
    kernels.check(err, "ba_pcg")
    kernels.LAUNCHES["ba_pcg"] += 1
    return BAResult(R=R, t=t, points=pts, inliers=inl, cost=cost)
