"""Bundle adjustment: the g2o replacement (port of
``extractorb_tpu/solver/ba.py``).

One Levenberg-Marquardt solver over (poses, points).  ``solver="cg"``
runs preconditioned conjugate gradients in each LM step, with a
matrix-free Hessian-vector product over the observation list and a
block-Jacobi preconditioner (the damped 6x6 pose and 3x3 point blocks);
the sparse normal equations are never formed.  ``solver="schur_dense"``
eliminates the points with closed-form 3x3 inverses and solves the dense
(6K, 6K) reduced camera system directly.  Jacobians are analytic (the
JAX module takes them with ``jax.jacfwd`` through the projection
closure): for the right perturbation R Exp(delta), delta = (rho, phi),
with A = J_pi R, the residual r = obs - pi(R p + t) has
J_pose = [-A | A hat(p)] and J_point = -A; J_pi is the camera's
``project_jac`` (pinhole, or KB8 in float64).  With ``obs_ur`` an
observation with ur >= 0 has a third row ur - (u - bf / z) (reference
EdgeStereo), whose row of A is A's first row plus (bf / z^2) times R's
third row; it is zero where ur < 0.

``optimize`` launches kernel K6 (``csrc/ba_pcg.cu``, with the camera and
the stereo rows as template parameters) on CUDA tensors: with ``cg`` the
whole solve is one launch of one thread-block cluster; with
``schur_dense`` K6's passes are launched one by one around kernel K35
(``csrc/ba_schur_dense.cu``), between the linearization and the
retraction.  On the CPU it runs ``optimize_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


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
    obs_ur: Optional[torch.Tensor] = None  # (O,) right-image u; <0 = mono


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    inliers: torch.Tensor      # (O,) bool after chi2 classification
    cost: torch.Tensor


SOLVERS = ("cg", "schur_dense")


def _check_solver(solver: str):
    if solver not in SOLVERS:
        raise ValueError(f"ba.optimize: solver={solver!r}, expected one of {SOLVERS}")


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


def _residual(pc, p: BAProblem, cam, bf: float = 0.0):
    """Residuals (O,2), or (O,3) with ``p.obs_ur``: the third row
    ur - (u - bf / z), 0 where ur < 0."""
    uv = cam.project(pc)
    r = p.obs_uv - uv
    if p.obs_ur is None:
        return r
    r3 = torch.where(p.obs_ur >= 0, p.obs_ur - (uv[:, 0] - bf / pc[:, 2]), 0.0)
    return torch.cat([r, r3[:, None]], -1)


def _residual_jac(R, t, points, p: BAProblem, cam, bf: float = 0.0):
    """Residuals (O,k), pose Jacobians (O,k,6), point Jacobians (O,k,3):
    k = 2, or 3 with ``p.obs_ur`` (the third row's A is A's first row plus
    bf / z^2 times R's third row, zero where ur < 0)."""
    Rk, tk, pw = _gather(R, t, points, p)
    pc = _camera_point(Rk, tk, pw)
    r = _residual(pc, p, cam, bf)
    A = cam.project_jac(pc) @ Rk                                                     # (O,2,3)
    if p.obs_ur is not None:
        a3 = A[:, 0, :] + (bf / (pc[:, 2] * pc[:, 2]))[:, None] * Rk[:, 2, :]
        A = torch.cat([A, torch.where((p.obs_ur >= 0)[:, None], a3, 0.0)[:, None, :]], 1)
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


def _rho(c2, use_huber: bool, delta=DELTA_MONO):
    if not use_huber:
        return c2
    d2 = delta * delta
    return torch.where(c2 <= d2, c2, 2.0 * delta * torch.sqrt(c2) - d2)


def _gates(p: BAProblem, chi2_outlier: float):
    """The Huber delta and chi2 gate of each observation: the stereo
    values on a stereo row (ur >= 0), else the mono ones."""
    if p.obs_ur is None:
        return DELTA_MONO, chi2_outlier
    st = p.obs_ur >= 0
    return torch.where(st, DELTA_STEREO, DELTA_MONO), torch.where(st, CHI2_STEREO, chi2_outlier)


def optimize_plain(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 40,
                   use_huber: bool = True, chi2_outlier: float = CHI2_MONO, bf: float = 0.0,
                   solver: str = "cg") -> BAResult:
    """Plain version of ``optimize`` (same arguments); on the card its sums
    run in PyTorch's deterministic order (``kernels.ordered_plain``)."""
    _check_solver(solver)
    with kernels.ordered_plain(p.points.is_cuda):
        return _optimize_plain(p, cam, n_iters, cg_iters, use_huber, chi2_outlier, bf, solver)


def _linearize(R, t, points, p: BAProblem, cam, bf: float, delta_h, use_huber: bool,
               free_kf, free_mp):
    """One LM step's linearization: residuals r, Jacobians Jp, Jl, IRLS
    weights w, chi2, Jp w, the masked gradients bp, bl and the diagonal
    blocks Hpp, Hll."""
    K, P = p.R.shape[0], p.points.shape[0]
    dt, dev = p.points.dtype, p.points.device
    kf_i, mp_i = p.obs_kf.long(), p.obs_mp.long()
    r, Jp, Jl = _residual_jac(R, t, points, p, cam, bf)
    chi2 = torch.sum(r * r, -1) * p.inv_sigma2
    w = huber_weight(chi2, delta_h) if use_huber else torch.ones_like(chi2)
    w = w * p.inv_sigma2 * p.obs_valid.to(dt)
    Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
    bp = torch.zeros(K, 6, dtype=dt, device=dev).index_add_(
        0, kf_i, torch.einsum("oif,oi->of", Jpw, r)) * free_kf
    bl = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
        0, mp_i, torch.einsum("oif,oi->of", Jlw, r)) * free_mp
    Hpp = torch.zeros(K, 6, 6, dtype=dt, device=dev).index_add_(
        0, kf_i, torch.einsum("oif,oig->ofg", Jpw, Jp))
    Hll = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(
        0, mp_i, torch.einsum("oif,oig->ofg", Jlw, Jl))
    return r, Jp, Jl, w, chi2, Jpw, bp, bl, Hpp, Hll


def _schur_dense_system(p: BAProblem, Jpw, Jl, Hpp, Hll, bp, bl, lam, free_kf):
    """The points eliminated, in the JAX function's arithmetic
    (``ba.py:217-237``): the dense (K,P,6,3) W C and W products, every
    point's block in S (a fixed point too), fixed keyframes' rows and
    columns made identity.  Returns the reduced system S (6K,6K), its
    right-hand side, W per observation and the point blocks' inverses."""
    K, P = Hpp.shape[0], Hll.shape[0]
    dt, dev = Hpp.dtype, Hpp.device
    kf_i, mp_i = p.obs_kf.long(), p.obs_mp.long()
    Ml = _inv3x3(Hll + lam * torch.eye(3, dtype=dt, device=dev))
    W_o = torch.einsum("oif,oig->ofg", Jpw, Jl)                     # (O,6,3)
    A_o = torch.einsum("ofg,ogh->ofh", W_o, Ml[mp_i])               # W C
    G1 = torch.zeros(K, P, 6, 3, dtype=dt, device=dev).index_put_((kf_i, mp_i), A_o,
                                                                   accumulate=True)
    G2 = torch.zeros(K, P, 6, 3, dtype=dt, device=dev).index_put_((kf_i, mp_i), W_o,
                                                                   accumulate=True)
    G1m = G1.transpose(1, 2).reshape(K * 6, P * 3)
    G2m = G2.transpose(1, 2).reshape(K * 6, P * 3)
    S = -(G1m @ G2m.T)
    kk = torch.arange(K, device=dev)
    S = S.reshape(K, 6, K, 6)
    S[kk, :, kk, :] += Hpp + lam * torch.eye(6, dtype=dt, device=dev)
    S = S.reshape(K * 6, K * 6)
    b_red = bp.reshape(-1) - G1m @ bl.reshape(-1)
    fvec = free_kf[:, 0].repeat_interleave(6)
    S = S * fvec[:, None] * fvec[None, :] + torch.diag(1.0 - fvec)
    return S, b_red * fvec, W_o, Ml


def _schur_dense_step(p: BAProblem, Jpw, Jl, Hpp, Hll, bp, bl, lam, free_kf, free_mp):
    """The dense solve and the back-substitution (``ba.py:238-243``):
    returns the steps (xp, xl)."""
    S, b, W_o, Ml = _schur_dense_system(p, Jpw, Jl, Hpp, Hll, bp, bl, lam, free_kf)
    K, P = Hpp.shape[0], Hll.shape[0]
    xp = torch.linalg.solve(S, b).reshape(K, 6) * free_kf
    wtd = torch.zeros(P, 3, dtype=Hpp.dtype, device=Hpp.device).index_add_(
        0, p.obs_mp.long(), torch.einsum("ofg,of->og", W_o, xp[p.obs_kf.long()]))
    return xp, torch.einsum("pfg,pg->pf", Ml, bl - wtd) * free_mp


def _optimize_plain(p: BAProblem, cam: Camera, n_iters: int, cg_iters: int, use_huber: bool,
                    chi2_outlier: float, bf: float, solver: str) -> BAResult:
    dt = p.points.dtype
    dev = p.points.device
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    free_mp = (~p.fixed_mp).to(dt)[:, None]
    valid = p.obs_valid
    delta_h, chi2_th = _gates(p, chi2_outlier)
    I6 = torch.eye(6, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)

    def total_cost(Rc, tc, pc_):
        Rk, tk, pw = _gather(Rc, tc, pc_, p)
        rr2 = _residual(_camera_point(Rk, tk, pw), p, cam, bf)
        c2 = torch.sum(rr2 * rr2, -1) * p.inv_sigma2
        return torch.sum(torch.where(valid, _rho(c2, use_huber, delta_h), 0.0))

    R, t, points = p.R, p.t, p.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = torch.tensor(float("inf"), dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Jp, Jl, w, chi2, Jpw, bp, bl, Hpp, Hll = _linearize(
            R, t, points, p, cam, bf, delta_h, use_huber, free_kf, free_mp)
        if solver == "schur_dense":
            x = _schur_dense_step(p, Jpw, Jl, Hpp, Hll, bp, bl, lam, free_kf, free_mp)
        else:
            x = _pcg(p, Jp, Jl, w, Hpp, Hll, bp, bl, lam, free_kf, free_mp, cg_iters, I6, I3)
        dp, dl = -x[0], -x[1]

        dR, dtr = lie.se3_exp(dp)
        Rn = R @ dR
        tn = (R @ dtr[..., None])[..., 0] + t
        pn = points + dl
        c_new = total_cost(Rn, tn, pn)
        c_old = torch.sum(torch.where(valid, _rho(chi2, use_huber, delta_h), 0.0))
        better = c_new < c_old
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        points = torch.where(better, pn, points)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        cost = torch.minimum(c_new, c_old)
    R = lie.orthonormalize(R)
    Rk, tk, pw = _gather(R, t, points, p)
    r = _residual(_camera_point(Rk, tk, pw), p, cam, bf)
    chi2 = torch.sum(r * r, -1) * p.inv_sigma2
    return BAResult(R=R, t=t, points=points, inliers=valid & (chi2 <= chi2_th), cost=cost)


def _pcg(p: BAProblem, Jp, Jl, w, Hpp, Hll, bp, bl, lam, free_kf, free_mp, cg_iters: int,
         I6, I3):
    """The PCG steps (xp, xl) of one LM iteration: matrix-free (H + lam I)
    products, block-Jacobi preconditioner."""
    K, P = Hpp.shape[0], Hll.shape[0]
    dt, dev = Hpp.dtype, Hpp.device
    kf_i, mp_i = p.obs_kf.long(), p.obs_mp.long()
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
    return x


def optimize(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 40,
             use_huber: bool = True, chi2_outlier: float = CHI2_MONO, bf: float = 0.0,
             solver: str = "cg") -> BAResult:
    """LM bundle adjustment of a padded problem.

    Replaces ``extractorb_tpu/solver/ba.py:optimize``.  Fixed
    keyframes/points stay where they are (g2o's setFixed).  With
    ``p.obs_ur`` (and ``bf`` = fx * baseline) an observation with
    ur >= 0 is a stereo edge: the 3-row residual, Huber delta sqrt(7.815)
    and the chi2 gate 7.815.  ``solver`` is "cg" (matrix-free PCG) or
    "schur_dense" (the dense reduced camera system, for window problems).
    On CUDA tensors this launches K6 (``<stereo>`` with ``obs_ur``): with
    "cg" one cluster launch runs the whole solve; with "schur_dense" K6's
    passes and K35 are launched step by step.  Nothing waits on the host
    (alpha, beta, the cost and lambda stay on the card), and a cluster
    the card cannot place raises.  ``cam`` is a ``Pinhole`` or a ``KannalaBrandt8``.  On the CPU
    it runs ``optimize_plain``."""
    _check_solver(solver)
    if not p.points.is_cuda:
        return optimize_plain(p, cam, n_iters, cg_iters, use_huber, chi2_outlier, bf, solver)
    K, P, O = p.R.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    dev = p.points.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    b8 = lambda a: a.to(torch.bool).contiguous()
    R, t, pts = f32(p.R).clone(), f32(p.t).clone(), f32(p.points).clone()
    args = [i32(p.obs_kf), i32(p.obs_mp), f32(p.obs_uv), f32(p.inv_sigma2), b8(p.obs_valid),
            b8(p.fixed_kf), b8(p.fixed_mp)]
    ur = None if p.obs_ur is None else f32(p.obs_ur)
    kernels.require_cuda("ba_pcg", R, t, pts, *args, *([] if ur is None else [ur]))
    if ur is not None and ur.shape != (O,):
        raise ValueError(f"ba.optimize: obs_ur is {tuple(ur.shape)}, expected ({O},)")
    dense = solver == "schur_dense"
    if dense and K > 256:
        raise ValueError(f"ba.optimize: schur_dense on the card takes K <= 256, got {K}")
    lib = kernels.lib()
    ws = torch.empty(int(lib.ba_workspace_bytes(K, P, O, cg_iters, int(ur is not None))),
                     dtype=torch.uint8, device=dev)
    dws = (torch.empty(int(lib.ba_schur_dense_workspace_bytes(K, P, O)), dtype=torch.uint8,
                       device=dev) if dense else None)
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    kb8 = cam.kernel_params()
    err = lib.ba_pcg_launch(
        R.data_ptr(), t.data_ptr(), pts.data_ptr(), *[a.data_ptr() for a in args],
        None if ur is None else ur.data_ptr(), float(bf), K, P, O,
        cam.fx, cam.fy, cam.cx, cam.cy, None if kb8 is None else kb8.ctypes.data, n_iters,
        cg_iters, int(use_huber), float(chi2_outlier), ws.data_ptr(),
        None if dws is None else dws.data_ptr(), inl.data_ptr(), cost.data_ptr(),
        kernels.stream())
    kernels.check(err, "ba_schur_dense" if dense else "ba_pcg")
    kernels.LAUNCHES["ba_pcg"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["ba_pcg_kb8"] += 1     # of those, through the KB8 camera
    if ur is not None:
        kernels.LAUNCHES["ba_pcg_stereo"] += 1  # of those, with the stereo rows
        if kb8 is not None:
            kernels.LAUNCHES["ba_pcg_stereo_kb8"] += 1   # and through the KB8 camera
    if dense:
        kernels.LAUNCHES["ba_schur_dense"] += 1
    return BAResult(R=R, t=t, points=pts, inliers=inl, cost=cost)
