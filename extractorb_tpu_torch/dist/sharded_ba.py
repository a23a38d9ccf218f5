"""The global bundle adjustment's Schur-complement solver (port of
``extractorb_tpu/dist/sharded_ba.py:optimize_schur_sharded``, one shard).

Levenberg-Marquardt over (poses, points) on the reduced camera system:
each step eliminates the landmarks with batched 3x3 inverses of the damped
Hll blocks, runs PCG (block-Jacobi on the damped 6x6 Hpp blocks) on

    (Hpp + lam - W (Hll + lam)^-1 W^T) dp = bp - W (Hll + lam)^-1 bl,

back-substitutes the landmarks and keeps the step only when the Huber
cost falls (lambda x0.5, else x4); the rotations are re-orthonormalized
at the end and the observations classified by chi2 <= 5.991.  The JAX
function shards landmarks and observations over a device mesh; on one
device it runs exactly this one-shard program (``dist/global_ba.py``).
A world size above one (the sharded solvers, ROADMAP A.14) raises
``NotImplementedError``.

Both project through the camera (``core.camera.Camera``: the pinhole or
the KB8 fisheye).  ``optimize_schur`` launches kernel K14
(``csrc/ba_schur.cu``, its ``Cam`` or ``CamKB8`` instantiation) on CUDA
tensors and runs ``optimize_schur_plain`` on the CPU.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from ..solver.ba import (BAProblem, BAResult, _camera_point, _gather, _inv3x3, _residual,
                         _residual_jac, _rho)
from ..solver.robust import CHI2_MONO, DELTA_MONO, huber_weight


def optimize_schur_plain(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 20,
                         use_huber: bool = True) -> BAResult:
    """Plain version of ``optimize_schur`` (same arguments)."""
    K, P = p.R.shape[0], p.points.shape[0]
    dt = p.points.dtype
    dev = p.points.device
    kf_i, mp_i = p.obs_kf.long(), p.obs_mp.long()
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    free_mp = (~p.fixed_mp).to(dt)[:, None]
    valid = p.obs_valid
    I6 = torch.eye(6, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)
    seg = lambda vals, idx, n: torch.zeros((n,) + vals.shape[1:], dtype=dt,
                                           device=dev).index_add_(0, idx, vals)

    def cost(Rc, tc, pc_):
        Rk, tk, pw = _gather(Rc, tc, pc_, p)
        r2 = _residual(_camera_point(Rk, tk, pw), p.obs_uv, cam)
        c2 = torch.sum(r2 * r2, -1) * p.inv_sigma2
        return torch.sum(torch.where(valid, _rho(c2, use_huber), 0.0))

    R, t, points = p.R, p.t, p.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Jp, Jl = _residual_jac(R, t, points, p, cam)
        chi2 = torch.sum(r * r, -1) * p.inv_sigma2
        w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
        w = w * p.inv_sigma2 * valid.to(dt)
        Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
        bp = seg(torch.einsum("oif,oi->of", Jpw, r), kf_i, K) * free_kf
        bl = seg(torch.einsum("oif,oi->of", Jlw, r), mp_i, P) * free_mp
        Ml = _inv3x3(seg(torch.einsum("oif,oig->ofg", Jlw, Jl), mp_i, P) + lam * I3)
        Hpp = seg(torch.einsum("oif,oig->ofg", Jpw, Jp), kf_i, K)
        Mp = torch.linalg.inv(Hpp + lam * I6)

        def wt_v(v):
            u = torch.einsum("oif,of->oi", Jp, v[kf_i]) * w[:, None]
            return seg(torch.einsum("oif,oi->of", Jl, u), mp_i, P) * free_mp

        def w_y(y):
            u = torch.einsum("oif,of->oi", Jl, y[mp_i]) * w[:, None]
            return seg(torch.einsum("oif,oi->of", Jp, u), kf_i, K) * free_kf

        def schur_mv(v):
            v = v * free_kf
            hv = torch.einsum("kfg,kg->kf", Hpp, v) * free_kf
            return hv + lam * v - w_y(torch.einsum("pfg,pg->pf", Ml, wt_v(v)))

        precond = lambda v: torch.einsum("kfg,kg->kf", Mp, v) * free_kf
        b_red = bp - w_y(torch.einsum("pfg,pg->pf", Ml, bl))
        x = torch.zeros(K, 6, dtype=dt, device=dev)
        rr = b_red
        z = precond(rr)
        pdir = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Ap = schur_mv(pdir)
            alpha = rz / torch.clamp(torch.sum(pdir * Ap), min=1e-20)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            pdir = z + beta * pdir
            rz = rz_new
        dp = -x
        dl = -torch.einsum("pfg,pg->pf", Ml, bl - wt_v(-dp)) * free_mp
        dR, dtr = lie.se3_exp(dp * free_kf)
        Rn = R @ dR
        tn = (R @ dtr[..., None])[..., 0] + t
        pn = points + dl
        better = cost(Rn, tn, pn) < cost(R, t, points)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        points = torch.where(better, pn, points)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    R = lie.orthonormalize(R)
    Rk, tk, pw = _gather(R, t, points, p)
    r = _residual(_camera_point(Rk, tk, pw), p.obs_uv, cam)
    chi2 = torch.sum(r * r, -1) * p.inv_sigma2
    return BAResult(R=R, t=t, points=points, inliers=valid & (chi2 <= CHI2_MONO),
                    cost=torch.sum(torch.where(valid, chi2, 0.0)))


def optimize_schur(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 20,
                   use_huber: bool = True, world_size: int = 1) -> BAResult:
    """LM bundle adjustment of a whole map on the reduced camera system.

    Replaces ``extractorb_tpu/dist/sharded_ba.py:optimize_schur_sharded``
    on a one-device mesh.  On CUDA tensors this launches K14: every LM and
    PCG step is enqueued without a host synchronisation (alpha, beta, the
    costs and lambda stay on the card); on the CPU it runs
    ``optimize_schur_plain``.  ``cam`` is a ``Pinhole`` or a
    ``KannalaBrandt8``."""
    if world_size != 1:
        raise NotImplementedError("optimize_schur: the sharded multi-device solve is not "
                                  "ported (ROADMAP A.14)")
    if p.obs_ur is not None:
        raise NotImplementedError("optimize_schur: the stereo residual is not ported "
                                  "(ROADMAP B.21)")
    if not p.points.is_cuda:
        return optimize_schur_plain(p, cam, n_iters, cg_iters, use_huber)
    K, P, O = p.R.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    dev = p.points.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    b8 = lambda a: a.to(torch.bool).contiguous()
    R, t, pts = f32(p.R).clone(), f32(p.t).clone(), f32(p.points).clone()
    args = [i32(p.obs_kf), i32(p.obs_mp), f32(p.obs_uv), f32(p.inv_sigma2), b8(p.obs_valid),
            b8(p.fixed_kf), b8(p.fixed_mp)]
    kernels.require_cuda("ba_schur", R, t, pts, *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.ba_schur_workspace_bytes(K, P, O, cg_iters)), dtype=torch.uint8,
                     device=dev)
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    kb8 = cam.kernel_params()
    err = lib.ba_schur_launch(
        R.data_ptr(), t.data_ptr(), pts.data_ptr(), *[a.data_ptr() for a in args], K, P, O,
        cam.fx, cam.fy, cam.cx, cam.cy, None if kb8 is None else kb8.ctypes.data, n_iters,
        cg_iters, int(use_huber), float(CHI2_MONO), ws.data_ptr(), inl.data_ptr(),
        cost.data_ptr(), kernels.stream())
    kernels.check(err, "ba_schur")
    kernels.LAUNCHES["ba_schur"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["ba_schur_kb8"] += 1   # of those, through the KB8 camera
    return BAResult(R=R, t=t, points=pts, inliers=inl, cost=cost)
