"""The global bundle adjustment's Schur-complement solver over landmark
shards (port of ``extractorb_tpu/dist/sharded_ba.py``).

Levenberg-Marquardt over (poses, points) on the reduced camera system:
each step eliminates the landmarks with batched 3x3 inverses of the damped
Hll blocks, runs PCG (block-Jacobi on the damped 6x6 Hpp blocks) on

    (Hpp + lam - W (Hll + lam)^-1 W^T) dp = bp - W (Hll + lam)^-1 bl,

back-substitutes the landmarks and keeps the step only when the Huber
cost falls (lambda x0.5, else x4); the rotations are re-orthonormalized
at the end and the observations classified by chi2 <= 5.991.

The landmarks and their observations are sharded over a device mesh
(``dist/mesh.py``): shard s holds points [s Ps, (s+1) Ps) and the
observations of those points, ``obs_mp`` global (``relayout_for_schur`` and
``dist/global_ba.py`` build that layout), and a copy of the poses.  Each
shard linearizes its own observations; bp, the Hpp blocks, the (K,6) W y
products and the costs are summed across shards in shard order, where the
JAX program psums.  On one shard that is the single-device program.

Both project through the camera (``core.camera.Camera``: the pinhole or
the KB8 fisheye).  ``optimize_schur`` launches kernel K14
(``csrc/ba_schur.cu``, its ``Cam`` or ``CamKB8`` instantiation) for one
shard and K30 (the same file, n shards) for more, on CUDA tensors, and runs
``optimize_schur_plain`` on the CPU.  The joint-PCG ``optimize_sharded``
and the inertial ``optimize_vi_sharded`` are not ported (ROADMAP A.14.3,
A.14.2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from ..solver.ba import (BAProblem, BAResult, _camera_point, _gather, _inv3x3, _residual,
                         _residual_jac, _rho)
from ..solver.robust import CHI2_MONO, DELTA_MONO, huber_weight
from .mesh import Mesh, cuda_ids, shard_sum


def _n_shards(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _shards(p: BAProblem, n: int):
    """The per-shard problems of a landmark-sharded layout: points and
    observations in n equal blocks, ``obs_mp`` made local to its shard."""
    P, O = p.points.shape[0], p.obs_kf.shape[0]
    if O % n or P % n:
        raise ValueError(f"optimize_schur: {P} points and {O} observations on {n} shards")
    if n == 1:
        return [p]
    Ps, Os = P // n, O // n
    out = []
    for s in range(n):
        o, q = slice(s * Os, (s + 1) * Os), slice(s * Ps, (s + 1) * Ps)
        out.append(p._replace(points=p.points[q], obs_kf=p.obs_kf[o],
                              obs_mp=p.obs_mp[o] - s * Ps, obs_uv=p.obs_uv[o],
                              inv_sigma2=p.inv_sigma2[o], obs_valid=p.obs_valid[o],
                              fixed_mp=p.fixed_mp[q]))
    return out


def optimize_schur_plain(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 20,
                         use_huber: bool = True, mesh: Mesh = None) -> BAResult:
    """Plain version of ``optimize_schur`` (same arguments): per-shard
    partials summed by ``shard_sum``, all on ``p``'s device."""
    shards = _shards(p, _n_shards(mesh))
    K = p.R.shape[0]
    dt = p.points.dtype
    dev = p.points.device
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    I6 = torch.eye(6, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)
    seg = lambda vals, idx, n: torch.zeros((n,) + vals.shape[1:], dtype=dt,
                                           device=dev).index_add_(0, idx, vals)
    # per shard: its problem, observation -> keyframe / local point, free points, points
    sh = [(q, q.obs_kf.long(), q.obs_mp.long(), (~q.fixed_mp).to(dt)[:, None], q.points.shape[0])
          for q in shards]

    def cost(Rc, tc, pts):
        parts = []
        for (q, _, _, _, _), pc_ in zip(sh, pts):
            Rk, tk, pw = _gather(Rc, tc, pc_, q)
            r2 = _residual(_camera_point(Rk, tk, pw), q.obs_uv, cam)
            c2 = torch.sum(r2 * r2, -1) * q.inv_sigma2
            parts.append(torch.sum(torch.where(q.obs_valid, _rho(c2, use_huber), 0.0)))
        return shard_sum(parts)

    R, t, pts = p.R, p.t, [q.points for q in shards]
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        lin, bps, Hpps = [], [], []
        for (q, kf_i, mp_i, free_mp, Ps), pq in zip(sh, pts):
            r, Jp, Jl = _residual_jac(R, t, pq, q, cam)
            chi2 = torch.sum(r * r, -1) * q.inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
            w = w * q.inv_sigma2 * q.obs_valid.to(dt)
            Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
            bps.append(seg(torch.einsum("oif,oi->of", Jpw, r), kf_i, K))
            bl = seg(torch.einsum("oif,oi->of", Jlw, r), mp_i, Ps) * free_mp
            Ml = _inv3x3(seg(torch.einsum("oif,oig->ofg", Jlw, Jl), mp_i, Ps) + lam * I3)
            Hpps.append(seg(torch.einsum("oif,oig->ofg", Jpw, Jp), kf_i, K))
            lin.append((Jp, Jl, w, bl, Ml))
        bp = shard_sum(bps) * free_kf
        Hpp = shard_sum(Hpps)
        Mp = torch.linalg.inv(Hpp + lam * I6)

        def wt_v(v):
            """W^T v, per shard: (K,6) -> each shard's (Ps,3)."""
            out = []
            for (_, kf_i, mp_i, free_mp, Ps), (Jp, Jl, w, _, _) in zip(sh, lin):
                u = torch.einsum("oif,of->oi", Jp, v[kf_i]) * w[:, None]
                out.append(seg(torch.einsum("oif,oi->of", Jl, u), mp_i, Ps) * free_mp)
            return out

        def w_y(ys):
            """W y summed across shards: the shards' (Ps,3) -> (K,6)."""
            parts = []
            for (_, kf_i, mp_i, _, _), (Jp, Jl, w, _, _), y in zip(sh, lin, ys):
                u = torch.einsum("oif,of->oi", Jl, y[mp_i]) * w[:, None]
                parts.append(seg(torch.einsum("oif,oi->of", Jp, u), kf_i, K))
            return shard_sum(parts) * free_kf

        ml = lambda vs: [torch.einsum("pfg,pg->pf", l[4], v) for l, v in zip(lin, vs)]

        def schur_mv(v):
            v = v * free_kf
            hv = torch.einsum("kfg,kg->kf", Hpp, v) * free_kf
            return hv + lam * v - w_y(ml(wt_v(v)))

        precond = lambda v: torch.einsum("kfg,kg->kf", Mp, v) * free_kf
        b_red = bp - w_y(ml([l[3] for l in lin]))
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
        dls = [-torch.einsum("pfg,pg->pf", l[4], l[3] - b) * s_[3]
               for l, b, s_ in zip(lin, wt_v(-dp), sh)]
        pn = [pq + dl for pq, dl in zip(pts, dls)]
        dR, dtr = lie.se3_exp(dp * free_kf)
        Rn = R @ dR
        tn = (R @ dtr[..., None])[..., 0] + t
        better = cost(Rn, tn, pn) < cost(R, t, pts)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        pts = [torch.where(better, a, b) for a, b in zip(pn, pts)]
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    R = lie.orthonormalize(R)
    inls, chis = [], []
    for (q, _, _, _, _), pq in zip(sh, pts):
        Rk, tk, pw = _gather(R, t, pq, q)
        r = _residual(_camera_point(Rk, tk, pw), q.obs_uv, cam)
        chi2 = torch.sum(r * r, -1) * q.inv_sigma2
        inls.append(q.obs_valid & (chi2 <= CHI2_MONO))
        chis.append(torch.sum(torch.where(q.obs_valid, chi2, 0.0)))
    cat = lambda a: a[0] if len(a) == 1 else torch.cat(a)
    return BAResult(R=R, t=t, points=cat(pts), inliers=cat(inls), cost=shard_sum(chis))


def _optimize_schur_kernel(p: BAProblem, cam: Camera, n_iters: int, cg_iters: int,
                           use_huber: bool) -> BAResult:
    """K14: one shard on ``p``'s card."""
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


def _optimize_schur_sharded_kernel(p: BAProblem, cam: Camera, n_iters: int, cg_iters: int,
                                   use_huber: bool, mesh: Mesh) -> BAResult:
    """K30: shard s's points, observations and a copy of the poses on
    ``mesh.devices[s]`` (a card); the points and inliers gathered back to
    shard 0's card in global order."""
    devs, dev_ids = mesh.devices, cuda_ids(mesh, "ba_schur_sharded")
    n, K = mesh.size, p.R.shape[0]
    shards = _shards(p, n)
    Ps, Os = shards[0].points.shape[0], shards[0].obs_kf.shape[0]
    lib = kernels.lib()
    ws_bytes = int(lib.ba_schur_workspace_bytes(K, Ps, Os, cg_iters))
    keep, rows = [], []
    for q, dev in zip(shards, devs):
        f32 = lambda a: a.to(device=dev, dtype=torch.float32).contiguous()
        i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()
        b8 = lambda a: a.to(device=dev, dtype=torch.bool).contiguous()
        t_ = [f32(p.R).clone(), f32(p.t).clone(), f32(q.points).clone(), i32(q.obs_kf),
              i32(q.obs_mp), f32(q.obs_uv), f32(q.inv_sigma2), b8(q.obs_valid), b8(p.fixed_kf),
              b8(q.fixed_mp), torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
              torch.empty(Os, dtype=torch.bool, device=dev)]
        kernels.require_cuda("ba_schur_sharded", *t_)
        keep.append(t_)
        rows.append([a.data_ptr() for a in t_] + [torch.cuda.current_stream(dev).cuda_stream])
    tab = np.asarray(rows, np.int64)
    peer = len(set(dev_ids.tolist())) > 1
    gather = (torch.empty(int(lib.ba_schur_gather_bytes(n, K)), dtype=torch.uint8,
                          device=devs[0]) if peer else None)
    cost = torch.empty((), dtype=torch.float32, device=devs[0])
    kb8 = cam.kernel_params()
    with torch.cuda.device(devs[0]):
        err = lib.ba_schur_sharded_launch(
            n, dev_ids.ctypes.data, tab.ctypes.data, K, Ps, Os, cam.fx, cam.fy, cam.cx, cam.cy,
            None if kb8 is None else kb8.ctypes.data, n_iters, cg_iters, int(use_huber),
            float(CHI2_MONO), None if gather is None else gather.data_ptr(), cost.data_ptr())
    kernels.check(err, "ba_schur_sharded")
    kernels.LAUNCHES["ba_schur_sharded"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["ba_schur_sharded_kb8"] += 1
    gather0 = lambda i: torch.cat([k[i].to(devs[0]) for k in keep])
    return BAResult(R=keep[0][0], t=keep[0][1], points=gather0(2), inliers=gather0(11),
                    cost=cost)


def optimize_schur(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 20,
                   use_huber: bool = True, mesh: Mesh = None) -> BAResult:
    """LM bundle adjustment of a whole map on the reduced camera system,
    its landmarks sharded over ``mesh`` (None: one shard).

    Replaces ``extractorb_tpu/dist/sharded_ba.py:optimize_schur_sharded``;
    with more than one shard the points and observations must be in its
    layout (both lengths multiples of the mesh size, each observation in
    its point's shard block).  On CUDA tensors this launches K14 for one
    shard and K30 for more: every LM and PCG step is enqueued without a
    host synchronisation (alpha, beta, the costs and lambda stay on the
    cards).  On the CPU it runs ``optimize_schur_plain``.  ``cam`` is a
    ``Pinhole`` or a ``KannalaBrandt8``."""
    if p.obs_ur is not None:
        raise NotImplementedError("optimize_schur: the stereo residual is not ported "
                                  "(ROADMAP B.21)")
    if not p.points.is_cuda:
        return optimize_schur_plain(p, cam, n_iters, cg_iters, use_huber, mesh)
    if _n_shards(mesh) == 1:
        return _optimize_schur_kernel(p, cam, n_iters, cg_iters, use_huber)
    return _optimize_schur_sharded_kernel(p, cam, n_iters, cg_iters, use_huber, mesh)


def optimize_sharded(mesh: Mesh, p: BAProblem, cam: Camera, n_iters: int = 10,
                     cg_iters: int = 30, use_huber: bool = True):
    """The joint-PCG BA with observations sharded and poses and points
    replicated (JAX ``sharded_ba.py:40``).  No engine path calls it."""
    raise NotImplementedError("optimize_sharded is not ported (ROADMAP A.14.3)")


def shard_layout(points, fixed_mp, obs_kf, obs_mp, obs_uv, obs_sig, n_dev: int,
                 block: int = 128):
    """The landmark-sharded layout, on host arrays: points padded to a
    multiple of ``n_dev`` (padding fixed at z = 1), observations grouped by
    their point's shard in a stable order, each group padded to a common
    multiple of ``block`` with invalid slots that address their shard's
    first point, ``obs_mp`` global.  Returns (points, fixed_mp, obs_kf,
    obs_mp, obs_uv, inv_sigma2, obs_valid)."""
    Pn = points.shape[0]
    Ps = -(-Pn // n_dev)
    P_pad = Ps * n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:Pn] = points
    fmp = np.ones(P_pad, bool)
    fmp[:Pn] = fixed_mp
    shard_of = obs_mp // Ps
    order = np.argsort(shard_of, kind="stable")
    obs_kf, obs_mp = obs_kf[order], obs_mp[order]
    obs_uv, obs_sig, shard_of = obs_uv[order], obs_sig[order], shard_of[order]
    counts = np.bincount(shard_of, minlength=n_dev)
    Os = int(np.ceil(max(int(counts.max()), 1) / block) * block)
    O_pad = Os * n_dev
    okf = np.zeros(O_pad, np.int32)
    omp = np.zeros(O_pad, np.int32)
    ouv = np.zeros((O_pad, 2), np.float32)
    osg = np.ones(O_pad, np.float32)
    ovl = np.zeros(O_pad, bool)
    start = 0
    for s in range(n_dev):
        n = int(counts[s])
        dst = s * Os
        okf[dst:dst + n] = obs_kf[start:start + n]
        omp[dst:dst + n] = obs_mp[start:start + n]
        ouv[dst:dst + n] = obs_uv[start:start + n]
        osg[dst:dst + n] = obs_sig[start:start + n]
        ovl[dst:dst + n] = True
        omp[dst + n:dst + Os] = s * Ps
        start += n
    return pts, fmp, okf, omp, ouv, osg, ovl


def relayout_for_schur(p: BAProblem, n_dev: int, block: int = 128) -> BAProblem:
    """Re-arrange a BAProblem into the landmark-sharded layout
    (``shard_layout``), dropping its own padding observations.  Host numpy,
    as the JAX function."""
    host = lambda a: a.detach().cpu().numpy()
    keep = host(p.obs_valid)
    out = shard_layout(host(p.points), host(p.fixed_mp), host(p.obs_kf)[keep],
                       host(p.obs_mp)[keep], host(p.obs_uv)[keep], host(p.inv_sigma2)[keep],
                       n_dev, block)
    pts, fmp, okf, omp, ouv, osg, ovl = (torch.from_numpy(a).to(p.points.device) for a in out)
    return p._replace(points=pts, obs_kf=okf, obs_mp=omp, obs_uv=ouv, inv_sigma2=osg,
                      obs_valid=ovl, fixed_mp=fmp)
