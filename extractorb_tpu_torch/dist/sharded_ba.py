"""Bundle adjustment over a device mesh (port of
``extractorb_tpu/dist/sharded_ba.py``).  Three solvers:

- ``optimize_schur``, the global bundle adjustment: Levenberg-Marquardt over
  (poses, points) on the reduced camera system.  Each step eliminates the
  landmarks with batched 3x3 inverses of the damped Hll blocks, runs PCG
  (block-Jacobi on the damped 6x6 Hpp blocks) on

      (Hpp + lam - W (Hll + lam)^-1 W^T) dp = bp - W (Hll + lam)^-1 bl,

  back-substitutes the landmarks and keeps the step only when the Huber
  cost falls (lambda x0.5, else x4); the rotations are re-orthonormalized
  at the end and the observations classified by chi2 <= 5.991.  The
  landmarks and their observations are sharded over the mesh
  (``dist/mesh.py``): shard s holds points [s Ps, (s+1) Ps) and the
  observations of those points, ``obs_mp`` global (``relayout_for_schur``
  and ``dist/global_ba.py`` build that layout), and a copy of the poses.
  Each shard linearizes its own observations; bp, the Hpp blocks, the (K,6)
  W y products and the costs are summed across shards in shard order,
  where the JAX program psums.  K14 (``csrc/ba_schur.cu``) for one shard,
  K30 (the same file, n shards) for more.
- ``optimize_vi_sharded``, the inertial post-loop GBA (FullInertialBA):
  the same landmark sharding (``relayout_point_sharded``) with the 15-dim
  states and the inertial chain on every shard.  K32 (``csrc/vi_ba.cu``,
  K20's passes per shard).
- ``optimize_sharded``, the joint-PCG BA: the observations sharded, the
  poses and points on every shard.  K33 (``csrc/ba_pcg.cu``, K6's passes
  per shard).  No engine path calls it.

``optimize_schur`` and ``optimize_sharded`` solve a problem's mono part
and ignore ``obs_ur``, as the JAX functions do: they rebuild the shard
problems from the mono fields (``extractorb_tpu/dist/sharded_ba.py:63-74``,
``:288-295``, ``:331-335``; ROADMAP C.2).

On one shard each is its single-device program.  They project through the
camera (``core.camera.Camera``: the pinhole or the KB8 fisheye), launch
their kernel (its ``Cam`` or ``CamKB8`` instantiation) on CUDA tensors and
run their plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from ..solver import inertial as sin
from ..solver.ba import (BAProblem, BAResult, _camera_point, _gather, _inv3x3, _residual,
                         _residual_jac, _rho)
from ..solver.inertial import VIBAProblem, VIBAResult
from ..solver.robust import CHI2_MONO, DELTA_MONO, huber_weight
from .mesh import Mesh, cuda_ids, landmark_shards, shard_sum


def _n_shards(mesh) -> int:
    return 1 if mesh is None else mesh.size


def optimize_schur_plain(p: BAProblem, cam: Camera, n_iters: int = 10, cg_iters: int = 20,
                         use_huber: bool = True, mesh: Mesh = None) -> BAResult:
    """Plain version of ``optimize_schur`` (same arguments): per-shard
    partials summed by ``shard_sum``, all on ``p``'s device; ``obs_ur`` is
    ignored, as JAX does."""
    p = p._replace(obs_ur=None)
    shards = landmark_shards(p, _n_shards(mesh), "optimize_schur")
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
            r2 = _residual(_camera_point(Rk, tk, pw), q, cam)
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
        r = _residual(_camera_point(Rk, tk, pw), q, cam)
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


def _shard_tables(mesh: Mesh, what: str, rows):
    """The launch table of a sharded kernel: ``rows`` (per shard, its
    tensors on its device), each followed by the shard's stream; the
    shards' CUDA device ids; and whether they span more than one card."""
    dev_ids = cuda_ids(mesh, what)
    for r in rows:
        kernels.require_cuda(what, *r)
    tab = np.asarray([[a.data_ptr() for a in r] + [torch.cuda.current_stream(d).cuda_stream]
                      for r, d in zip(rows, mesh.devices)], np.int64)
    return tab, dev_ids, len(set(dev_ids.tolist())) > 1


def _optimize_schur_sharded_kernel(p: BAProblem, cam: Camera, n_iters: int, cg_iters: int,
                                   use_huber: bool, mesh: Mesh) -> BAResult:
    """K30: shard s's points, observations and a copy of the poses on
    ``mesh.devices[s]`` (a card); the points and inliers gathered back to
    shard 0's card in global order."""
    n, K = mesh.size, p.R.shape[0]
    shards = landmark_shards(p, n, "optimize_schur")
    Ps, Os = shards[0].points.shape[0], shards[0].obs_kf.shape[0]
    lib = kernels.lib()
    ws_bytes = int(lib.ba_schur_workspace_bytes(K, Ps, Os, cg_iters))
    rows = []
    for q, dev in zip(shards, mesh.devices):
        f32 = lambda a: a.to(device=dev, dtype=torch.float32).contiguous()
        i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()
        b8 = lambda a: a.to(device=dev, dtype=torch.bool).contiguous()
        rows.append([f32(p.R).clone(), f32(p.t).clone(), f32(q.points).clone(), i32(q.obs_kf),
                     i32(q.obs_mp), f32(q.obs_uv), f32(q.inv_sigma2), b8(q.obs_valid),
                     b8(p.fixed_kf), b8(q.fixed_mp),
                     torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
                     torch.empty(Os, dtype=torch.bool, device=dev)])
    tab, dev_ids, peer = _shard_tables(mesh, "ba_schur_sharded", rows)
    dev0 = mesh.devices[0]
    gather = (torch.empty(int(lib.ba_schur_gather_bytes(n, K)), dtype=torch.uint8,
                          device=dev0) if peer else None)
    cost = torch.empty((), dtype=torch.float32, device=dev0)
    kb8 = cam.kernel_params()
    with torch.cuda.device(dev0):
        err = lib.ba_schur_sharded_launch(
            n, dev_ids.ctypes.data, tab.ctypes.data, K, Ps, Os, cam.fx, cam.fy, cam.cx, cam.cy,
            None if kb8 is None else kb8.ctypes.data, n_iters, cg_iters, int(use_huber),
            float(CHI2_MONO), None if gather is None else gather.data_ptr(), cost.data_ptr())
    kernels.check(err, "ba_schur_sharded")
    kernels.LAUNCHES["ba_schur_sharded"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["ba_schur_sharded_kb8"] += 1
    gather0 = lambda i: torch.cat([r[i].to(dev0) for r in rows])
    return BAResult(R=rows[0][0], t=rows[0][1], points=gather0(2), inliers=gather0(11),
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
    if not p.points.is_cuda:
        return optimize_schur_plain(p, cam, n_iters, cg_iters, use_huber, mesh)
    if _n_shards(mesh) == 1:
        return _optimize_schur_kernel(p, cam, n_iters, cg_iters, use_huber)
    return _optimize_schur_sharded_kernel(p, cam, n_iters, cg_iters, use_huber, mesh)


def _obs_shards(p: BAProblem, n: int):
    """The per-shard problems of an observation-sharded layout: the
    observations in n equal blocks (``obs_mp`` global), the poses and
    points every shard's."""
    O = p.obs_kf.shape[0]
    if O % n:
        raise ValueError(f"optimize_sharded: {O} observations on {n} shards")
    Os = O // n
    return [p._replace(obs_kf=p.obs_kf[o], obs_mp=p.obs_mp[o], obs_uv=p.obs_uv[o],
                       inv_sigma2=p.inv_sigma2[o], obs_valid=p.obs_valid[o])
            for o in (slice(s * Os, (s + 1) * Os) for s in range(n))]


def optimize_sharded_plain(mesh: Mesh, p: BAProblem, cam: Camera, n_iters: int = 10,
                           cg_iters: int = 40, use_huber: bool = True) -> BAResult:
    """Plain version of ``optimize_sharded`` (same arguments): per-shard
    partials summed by ``shard_sum``, all on ``p``'s device; ``obs_ur`` is
    ignored, as JAX does."""
    p = p._replace(obs_ur=None)
    with kernels.ordered_plain(p.points.is_cuda):
        return _optimize_sharded_plain(_obs_shards(p, mesh.size), p, cam, n_iters, cg_iters,
                                       use_huber)


def _optimize_sharded_plain(shards, p: BAProblem, cam: Camera, n_iters: int, cg_iters: int,
                            use_huber: bool) -> BAResult:
    K, P = p.R.shape[0], p.points.shape[0]
    dt, dev = p.points.dtype, p.points.device
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    free_mp = (~p.fixed_mp).to(dt)[:, None]
    I6 = torch.eye(6, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)
    seg = lambda vals, idx, n: torch.zeros((n,) + vals.shape[1:], dtype=dt,
                                           device=dev).index_add_(0, idx, vals)
    sh = [(q, q.obs_kf.long(), q.obs_mp.long()) for q in shards]

    def cost(Rc, tc, pc):
        parts = []
        for q, _, _ in sh:
            Rk, tk, pw = _gather(Rc, tc, pc, q)
            r2 = _residual(_camera_point(Rk, tk, pw), q, cam)
            c2 = torch.sum(r2 * r2, -1) * q.inv_sigma2
            parts.append(torch.sum(torch.where(q.obs_valid, _rho(c2, use_huber), 0.0)))
        return shard_sum(parts)

    R, t, points = p.R, p.t, p.points
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        lin, gp, gl, Hp, Hl = [], [], [], [], []
        for q, kf_i, mp_i in sh:
            r, Jp, Jl = _residual_jac(R, t, points, q, cam)
            chi2 = torch.sum(r * r, -1) * q.inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
            w = w * q.inv_sigma2 * q.obs_valid.to(dt)
            Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
            gp.append(seg(torch.einsum("oif,oi->of", Jpw, r), kf_i, K))
            gl.append(seg(torch.einsum("oif,oi->of", Jlw, r), mp_i, P))
            Hp.append(seg(torch.einsum("oif,oig->ofg", Jpw, Jp), kf_i, K))
            Hl.append(seg(torch.einsum("oif,oig->ofg", Jlw, Jl), mp_i, P))
            lin.append((Jp, Jl, w))
        g_pose, g_point = shard_sum(gp) * free_kf, shard_sum(gl) * free_mp
        Mp = torch.linalg.inv(shard_sum(Hp) + lam * I6)
        Ml = _inv3x3(shard_sum(Hl) + lam * I3)

        def hv(vp, vl):
            vp, vl = vp * free_kf, vl * free_mp
            hp, hl = [], []
            for (_, kf_i, mp_i), (Jp, Jl, w) in zip(sh, lin):
                u = (torch.einsum("oif,of->oi", Jp, vp[kf_i])
                     + torch.einsum("oif,of->oi", Jl, vl[mp_i]))
                uw = u * w[:, None]
                hp.append(seg(torch.einsum("oif,oi->of", Jp, uw), kf_i, K))
                hl.append(seg(torch.einsum("oif,oi->of", Jl, uw), mp_i, P))
            return (shard_sum(hp) * free_kf + lam * vp, shard_sum(hl) * free_mp + lam * vl)

        def precond(vp, vl):
            return (torch.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    torch.einsum("pfg,pg->pf", Ml, vl) * free_mp)

        def dot(a, b):
            return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

        x = (torch.zeros_like(g_pose), torch.zeros_like(g_point))
        rr = (g_pose, g_point)
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
        dR, dtr = lie.se3_exp(-x[0])
        Rn = R @ dR
        tn = (R @ dtr[..., None])[..., 0] + t
        pn = points - x[1]
        better = cost(Rn, tn, pn) < cost(R, t, points)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        points = torch.where(better, pn, points)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    R = lie.orthonormalize(R)
    inls, chis = [], []
    for q, _, _ in sh:
        Rk, tk, pw = _gather(R, t, points, q)
        r = _residual(_camera_point(Rk, tk, pw), q, cam)
        chi2 = torch.sum(r * r, -1) * q.inv_sigma2
        inls.append(q.obs_valid & (chi2 <= CHI2_MONO))
        chis.append(torch.sum(torch.where(q.obs_valid, chi2, 0.0)))
    return BAResult(R=R, t=t, points=points, inliers=torch.cat(inls), cost=shard_sum(chis))


def _optimize_sharded_kernel(mesh: Mesh, p: BAProblem, cam: Camera, n_iters: int,
                             cg_iters: int, use_huber: bool) -> BAResult:
    """K33: shard s's observations and a copy of the poses and points on
    ``mesh.devices[s]`` (a card); the inliers gathered back to shard 0's
    card in shard order."""
    n, K, P = mesh.size, p.R.shape[0], p.points.shape[0]
    shards = _obs_shards(p, n)
    Os = shards[0].obs_kf.shape[0]
    lib = kernels.lib()
    ws_bytes = int(lib.ba_workspace_bytes(K, P, Os, cg_iters, 0))
    rows = []
    for q, dev in zip(shards, mesh.devices):
        f32 = lambda a: a.to(device=dev, dtype=torch.float32).contiguous()
        i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()
        b8 = lambda a: a.to(device=dev, dtype=torch.bool).contiguous()
        rows.append([f32(p.R).clone(), f32(p.t).clone(), f32(p.points).clone(), i32(q.obs_kf),
                     i32(q.obs_mp), f32(q.obs_uv), f32(q.inv_sigma2), b8(q.obs_valid),
                     b8(p.fixed_kf), b8(p.fixed_mp),
                     torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
                     torch.empty(Os, dtype=torch.bool, device=dev)])
    tab, dev_ids, peer = _shard_tables(mesh, "ba_pcg_sharded", rows)
    dev0 = mesh.devices[0]
    gather = (torch.empty(int(lib.ba_pcg_gather_bytes(n, K, P)), dtype=torch.uint8,
                          device=dev0) if peer else None)
    cost = torch.empty((), dtype=torch.float32, device=dev0)
    kb8 = cam.kernel_params()
    with torch.cuda.device(dev0):
        err = lib.ba_pcg_sharded_launch(
            n, dev_ids.ctypes.data, tab.ctypes.data, K, P, Os, cam.fx, cam.fy, cam.cx, cam.cy,
            None if kb8 is None else kb8.ctypes.data, n_iters, cg_iters, int(use_huber),
            float(CHI2_MONO), None if gather is None else gather.data_ptr(), cost.data_ptr())
    kernels.check(err, "ba_pcg_sharded")
    kernels.LAUNCHES["ba_pcg_sharded"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["ba_pcg_sharded_kb8"] += 1
    return BAResult(R=rows[0][0], t=rows[0][1], points=rows[0][2],
                    inliers=torch.cat([r[11].to(dev0) for r in rows]), cost=cost)


def optimize_sharded(mesh: Mesh, p: BAProblem, cam: Camera, n_iters: int = 10,
                     cg_iters: int = 40, use_huber: bool = True) -> BAResult:
    """LM-PCG bundle adjustment with the observations sharded over ``mesh``
    and the poses and points on every shard (JAX ``sharded_ba.py:40``, its
    joint PCG).  The observation arrays' length must be a multiple of the
    mesh size (pad with ``obs_valid`` False).  Every shard linearizes its
    own observations; the pose and point gradients, the 6x6 and 3x3
    blocks, both halves of each Hessian product and the costs are summed
    across shards in shard order, and the rest runs on every shard on the
    same sums.  Returns the poses and points of shard 0, the inliers in
    shard order and the final sum of chi2 (JAX's).  On CUDA tensors this
    launches K33 (``csrc/ba_pcg.cu``, K6's passes per shard); on the CPU it
    runs ``optimize_sharded_plain``.  No engine path calls it."""
    if not p.points.is_cuda:
        return optimize_sharded_plain(mesh, p, cam, n_iters, cg_iters, use_huber)
    return _optimize_sharded_kernel(mesh, p, cam, n_iters, cg_iters, use_huber)


def _optimize_vi_sharded_kernel(mesh: Mesh, p: VIBAProblem, cam: Camera, n_iters: int,
                                cg_iters: int, use_huber: bool) -> VIBAResult:
    """K32: shard s's points, observations and a copy of the states and the
    chain on ``mesh.devices[s]`` (a card); the points and inliers gathered
    back to shard 0's card in shard order."""
    n, K = mesh.size, p.Rwb.shape[0]
    shards = landmark_shards(p, n, "optimize_vi_sharded")
    Ps, Os = shards[0].points.shape[0], shards[0].obs_kf.shape[0]
    lib = kernels.lib()
    ws_bytes = int(lib.vi_ba_workspace_bytes(K, Ps, Os, cg_iters))
    rows = []
    for q, dev in zip(shards, mesh.devices):
        f32 = lambda a: a.to(device=dev, dtype=torch.float32).contiguous()
        i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()
        b8 = lambda a: a.to(device=dev, dtype=torch.bool).contiguous()
        rows.append([
            torch.cat([f32(p.Rwb).reshape(-1, 9), f32(p.twb), f32(p.v), f32(p.bg), f32(p.ba)],
                      1).contiguous(),
            f32(q.points).clone(), sin.pack_preint(p.chain, dev), i32(q.obs_kf), i32(q.obs_mp),
            f32(q.obs_uv), f32(q.inv_sigma2), b8(q.obs_valid), b8(p.chain.valid),
            b8(p.fixed_kf), b8(q.fixed_mp),
            torch.cat([f32(p.Rcb).reshape(-1), f32(p.tcb).reshape(-1)]).contiguous(),
            torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
            torch.empty(Os, dtype=torch.bool, device=dev)])
    tab, dev_ids, peer = _shard_tables(mesh, "vi_ba_sharded", rows)
    dev0 = mesh.devices[0]
    gather = (torch.empty(int(lib.vi_ba_gather_bytes(n, K)), dtype=torch.uint8, device=dev0)
              if peer else None)
    cost = torch.empty((), dtype=torch.float32, device=dev0)
    kb8 = cam.kernel_params()
    with torch.cuda.device(dev0):
        err = lib.vi_ba_sharded_launch(
            n, dev_ids.ctypes.data, tab.ctypes.data, K, Ps, Os, cam.fx, cam.fy, cam.cx, cam.cy,
            None if kb8 is None else kb8.ctypes.data, float(p.prior_g), float(p.prior_a),
            n_iters, cg_iters, int(use_huber), float(CHI2_MONO),
            None if gather is None else gather.data_ptr(), cost.data_ptr())
    kernels.check(err, "vi_ba_sharded")
    kernels.LAUNCHES["vi_ba_sharded"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["vi_ba_sharded_kb8"] += 1   # of those, through the KB8 camera
    S = rows[0][0]
    gather0 = lambda i: torch.cat([r[i].to(dev0) for r in rows])
    return VIBAResult(Rwb=S[:, :9].reshape(K, 3, 3), twb=S[:, 9:12], v=S[:, 12:15],
                      bg=S[:, 15:18], ba=S[:, 18:21], points=gather0(1), inliers=gather0(13),
                      cost=cost)


def optimize_vi_sharded(mesh: Mesh, p: VIBAProblem, cam: Camera, n_iters: int = 8,
                        cg_iters: int = 40, use_huber: bool = True) -> VIBAResult:
    """FullInertialBA over the mesh (JAX ``sharded_ba.py:589``): the visual
    residuals and the landmarks sharded, the 15-dim states and the O(K)
    inertial chain on every shard.  The points and observations must be in
    ``relayout_point_sharded``'s layout (both lengths multiples of the mesh
    size, each observation in its point's shard block, ``obs_mp`` global).
    The visual gradient and 6x6 blocks, the visual part of each Hessian
    product, the landmark half of each PCG dot and the visual cost are
    summed across shards in shard order; the chain and the priors are added
    once to those sums, on every shard.  Returns shard 0's states and the
    points and inliers in shard order.  On CUDA tensors this launches K32
    (``csrc/vi_ba.cu``, K20's passes per shard); on the CPU it runs
    ``solver/inertial.optimize_vi_ba_plain`` over the mesh."""
    if not p.points.is_cuda:
        return sin.optimize_vi_ba_plain(p, cam, n_iters, cg_iters, use_huber, mesh=mesh)
    return _optimize_vi_sharded_kernel(mesh, p, cam, n_iters, cg_iters, use_huber)


def _group_by_shard(obs_kf, obs_mp, obs_uv, obs_sig, Ps: int, n_dev: int, block: int):
    """Observations grouped by their point's shard (``obs_mp // Ps``) in a
    stable order, each group padded to a common multiple of ``block`` with
    invalid slots that address their shard's first point, ``obs_mp``
    global.  Returns (obs_kf, obs_mp, obs_uv, inv_sigma2, obs_valid)."""
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
    return okf, omp, ouv, osg, ovl


def shard_layout(points, fixed_mp, obs_kf, obs_mp, obs_uv, obs_sig, n_dev: int,
                 block: int = 128):
    """The landmark-sharded layout, on host arrays: points padded to a
    multiple of ``n_dev`` (padding fixed at z = 1), the observations
    grouped by ``_group_by_shard``.  Returns (points, fixed_mp, obs_kf,
    obs_mp, obs_uv, inv_sigma2, obs_valid)."""
    Pn = points.shape[0]
    Ps = -(-Pn // n_dev)
    P_pad = Ps * n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:Pn] = points
    fmp = np.ones(P_pad, bool)
    fmp[:Pn] = fixed_mp
    return (pts, fmp) + _group_by_shard(obs_kf, obs_mp, obs_uv, obs_sig, Ps, n_dev, block)


def relayout_point_sharded(obs_kf, obs_mp, obs_uv, obs_sig, obs_val, P: int, n_dev: int):
    """The valid observations of a problem of ``P`` points (a multiple of
    ``n_dev``; the points are kept as they are) grouped by their point's
    shard and padded to a multiple of 128 (``_group_by_shard``): the layout
    of ``optimize_vi_sharded``.  Host numpy, as JAX
    ``dist/sharded_ba.py:553``.  Returns (obs_kf, obs_mp, obs_uv,
    inv_sigma2, obs_valid)."""
    if P % n_dev:
        raise ValueError(f"relayout_point_sharded: {P} points on {n_dev} shards")
    live = np.asarray(obs_val, bool)
    return _group_by_shard(np.asarray(obs_kf)[live], np.asarray(obs_mp)[live],
                           np.asarray(obs_uv)[live], np.asarray(obs_sig)[live], P // n_dev,
                           n_dev, 128)


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
