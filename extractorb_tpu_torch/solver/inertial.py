"""Visual-inertial optimisation (port of ``extractorb_tpu/solver/inertial.py``).

Replaces the reference's inertial Optimizer entry points with four solvers
sharing the preintegration residual of ``imu/preintegration.py``:

- ``optimize_vi_ba``: LocalInertialBA / FullInertialBA (src/Optimizer.cc:4413
  / :420), visual reprojection edges, the 9-dim EdgeInertial chain, the
  EdgeGyroRW / EdgeAccRW bias walks and KF0's bias priors, LM with a
  matrix-free PCG over 15-dim keyframe states and 3-dim points.  Kernel
  K20 (``csrc/vi_ba.cu``).
- ``inertial_only``: InertialOptimization (src/Optimizer.cc:5142), gravity
  direction (2-DoF), scale, velocities and one shared bias with the poses
  fixed (EdgeInertialGS), dense LM.  Kernel K21 (``csrc/inertial_init.cu``).
- ``optimize_pose_inertial`` and ``optimize_pose_inertial_last_frame``:
  PoseInertialOptimizationLastKeyFrame / LastFrame (src/Optimizer.cc:7327 /
  :7722), the tracking-time 15-dim state against visual unary edges and one
  inertial edge, 4 chi2 rounds x 10 Gauss-Newton iterations; the joint
  variant solves the previous and the current state together against the
  previous state's marginalisation prior and marginalises the previous
  state out of the final 30x30 Hessian.  Kernel K22
  (``csrc/pose_inertial.cu``).

States are body-in-world (Rwb, twb, v, bg, ba); the camera sees a point
through the fixed extrinsics Tcb.  Edge residuals are whitened with the
Cholesky factor of the preintegration information.

The camera (``core.camera``: ``Pinhole`` or ``KannalaBrandt8``) projects
every visual residual.  Each solver dispatches on its tensors' device: CUDA
tensors launch the kernel's instantiation for the camera, CPU tensors run
the plain version (``*_plain``), which takes its Jacobians with
``torch.func.jacfwd`` as the JAX package takes them with ``jax.jacfwd``,
but the projection's part in closed form (``cam.project_jac``, chained onto
the forward-mode Jacobian of the camera-frame point).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from ..imu import preintegration as pre
from . import marginal as mg
from .robust import CHI2_MONO, DELTA_MONO, huber_weight

GRAVITY = 9.81


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _cast(tree, dtype):
    """``tree`` with every floating tensor cast to ``dtype`` (tuples and
    NamedTuples kept)."""
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        vals = [_cast(v, dtype) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _leaves(tree):
    """The tensors of a tree of tuples and NamedTuples."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _leaves(v)]
    return []


def _jac(fn, argnums=0, in_dims=None, wide: bool = False):
    """``jacfwd(fn, argnums)`` (``vmap`` of it with ``in_dims`` when given)
    with the forward-mode pass in float64 and the Jacobians returned in
    float32 (float64 when every floating argument is float64, or ``wide``).
    ``fn`` must take every tensor it reads as an argument.
    PyTorch's forward-mode AD promotes the tangent of a 0-dim float32
    tensor combined with a Python scalar to float64, so a float32 pass
    through the Lie maps fails; the JAX package takes these Jacobians in
    float32, a difference far below the tests' tolerances."""
    jf = jacfwd(fn, argnums=argnums)
    if in_dims is not None:
        jf = vmap(jf, in_dims=in_dims)

    def run(*args):
        w = wide or _wide(args)
        return _cast(jf(*_cast(args, torch.float64)), torch.float64 if w else torch.float32)

    return run


def _wide(args) -> bool:
    return all(a.dtype == torch.float64 for a in _leaves(args) if a.is_floating_point())


def _camera_jac(cam: Camera, fn, argnums=0, in_dims=None):
    """Jacobians of ``(uv - cam.project(pc), *rest)`` where ``fn(*args)``
    returns ``(pc, *rest)`` (camera-frame points (N,3) first; ``vmap`` of
    ``fn`` with ``in_dims`` when given): the projection's part in closed
    form (``cam.project_jac``, float64) chained onto ``jacfwd`` of ``pc``,
    everything in float64 and returned in float32 (float64 when every
    floating argument is)."""
    jf = _jac(fn, argnums, in_dims, wide=True)
    fv = fn if in_dims is None else vmap(fn, in_dims=in_dims)

    def run(*args):
        J = jf(*args)
        pc = fv(*_cast(args, torch.float64))[0]
        Jr = -cam.project_jac(pc) @ J[0]
        return _cast((Jr,) + tuple(J[1:]), torch.float64 if _wide(args) else torch.float32)

    return run


def _gvec(dtype, device):
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=device)


class InertialChain(NamedTuple):
    """Per-keyframe preintegration from its temporal predecessor (edge k
    connects KF k-1 -> KF k; k = 0 and broken chains have valid False)."""
    dR: torch.Tensor      # (K,3,3)
    dV: torch.Tensor      # (K,3)
    dP: torch.Tensor      # (K,3)
    JRg: torch.Tensor     # (K,3,3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dT: torch.Tensor      # (K,)
    C: torch.Tensor       # (K,15,15)
    bias0: torch.Tensor   # (K,6) bias used at integration time
    valid: torch.Tensor   # (K,) bool


def stack_chain(preints, valids, device=None) -> InertialChain:
    """Stack per-keyframe Preintegrated tuples (their fields may be numpy
    arrays or tensors) into an InertialChain on ``device``."""
    def f(field):
        arr = np.stack([np.asarray(getattr(p, field) if not torch.is_tensor(getattr(p, field))
                                   else getattr(p, field).cpu().numpy(), np.float32)
                        for p in preints])
        return torch.from_numpy(arr).to(device)

    return InertialChain(
        dR=f("dR"), dV=f("dV"), dP=f("dP"), JRg=f("JRg"), JVg=f("JVg"), JVa=f("JVa"),
        JPg=f("JPg"), JPa=f("JPa"), dT=f("dT"), C=f("C"), bias0=f("bias"),
        valid=torch.from_numpy(np.asarray(valids, bool)).to(device),
    )


def info_sqrt(C, eps: float = 1e-8):
    """Lower Cholesky factor L of (C + eps I)^-1: the whitened residual is
    L^T r."""
    n = C.shape[-1]
    Ci = torch.linalg.inv(C + eps * torch.eye(n, dtype=C.dtype, device=C.device))
    Ci = 0.5 * (Ci + Ci.transpose(-1, -2))
    return torch.linalg.cholesky(Ci)


def apply_delta(R, t, v, bg, ba, d):
    """The 15-dim retraction of VertexPose / VertexVelocity / Vertex*Bias:
    right-multiplicative rotation, body-frame translation step."""
    return (R @ lie.so3_exp(d[..., 0:3]), t + _mv(R, d[..., 3:6]), v + d[..., 6:9],
            bg + d[..., 9:12], ba + d[..., 12:15])


def edge_resid15(p: pre.Preintegrated, Lr, Lb, g, Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj, baj):
    """Whitened [9 inertial; 6 bias walk] residual of one chain edge; the
    inertial part takes the first state's bias (EdgeInertial)."""
    b_i = torch.cat([bgi, bai])
    r9 = pre.inertial_residual(p, Ri, ti, vi, Rj, tj, vj, b_i, gravity=g)
    r6 = torch.cat([bgj - bgi, baj - bai])
    return torch.cat([_mv(Lr.T, r9), _mv(Lb.T, r6)])


# --------------------------------------------------------------------------
# visual-inertial bundle adjustment
# --------------------------------------------------------------------------

class VIBAProblem(NamedTuple):
    Rwb: torch.Tensor          # (K,3,3) body->world rotation
    twb: torch.Tensor          # (K,3)
    v: torch.Tensor            # (K,3) world velocity
    bg: torch.Tensor           # (K,3)
    ba: torch.Tensor           # (K,3)
    points: torch.Tensor       # (P,3)
    obs_kf: torch.Tensor       # (O,) int32
    obs_mp: torch.Tensor       # (O,) int32
    obs_uv: torch.Tensor       # (O,2)
    inv_sigma2: torch.Tensor   # (O,)
    obs_valid: torch.Tensor    # (O,) bool
    chain: InertialChain       # K edges (edge k: k-1 -> k)
    fixed_kf: torch.Tensor     # (K,) bool (pose, velocity and biases frozen)
    fixed_mp: torch.Tensor     # (P,) bool
    Rcb: torch.Tensor          # (3,3) camera-from-body rotation
    tcb: torch.Tensor          # (3,)
    prior_g: float = 0.0       # EdgePriorGyro information (on KF 0)
    prior_a: float = 0.0       # EdgePriorAcc information


class VIBAResult(NamedTuple):
    Rwb: torch.Tensor
    twb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    points: torch.Tensor
    inliers: torch.Tensor
    cost: torch.Tensor


def _vis_points(Rwb, twb, points, p: VIBAProblem):
    """Per-observation pose and world point; padding slots get a point 1 m
    in front of their camera, so they stay finite."""
    Rk, tk = Rwb[p.obs_kf.long()], twb[p.obs_kf.long()]
    pw = points[p.obs_mp.long()]
    pb_safe = _mv(p.Rcb.T, torch.tensor([0.0, 0.0, 1.0], dtype=pw.dtype, device=pw.device)
                  - p.tcb)
    pw_safe = _mv(Rk, pb_safe) + tk
    return Rk, tk, torch.where(p.obs_valid[:, None], pw, pw_safe)


def _vis_residual(Rwb, twb, points, p: VIBAProblem, cam: Camera):
    Rk, tk, pw = _vis_points(Rwb, twb, points, p)
    pb = _mv(Rk.transpose(-1, -2), pw - tk)
    return p.obs_uv - cam.project(_mv(p.Rcb, pb) + p.tcb)


def _vis_residual_jac(Rwb, twb, points, p: VIBAProblem, cam: Camera):
    """Reprojection residual and its Jacobians wrt the pose slice (rotation,
    translation) of the 15-dim body state and wrt the point."""
    Rk, tk, pw = _vis_points(Rwb, twb, points, p)

    def pc_fn(d9, Rk1, tk1, pw1, Rcb, tcb):   # d9: the pose's (phi, rho), the point's step
        Rn = Rk1 @ lie.so3_exp(d9[0:3])
        tn = tk1 + _mv(Rk1, d9[3:6])
        pb = _mv(Rn.T, pw1 + d9[6:9] - tn)
        return (_mv(Rcb, pb) + tcb,)

    z9 = torch.zeros(9, dtype=points.dtype, device=points.device)
    r = _vis_residual(Rwb, twb, points, p, cam)
    J = _camera_jac(cam, pc_fn, 0, (None, 0, 0, 0, None, None))(z9, Rk, tk, pw, p.Rcb, p.tcb)[0]
    return r, J[..., :6], J[..., 6:]


def _edge_residual_jac(Rwb, twb, v, bg, ba, chain: InertialChain, g, with_jac: bool = True):
    """Whitened 15-dim chain-edge residuals (K,15) and the Jacobians wrt
    both endpoint states (K,15,15); edge k connects KF k-1 (i) and KF k (j)."""
    K = Rwb.shape[0]
    idx_j = torch.arange(K, device=Rwb.device)
    idx_i = torch.clamp(idx_j - 1, min=0)
    Lr = info_sqrt(chain.C[:, :9, :9])
    Lb = info_sqrt(chain.C[:, 9:, 9:])
    m = chain.valid.to(Rwb.dtype)

    def r_fn(di, dj, pk_, Lr_k, Lb_k, g_, Si_, Sj_):
        return edge_resid15(pk_, Lr_k, Lb_k, g_, *apply_delta(*Si_, di), *apply_delta(*Sj_, dj))

    pk = pre.Preintegrated(dR=chain.dR, dV=chain.dV, dP=chain.dP, C=chain.C, JRg=chain.JRg,
                           JVg=chain.JVg, JVa=chain.JVa, JPg=chain.JPg, JPa=chain.JPa,
                           dT=chain.dT, bias=chain.bias0)
    Si = (Rwb[idx_i], twb[idx_i], v[idx_i], bg[idx_i], ba[idx_i])
    Sj = (Rwb, twb, v, bg, ba)
    z = torch.zeros(K, 15, dtype=Rwb.dtype, device=Rwb.device)
    r = vmap(r_fn, in_dims=(0, 0, 0, 0, 0, None, 0, 0))(z, z, pk, Lr, Lb, g, Si, Sj)
    if not with_jac:
        return r * m[:, None]
    Ji, Jj = _jac(r_fn, (0, 1), (0, 0, 0, 0, 0, None, 0, 0))(z, z, pk, Lr, Lb, g, Si, Sj)
    return (r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None]), idx_i, idx_j


def _rho(c2, use_huber: bool):
    if not use_huber:
        return c2
    d2 = DELTA_MONO * DELTA_MONO
    return torch.where(c2 <= d2, c2, 2.0 * DELTA_MONO * torch.sqrt(c2) - d2)


def optimize_vi_ba_plain(p: VIBAProblem, cam: Camera, n_iters: int = 8, cg_iters: int = 50,
                         use_huber: bool = True, mesh=None) -> VIBAResult:
    """Plain version of ``optimize_vi_ba`` (same arguments); on the card its
    sums run in PyTorch's deterministic order (``kernels.ordered_plain``).

    With a ``mesh`` of n shards, ``p`` is in the landmark-sharded layout
    (``dist/sharded_ba.relayout_point_sharded``) and the solve is JAX's
    ``optimize_vi_sharded``: each shard linearizes its own observations;
    the visual gradient and 6x6 blocks, the visual part of each Hessian
    product, the landmark half of each PCG dot and the visual cost are
    summed across shards by ``shard_sum``; the chain, the priors and the
    state half are added once to those sums; the point blocks stay per
    shard.  On one shard this is the one-device solve."""
    from ..dist.mesh import landmark_shards

    with kernels.ordered_plain(p.points.is_cuda):
        shards = landmark_shards(p, 1 if mesh is None else mesh.size, "optimize_vi_sharded")
        return _optimize_vi_ba_plain(p, shards, cam, n_iters, cg_iters, use_huber)


def _optimize_vi_ba_plain(p: VIBAProblem, shards, cam: Camera, n_iters: int, cg_iters: int,
                          use_huber: bool) -> VIBAResult:
    from ..dist.mesh import shard_sum

    K = p.Rwb.shape[0]
    dt, dev = p.points.dtype, p.points.device
    g = _gvec(dt, dev)
    # per shard: its problem, observation -> keyframe / local point, free points, points
    sh = [(q, q.obs_kf.long(), q.obs_mp.long(), (~q.fixed_mp).to(dt)[:, None],
           q.points.shape[0]) for q in shards]
    free_kf = (~p.fixed_kf).to(dt)[:, None]
    prior_diag = torch.zeros(K, 15, dtype=dt, device=dev)
    prior_diag[0, 9:12] = p.prior_g
    prior_diag[0, 12:15] = p.prior_a
    I15 = torch.eye(15, dtype=dt, device=dev)
    I3 = torch.eye(3, dtype=dt, device=dev)
    seg = lambda vals, idx, n: torch.zeros((n,) + vals.shape[1:], dtype=dt,
                                           device=dev).index_add_(0, idx, vals)

    def total_cost(Rc, tc, vc, bgc, bac, pcs):
        parts = []
        for (q, _, _, _, _), pc in zip(sh, pcs):
            rr2 = _vis_residual(Rc, tc, pc, q, cam)
            c2 = torch.sum(rr2 * rr2, -1) * q.inv_sigma2
            parts.append(torch.sum(torch.where(q.obs_valid, _rho(c2, use_huber), 0.0)))
        re2 = _edge_residual_jac(Rc, tc, vc, bgc, bac, p.chain, g, with_jac=False)
        return shard_sum(parts) + torch.sum(re2 * re2)

    Rwb, twb, v, bg, ba = p.Rwb, p.twb, p.v, p.bg, p.ba
    pts = [q.points for q in shards]
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = torch.tensor(float("inf"), dtype=dt, device=dev)
    for _ in range(n_iters):
        lin, g_vis, H_vis = [], [], []
        for (q, kf_i, mp_i, free_mp, Ps), pq in zip(sh, pts):
            r, Jp6, Jl = _vis_residual_jac(Rwb, twb, pq, q, cam)
            chi2 = torch.sum(r * r, -1) * q.inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
            w = w * q.inv_sigma2 * q.obs_valid.to(dt)
            Jpw6, Jlw = Jp6 * w[:, None, None], Jl * w[:, None, None]
            g_vis.append(seg(torch.einsum("oif,oi->of", Jpw6, r), kf_i, K))
            H_vis.append(seg(torch.einsum("oif,oig->ofg", Jpw6, Jp6), kf_i, K))
            g_point = seg(torch.einsum("oif,oi->of", Jlw, r), mp_i, Ps) * free_mp
            Ml = torch.linalg.inv(seg(torch.einsum("oif,oig->ofg", Jlw, Jl), mp_i, Ps)
                                  + lam * I3)
            lin.append((Jp6, Jl, w, g_point, Ml))
        (re, Ji, Jj), idx_i, idx_j = _edge_residual_jac(Rwb, twb, v, bg, ba, p.chain, g)

        g_state = torch.zeros(K, 15, dtype=dt, device=dev)
        g_state[:, :6] += shard_sum(g_vis)
        g_state = g_state.index_add(0, idx_i, torch.einsum("eif,ei->ef", Ji, re))
        g_state = g_state.index_add(0, idx_j, torch.einsum("eif,ei->ef", Jj, re))
        g_state = g_state * free_kf

        Hpp = torch.zeros(K, 15, 15, dtype=dt, device=dev)
        Hpp[:, :6, :6] += shard_sum(H_vis)
        Hpp = Hpp.index_add(0, idx_i, torch.einsum("eif,eig->efg", Ji, Ji))
        Hpp = Hpp.index_add(0, idx_j, torch.einsum("eif,eig->efg", Jj, Jj))
        Hpp = Hpp + torch.diag_embed(prior_diag)
        Mp = torch.linalg.inv(Hpp + lam * I15)

        def hv(vp, vls):
            vp = vp * free_kf
            hp_vis, hls = [], []
            for (_, kf_i, mp_i, free_mp, Ps), (Jp6, Jl, w, _, _), vl in zip(sh, lin, vls):
                vl = vl * free_mp
                u = (torch.einsum("oif,of->oi", Jp6, vp[kf_i, :6])
                     + torch.einsum("oif,of->oi", Jl, vl[mp_i]))
                uw = u * w[:, None]
                hp_vis.append(seg(torch.einsum("oif,oi->of", Jp6, uw), kf_i, K))
                hl = seg(torch.einsum("oif,oi->of", Jl, uw), mp_i, Ps) * free_mp
                hls.append(hl + lam * vl)
            hp = torch.zeros(K, 15, dtype=dt, device=dev)
            hp[:, :6] += shard_sum(hp_vis)
            ue = (torch.einsum("eif,ef->ei", Ji, vp[idx_i])
                  + torch.einsum("eif,ef->ei", Jj, vp[idx_j]))
            hp = hp.index_add(0, idx_i, torch.einsum("eif,ei->ef", Ji, ue))
            hp = hp.index_add(0, idx_j, torch.einsum("eif,ei->ef", Jj, ue))
            hp = (hp + prior_diag * vp) * free_kf
            return hp + lam * vp, hls

        def precond(vp, vls):
            return (torch.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    [torch.einsum("pfg,pg->pf", l[4], vl) * s_[3]
                     for l, vl, s_ in zip(lin, vls, sh)])

        def dot(a, b):
            # the state half is every shard's; the landmark half is summed
            return torch.sum(a[0] * b[0]) + shard_sum(
                [torch.sum(x * y) for x, y in zip(a[1], b[1])])

        def axpy(alpha, x, y):   # x + alpha y, both halves
            return (x[0] + alpha * y[0], [a + alpha * b for a, b in zip(x[1], y[1])])

        x = (torch.zeros_like(g_state), [torch.zeros_like(l[3]) for l in lin])
        rr = (g_state, [l[3] for l in lin])
        z = precond(*rr)
        pdir = z
        rz = dot(rr, z)
        for _ in range(cg_iters):
            Ap = hv(*pdir)
            alpha = rz / torch.clamp(dot(pdir, Ap), min=1e-20)
            x = axpy(alpha, x, pdir)
            rr = axpy(-alpha, rr, Ap)
            z = precond(*rr)
            rz_new = dot(rr, z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            pdir = axpy(beta, z, pdir)
            rz = rz_new
        dp = -x[0] * free_kf
        Rn, tn, vn, bgn, ban = apply_delta(Rwb, twb, v, bg, ba, dp)
        pn = [pq + (-xl * s_[3]) for pq, xl, s_ in zip(pts, x[1], sh)]
        c_new = total_cost(Rn, tn, vn, bgn, ban, pn)
        c_old = total_cost(Rwb, twb, v, bg, ba, pts)
        better = c_new < c_old
        Rwb, twb, v = torch.where(better, Rn, Rwb), torch.where(better, tn, twb), \
            torch.where(better, vn, v)
        bg, ba = torch.where(better, bgn, bg), torch.where(better, ban, ba)
        pts = [torch.where(better, a, b) for a, b in zip(pn, pts)]
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        cost = torch.minimum(c_new, c_old)
    Rwb = lie.orthonormalize(Rwb)
    inls = []
    for (q, _, _, _, _), pq in zip(sh, pts):
        r = _vis_residual(Rwb, twb, pq, q, cam)
        chi2 = torch.sum(r * r, -1) * q.inv_sigma2
        inls.append(q.obs_valid & (chi2 <= CHI2_MONO))
    cat = lambda a: a[0] if len(a) == 1 else torch.cat(a)
    return VIBAResult(Rwb, twb, v, bg, ba, cat(pts), cat(inls), cost)


def pack_preint(p, device=None) -> torch.Tensor:
    """A Preintegrated, or an InertialChain of them, in the kernels' packed
    layout (K20, K21, K22; ``csrc/imu_t.cuh``): (..., 292) float32 rows of
    dR 9, dV 3, dP 3, JRg 9, JVg 9, JVa 9, JPg 9, JPa 9, dT 1, C 225, bias 6."""
    bias = p.bias0 if isinstance(p, InertialChain) else p.bias
    lead = p.dT.shape
    f = lambda a, n: torch.as_tensor(a).to(device=device, dtype=torch.float32).reshape(
        lead + (n,))
    return torch.cat([f(p.dR, 9), f(p.dV, 3), f(p.dP, 3), f(p.JRg, 9), f(p.JVg, 9),
                      f(p.JVa, 9), f(p.JPg, 9), f(p.JPa, 9), f(p.dT, 1), f(p.C, 225),
                      f(bias, 6)], -1).contiguous()


def optimize_vi_ba(p: VIBAProblem, cam: Camera, n_iters: int = 8, cg_iters: int = 50,
                   use_huber: bool = True) -> VIBAResult:
    """LM visual-inertial BA with matrix-free PCG over padded problems.

    Replaces ``extractorb_tpu/solver/inertial.py:optimize_vi_ba``.  On CUDA
    tensors this launches K20 once (its instantiation for ``cam``: pinhole
    or KB8): every LM and PCG step is enqueued from C without a host
    synchronisation, and every sum runs in a fixed order.
    On the CPU it runs ``optimize_vi_ba_plain``."""
    if not p.points.is_cuda:
        return optimize_vi_ba_plain(p, cam, n_iters, cg_iters, use_huber)
    K, P, O = p.Rwb.shape[0], p.points.shape[0], p.obs_kf.shape[0]
    dev = p.points.device
    f32 = lambda a: a.to(torch.float32)
    state = torch.cat([f32(p.Rwb).reshape(-1, 9), f32(p.twb), f32(p.v), f32(p.bg), f32(p.ba)],
                      1).contiguous()
    pts, chain = f32(p.points).clone().contiguous(), pack_preint(p.chain, dev)
    i32 = lambda a: a.to(torch.int32).contiguous()
    b8 = lambda a: a.to(torch.bool).contiguous()
    obs = [i32(p.obs_kf), i32(p.obs_mp), p.obs_uv.to(torch.float32).contiguous(),
           p.inv_sigma2.to(torch.float32).contiguous(), b8(p.obs_valid)]
    masks = [b8(p.chain.valid), b8(p.fixed_kf), b8(p.fixed_mp)]
    ext = torch.cat([p.Rcb.reshape(-1), p.tcb.reshape(-1)]).to(torch.float32).contiguous()
    kernels.require_cuda("vi_ba", state, pts, chain, *obs, *masks, ext)
    lib = kernels.lib()
    ws = torch.empty(int(lib.vi_ba_workspace_bytes(K, P, O, cg_iters)), dtype=torch.uint8,
                     device=dev)
    inl = torch.empty(O, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    kb8 = cam.kernel_params()
    err = lib.vi_ba_launch(
        state.data_ptr(), pts.data_ptr(), chain.data_ptr(), *[a.data_ptr() for a in obs],
        *[a.data_ptr() for a in masks], ext.data_ptr(), K, P, O, cam.fx, cam.fy, cam.cx, cam.cy,
        None if kb8 is None else kb8.ctypes.data, float(p.prior_g), float(p.prior_a), n_iters,
        cg_iters, int(use_huber), float(CHI2_MONO), ws.data_ptr(), inl.data_ptr(),
        cost.data_ptr(), kernels.stream())
    kernels.check(err, "vi_ba")
    kernels.LAUNCHES["vi_ba"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["vi_ba_kb8"] += 1     # of those, through the KB8 camera
    return VIBAResult(Rwb=state[:, :9].reshape(K, 3, 3), twb=state[:, 9:12], v=state[:, 12:15],
                      bg=state[:, 15:18], ba=state[:, 18:21], points=pts, inliers=inl, cost=cost)


# --------------------------------------------------------------------------
# inertial-only optimisation (gravity, scale, velocities, bias)
# --------------------------------------------------------------------------

class InertialOnlyResult(NamedTuple):
    Rwg: torch.Tensor     # (3,3) gravity-frame rotation (g_world = Rwg @ [0,0,-G])
    scale: torch.Tensor   # ()
    v: torch.Tensor       # (K,3)
    bg: torch.Tensor      # (3,)
    ba: torch.Tensor      # (3,)
    cost: torch.Tensor


def inertial_only_plain(Rwb, twb, chain: InertialChain, v0, bias0, prior_g: float = 1e2,
                        prior_a: float = 1e6, fix_scale: bool = False, n_iters: int = 30,
                        Rwg0=None, solve_dtype=torch.float32) -> InertialOnlyResult:
    """Plain version of ``inertial_only``.  ``solve_dtype`` is the type of
    the normal equations and their solve: float32 as the JAX package,
    float64 as kernel K21 (the residuals are float32 either way)."""
    K = Rwb.shape[0]
    dt, dev = twb.dtype, twb.device
    g0 = _gvec(dt, dev)
    Rwg_seed = (torch.eye(3, dtype=dt, device=dev) if Rwg0 is None
                else torch.as_tensor(Rwg0, dtype=dt, device=dev))
    idx_j = torch.arange(K, device=dev)
    idx_i = torch.clamp(idx_j - 1, min=0)
    Lr = info_sqrt(chain.C[:, :9, :9])
    pk = pre.Preintegrated(dR=chain.dR, dV=chain.dV, dP=chain.dP, C=chain.C, JRg=chain.JRg,
                           JVg=chain.JVg, JVa=chain.JVa, JPg=chain.JPg, JPa=chain.JPa,
                           dT=chain.dT, bias=chain.bias0)
    m = chain.valid.to(dt)
    sg, sa = float(np.sqrt(prior_g)), float(np.sqrt(prior_a))

    def unpack(x, Rwg_seed):
        z1 = torch.zeros(1, dtype=x.dtype, device=dev)
        Rwg = Rwg_seed @ lie.so3_exp(torch.cat([x[0:2], z1]))
        s = torch.ones((), dtype=x.dtype, device=dev) if fix_scale else torch.exp(x[2])
        return Rwg, s, x[3:6], x[6:9], x[9:].reshape(K, 3)

    def residuals(x, consts):
        Rwg_seed, g0, pk, Lr, m, Rwb_, twb_ = consts
        Rwg, s, bg, ba, v = unpack(x, Rwg_seed)
        g = _mv(Rwg, g0)
        b = torch.cat([bg, ba])

        def per_edge(pk_, Lr_, Ri, Rj, ti, tj, vi, vj):
            dT = pk_.dT
            eR = lie.so3_log(pre.delta_rotation(pk_, b).T @ (Ri.T @ Rj))
            eV = _mv(Ri.T, s * (vj - vi) - g * dT) - pre.delta_velocity(pk_, b)
            eP = _mv(Ri.T, s * (tj - ti - vi * dT) - 0.5 * g * dT * dT) \
                - pre.delta_position(pk_, b)
            return _mv(Lr_.T, torch.cat([eR, eV, eP]))

        r = vmap(per_edge)(pk, Lr, Rwb_[idx_i], Rwb_[idx_j], twb_[idx_i], twb_[idx_j], v[idx_i],
                           v[idx_j]) * m[:, None]
        return torch.cat([r.reshape(-1), sg * bg, sa * ba])

    consts = (Rwg_seed, g0, pk, Lr, m, Rwb, twb)
    jac = _jac(residuals, 0)
    x = torch.cat([torch.zeros(3, dtype=dt, device=dev), bias0.to(dt),
                   v0.reshape(-1).to(dt)])
    n = x.shape[0]
    lam = torch.tensor(1e-2, dtype=dt, device=dev)
    cost = torch.tensor(float("inf"), dtype=dt, device=dev)
    eye = torch.eye(n, dtype=solve_dtype, device=dev)
    for _ in range(n_iters):
        r = residuals(x, consts)
        J = jac(x, consts).to(solve_dtype)
        H = J.T @ J
        b = J.T @ r.to(solve_dtype)
        dx = -torch.linalg.solve(H + lam.to(solve_dtype) * eye + 1e-9 * eye, b)
        xn = x + dx.to(dt)
        c_new = torch.sum(residuals(xn, consts) ** 2)
        c_old = torch.sum(r ** 2)
        better = c_new < c_old
        x = torch.where(better, xn, x)
        lam = torch.where(better, lam * 0.5, lam * 5.0)
        cost = torch.minimum(c_new, c_old)
    Rwg, s, bg, ba, v = unpack(x, Rwg_seed)
    return InertialOnlyResult(Rwg=Rwg, scale=s, v=v, bg=bg, ba=ba, cost=cost)


def inertial_only(Rwb, twb, chain: InertialChain, v0, bias0, prior_g: float = 1e2,
                  prior_a: float = 1e6, fix_scale: bool = False, n_iters: int = 30,
                  Rwg0=None) -> InertialOnlyResult:
    """InertialOptimization (src/Optimizer.cc:5142): with every body pose
    fixed, gravity direction (2-DoF about the seed ``Rwg0``), scale, the
    K velocities and one shared bias, by dense LM.

    Replaces ``extractorb_tpu/solver/inertial.py:inertial_only``.  On CUDA
    tensors this launches K21 (one CTA; float32 residuals, float64 normal
    equations and Cholesky solve: a recorded divergence, held by
    ``inertial_only_plain(..., solve_dtype=torch.float64)``)."""
    if not twb.is_cuda:
        return inertial_only_plain(Rwb, twb, chain, v0, bias0, prior_g, prior_a, fix_scale,
                                   n_iters, Rwg0)
    K = Rwb.shape[0]
    dev = twb.device
    f32 = lambda a: torch.as_tensor(a).to(device=dev, dtype=torch.float32).contiguous()
    Rwg_seed = f32(torch.eye(3) if Rwg0 is None else Rwg0)
    args = [f32(Rwb).reshape(-1, 9).contiguous(), f32(twb), pack_preint(chain, dev),
            chain.valid.to(torch.bool).contiguous(), f32(v0).reshape(-1).contiguous(),
            f32(bias0), Rwg_seed]
    kernels.require_cuda("inertial_init", *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.inertial_init_workspace_bytes(K)), dtype=torch.uint8, device=dev)
    out = torch.empty(17 + 3 * K, dtype=torch.float32, device=dev)
    err = lib.inertial_init_launch(
        *[a.data_ptr() for a in args], K, float(prior_g), float(prior_a), int(fix_scale),
        n_iters, ws.data_ptr(), out.data_ptr(), kernels.stream())
    kernels.check(err, "inertial_init")
    kernels.LAUNCHES["inertial_init"] += 1
    # out: [Rwg 9 | scale | bg 3 | ba 3 | v 3K | cost]
    return InertialOnlyResult(Rwg=out[:9].reshape(3, 3), scale=out[9], bg=out[10:13],
                              ba=out[13:16], v=out[16:16 + 3 * K].reshape(K, 3),
                              cost=out[16 + 3 * K])


# --------------------------------------------------------------------------
# tracking-time pose-velocity-bias optimisation
# --------------------------------------------------------------------------

class PoseInertialResult(NamedTuple):
    Rwb: torch.Tensor
    twb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    H: torch.Tensor        # (15,15) information for the next frame's prior


def _pose_pc(R, t, pts, Rcb, tcb):
    """Camera-frame points of world points seen from body state (R, t)."""
    return _mv(Rcb, _mv(R.T, pts - t)) + tcb


def _pose_resid(R, t, pts, uv, Rcb, tcb, cam: Camera):
    return uv - cam.project(_pose_pc(R, t, pts, Rcb, tcb))


def _safe_pts(R, t, pts_w, valid, Rcb, tcb):
    pb_safe = _mv(Rcb.T, torch.tensor([0.0, 0.0, 1.0], dtype=t.dtype, device=t.device) - tcb)
    return torch.where(valid[:, None], pts_w, _mv(R, pb_safe) + t)


def prior_sqrt(Hp):
    """Square root Lp (Lp Lp^T = Hp) of a prior's information by eigh, the
    spectrum clamped to [0, 1e7] (JAX ``inertial.py:719-730``)."""
    Hp = 0.5 * (Hp + Hp.T)
    w_e, V_e = torch.linalg.eigh(Hp)
    return V_e * torch.sqrt(torch.clamp(w_e, 0.0, 1e7))[None, :]


def optimize_pose_inertial_plain(Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w, obs_uv,
                                 inv_sigma2, valid, Rcb, tcb, cam: Camera, n_rounds: int = 4,
                                 n_iters: int = 10) -> PoseInertialResult:
    """Plain version of ``optimize_pose_inertial`` (same arguments)."""
    dt, dev = twb0.dtype, twb0.device
    ctx = (_gvec(dt, dev), tuple(prev_state), preint, info_sqrt(preint.C[:9, :9]),
           info_sqrt(preint.C[9:, 9:]), obs_uv, Rcb, tcb)
    I15 = torch.eye(15, dtype=dt, device=dev)
    z15 = torch.zeros(15, dtype=dt, device=dev)

    def state_fn(d, st, pts, ctx):   # camera-frame points, inertial residual
        g, prev, pk, Lr_, Lb_, uv, Rcb_, tcb_ = ctx
        R, t, vv, bgn, ban = apply_delta(*st, d)
        return _pose_pc(R, t, pts, Rcb_, tcb_), edge_resid15(pk, Lr_, Lb_, g, *prev, R, t, vv,
                                                             bgn, ban)

    def resid_all(d, st, pts, ctx):
        pc, ri = state_fn(d, st, pts, ctx)
        return ctx[5] - cam.project(pc), ri

    jac = _camera_jac(cam, state_fn, 0)
    st = (Rwb0, twb0, v0, bg0, ba0)
    active = valid
    for rnd in range(n_rounds):
        use_huber = rnd < n_rounds - 1
        for _ in range(n_iters):
            pts = _safe_pts(st[0], st[1], pts_w, valid, Rcb, tcb)
            rv, ri = resid_all(z15, st, pts, ctx)
            Jv, Jji = jac(z15, st, pts, ctx)
            chi2 = torch.sum(rv * rv, -1) * inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
            w = w * inv_sigma2 * active.to(dt)
            Jvw = Jv * w[:, None, None]
            H = torch.einsum("nio,nij->oj", Jvw, Jv) + Jji.T @ Jji
            b = torch.einsum("nio,ni->o", Jvw, rv) + Jji.T @ ri
            d = -torch.linalg.solve(H + 1e-8 * I15, b)
            st = apply_delta(*st, d)
        rv = _pose_resid(st[0], st[1], pts_w, obs_uv, Rcb, tcb, cam)
        active = valid & (torch.sum(rv * rv, -1) * inv_sigma2 <= CHI2_MONO)
    st = (lie.orthonormalize(st[0]),) + tuple(st[1:])
    pts = _safe_pts(st[0], st[1], pts_w, valid, Rcb, tcb)
    Jv, Jji = jac(z15, st, pts, ctx)
    wf = inv_sigma2 * active.to(dt)
    H = torch.einsum("nio,nij->oj", Jv * wf[:, None, None], Jv) + Jji.T @ Jji
    return PoseInertialResult(Rwb=st[0], twb=st[1], v=st[2], bg=st[3], ba=st[4], inliers=active,
                              n_inliers=torch.sum(active.to(torch.int32)), H=H)


def optimize_pose_inertial_last_frame_plain(Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w,
                                            obs_uv, inv_sigma2, valid, Rcb, tcb, cam: Camera,
                                            n_rounds: int = 4, n_iters: int = 10,
                                            prior=None) -> PoseInertialResult:
    """Plain version of ``optimize_pose_inertial_last_frame``."""
    dt, dev = twb0.dtype, twb0.device
    Lr = info_sqrt(preint.C[:9, :9])
    Lb = info_sqrt(preint.C[9:, 9:])
    if prior is not None:
        Hp, prior_state = prior
    else:
        Hp = torch.eye(15, dtype=dt, device=dev) * 1e4
        prior_state = prev_state
    ctx = (_gvec(dt, dev), preint, Lr, Lb, prior_sqrt(Hp), tuple(prior_state), obs_uv, Rcb, tcb)
    I30 = torch.eye(30, dtype=dt, device=dev)
    z30 = torch.zeros(30, dtype=dt, device=dev)

    def state_fn(d30, st, pts, ctx):   # camera-frame points, inertial and prior residuals
        g, pk, Lr_, Lb_, Lp_, ps, uv, Rcb_, tcb_ = ctx
        Rp, tp, vp, bgp, bap = apply_delta(*st[:5], d30[:15])
        R, t, vv, bgn, ban = apply_delta(*st[5:], d30[15:])
        ri = edge_resid15(pk, Lr_, Lb_, g, Rp, tp, vp, bgp, bap, R, t, vv, bgn, ban)
        Rpr, tpr, vpr, bgpr, bapr = ps
        rp = _mv(Lp_.T, torch.cat([lie.so3_log(Rpr.T @ Rp), _mv(Rpr.T, tp - tpr), vp - vpr,
                                   bgp - bgpr, bap - bapr]))
        return _pose_pc(R, t, pts, Rcb_, tcb_), ri, rp

    def resid_all(d30, st, pts, ctx):
        pc, ri, rp = state_fn(d30, st, pts, ctx)
        return ctx[6] - cam.project(pc), ri, rp

    jac = _camera_jac(cam, state_fn, 0)
    st = tuple(prev_state) + (Rwb0, twb0, v0, bg0, ba0)
    active = valid
    for rnd in range(n_rounds):
        use_huber = rnd < n_rounds - 1
        for _ in range(n_iters):
            pts = _safe_pts(st[5], st[6], pts_w, valid, Rcb, tcb)
            rv, ri, rp = resid_all(z30, st, pts, ctx)
            Jv, Ji, Jp = jac(z30, st, pts, ctx)
            chi2 = torch.sum(rv * rv, -1) * inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else torch.ones_like(chi2)
            w = w * inv_sigma2 * active.to(dt)
            Jvw = Jv * w[:, None, None]
            H = torch.einsum("nio,nij->oj", Jvw, Jv) + Ji.T @ Ji + Jp.T @ Jp
            b = torch.einsum("nio,ni->o", Jvw, rv) + Ji.T @ ri + Jp.T @ rp
            d = -torch.linalg.solve(H + 1e-8 * I30, b)
            st = apply_delta(*st[:5], d[:15]) + apply_delta(*st[5:], d[15:])
        rv = _pose_resid(st[5], st[6], pts_w, obs_uv, Rcb, tcb, cam)
        active = valid & (torch.sum(rv * rv, -1) * inv_sigma2 <= CHI2_MONO)
    st = (lie.orthonormalize(st[0]),) + tuple(st[1:5]) + (lie.orthonormalize(st[5]),) \
        + tuple(st[6:])
    pts = _safe_pts(st[5], st[6], pts_w, valid, Rcb, tcb)
    Jv, Ji, Jp = jac(z30, st, pts, ctx)
    wf = inv_sigma2 * active.to(dt)
    H30 = (torch.einsum("nio,nij->oj", Jv * wf[:, None, None], Jv) + Ji.T @ Ji + Jp.T @ Jp)
    H_marg = mg.marginalize_plain(H30, 0, 14)[15:, 15:]
    H_marg = 0.5 * (H_marg + H_marg.T)
    return PoseInertialResult(Rwb=st[5], twb=st[6], v=st[7], bg=st[8], ba=st[9], inliers=active,
                              n_inliers=torch.sum(active.to(torch.int32)), H=H_marg)


def _pose_inertial_launch(joint: bool, Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w,
                          obs_uv, inv_sigma2, valid, Rcb, tcb, cam: Camera, n_rounds, n_iters,
                          prior=None) -> PoseInertialResult:
    """Launch K22 (``<joint>``) on one problem; every input stays on the
    card (no host synchronisation)."""
    dev = twb0.device
    f32 = lambda a: a.to(dtype=torch.float32).reshape(-1)
    cur = torch.cat([f32(Rwb0), f32(twb0), f32(v0), f32(bg0), f32(ba0)])
    prev = torch.cat([f32(a) for a in prev_state])
    if joint:
        Hp, prior_state = (prior if prior is not None
                           else (torch.eye(15, dtype=torch.float32, device=dev) * 1e4,
                                 prev_state))
        pri = torch.cat([f32(Hp)] + [f32(a) for a in prior_state])
    else:
        pri = torch.zeros(225 + 21, dtype=torch.float32, device=dev)
    pk = pack_preint(preint, dev)
    ext = torch.cat([f32(Rcb), f32(tcb)])
    state = torch.cat([cur, prev, pri, pk, ext]).contiguous()
    N = pts_w.shape[0]
    obs = [pts_w.to(torch.float32).contiguous(), obs_uv.to(torch.float32).contiguous(),
           inv_sigma2.to(torch.float32).contiguous(), valid.to(torch.bool).contiguous()]
    kernels.require_cuda("pose_inertial", state, *obs)
    out = torch.empty(21 + 225, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    kb8 = cam.kernel_params()
    err = kernels.lib().pose_inertial_launch(
        state.data_ptr(), *[a.data_ptr() for a in obs], N, cam.fx, cam.fy, cam.cx, cam.cy,
        None if kb8 is None else kb8.ctypes.data, int(joint), n_rounds, n_iters, out.data_ptr(),
        inl.data_ptr(), n_inl.data_ptr(), kernels.stream())
    kernels.check(err, "pose_inertial")
    kernels.LAUNCHES["pose_inertial"] += 1
    kernels.LAUNCHES["pose_inertial_joint"] += int(joint)   # of those, the joint variant
    if kb8 is not None:   # of those, through the KB8 camera (and of these, the joint variant)
        kernels.LAUNCHES["pose_inertial_kb8"] += 1
        kernels.LAUNCHES["pose_inertial_joint_kb8"] += int(joint)
    return PoseInertialResult(Rwb=out[:9].reshape(3, 3), twb=out[9:12], v=out[12:15],
                              bg=out[15:18], ba=out[18:21], inliers=inl, n_inliers=n_inl,
                              H=out[21:].reshape(15, 15))


def optimize_pose_inertial(Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w, obs_uv,
                           inv_sigma2, valid, Rcb, tcb, cam: Camera, n_rounds: int = 4,
                           n_iters: int = 10) -> PoseInertialResult:
    """PoseInertialOptimizationLastKeyFrame (src/Optimizer.cc:7327): GN on
    the frame's 15-dim state with visual unary edges (chi2 reclassified
    over 4 rounds, Huber in the first 3), one inertial edge to the fixed
    previous state ``prev_state`` = (Rwb, twb, v, bg, ba) and the bias
    walk; returns the final 15x15 Hessian.  (The JAX function's optional
    prior has no caller there and is not ported.)

    Replaces ``extractorb_tpu/solver/inertial.py:optimize_pose_inertial``.
    On CUDA tensors this launches K22 ``<joint=false>``."""
    if not twb0.is_cuda:
        return optimize_pose_inertial_plain(Rwb0, twb0, v0, bg0, ba0, prev_state, preint,
                                            pts_w, obs_uv, inv_sigma2, valid, Rcb, tcb, cam,
                                            n_rounds, n_iters)
    return _pose_inertial_launch(False, Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w,
                                 obs_uv, inv_sigma2, valid, Rcb, tcb, cam, n_rounds, n_iters)


def optimize_pose_inertial_last_frame(Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w,
                                      obs_uv, inv_sigma2, valid, Rcb, tcb, cam: Camera,
                                      n_rounds: int = 4, n_iters: int = 10,
                                      prior=None) -> PoseInertialResult:
    """PoseInertialOptimizationLastFrame (src/Optimizer.cc:7722): joint GN
    over the previous frame's and the current frame's 15-dim states; the
    previous one is anchored by its prior ``prior`` = (H15, state) (else
    1e4 I at ``prev_state``), whose square root comes from eigh with the
    spectrum clamped to [0, 1e7].  After convergence the previous state is
    marginalised out of the joint 30x30 Hessian (``marginal.marginalize``;
    the plain version calls ``marginal.marginalize_plain``) into the current
    frame's prior for the next call.

    Replaces ``extractorb_tpu/solver/inertial.py:optimize_pose_inertial_last_frame``
    and, inside it, ``solver/marginal.py:marginalize``.  On CUDA tensors
    this launches K22 ``<joint=true>``."""
    if not twb0.is_cuda:
        return optimize_pose_inertial_last_frame_plain(Rwb0, twb0, v0, bg0, ba0, prev_state,
                                                       preint, pts_w, obs_uv, inv_sigma2, valid,
                                                       Rcb, tcb, cam, n_rounds, n_iters, prior)
    return _pose_inertial_launch(True, Rwb0, twb0, v0, bg0, ba0, prev_state, preint, pts_w,
                                 obs_uv, inv_sigma2, valid, Rcb, tcb, cam, n_rounds, n_iters,
                                 prior)
