"""Pose-graph optimisation of the essential graph (port of
``extractorb_tpu/solver/pose_graph.py``: the 7-DoF Sim3 graph and the
4-DoF graph of inertial maps).

Replaces Optimizer::OptimizeEssentialGraph (reference
src/Optimizer.cc:2303, :2621 with bFixScale): keyframe poses are Sim3
vertices, spanning-tree / covisibility / loop edges carry relative Sim3
measurements m_ij, and each edge's residual is r = log(m_ij S_i S_j^-1)
under the left update S <- Exp(d) S.  Its Jacobians are taken at d = 0 by
forward mode (the JAX module's ``jax.jacfwd``; here ``torch.func.jvp``,
seven directions per side).  Levenberg-Marquardt: 15 iterations, each a
50-step PCG with a block-Jacobi (7x7) preconditioner on the matrix-free
normal equations; the step is kept only when the cost falls (lambda x0.5,
else x4) and each rotation is projected back onto SO(3) by its SVD.  Fixed
vertices (the loop keyframe) stay; ``fix_scale`` freezes every scale (the
stereo / RGB-D graph).

``optimize_pose_graph`` launches kernel K13 (``csrc/pose_graph.cu``) on
CUDA tensors and runs ``optimize_pose_graph_plain`` on the CPU.

Inertial maps (OptimizeEssentialGraph4DoF, Optimizer.cc:8153) observe
gravity, so only yaw about the world z axis and the translation are free:
each vertex has a 4-dim tangent applied in the world frame, each edge a
6-dim SE3 log residual r = log(m_ij (T_i <+ d_i) (T_j <+ d_j)^-1), and the
same LM and block-Jacobi PCG run with 4x4 blocks.
``optimize_pose_graph_4dof`` launches kernel K23 (``csrc/pose_graph_4dof.cu``)
on CUDA tensors and runs ``optimize_pose_graph_4dof_plain`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie
from ..dist.mesh import shard_sum


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor        # (K,3,3) world->cam
    t: torch.Tensor        # (K,3)
    s: torch.Tensor        # (K,)
    edge_i: torch.Tensor   # (E,) int
    edge_j: torch.Tensor   # (E,) int
    m_R: torch.Tensor      # (E,3,3) measurement m_ij = S_j S_i^-1
    m_t: torch.Tensor      # (E,3)
    m_s: torch.Tensor      # (E,)
    weight: torch.Tensor   # (E,)
    edge_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor    # (K,) bool


def _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms, di, dj):
    """r = log(m_ij (Exp(di) S_i) (Exp(dj) S_j)^-1), batched over edges."""
    dRi, dti, dsi = lie.sim3_exp(di)
    dRj, dtj, dsj = lie.sim3_exp(dj)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    Rji, tji, sji = lie.sim3_inverse(Rj2, tj2, sj2)
    Ra, ta, sa = lie.sim3_compose(Ri2, ti2, si2, Rji, tji, sji)
    Rb, tb, sb = lie.sim3_compose(mR, mt, ms, Ra, ta, sa)
    return lie.sim3_log(Rb, tb, sb)


def _build(p: PoseGraphProblem, R, t, s, jac: bool = True):
    """Residuals (E,7) and, with ``jac``, Jacobians (E,7,7) for both ends."""
    ei, ej = p.edge_i.long(), p.edge_j.long()
    args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], p.m_R, p.m_t, p.m_s)
    zero = torch.zeros(ei.shape[0], 7, dtype=t.dtype, device=t.device)
    r = _edge_residual(*args, zero, zero)
    if not jac:
        return r
    cols_i, cols_j = [], []
    for k in range(7):
        e = torch.zeros_like(zero)
        e[:, k] = 1.0
        cols_i.append(torch.func.jvp(lambda d: _edge_residual(*args, d, zero), (zero,), (e,))[1])
        cols_j.append(torch.func.jvp(lambda d: _edge_residual(*args, zero, d), (zero,), (e,))[1])
    return r, torch.stack(cols_i, -1), torch.stack(cols_j, -1)


def _lm_block_jacobi(p, state, build, retract, free, B: int, n_iters: int, cg_iters: int,
                     n_shards: int = 1):
    """The plain LM both essential graphs run: ``build(state, jac)`` gives
    the edge residuals and, with ``jac``, both ends' Jacobians (E,r,B);
    ``retract(state, d)`` the candidate state for the step ``d`` (K,B);
    ``free`` masks the fixed coordinates ((K,B) or (K,1)).  Each iteration
    solves the damped normal equations by ``cg_iters`` sweeps of PCG with a
    BxB block-Jacobi preconditioner and keeps the step only when the cost
    falls (lambda x0.5, else x4).  Over ``n_shards`` edge shards (E / n
    consecutive edges each) the gradient, the blocks, the Hessian-vector
    products and the costs are per-shard partials summed by ``shard_sum``.
    Returns (state, the last candidate's cost)."""
    K = p.R.shape[0]
    dt = p.t.dtype
    dev = p.t.device
    E = p.edge_i.shape[0]
    if E % n_shards:
        raise ValueError(f"pose graph: {E} edges on {n_shards} shards")
    # each end's vertex in its shard's block of n x K partial rows
    shard_of = torch.arange(E, device=dev) // (E // n_shards) * K
    ei, ej = p.edge_i.long() + shard_of, p.edge_j.long() + shard_of
    w = p.weight.to(dt) * p.edge_valid.to(dt)
    I = torch.eye(B, dtype=dt, device=dev)

    def seg2(a, b):
        """Each shard's segment sums of ``a`` over its edges' i ends plus
        ``b`` over their j ends, then the shards summed in order."""
        z = lambda vals, idx: torch.zeros((n_shards * K,) + vals.shape[1:], dtype=dt,
                                          device=dev).index_add_(0, idx, vals)
        per = z(a, ei) + z(b, ej)
        return shard_sum(list(per.view((n_shards, K) + a.shape[1:]).unbind(0)))

    def cost(st):
        r2 = build(st, False)
        c = torch.where(p.edge_valid, torch.sum(r2 * r2, -1) * p.weight, 0.0)
        return torch.sum(c) if n_shards == 1 else shard_sum(list(torch.sum(
            c.view(n_shards, -1), 1).unbind(0)))

    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    c_new = torch.tensor(0.0, dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Ji, Jj = build(state, True)
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        g = seg2(torch.einsum("eif,ei->ef", Jiw, r), torch.einsum("eif,ei->ef", Jjw, r)) * free
        Hd = seg2(torch.einsum("eif,eig->efg", Jiw, Ji), torch.einsum("eif,eig->efg", Jjw, Jj))
        M = torch.linalg.inv(Hd + lam * I[None])

        def hv(v):
            v = v * free
            vi, vj = v[p.edge_i.long()], v[p.edge_j.long()]
            u = torch.einsum("eif,ef->ei", Ji, vi) + torch.einsum("eif,ef->ei", Jj, vj)
            uw = u * w[:, None]
            h = seg2(torch.einsum("eif,ei->ef", Ji, uw), torch.einsum("eif,ei->ef", Jj, uw))
            return h * free + lam * v

        precond = lambda v: torch.einsum("kfg,kg->kf", M, v) * free
        x = torch.zeros_like(g)
        rr = g
        z = precond(rr)
        pd = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Ap = hv(pd)
            alpha = rz / torch.clamp(torch.sum(pd * Ap), min=1e-20)
            x = x + alpha * pd
            rr = rr - alpha * Ap
            z = precond(rr)
            rz2 = torch.sum(rr * z)
            beta = rz2 / torch.clamp(rz, min=1e-20)
            pd = z + beta * pd
            rz = rz2
        cand = retract(state, -x * free)
        c_new = cost(cand)
        better = c_new < cost(state)
        state = tuple(torch.where(better, a, b) for a, b in zip(cand, state))
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return state, c_new


def optimize_pose_graph_plain(p: PoseGraphProblem, n_iters: int = 15, cg_iters: int = 50,
                              fix_scale: bool = False, n_shards: int = 1):
    """Plain version of ``optimize_pose_graph`` (same arguments); with
    ``n_shards`` the plain version of the edge-sharded solve
    (``dist/sharded_pose_graph.py``)."""
    K = p.R.shape[0]
    free = (~p.fixed).to(p.t.dtype)[:, None].expand(K, 7).clone()
    if fix_scale:
        free[:, 6] = 0.0

    def retract(st, d):
        R, t, s = st
        Rn, tn, sn = lie.sim3_compose(*lie.sim3_exp(d), R, t, s)
        return lie.normalize_rotation(Rn), tn, sn

    (R, t, s), c = _lm_block_jacobi(p, (p.R, p.t, p.s),
                                    lambda st, jac: _build(p, *st, jac=jac), retract, free, 7,
                                    n_iters, cg_iters, n_shards)
    return R, t, s, c


class PoseGraph4DoFProblem(NamedTuple):
    """The inertial essential graph: world->camera vertices with a 4-dim
    tangent (yaw about world z, then the world translation)."""

    R: torch.Tensor        # (K,3,3) world->cam
    t: torch.Tensor        # (K,3)
    edge_i: torch.Tensor   # (E,) int
    edge_j: torch.Tensor   # (E,) int
    m_R: torch.Tensor      # (E,3,3) measurement m_ij = T_j T_i^-1
    m_t: torch.Tensor      # (E,3)
    weight: torch.Tensor   # (E,)
    edge_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor    # (K,) bool


def _apply_4dof(R, t, d):
    """The world-frame update of ImuCamPose::UpdateW on world->camera
    poses, batched: the camera->world pose turns by Exp((0, 0, d0)) about
    world z and moves by d[1:4], so T_cw' = T_cw [dR, d[1:4]]^-1."""
    z = torch.zeros_like(d[..., 0])
    dR = lie.so3_exp(torch.stack([z, z, d[..., 0]], -1))
    Rn = R @ dR.transpose(-1, -2)
    return Rn, t - (Rn @ d[..., 1:4, None])[..., 0]


def _edge_residual_4dof(Ri, ti, Rj, tj, mR, mt, di, dj):
    """r = log_se3(m_ij (T_i <+ di) (T_j <+ dj)^-1), (...,6)."""
    Ri2, ti2 = _apply_4dof(Ri, ti, di)
    Rj2, tj2 = _apply_4dof(Rj, tj, dj)
    Rji, tji = lie.se3_inverse(Rj2, tj2)
    Ra, ta = lie.se3_compose(Ri2, ti2, Rji, tji)
    Rb, tb = lie.se3_compose(mR, mt, Ra, ta)
    return lie.se3_log(Rb, tb)


def _build_4dof(p: PoseGraph4DoFProblem, R, t, jac: bool = True):
    """Residuals (E,6) and, with ``jac``, Jacobians (E,6,4) for both ends."""
    ei, ej = p.edge_i.long(), p.edge_j.long()
    args = (R[ei], t[ei], R[ej], t[ej], p.m_R, p.m_t)
    zero = torch.zeros(ei.shape[0], 4, dtype=t.dtype, device=t.device)
    r = _edge_residual_4dof(*args, zero, zero)
    if not jac:
        return r
    cols_i, cols_j = [], []
    for k in range(4):
        e = torch.zeros_like(zero)
        e[:, k] = 1.0
        cols_i.append(torch.func.jvp(lambda d: _edge_residual_4dof(*args, d, zero), (zero,),
                                     (e,))[1])
        cols_j.append(torch.func.jvp(lambda d: _edge_residual_4dof(*args, zero, d), (zero,),
                                     (e,))[1])
    return r, torch.stack(cols_i, -1), torch.stack(cols_j, -1)


def optimize_pose_graph_4dof_plain(p: PoseGraph4DoFProblem, n_iters: int = 15,
                                   cg_iters: int = 50):
    """Plain version of ``optimize_pose_graph_4dof`` (same arguments)."""
    def retract(st, d):
        Rn, tn = _apply_4dof(*st, d)
        return lie.normalize_rotation(Rn), tn

    (R, t), c = _lm_block_jacobi(p, (p.R, p.t), lambda st, jac: _build_4dof(p, *st, jac=jac),
                                 retract, (~p.fixed).to(p.t.dtype)[:, None], 4, n_iters,
                                 cg_iters)
    return R, t, c


def optimize_pose_graph_4dof(p: PoseGraph4DoFProblem, n_iters: int = 15, cg_iters: int = 50):
    """LM over the 4-DoF essential graph.  Returns (R (K,3,3), t (K,3),
    the last candidate's cost).

    Replaces ``extractorb_tpu/solver/pose_graph.py:optimize_pose_graph_4dof``.
    On CUDA tensors this launches K23 once: one CTA runs every LM and PCG
    step in float32, with sums in a fixed order (one result per input); the
    problem's real fields must be float32 there.  On the CPU it runs
    ``optimize_pose_graph_4dof_plain`` (float32 or float64)."""
    if not p.t.is_cuda:
        return optimize_pose_graph_4dof_plain(p, n_iters, cg_iters)
    K, E = p.R.shape[0], p.edge_i.shape[0]
    reals = (p.R, p.t, p.m_R, p.m_t, p.weight)
    if any(a.dtype != torch.float32 for a in reals):
        raise ValueError(f"pose_graph_4dof: dtypes {[a.dtype for a in reals]}, K23 takes "
                         f"float32")
    if p.R.shape != (K, 3, 3) or p.t.shape != (K, 3) or p.m_R.shape != (E, 3, 3) \
            or p.m_t.shape != (E, 3) or p.fixed.shape != (K,):
        raise ValueError("pose_graph_4dof: inconsistent problem shapes")
    i32 = lambda a: a.to(torch.int32).contiguous()
    R, t = p.R.contiguous().clone(), p.t.contiguous().clone()
    w = (p.weight * p.edge_valid.to(p.weight.dtype)).contiguous()
    args = [i32(p.edge_i), i32(p.edge_j), p.m_R.contiguous(), p.m_t.contiguous(), w,
            p.fixed.to(torch.bool).contiguous()]
    kernels.require_cuda("pose_graph_4dof", R, t, *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.pose_graph_4dof_workspace_bytes(K, E)), dtype=torch.uint8,
                     device=p.t.device)
    cost = torch.empty((), dtype=torch.float32, device=p.t.device)
    err = lib.pose_graph_4dof_launch(R.data_ptr(), t.data_ptr(), *[a.data_ptr() for a in args],
                                     K, E, n_iters, cg_iters, ws.data_ptr(), cost.data_ptr(),
                                     kernels.stream())
    kernels.check(err, "pose_graph_4dof")
    kernels.LAUNCHES["pose_graph_4dof"] += 1
    return R, t, cost


def optimize_pose_graph(p: PoseGraphProblem, n_iters: int = 15, cg_iters: int = 50,
                        fix_scale: bool = False):
    """LM over the essential graph.  Returns (R (K,3,3), t (K,3), s (K,),
    the last candidate's cost).

    Replaces ``extractorb_tpu/solver/pose_graph.py:optimize_pose_graph``.
    On CUDA tensors this launches K13: every LM and PCG step is enqueued
    without a host synchronisation (alpha, beta, the costs and lambda stay
    on the card; 7 + 3 cg_iters launches per LM iteration, every sum in a fixed
    order).  The kernel
    computes in float64 and returns the problem's dtype: exact-scale edges
    put the float32 Sim3 log in cancellation (csrc/pose_graph.cu).  On the
    CPU it runs ``optimize_pose_graph_plain``."""
    if not p.t.is_cuda:
        return optimize_pose_graph_plain(p, n_iters, cg_iters, fix_scale)
    K, E = p.R.shape[0], p.edge_i.shape[0]
    dev = p.t.device
    f64 = lambda a: a.to(torch.float64).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    R, t, s = f64(p.R).clone(), f64(p.t).clone(), f64(p.s).clone()
    w = f64(p.weight * p.edge_valid.to(p.weight.dtype))
    args = [i32(p.edge_i), i32(p.edge_j), f64(p.m_R), f64(p.m_t), f64(p.m_s), w,
            p.fixed.to(torch.bool).contiguous()]
    kernels.require_cuda("pose_graph", R, t, s, *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.pose_graph_workspace_bytes(K, E, cg_iters)), dtype=torch.uint8,
                     device=dev)
    cost = torch.empty((), dtype=torch.float64, device=dev)
    err = lib.pose_graph_launch(R.data_ptr(), t.data_ptr(), s.data_ptr(),
                                *[a.data_ptr() for a in args], K, E, n_iters, cg_iters,
                                int(fix_scale), ws.data_ptr(), cost.data_ptr(), kernels.stream())
    kernels.check(err, "pose_graph")
    kernels.LAUNCHES["pose_graph"] += 1
    dt = p.t.dtype
    return R.to(dt), t.to(dt), s.to(dt), cost.to(dt)
