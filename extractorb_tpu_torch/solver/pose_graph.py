"""Sim3 pose-graph optimisation of the essential graph (port of
``extractorb_tpu/solver/pose_graph.py``, the 7-DoF graph; the 4-DoF
inertial graph is ROADMAP A.11).

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie


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


def optimize_pose_graph_plain(p: PoseGraphProblem, n_iters: int = 15, cg_iters: int = 50,
                              fix_scale: bool = False):
    """Plain version of ``optimize_pose_graph`` (same arguments)."""
    K = p.R.shape[0]
    dt = p.t.dtype
    dev = p.t.device
    ei, ej = p.edge_i.long(), p.edge_j.long()
    free = (~p.fixed).to(dt)[:, None].expand(K, 7).clone()
    if fix_scale:
        free[:, 6] = 0.0
    w = p.weight.to(dt) * p.edge_valid.to(dt)
    I7 = torch.eye(7, dtype=dt, device=dev)

    def seg(vals, idx, shape):
        return torch.zeros(shape, dtype=dt, device=dev).index_add_(0, idx, vals)

    def cost(R, t, s):
        r2 = _build(p, R, t, s, jac=False)
        return torch.sum(torch.where(p.edge_valid, torch.sum(r2 * r2, -1) * p.weight, 0.0))

    R, t, s = p.R, p.t, p.s
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    c_new = torch.tensor(0.0, dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Ji, Jj = _build(p, R, t, s)
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        g = (seg(torch.einsum("eif,ei->ef", Jiw, r), ei, (K, 7))
             + seg(torch.einsum("eif,ei->ef", Jjw, r), ej, (K, 7))) * free
        Hd = (seg(torch.einsum("eif,eig->efg", Jiw, Ji), ei, (K, 7, 7))
              + seg(torch.einsum("eif,eig->efg", Jjw, Jj), ej, (K, 7, 7)))
        M = torch.linalg.inv(Hd + lam * I7[None])

        def hv(v):
            v = v * free
            u = torch.einsum("eif,ef->ei", Ji, v[ei]) + torch.einsum("eif,ef->ei", Jj, v[ej])
            uw = u * w[:, None]
            h = (seg(torch.einsum("eif,ei->ef", Ji, uw), ei, (K, 7))
                 + seg(torch.einsum("eif,ei->ef", Jj, uw), ej, (K, 7)))
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
        d = -x * free
        dR, dtr, ds = lie.sim3_exp(d)
        Rn, tn, sn = lie.sim3_compose(dR, dtr, ds, R, t, s)
        Rn = lie.normalize_rotation(Rn)
        c_new = cost(Rn, tn, sn)
        better = c_new < cost(R, t, s)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return R, t, s, c_new


def optimize_pose_graph(p: PoseGraphProblem, n_iters: int = 15, cg_iters: int = 50,
                        fix_scale: bool = False):
    """LM over the essential graph.  Returns (R (K,3,3), t (K,3), s (K,),
    the last candidate's cost).

    Replaces ``extractorb_tpu/solver/pose_graph.py:optimize_pose_graph``.
    On CUDA tensors this launches K13: every LM and PCG step is enqueued
    without a host synchronisation (alpha, beta, the costs and lambda stay
    on the card; 6 + 3 cg_iters launches per LM iteration).  The kernel
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
