"""The essential graph over edge shards (port of
``extractorb_tpu/dist/sharded_pose_graph.py``).

The multi-device OptimizeEssentialGraph (reference src/Optimizer.cc:2303):
the edges (spanning tree, covisibility, loop edges: O(K x covisibility))
are cut into one block per shard while the K Sim3 vertices stay whole on
every shard.  Each shard builds the residuals and Jacobians of its edges;
the gradient, the block-Jacobi preconditioner's blocks, the PCG's
Hessian-vector products and the costs are summed across shards in shard
order, where the JAX program psums: the same LM as
``solver/pose_graph.optimize_pose_graph``.

``optimize_sharded_pose_graph`` launches kernel K31 (``csrc/pose_graph.cu``)
on CUDA tensors over a mesh of more than one shard, K13 on one shard, and
runs ``optimize_sharded_pose_graph_plain`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..solver import pose_graph as pg
from ..solver.pose_graph import PoseGraphProblem
from .mesh import Mesh, cuda_ids


def optimize_sharded_pose_graph_plain(mesh: Mesh, p: PoseGraphProblem, n_iters: int = 15,
                                      cg_iters: int = 50, fix_scale: bool = False):
    """Plain version of ``optimize_sharded_pose_graph`` (same arguments),
    on ``p``'s device."""
    return pg.optimize_pose_graph_plain(p, n_iters, cg_iters, fix_scale, n_shards=mesh.size)


def _edge_shards(p: PoseGraphProblem, n: int):
    """``p`` cut into n problems of E / n consecutive edges each, every one
    with all the vertices."""
    Es = p.edge_i.shape[0] // n
    cut = lambda a, s: a[s * Es:(s + 1) * Es]
    return [p._replace(edge_i=cut(p.edge_i, s), edge_j=cut(p.edge_j, s), m_R=cut(p.m_R, s),
                       m_t=cut(p.m_t, s), m_s=cut(p.m_s, s), weight=cut(p.weight, s),
                       edge_valid=cut(p.edge_valid, s)) for s in range(n)]


def _sharded_kernel(mesh: Mesh, p: PoseGraphProblem, n_iters: int, cg_iters: int,
                    fix_scale: bool):
    """K31: shard s's edges and a copy of the vertices on
    ``mesh.devices[s]``, in float64 as K13."""
    devs, dev_ids = mesh.devices, cuda_ids(mesh, "pose_graph_sharded")
    n, K = mesh.size, p.R.shape[0]
    shards = _edge_shards(p, n)
    Es = shards[0].edge_i.shape[0]
    lib = kernels.lib()
    ws_bytes = int(lib.pose_graph_workspace_bytes(K, Es, cg_iters))
    keep, rows = [], []
    for q, dev in zip(shards, devs):
        f64 = lambda a: a.to(device=dev, dtype=torch.float64).contiguous()
        i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()
        t_ = [f64(p.R).clone(), f64(p.t).clone(), f64(p.s).clone(), i32(q.edge_i),
              i32(q.edge_j), f64(q.m_R), f64(q.m_t), f64(q.m_s),
              f64(q.weight * q.edge_valid.to(q.weight.dtype)),
              p.fixed.to(device=dev, dtype=torch.bool).contiguous(),
              torch.empty(ws_bytes, dtype=torch.uint8, device=dev),
              torch.empty((), dtype=torch.float64, device=dev)]
        kernels.require_cuda("pose_graph_sharded", *t_)
        keep.append(t_)
        rows.append([a.data_ptr() for a in t_] + [torch.cuda.current_stream(dev).cuda_stream])
    tab = np.asarray(rows, np.int64)
    gather = (torch.empty(int(lib.pose_graph_gather_bytes(n, K)), dtype=torch.uint8,
                          device=devs[0]) if len(set(dev_ids.tolist())) > 1 else None)
    with torch.cuda.device(devs[0]):
        err = lib.pose_graph_sharded_launch(n, dev_ids.ctypes.data, tab.ctypes.data, K, Es,
                                            n_iters, cg_iters, int(fix_scale),
                                            None if gather is None else gather.data_ptr())
    kernels.check(err, "pose_graph_sharded")
    kernels.LAUNCHES["pose_graph_sharded"] += 1
    dt = p.t.dtype
    R, t, s, cost = keep[0][0], keep[0][1], keep[0][2], keep[0][11]
    return R.to(dt), t.to(dt), s.to(dt), cost.to(dt)


def optimize_sharded_pose_graph(mesh: Mesh, p: PoseGraphProblem, n_iters: int = 15,
                                cg_iters: int = 50, fix_scale: bool = False):
    """Edge-sharded pose-graph LM.  The number of edges must be a multiple
    of the mesh size (pad with ``edge_valid`` False).  Returns (R, t, s,
    the last candidate's cost) like ``solver.pose_graph.optimize_pose_graph``;
    ``fix_scale`` freezes every vertex's scale (the stereo / RGB-D graph,
    Optimizer.cc:2621).

    Replaces ``extractorb_tpu/dist/sharded_pose_graph.py:
    optimize_sharded_pose_graph``.  On CUDA tensors this launches K31 over
    more than one shard (K13 over one): every LM and PCG step is enqueued
    without a host synchronisation, in float64 as K13.  On the CPU it runs
    ``optimize_sharded_pose_graph_plain``."""
    if p.edge_i.shape[0] % mesh.size:
        raise ValueError(f"optimize_sharded_pose_graph: {p.edge_i.shape[0]} edges on "
                         f"{mesh.size} shards")
    if not p.t.is_cuda:
        return optimize_sharded_pose_graph_plain(mesh, p, n_iters, cg_iters, fix_scale)
    if mesh.size == 1:
        return pg.optimize_pose_graph(p, n_iters, cg_iters, fix_scale)
    return _sharded_kernel(mesh, p, n_iters, cg_iters, fix_scale)
