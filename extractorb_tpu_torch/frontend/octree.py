"""Quadtree keypoint distribution, device path
(port of ``extractorb_tpu/frontend/octree.py:distribute_device``).

The quadtree cell boundaries are data-independent (DivideNode's ceil
halving depends only on the box), so each keypoint's cell at every depth
is a lookup in static tables, built once per level shape on the host
(``OctreePlan``).  The device picks the smallest depth with >= N occupied
cells and keeps the per-cell argmax response, with the earlier index
winning ties.  This is the JAX package's documented approximation of
DistributeOctTree, and the port matches it, not the C++ leaf set.
"""

from __future__ import annotations

import numpy as np
import torch

D_MAX = 7
SENT = 2 ** 30


def _cuts_for_depth(w: int, h: int, d_max: int):
    """Static x/y cell left-edges per depth, following DivideNode's ceil
    halving.  Returns lists of np arrays indexed by depth."""
    n_ini = max(int(np.floor(w / float(h) + 0.5)), 1)
    h_x = np.float32(w) / np.float32(n_ini)
    x_edges = [
        np.asarray([int(h_x * np.float32(i)) for i in range(n_ini)] + [w])
    ]
    y_edges = [np.asarray([0, h])]

    def split(edges):
        out = []
        for a, b in zip(edges[:-1], edges[1:]):
            half = int(np.ceil(np.float32(b - a) / 2))
            mid = a + half
            out.append(a)
            if mid < b and mid > a:
                out.append(mid)
        out.append(edges[-1])
        return np.asarray(sorted(set(out)))

    for _ in range(d_max):
        x_edges.append(split(x_edges[-1]))
        y_edges.append(split(y_edges[-1]))
    return x_edges, y_edges


def _axis_path_bits(edges_list, d_max: int = D_MAX):
    """Per fine interval of one axis: its child bit at every depth (packed,
    depth 1 in the high bit) and its top-level cell."""
    fine = edges_list[d_max]
    code = np.zeros(len(fine) - 1, np.int64)
    for d in range(1, d_max + 1):
        idx_d = np.searchsorted(edges_list[d][1:-1], fine[:-1], "right")
        idx_p = np.searchsorted(edges_list[d - 1][1:-1], fine[:-1], "right")
        start = np.full(len(edges_list[d - 1]) - 1, 1 << 30, np.int64)
        np.minimum.at(start, idx_p, idx_d)
        child = idx_d - start[idx_p]
        assert child.min() >= 0 and child.max() <= 1
        code = (code << 1) | child
    top = np.searchsorted(edges_list[0][1:-1], fine[:-1], "right")
    return code.astype(np.int32), top.astype(np.int32)


class OctreePlan:
    """Static tables of one level's quadtree (inner edges per depth and
    the path-bit tables), on the device that runs the distribution."""

    def __init__(self, width: int, height: int, min_x: int, min_y: int, device):
        x_edges, y_edges = _cuts_for_depth(width, height, D_MAX)
        for d in range(D_MAX + 1):
            assert (len(x_edges[d]) - 1) * (len(y_edges[d]) - 1) < (1 << 22), \
                "cell id must fit the packed int32 key"
        t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        self.width, self.height = width, height
        self.min_x, self.min_y = min_x, min_y
        self.x_inner = [t(e[1:-1]) for e in x_edges]
        self.y_inner = [t(e[1:-1]) for e in y_edges]
        self.n_cx = [len(e) - 1 for e in x_edges]
        bx_tab, topx_tab = _axis_path_bits(x_edges)
        by_tab, _ = _axis_path_bits(y_edges)
        self.bx, self.topx, self.by = t(bx_tab), t(topx_tab), t(by_tab)


def _cell_index(coord: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    # number of inner edges <= coord: the interval index
    return torch.searchsorted(inner, coord, right=True).to(torch.int32)


def _interleave(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    # one (by, bx) child-bit pair per depth, depth 1 in the high pair
    morton = torch.zeros_like(kx)
    for i in range(D_MAX):
        morton |= (((kx >> i) & 1) | (((ky >> i) & 1) << 1)) << (2 * i)
    return morton


def path_code(x: torch.Tensor, y: torch.Tensor, plan: OctreePlan) -> torch.Tensor:
    """The quadtree path code of each point (coords relative to the
    plan's origin): the top-level x cell, then one (by, bx) child-bit pair
    per depth, depth 1 in the high pair; every depth-d cell is the code's
    prefix ``code >> 2 (D_MAX - d)``."""
    cx_f = _cell_index(x, plan.x_inner[D_MAX]).long()
    cy_f = _cell_index(y, plan.y_inner[D_MAX]).long()
    return (plan.topx[cx_f] << (2 * D_MAX)) | _interleave(plan.bx[cx_f], plan.by[cy_f])


def path_code_tables(plan: OctreePlan):
    """Per pixel column x in [0, width) and row y in [0, height) of the
    plan's box, the parts of ``path_code`` each axis gives: (px (width,),
    py (height,)) int32 on the host with path_code = px[x] | py[y].
    Coordinates outside the box take the edge pixel's part (the first or
    the last interval, as ``_cell_index``)."""
    cx = _cell_index(torch.arange(plan.width, dtype=torch.int32),
                     plan.x_inner[D_MAX].cpu()).long()
    cy = _cell_index(torch.arange(plan.height, dtype=torch.int32),
                     plan.y_inner[D_MAX].cpu()).long()
    kx, topx, ky = plan.bx.cpu()[cx], plan.topx.cpu()[cx], plan.by.cpu()[cy]
    px = (topx << (2 * D_MAX)) | _interleave(kx, torch.zeros_like(kx))
    py = _interleave(torch.zeros_like(ky), ky)
    return px.to(torch.int32), py.to(torch.int32)


def distribute_device(xy: torch.Tensor, resp: torch.Tensor, valid: torch.Tensor,
                      n_target: int, plan: OctreePlan):
    """Quadtree distribution.  xy: (K, 2) int32 absolute inner coords.

    Returns (keep_mask (K,), depth_used ()).  Keeps the argmax-response
    keypoint of every occupied cell at the smallest depth whose occupied
    cell count reaches n_target (or the deepest table).  Two K-element
    sorts, the second stable; no host synchronisation."""
    K = xy.shape[0]
    dev = xy.device
    x = (xy[:, 0] - plan.min_x).contiguous()
    y = (xy[:, 1] - plan.min_y).contiguous()

    cells = torch.stack([
        torch.where(valid,
                    _cell_index(y, plan.y_inner[d]) * plan.n_cx[d]
                    + _cell_index(x, plan.x_inner[d]), SENT)
        for d in range(D_MAX + 1)
    ])  # (D+1, K) cell id per depth, in input order

    path = torch.where(valid, path_code(x, y, plan), SENT)

    p1 = torch.sort(path).values
    counts = []
    for d in range(D_MAX + 1):
        pre = torch.where(p1 < SENT, p1 >> (2 * (D_MAX - d)), SENT)
        head = torch.ones_like(pre, dtype=torch.bool)
        head[1:] = pre[1:] != pre[:-1]
        counts.append(torch.sum(head & (pre < SENT)))
    reached = torch.stack(counts) >= n_target
    depths = torch.arange(D_MAX + 1, device=dev)
    depth = torch.where(reached, depths, D_MAX).amin()  # first reached, else D_MAX

    cell = cells.index_select(0, depth.reshape(1))[0]
    # per-cell argmax response, earliest index on ties: one STABLE sort
    # by (cell asc, resp desc); resp is a FAST score in [0, 255]
    packed = torch.where(cell < SENT, cell * 256 + (255 - resp), SENT)
    p_s, i_s = torch.sort(packed, stable=True)
    leader = torch.ones_like(p_s, dtype=torch.bool)
    leader[1:] = (p_s[1:] >> 8) != (p_s[:-1] >> 8)
    leader &= p_s < SENT
    keep = torch.zeros(K, dtype=torch.bool, device=dev)
    keep[i_s] = leader
    return keep & valid, depth
