"""FAST-9/16 corner detection with OpenCV-exact scores and the reference's
per-cell structure (port of ``extractorb_tpu/frontend/fast.py``).

``fast_detect`` is kernel K1 (``csrc/fast_detect.cu``): one CTA per FAST
cell of every pyramid level, all levels in one launch.  ``collect_levels``
is kernel K16 (``csrc/kp_collect.cu``): the per-level top-K collection of
the kept pixels, one CTA per level, all levels in one launch; its plain
version runs ``collect_keypoints`` level by level.  ``detect_keypoints``
is its plain PyTorch version for one level, written like the JAX
function: a dense cornerScore<16> plane, then a 3x3 non-max suppression
whose neighbours stop at cell boundaries, at threshold ``ini_th`` with a
per-cell retry at ``min_th`` in cells that keep nothing.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import kernels
from .pyramid import EDGE_THRESHOLD, Pyramid

# Bresenham circle of radius 3, OpenCV makeOffsets order (x, y):
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

MIN_BORDER = EDGE_THRESHOLD - 3  # 16; reference ORBextractor.cc:781-784


def cell_layout(width: int, height: int, cell: float = 30.0):
    """Reference cell grid over the valid FAST region (ORBextractor.cc:787-795).

    width/height are maxBorder-minBorder for the level.  Returns
    (n_cols, n_rows, w_cell, h_cell).
    """
    n_cols = int(width / cell)
    n_rows = int(height / cell)
    w_cell = int(np.ceil(width / n_cols))
    h_cell = int(np.ceil(height / n_rows))
    return n_cols, n_rows, w_cell, h_cell


def _level_geometry(H: int, W: int):
    """(n_cols, n_rows, w_cell, h_cell, x_end, y_end): the cell grid and
    the exclusive end of the valid region [MIN_BORDER+3, end) per axis."""
    min_b = MIN_BORDER
    max_x, max_y = W - min_b, H - min_b
    n_cols, n_rows, w_cell, h_cell = cell_layout(max_x - min_b, max_y - min_b)
    x_end = min(max_x - 3, min_b + n_cols * w_cell + 3)
    y_end = min(max_y - 3, min_b + n_rows * h_cell + 3)
    return n_cols, n_rows, w_cell, h_cell, x_end, y_end


# ----------------------------------------------------------- plain version


def corner_score(bordered: torch.Tensor, border: int = EDGE_THRESHOLD) -> torch.Tensor:
    """OpenCV cornerScore<16> for every inner pixel, as int16 (H, W):
    max over the 16 contiguous 9-arcs of the bright minimum or the dark
    maximum, minus 1.  A pixel is a FAST corner at threshold t iff
    score >= t."""
    h, w = bordered.shape
    H, W = h - 2 * border, w - 2 * border
    x = bordered.to(torch.int16)
    v = x[border:border + H, border:border + W]
    d = torch.stack([
        v - x[border + dy:border + dy + H, border + dx:border + dx + W]
        for dx, dy in _CIRCLE.tolist()
    ])
    d = torch.cat([d, d[:8]])
    arc_min = torch.stack([d[s:s + 9].amin(0) for s in range(16)])
    arc_max = torch.stack([d[s:s + 9].amax(0) for s in range(16)])
    s_bright = arc_min.amax(0)
    s_dark = arc_max.amin(0)
    return torch.maximum(s_bright, -s_dark) - 1


def detect_keypoints(bordered: torch.Tensor, ini_th: int = 20, min_th: int = 7,
                     border: int = EDGE_THRESHOLD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain per-level FAST with the reference's cell/retry semantics.

    Returns (keep, score): bool keep mask and int16 score over the inner
    (H, W) image; keep is set only inside the valid region."""
    h, w = bordered.shape
    H, W = h - 2 * border, w - 2 * border
    n_cols, n_rows, w_cell, h_cell, x_end, y_end = _level_geometry(H, W)
    x0 = MIN_BORDER + 3
    dev = bordered.device
    score = corner_score(bordered, border)

    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    in_region = (xs >= x0) & (xs < x_end) & (ys >= x0) & (ys < y_end)
    cell_x = ((xs - x0).div(w_cell, rounding_mode="floor")).clamp(0, n_cols - 1)
    cell_y = ((ys - x0).div(h_cell, rounding_mode="floor")).clamp(0, n_rows - 1)
    cell = (cell_y * n_cols + cell_x).expand(H, W)

    def shifted(a, dx, dy, fill):
        # out[y, x] = a[y + dy, x + dx], ``fill`` outside the plane
        out = torch.full_like(a, fill)
        out[max(0, -dy):min(H, H - dy), max(0, -dx):min(W, W - dx)] = \
            a[max(0, dy):min(H, H + dy), max(0, dx):min(W, W + dx)]
        return out

    def nonmax(th: int):
        cand = (score >= th) & in_region
        s = torch.where(cand, score, torch.zeros_like(score))
        keep = cand.clone()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                same = shifted(cell, dx, dy, -1) == cell
                ns = shifted(s, dx, dy, 0)
                keep &= s > torch.where(same, ns, torch.zeros_like(ns))
        return keep

    keep_ini = nonmax(ini_th)
    keep_min = nonmax(min_th)
    # per-cell retry: min_th survivors only in cells without an ini_th one
    counts = torch.zeros(n_rows * n_cols + 1, dtype=torch.int32, device=dev)
    cell_r = torch.where(in_region, cell, n_rows * n_cols)
    counts.index_add_(0, cell_r.reshape(-1), keep_ini.reshape(-1).to(torch.int32))
    has_ini = counts[cell_r] > 0
    keep = torch.where(has_ini, keep_ini, keep_min) & in_region
    return keep, score


def collect_keypoints(keep: torch.Tensor, score: torch.Tensor, capacity: int):
    """Compact a keep mask into a fixed-size keypoint list.

    Returns (xy int32 (K,2) inner coords, response int32 (K,), valid (K,)),
    by descending score with row-major ties.  The key
    ``score << 21 | (2^21 - 1 - idx)`` is unique, so ``torch.topk`` is
    deterministic on it (H*W < 2^21)."""
    H, W = keep.shape
    flat_score = torch.where(keep, score.to(torch.int32), -1).reshape(-1)
    flat_idx = torch.arange(H * W, dtype=torch.int32, device=keep.device)
    key = flat_score * (1 << 21) + ((1 << 21) - 1 - flat_idx)
    top, idx = torch.topk(key, capacity)
    valid = top >= 0
    xy = torch.stack([idx % W, idx.div(W, rounding_mode="floor")], -1).to(torch.int32)
    resp = torch.where(valid, score.reshape(-1)[idx].to(torch.int32), 0)
    return xy, resp, valid


# ------------------------------------------------------------- kernel K1


class FastPlan:
    """Static launch tables of K1 for one pyramid shape.

    Per level (int32): bordered offset and stride, inner W and H, offset
    of the inner plane in the outputs, n_cols, n_rows, w_cell, h_cell,
    region x_end and y_end, first CTA index."""

    def __init__(self, pyramid_shapes, pyramid_offsets, border: int = EDGE_THRESHOLD):
        self.border = border
        self.inner = [(hb - 2 * border, wb - 2 * border) for hb, wb in pyramid_shapes]
        rows, o_off, block0 = [], 0, 0
        tw_max = th_max = 0
        for (H, W), (hb, wb), b_off in zip(self.inner, pyramid_shapes, pyramid_offsets):
            n_cols, n_rows, w_cell, h_cell, x_end, y_end = _level_geometry(H, W)
            rows.append([b_off, wb, W, H, o_off, n_cols, n_rows, w_cell, h_cell,
                         x_end, y_end, block0])
            tw_max = max(tw_max, *self._tile_extents(W, n_cols, w_cell))
            th_max = max(th_max, *self._tile_extents(H, n_rows, h_cell))
            o_off += H * W
            block0 += n_cols * n_rows
        self.table = np.ascontiguousarray(np.asarray(rows, np.int32))
        self.plane_offsets = [r[4] for r in rows]
        self.total = o_off
        self.n_blocks = block0
        # dynamic shared memory: score tile (int16), raw tile with a 3-px
        # halo (uint8), keep flags (uint8)
        self.smem = th_max * tw_max * 3 + (th_max + 6) * (tw_max + 6)

    @staticmethod
    def _tile_extents(n: int, n_cells: int, cell: int):
        """Extent of every cell's tile along one axis; the first and last
        tiles also cover the margins, so the tiles partition the plane."""
        x0 = MIN_BORDER + 3
        out = []
        for c in range(n_cells):
            lo = 0 if c == 0 else x0 + c * cell
            hi = n if c == n_cells - 1 else min(n, x0 + (c + 1) * cell)
            out.append(hi - lo)
        return out


def fast_detect_plain(pyr: Pyramid, plan: FastPlan, ini_th: int = 20, min_th: int = 7):
    """Plain version of ``fast_detect``: ``detect_keypoints`` per level."""
    out = [detect_keypoints(b, ini_th, min_th, plan.border) for b in pyr.levels]
    return [k for k, _ in out], [s for _, s in out]


def fast_detect(pyr: Pyramid, plan: FastPlan, ini_th: int = 20, min_th: int = 7
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """FAST keep masks and scores of every pyramid level.

    Replaces ``extractorb_tpu/frontend/fast.py:detect_keypoints`` (with
    ``corner_score``) over all levels.  On a CUDA pyramid this launches
    K1 once; on the CPU it runs ``detect_keypoints`` per level.
    Returns per-level lists of (H, W) bool keep and int16 score."""
    if not pyr.flat.is_cuda:
        return fast_detect_plain(pyr, plan, ini_th, min_th)
    kernels.require_cuda("fast_detect", pyr.flat)
    dev = pyr.flat.device
    score = torch.empty(plan.total, dtype=torch.int16, device=dev)
    keep = torch.empty(plan.total, dtype=torch.bool, device=dev)
    hdr = np.asarray([len(plan.inner), plan.border, MIN_BORDER + 3, ini_th, min_th],
                     np.int32)
    tab = np.ascontiguousarray(np.concatenate([hdr, plan.table.reshape(-1)]))
    err = kernels.lib().fast_detect_launch(
        pyr.flat.data_ptr(), score.data_ptr(), keep.data_ptr(),
        tab.ctypes.data, plan.n_blocks, plan.smem, kernels.stream(),
    )
    kernels.check(err, "fast_detect")
    kernels.LAUNCHES["fast_detect"] += 1
    keeps, scores = [], []
    for (H, W), off in zip(plan.inner, plan.plane_offsets):
        keeps.append(keep[off:off + H * W].view(H, W))
        scores.append(score[off:off + H * W].view(H, W))
    return keeps, scores


# ------------------------------------------------------------- kernel K16


class CollectPlan:
    """Static launch table of K16 for one pyramid shape: per level (int32)
    the plane offset in K1's outputs, inner W and H, the candidate count
    k and the level's first slot in the concatenated outputs."""

    def __init__(self, fast_plan: FastPlan, k_levels):
        self.k_levels = [int(k) for k in k_levels]
        self.slot_offsets = np.concatenate([[0], np.cumsum(self.k_levels)[:-1]]).astype(int)
        self.total = int(sum(self.k_levels))
        self.plane_offsets = fast_plan.plane_offsets
        sort_n = 1 << (max(self.k_levels) - 1).bit_length()
        rows = [[off, W, H, k, o] for off, (H, W), k, o in
                zip(fast_plan.plane_offsets, fast_plan.inner, self.k_levels, self.slot_offsets)]
        self.table = np.ascontiguousarray(
            np.concatenate([[len(rows), sort_n], np.asarray(rows).reshape(-1)]).astype(np.int32))


def collect_levels_plain(keeps, scores, plan: CollectPlan):
    """Plain version of ``collect_levels``: ``collect_keypoints`` per level."""
    out = [collect_keypoints(k, s, n) for k, s, n in zip(keeps, scores, plan.k_levels)]
    return tuple(torch.cat(a) for a in zip(*out))


def collect_levels(keeps: List[torch.Tensor], scores: List[torch.Tensor], plan: CollectPlan):
    """The top ``plan.k_levels[l]`` kept pixels of every level by the key
    ``score << 21 | (2^21 - 1 - idx)``, descending, levels concatenated:
    (xy int32 (T, 2) inner coords, response int32 (T,), valid (T,)).
    Invalid slots hold the first unkept pixels in row-major order, with
    response 0, as ``collect_keypoints`` returns them.

    Replaces ``extractorb_tpu/frontend/fast.py:collect_keypoints`` on every
    level.  On CUDA planes (``fast_detect``'s views of its flat outputs)
    this launches K16 once; on the CPU it runs ``collect_levels_plain``."""
    if not keeps[0].is_cuda:
        return collect_levels_plain(keeps, scores, plan)
    kernels.require_cuda("kp_collect", *keeps, *scores)
    k0, s0 = keeps[0].data_ptr(), scores[0].data_ptr()
    for k, s, off in zip(keeps, scores, plan.plane_offsets):
        if k.dtype != torch.bool or s.dtype != torch.int16 or \
                k.data_ptr() != k0 + off or s.data_ptr() != s0 + 2 * off:
            raise ValueError("kp_collect: keep/score must be fast_detect's level views")
    dev = keeps[0].device
    xy = torch.empty(plan.total, 2, dtype=torch.int32, device=dev)
    resp = torch.empty(plan.total, dtype=torch.int32, device=dev)
    valid = torch.empty(plan.total, dtype=torch.bool, device=dev)
    err = kernels.lib().kp_collect_launch(k0, s0, plan.table.ctypes.data, xy.data_ptr(),
                                          resp.data_ptr(), valid.data_ptr(), kernels.stream())
    kernels.check(err, "kp_collect")
    kernels.LAUNCHES["kp_collect"] += 1
    return xy, resp, valid
