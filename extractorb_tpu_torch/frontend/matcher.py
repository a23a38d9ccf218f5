"""Descriptor matching (port of ``extractorb_tpu/frontend/matcher.py``).

The projection searches (tracking, relocalization, fusion, the Sim3
searches of loop closing) reduce to one primitive, kernel K3
``hamming_best2``:
for every query row, the best and second-best 256-bit Hamming distance
over the candidate columns that pass a per-row gate (a strict box
|u - x| < r, |v - y| < r, a level range [lo, hi], row and column
validity).  The JAX package builds the dense (N1, N2) distance matrix as
bf16 bit-plane matmuls on the MXU; the kernel XORs and popcounts and never
stores the matrix.  The accept tests around it (TH and ratio) are torch
elementwise ops; the conflict resolution and the rotation histogram that
turn the accepted rows into matches are kernel K18 ``match_epilogue``.

Semantics kept from the JAX functions: a masked pair counts as 1<<20;
ties go to the lower index (``jnp.argmin``); "second" is the minimum with
only the best column removed; a row without a candidate (or without a
second) reports distance 1<<20 and index 0.

Constants TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 (ORBmatcher.cc:36-38),
including the reference's 1/HISTO_LENGTH histogram factor quirk.

The triangulation search of local mapping (``search_for_triangulation``,
and with the triangulation gates ``tri_search``) is kernel K7: the
epipolar-gated best match per keypoint and the per-column claim, without
the dense distance matrix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from .. import kernels
from ..core.camera import Camera

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INF = 1 << 20
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


class Best2(NamedTuple):
    best: torch.Tensor        # (M,) int32 distance, INF if no candidate
    second: torch.Tensor      # (M,) int32
    best_idx: torch.Tensor    # (M,) int32 column, 0 if no candidate
    second_idx: torch.Tensor  # (M,) int32


class Gate(NamedTuple):
    """Per-row window and level range, per-column position and level."""
    u: torch.Tensor       # (M,) f32 window centre
    v: torch.Tensor       # (M,) f32
    r: torch.Tensor       # (M,) f32 half-width (strict)
    lo: torch.Tensor      # (M,) int32 lowest allowed column level
    hi: torch.Tensor      # (M,) int32 highest allowed column level
    x: torch.Tensor       # (N,) f32 column position
    y: torch.Tensor       # (N,) f32
    octave: torch.Tensor  # (N,) int32 column level


def open_gate(M: int, N: int, device) -> Gate:
    """A gate that admits every pair (for plain descriptor matching)."""
    z = torch.zeros(M, dtype=torch.float32, device=device)
    zc = torch.zeros(N, dtype=torch.float32, device=device)
    return Gate(z, z, torch.full_like(z, float("inf")),
                torch.full((M,), _I32_MIN, dtype=torch.int32, device=device),
                torch.full((M,), _I32_MAX, dtype=torch.int32, device=device),
                zc, zc, torch.zeros(N, dtype=torch.int32, device=device))


# ----------------------------------------------------------- plain version

def hamming_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(N1, N2) int32 Hamming distances between packed descriptors, as
    bit-plane products (exact in float32 even under TF32: the operands
    are 0/1 and the sums <= 256)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc1.device)
    unpack = lambda d: ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256).float()
    a, b = unpack(desc1), unpack(desc2)
    dots = a @ b.T
    return (a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * dots).to(torch.int32)


def _gate_mask(gate: Gate, row_ok, col_ok):
    in_win = ((gate.u[:, None] - gate.x[None, :]).abs() < gate.r[:, None]) & \
             ((gate.v[:, None] - gate.y[None, :]).abs() < gate.r[:, None])
    lvl = (gate.octave[None, :] >= gate.lo[:, None]) & (gate.octave[None, :] <= gate.hi[:, None])
    return in_win & lvl & row_ok[:, None] & col_ok[None, :]


def _word_mask(q_word, c_word, row_ok, col_ok):
    return ((q_word[:, None] == c_word[None, :]) & (q_word >= 0)[:, None] & (c_word >= 0)[None, :]
            & row_ok[:, None] & col_ok[None, :])


def hamming_best2_plain(q_desc, row_ok, c_desc, col_ok, gate: Optional[Gate] = None,
                        words=None) -> Best2:
    """Plain version of ``hamming_best2``; ``words`` = (q_word, c_word)
    takes the word gate in place of ``gate``, and neither the open gate."""
    M, N = q_desc.shape[0], c_desc.shape[0]
    if gate is None and words is None:
        gate = open_gate(M, N, q_desc.device)
    mask = (_word_mask(words[0], words[1], row_ok, col_ok) if words is not None
            else _gate_mask(gate, row_ok, col_ok))
    d = torch.where(mask, hamming_matrix(q_desc, c_desc), INF)
    # unique (distance, column) keys: min = argmin with the lower index on ties
    cols = torch.arange(N, device=d.device)
    key = d.long() * N + cols
    k1 = key.amin(1)
    best, best_idx = k1 // N, k1 % N
    key2 = torch.where(cols[None, :] == best_idx[:, None], INF * N, key)
    k2 = key2.amin(1)
    second, second_idx = k2 // N, k2 % N
    i32 = lambda t: t.to(torch.int32)
    return Best2(i32(best), i32(second), i32(best_idx), i32(second_idx))


# the box route's bucket grid (hamming_best2.cu kColsPerCell, kMaxCells)
BOX_COLS_PER_CELL = 2
BOX_MAX_CELLS = 2048


class BucketGrid(NamedTuple):
    """K3's box-route grid over the columns: origin, cells per pixel and
    cell counts of each axis; ``cells`` (N,) the row-major cell of each
    column in the grid, -1 for a column left out."""
    x0: torch.Tensor
    y0: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    gx: int
    gy: int
    cells: torch.Tensor


def grid_cell(c: torch.Tensor, c0: torch.Tensor, s: torch.Tensor, g: int) -> torch.Tensor:
    """floor((c - c0) * s) clamped to [0, g - 1], NaN to 0, in float32: the
    kernel's cell of a coordinate, monotone in c."""
    f = torch.floor((c - c0) * s)
    return torch.nan_to_num(f, nan=0.0).clamp(0.0, float(g - 1)).to(torch.int32)


def bucket_grid(x: torch.Tensor, y: torch.Tensor, col_ok: torch.Tensor) -> BucketGrid:
    """The plain mirror of the grid each CTA of K3's box route builds: the
    bounding box of the valid columns with finite x and y, about
    BOX_COLS_PER_CELL of them a cell (at most BOX_MAX_CELLS cells), the
    same float32 arithmetic as the kernel."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    inside = col_ok & torch.isfinite(x) & torch.isfinite(y)
    n_in = int(inside.sum())
    big = f32(float("inf"))
    xmin = torch.where(inside, x, big).amin() if x.numel() else big
    xmax = torch.where(inside, x, -big).amax() if x.numel() else -big
    ymin = torch.where(inside, y, big).amin() if y.numel() else big
    ymax = torch.where(inside, y, -big).amax() if y.numel() else -big
    cells = min(max(n_in // BOX_COLS_PER_CELL, 1), BOX_MAX_CELLS)
    gw, gh = torch.clamp(xmax - xmin, min=1.0), torch.clamp(ymax - ymin, min=1.0)
    q = torch.sqrt(f32(cells) * gw / gh)
    gx = int(torch.clamp(torch.nan_to_num(q, nan=float(cells)), max=float(cells)).clamp(min=1.0))
    gy = max(cells // gx, 1)
    sx, sy = f32(gx) / gw, f32(gy) / gh
    cell = grid_cell(y, ymin, sy, gy) * gx + grid_cell(x, xmin, sx, gx)
    return BucketGrid(xmin, ymin, sx, sy, gx, gy, torch.where(inside, cell, -1))


def row_cells(grid: BucketGrid, u, v, r):
    """The cells a row of K3's box route walks: (cx0, cx1, cy0, cy1), the
    cells of u - r, u + r, v - r and v + r widened by one a side."""
    cx0 = (grid_cell(u - r, grid.x0, grid.sx, grid.gx) - 1).clamp(min=0)
    cx1 = (grid_cell(u + r, grid.x0, grid.sx, grid.gx) + 1).clamp(max=grid.gx - 1)
    cy0 = (grid_cell(v - r, grid.y0, grid.sy, grid.gy) - 1).clamp(min=0)
    cy1 = (grid_cell(v + r, grid.y0, grid.sy, grid.gy) + 1).clamp(max=grid.gy - 1)
    return cx0, cx1, cy0, cy1


# ------------------------------------------------------------- kernel K3


def hamming_best2(q_desc: torch.Tensor, row_ok: torch.Tensor, c_desc: torch.Tensor,
                  col_ok: torch.Tensor, gate: Optional[Gate] = None, words=None) -> Best2:
    """Gated best/second-best Hamming match of every query row.

    Replaces the ``hamming_matrix`` + masked min/argmin of the JAX
    searches.  q_desc (M,32) u8 with row_ok (M,); c_desc (N,32) u8 with
    col_ok (N,).  ``words`` = (q_word (M,), c_word (N,)) int32 takes the
    word gate of ``search_by_bow`` (equal words, both >= 0) in place of
    ``gate``; with neither, every pair is open.  On CUDA tensors this
    launches K3, the grid route under a box gate and the dense route
    otherwise (its launches are counted as "hamming_best2_words" with the
    word gate); on the CPU it runs the dense plain version."""
    M, N = q_desc.shape[0], c_desc.shape[0]
    if not q_desc.is_cuda:
        return hamming_best2_plain(q_desc, row_ok, c_desc, col_ok, gate, words)
    f32 = lambda t: t.to(torch.float32).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    name = "hamming_best2"
    word_args = [None, None]
    if words is not None:
        name = "hamming_best2_words"
        word_args = [i32(words[0]), i32(words[1])]
    if gate is None or words is not None:
        # the word gate or the open gate: the box and level arguments are not read
        args = [q_desc.contiguous(), None, None, None, None, None, row_ok.contiguous(),
                c_desc.contiguous(), None, None, None, col_ok.contiguous()]
    else:
        args = [q_desc.contiguous(), f32(gate.u), f32(gate.v), f32(gate.r), i32(gate.lo),
                i32(gate.hi), row_ok.contiguous(), c_desc.contiguous(), f32(gate.x),
                f32(gate.y), i32(gate.octave), col_ok.contiguous()]
    kernels.require_cuda(name, *(a for a in args + word_args if a is not None))
    if args[0].data_ptr() % 16 or args[7].data_ptr() % 16:
        # the kernel reads descriptors as 16-byte words: fresh allocations are aligned
        args[0], args[7] = args[0].clone(), args[7].clone()
    out = torch.empty(4, M, dtype=torch.int32, device=q_desc.device)
    p = [None if a is None else a.data_ptr() for a in word_args + args]
    err = kernels.lib().hamming_best2_launch(
        *p[:9], M, *p[9:], N, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(), kernels.stream(),
    )
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return Best2(out[0], out[1], out[2], out[3])


# ------------------------------------------------------------ the searches


def rotation_consistency_mask(angle1, angle2, cand_valid):
    """Reference rotation-histogram filter (ComputeThreeMaxima,
    ORBmatcher.cc:2303): keep the candidates in the top-3 bins, dropping
    bins 2 and 3 below 0.1x the largest.  Ties between bins go to the
    lower bin (``jax.lax.top_k``): the sort key count*32 + (31 - bin) is
    unique."""
    rot = angle1 - angle2
    rot = torch.where(rot < 0, rot + 360.0, rot)
    binf = torch.round(rot * (1.0 / HISTO_LENGTH)).to(torch.int32)  # reference quirk
    binf = torch.where(binf == HISTO_LENGTH, 0, binf).clamp(0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=binf.device)
    hist.index_add_(0, binf, cand_valid.to(torch.int32))
    bins = torch.arange(HISTO_LENGTH, dtype=torch.int32, device=binf.device)
    top = torch.sort(hist * 32 + (31 - bins), descending=True).values[:3]
    cnt, ib = top // 32, 31 - top % 32
    keep2 = cnt[1].float() >= 0.1 * cnt[0].float()
    keep3 = cnt[2].float() >= 0.1 * cnt[0].float()
    ok = (binf == ib[0]) | (keep2 & (binf == ib[1])) | (keep3 & (binf == ib[2]))
    return ok & cand_valid


def _first_claim(best_idx, accept, n_kp: int):
    """First-come conflict resolution: the smallest map-point index claims
    a keypoint (scatter-min; index n_kp is the drop slot)."""
    M = best_idx.shape[0]
    mp_i = torch.arange(M, dtype=torch.int32, device=best_idx.device)
    winner = torch.full((n_kp + 1,), M, dtype=torch.int32, device=best_idx.device)
    winner.scatter_reduce_(0, torch.where(accept, best_idx, n_kp).long(),
                           torch.where(accept, mp_i, M), "amin")
    return accept & (winner[best_idx.long()] == mp_i)


def _distance_claim(best, best_idx, accept, n_kp: int):
    """Distance-major conflict resolution of the initialization and BoW
    searches: a keypoint goes to the row with the smaller distance, then
    the earlier row (scatter-min of best * M + row; n_kp is the drop slot)."""
    M = best_idx.shape[0]
    claim_key = best.long() * M + torch.arange(M, device=best.device)
    big = torch.iinfo(torch.int64).max
    winner = torch.full((n_kp + 1,), big, dtype=torch.int64, device=best.device)
    winner.scatter_reduce_(0, torch.where(accept, best_idx, n_kp).long(),
                           torch.where(accept, claim_key, big), "amin")
    return accept & (winner[best_idx.long()] == claim_key)


def match_epilogue_plain(best, best_idx, accept, n_kp: int, by_distance: bool,
                         angle1=None, angle2=None):
    """Plain version of ``match_epilogue``."""
    claim = _distance_claim(best, best_idx, accept, n_kp) if by_distance else \
        _first_claim(best_idx, accept, n_kp)
    if angle1 is not None:
        claim = claim & rotation_consistency_mask(angle1, angle2[best_idx.long()], accept)
    return torch.where(claim, best_idx, -1)


# ------------------------------------------------------------ kernel K18


def match_epilogue(best, best_idx, accept, n_kp: int, by_distance: bool,
                   angle1=None, angle2=None):
    """A search's final matches from K3's best distance and column per
    row and the search's accept mask: one keypoint per row by the claim
    rule (``by_distance``: the smaller distance, then the earlier row;
    else the earlier row), then, with ``angle1`` (M,) / ``angle2`` (N,),
    the rotation-histogram filter over the accepted rows.

    Replaces ``extractorb_tpu/frontend/matcher.py:_first_claim``,
    ``:rotation_consistency_mask`` and the claims of
    ``search_for_initialization`` and ``search_by_bow``.  Returns (M,)
    int32 column or -1.  On CUDA tensors this launches K18; on the CPU it
    runs ``match_epilogue_plain``."""
    if not best.is_cuda:
        return match_epilogue_plain(best, best_idx, accept, n_kp, by_distance, angle1, angle2)
    M = best.shape[0]
    if best_idx.shape != (M,) or accept.shape != (M,) or \
            (angle1 is not None and (angle1.shape != (M,) or angle2.dim() != 1)):
        raise ValueError(f"match_epilogue: expected ({M},) rows")
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [i32(best), i32(best_idx), accept.to(torch.bool).contiguous()]
    rot = [None, None]
    if angle1 is not None:
        rot = [angle1.to(torch.float32).contiguous(), angle2.to(torch.float32).contiguous()]
        kernels.require_cuda("match_epilogue", *args, *rot)
    else:
        kernels.require_cuda("match_epilogue", *args)
    out = torch.empty(M, dtype=torch.int32, device=best.device)
    err = kernels.lib().match_epilogue_launch(
        *(a.data_ptr() for a in args), M, n_kp, int(by_distance),
        *(None if a is None else a.data_ptr() for a in rot), out.data_ptr(), kernels.stream())
    kernels.check(err, "match_epilogue")
    kernels.LAUNCHES["match_epilogue"] += 1
    return out


def search_for_initialization(desc1, xy1, angle1, octave1, valid1,
                              desc2, xy2, angle2, octave2, valid2,
                              window: int = 100, prev_matched=None,
                              nn_ratio: float = 0.9):
    """ORBmatcher::SearchForInitialization: level-0 keypoints of frame 1
    search a +-window box in frame 2's level-0 keypoints; TH_LOW and NN
    ratio, min-distance conflict resolution (earlier i1 on ties), rotation
    filter.  Returns matches12 (N1,) int32 (index into frame 2 or -1)."""
    if prev_matched is None:
        prev_matched = xy1
    n1, n2 = desc1.shape[0], desc2.shape[0]
    dev = desc1.device
    ok1 = valid1 & (octave1 == 0)
    zeros1 = torch.zeros(n1, dtype=torch.int32, device=dev)
    gate = Gate(prev_matched[:, 0], prev_matched[:, 1],
                torch.full((n1,), float(window), device=dev), zeros1, zeros1,
                xy2[:, 0], xy2[:, 1], octave2)
    r = hamming_best2(desc1, ok1, desc2, valid2, gate)
    accept = (r.best <= TH_LOW) & (r.best.float() < nn_ratio * r.second.float()) & ok1
    return match_epilogue(r.best, r.best_idx, accept, n2, True, angle1, angle2)


def mutual_best_match(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW):
    """Mutual nearest neighbours with distance <= max_dist (the ref-KF
    fallback of the fused step).  Returns (matches12 (N1,), dmin (N1,))."""
    r12 = hamming_best2(desc1, valid1, desc2, valid2)
    r21 = hamming_best2(desc2, valid2, desc1, valid1)
    i1 = torch.arange(desc1.shape[0], dtype=torch.int32, device=desc1.device)
    mutual = r21.best_idx[r12.best_idx.long()] == i1
    ok = mutual & (r12.best <= max_dist) & valid1
    return torch.where(ok, r12.best_idx, -1), r12.best


@functools.lru_cache(maxsize=None)
def _scales_on(scale_factors: tuple, device: torch.device) -> torch.Tensor:
    """The scale factors as a float32 tensor on ``device``, made once: a
    search enqueues no host-to-device copy (the tracking step is captured
    in a CUDA graph on the card)."""
    return torch.as_tensor(scale_factors, dtype=torch.float32, device=device)


def _project(cam: Camera, R, t, pos):
    """Camera-frame points and their pixels through the camera (pinhole or
    KB8), as the JAX searches' ``jax.vmap(project)``."""
    pc = pos @ R.T + t[None]
    return pc, cam.project(pc)


def _in_image(uv, img_wh):
    return (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])


def _predict_scale(dist3, max_dist, scales):
    """MapPoint::PredictScale (reference inc/MapPoint.h:172-173):
    ceil(log(max_dist / dist) / log(scale[1])), clipped to the levels."""
    ratio = max_dist / dist3.clamp(min=1e-9)
    pred = torch.ceil(torch.log(ratio) / torch.log(scales[1])).to(torch.int32)
    return pred.clamp(0, scales.shape[0] - 1)


def search_by_projection_last_frame(
    mp_pos, mp_desc, mp_valid, mp_octave, mp_angle, R, t,
    kp_xy, kp_desc, kp_octave, kp_angle, kp_valid_and_free,
    cam: Camera, scale_factors: Sequence[float], img_wh, th: float = 15.0,
):
    """SearchByProjection, motion-model variant: project the last frame's
    map points with the predicted pose, search a th*scale[lastOctave]
    window in levels [lastOct-1, lastOct+1], keep best <= TH_HIGH,
    first-come conflict resolution, rotation filter.
    Returns (M,) int32 keypoint index per map point or -1."""
    N = kp_xy.shape[0]
    scales = _scales_on(tuple(float(s) for s in scale_factors), mp_pos.device)
    pc, uv = _project(cam, R, t, mp_pos)
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh)
    radius = th * scales[mp_octave.clamp(0, len(scale_factors) - 1).long()]
    gate = Gate(uv[:, 0], uv[:, 1], radius, mp_octave - 1, mp_octave + 1,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid_and_free, gate)
    accept = (r.best <= TH_HIGH) & row_ok
    return match_epilogue(r.best, r.best_idx, accept, N, False, mp_angle, kp_angle)


def search_by_projection_local_map(
    mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist, R, t,
    kp_xy, kp_desc, kp_octave, kp_valid_and_free,
    cam: Camera, scale_factors: Sequence[float], img_wh,
    th: float = 1.0, nn_ratio: float = 0.8,
):
    """SearchByProjection, local-map variant: frustum (view cos >= 0.5)
    and scale-invariance checks, PredictScale level, radius 2.5 or 4.0 x
    scale x th over levels [pred-1, pred], NN ratio only when best and
    second lie on one level, TH_HIGH gate, first-come conflicts.
    Returns (M,) int32 keypoint index per map point or -1."""
    N = kp_xy.shape[0]
    n_levels = len(scale_factors)
    scales = _scales_on(tuple(float(s) for s in scale_factors), mp_pos.device)
    pc, uv = _project(cam, R, t, mp_pos)

    Ow = -(R.T @ t)  # camera centre in world
    view = mp_pos - Ow[None]
    dist3 = torch.sqrt(torch.sum(view * view, -1))
    view_cos = torch.sum(view * mp_normal, -1) / dist3.clamp(min=1e-9)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= 0.8 * min_dist) & (dist3 <= 1.2 * mp_max_dist)
    pred = _predict_scale(dist3, mp_max_dist, scales)
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * scales[pred.long()] * th
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh) & (view_cos >= 0.5) & dist_ok

    gate = Gate(uv[:, 0], uv[:, 1], radius, pred - 1, pred,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid_and_free, gate)
    ratio_fail = (
        (kp_octave[r.best_idx.long()] == kp_octave[r.second_idx.long()])
        & (r.best.float() > nn_ratio * r.second.float())
        & (r.second < INF)
    )
    accept = (r.best <= TH_HIGH) & row_ok & ~ratio_fail
    return match_epilogue(r.best, r.best_idx, accept, N, False)


# ------------------------------------------------- triangulation search (K7)


class TriGeometry(NamedTuple):
    """The two-view geometry of a triangulation job: keyframe 1 and B
    neighbours.  P (3,4) = K [R | t], R world->camera, O camera centres,
    scale_factors (L,) f32 and factor = 1.5 * scale_factors[1]."""
    P1: torch.Tensor
    P2: torch.Tensor     # (B,3,4)
    R1: torch.Tensor
    t1: torch.Tensor
    R2: torch.Tensor     # (B,3,3)
    t2: torch.Tensor     # (B,3)
    O1: torch.Tensor
    O2: torch.Tensor     # (B,3)
    K: tuple             # (fx, fy, cx, cy) floats
    scale_factors: torch.Tensor
    factor: float


def _tri_search_one(desc1, xy1, oct1, free1, desc2, xy2, oct2, free2, F12, sigma2):
    """search_for_triangulation for one pair, dense (the plain version)."""
    N1, N2 = xy1.shape[0], xy2.shape[0]
    dev = xy1.device
    dist = hamming_matrix(desc1, desc2)
    # epipolar lines in image 2, l = F12^T [x1 y1 1], summed in a fixed order
    la = xy1[:, 0] * F12[0, 0] + xy1[:, 1] * F12[1, 0] + F12[2, 0]
    lb = xy1[:, 0] * F12[0, 1] + xy1[:, 1] * F12[1, 1] + F12[2, 1]
    lc = xy1[:, 0] * F12[0, 2] + xy1[:, 1] * F12[1, 2] + F12[2, 2]
    num = la[:, None] * xy2[None, :, 0] + lb[:, None] * xy2[None, :, 1] + lc[:, None]
    den = torch.clamp(la * la + lb * lb, min=1e-12)
    d2 = num * num / den[:, None]
    sig2 = sigma2[oct2.clamp(0, sigma2.shape[0] - 1).long()]
    mask = (d2 < 3.84 * sig2[None, :]) & free1[:, None] & free2[None, :]
    d = torch.where(mask, dist, INF)
    cols = torch.arange(N2, device=dev)
    key = (d.long() * N2 + cols).amin(1)
    best, best_idx = key // N2, key % N2
    accept = best <= TH_LOW
    # one kp2 per kp1: min distance, then the earlier kp1
    claim = best * N1 + torch.arange(N1, device=dev)
    big = torch.iinfo(torch.int64).max
    winner = torch.full((N2 + 1,), big, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(accept, best_idx, N2), torch.where(accept, claim, big),
                           "amin")
    final = accept & (winner[best_idx] == claim)
    return torch.where(final, best_idx, -1).to(torch.int32)


def _tri_gates(m12, xy1, oct1, xy2, oct2, g: TriGeometry, b: int, sigma2):
    """Triangulation and the acceptance gates of CreateNewMapPoints
    (local_mapping.py:226-245 of the JAX package) for neighbour b."""
    from ..geometry.two_view import _norm3, triangulate

    N2, L = xy2.shape[0], sigma2.shape[0]
    j = m12.clamp(0, N2 - 1).long()
    x2, o2 = xy2[j], oct2[j]
    X = triangulate(g.P1, g.P2[b], xy1, x2)
    r1, r2 = X - g.O1, X - g.O2[b]
    n1, n2 = _norm3(r1), _norm3(r2)
    cos_par = (r1[:, 0] * r2[:, 0] + r1[:, 1] * r2[:, 1] + r1[:, 2] * r2[:, 2]) \
        / torch.clamp(n1 * n2, min=1e-12)

    def cam_point(R, t):
        return torch.stack([X[:, 0] * R[i, 0] + X[:, 1] * R[i, 1] + X[:, 2] * R[i, 2] + t[i]
                            for i in range(3)], -1)

    pc1, pc2 = cam_point(g.R1, g.t1), cam_point(g.R2[b], g.t2[b])
    ok = (m12 >= 0) & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (cos_par < 0.9998)
    fx, fy, cx, cy = g.K
    for pc, x, octv in ((pc1, xy1, oct1), (pc2, x2, o2)):
        z = torch.clamp(pc[:, 2], min=1e-9)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        s2 = sigma2[octv.clamp(0, L - 1).long()]
        ok = ok & ((u - x[:, 0]) ** 2 + (v - x[:, 1]) ** 2 <= 5.991 * s2)
    ratio_dist = n2 / torch.clamp(n1, min=1e-12)
    sf = g.scale_factors
    ratio_oct = sf[oct1.clamp(0, L - 1).long()] / sf[o2.clamp(0, L - 1).long()]
    ok = ok & (ratio_dist < ratio_oct * g.factor) & (ratio_dist * g.factor > ratio_oct)
    return X, ok


def tri_search_plain(desc1, xy1, oct1, free1, desc2B, xy2B, oct2B, free2B, F12B, sigma2,
                     geom: Optional[TriGeometry] = None):
    """Plain version of ``tri_search`` (same arguments)."""
    out_m, out_X, out_ok = [], [], []
    for b in range(desc2B.shape[0]):
        m = _tri_search_one(desc1, xy1, oct1, free1, desc2B[b], xy2B[b], oct2B[b], free2B[b],
                            F12B[b], sigma2)
        out_m.append(m)
        if geom is not None:
            X, ok = _tri_gates(m, xy1, oct1, xy2B[b], oct2B[b], geom, b, sigma2)
            out_X.append(X)
            out_ok.append(ok)
    m12 = torch.stack(out_m)
    if geom is None:
        return m12, None, None
    return m12, torch.stack(out_X), torch.stack(out_ok)


def tri_search(desc1, xy1, oct1, free1, desc2B, xy2B, oct2B, free2B, F12B, sigma2,
               geom: Optional[TriGeometry] = None):
    """SearchForTriangulation of keyframe 1 against B neighbours, and with
    ``geom`` the triangulation of the matches and its acceptance gates.

    Replaces ``extractorb_tpu/frontend/matcher.py:search_for_triangulation``
    and, with ``geom``, ``slam/local_mapping.py:_triangulation_program``.
    desc1 (N1,32) u8, xy1 (N1,2), oct1 (N1,) i32, free1 (N1,) bool;
    desc2B (B,N2,32), xy2B (B,N2,2), oct2B (B,N2), free2B (B,N2); F12B
    (B,3,3); sigma2 (L,) per-level sigma^2.  Returns m12 (B,N1) int32
    (index into the neighbour or -1) and, with ``geom``, X (B,N1,3) and
    ok (B,N1) bool (else None, None).  On CUDA tensors this launches K7;
    on the CPU it runs ``tri_search_plain``."""
    if not desc1.is_cuda:
        return tri_search_plain(desc1, xy1, oct1, free1, desc2B, xy2B, oct2B, free2B, F12B,
                                sigma2, geom)
    N1, (B, N2) = desc1.shape[0], desc2B.shape[:2]
    dev = desc1.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    b8 = lambda a: a.to(torch.bool).contiguous()
    args = [desc1.contiguous(), f32(xy1), i32(oct1), b8(free1), desc2B.contiguous(), f32(xy2B),
            i32(oct2B), b8(free2B), f32(F12B), f32(sigma2)]
    for k in (0, 4):   # the kernel reads descriptors as 4-byte words
        if args[k].data_ptr() % 4:
            args[k] = args[k].clone()
    gf = gb = None
    fx = fy = cx = cy = factor = 0.0
    if geom is not None:
        gf = torch.cat([f32(geom.P1).reshape(-1), f32(geom.R1).reshape(-1), f32(geom.t1),
                        f32(geom.O1), f32(geom.scale_factors)])
        gb = torch.cat([f32(geom.P2).reshape(-1), f32(geom.R2).reshape(-1),
                        f32(geom.t2).reshape(-1), f32(geom.O2).reshape(-1)])
        fx, fy, cx, cy = (float(v) for v in geom.K)
        factor = float(geom.factor)
        kernels.require_cuda("tri_search", *args, gf, gb)
    else:
        kernels.require_cuda("tri_search", *args)
    ws = torch.empty(2 * B * N1 + B * N2, dtype=torch.int32, device=dev)
    m12 = torch.empty(B, N1, dtype=torch.int32, device=dev)
    X = torch.empty(B, N1, 3, dtype=torch.float32, device=dev)
    ok = torch.empty(B, N1, dtype=torch.bool, device=dev)
    p = [a.data_ptr() for a in args]
    err = kernels.lib().tri_search_launch(
        *p[:4], N1, *p[4:8], N2, B, p[8], p[9], sigma2.shape[0],
        None if gf is None else gf.data_ptr(), None if gb is None else gb.data_ptr(),
        fx, fy, cx, cy, factor, ws.data_ptr(), m12.data_ptr(), X.data_ptr(), ok.data_ptr(),
        kernels.stream())
    kernels.check(err, "tri_search")
    kernels.LAUNCHES["tri_search"] += 1
    if geom is None:
        return m12, None, None
    return m12, X, ok


def search_for_triangulation(desc1, xy1, octave1, free1, desc2, xy2, octave2, free2, F12,
                             sigma2_levels):
    """ORBmatcher::SearchForTriangulation (reference ORBmatcher.cc:965) for
    one keyframe pair: unassociated keypoints matched under the epipolar
    constraint dist(kp2, F12^T kp1)^2 < 3.84 sigma2[octave2], best
    distance <= TH_LOW, min-distance conflict resolution per kp2.
    Returns (N1,) int32 index into keyframe 2 or -1 (K7 on the card)."""
    m12, _, _ = tri_search(desc1, xy1, octave1, free1, desc2[None], xy2[None], octave2[None],
                           free2[None], F12[None], sigma2_levels)
    return m12[0]


# ------------------------------------------------- loop-closing searches


def search_by_bow(desc1, word1, angle1, valid1, desc2, word2, angle2, valid2,
                  nn_ratio: float = 0.7, check_rotation: bool = True):
    """ORBmatcher::SearchByBoW (reference ORBmatcher.cc:269, :823): only
    keypoints with the same vocabulary word are candidates (K3's word
    gate), then best <= TH_LOW and the NN ratio, one keypoint of set 2 per
    keypoint of set 1 (the smaller distance, then the earlier row), the
    rotation-histogram filter.  word1/word2 (N,) int32, -1 = none.
    Returns (N1,) int32 index into set 2 or -1."""
    r = hamming_best2(desc1, valid1, desc2, valid2, words=(word1, word2))
    accept = (r.best <= TH_LOW) & (r.best.float() < nn_ratio * r.second.float())
    rot = (angle1, angle2) if check_rotation else (None, None)
    return match_epilogue(r.best, r.best_idx, accept, desc2.shape[0], True, *rot)


def search_by_projection_sim3(mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist, s, R, t,
                              kp_xy, kp_desc, kp_octave, kp_valid_and_free,
                              cam: Camera, scale_factors: Sequence[float], img_wh,
                              th: float = 7.5):
    """SearchByProjection through a Sim3 Scw (reference ORBmatcher.cc:473):
    project s R p + t, distance inside the scale-invariance range, view
    cos >= 0.5, radius th * scale[pred] over levels [pred-1, pred+1] (K3's
    box and level gate), best <= TH_LOW, first-come claims, no rotation
    check.  Returns (M,) int32 keypoint index per map point or -1."""
    scales = _scales_on(tuple(float(f) for f in scale_factors), mp_pos.device)
    n_levels = len(scale_factors)
    pc = s * (mp_pos @ R.T) + t[None]
    uv = cam.project(pc)
    Ow = -(R.T @ t) / torch.clamp(torch.as_tensor(s, dtype=torch.float32), min=1e-12)
    view = mp_pos - Ow[None]
    dist3 = torch.linalg.vector_norm(view, dim=-1)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= min_dist) & (dist3 <= mp_max_dist)
    view_cos = torch.sum(view * mp_normal, -1) / torch.clamp(dist3, min=1e-9)
    pred = _predict_scale(dist3, mp_max_dist, scales)
    radius = th * scales[pred.long()]
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh) & dist_ok & (view_cos >= 0.5)
    gate = Gate(uv[:, 0], uv[:, 1], radius, pred - 1, pred + 1,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid_and_free, gate)
    accept = (r.best <= TH_LOW) & row_ok
    return match_epilogue(r.best, r.best_idx, accept, kp_xy.shape[0], False)


def fuse_by_projection(mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist, R, t,
                       kp_xy, kp_desc, kp_octave, kp_valid,
                       cam: Camera, scale_factors: Sequence[float], img_wh, th: float = 3.0):
    """ORBmatcher::Fuse (reference ORBmatcher.cc:1399): project map points
    into a keyframe; depth inside the scale-invariance range, view cos >=
    0.5, radius th * scale[pred] over levels [pred-1, pred+1] (K3's box and
    level gate), best <= TH_LOW.  No claims: several map points may take
    one keypoint (the caller decides replace or add).  Returns (M,) int32
    keypoint index per map point or -1."""
    scales = _scales_on(tuple(float(f) for f in scale_factors), mp_pos.device)
    pc, uv = _project(cam, R, t, mp_pos)
    Ow = -(R.T @ t)
    view = mp_pos - Ow[None]
    dist3 = torch.linalg.vector_norm(view, dim=-1)
    min_dist = mp_max_dist / scales[len(scale_factors) - 1]
    dist_ok = (dist3 >= min_dist) & (dist3 <= mp_max_dist)
    view_cos = torch.sum(view * mp_normal, -1) / torch.clamp(dist3, min=1e-9)
    pred = _predict_scale(dist3, mp_max_dist, scales)
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh) & dist_ok & (view_cos >= 0.5)
    gate = Gate(uv[:, 0], uv[:, 1], th * scales[pred.long()], pred - 1, pred + 1,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid, gate)
    return torch.where((r.best <= TH_LOW) & row_ok, r.best_idx, -1)


def search_by_projection_reloc(mp_pos, mp_desc, mp_valid, mp_octave, mp_angle, mp_max_dist,
                               R, t, kp_xy, kp_desc, kp_octave, kp_angle, kp_valid_and_free,
                               cam: Camera, scale_factors: Sequence[float], img_wh,
                               th: float = 10.0, orb_dist: int = 100):
    """SearchByProjection, relocalization variant (reference
    ORBmatcher.cc:2179): project the candidate keyframe's map points with
    the PnP pose, radius th * scale[pred] over levels [pred-1, pred+1]
    (K3), best <= orb_dist, first-come claims and the rotation filter over
    the accepted rows (K18).  ``mp_octave`` is unused, as in JAX.  Returns
    (M,) int32 keypoint index per map point or -1."""
    scales = _scales_on(tuple(float(f) for f in scale_factors), mp_pos.device)
    pc, uv = _project(cam, R, t, mp_pos)
    Ow = -(R.T @ t)
    dist3 = torch.linalg.vector_norm(mp_pos - Ow[None], dim=-1)
    pred = _predict_scale(dist3, mp_max_dist, scales)
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh)
    gate = Gate(uv[:, 0], uv[:, 1], th * scales[pred.long()], pred - 1, pred + 1,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid_and_free, gate)
    accept = (r.best <= orb_dist) & row_ok
    return match_epilogue(r.best, r.best_idx, accept, kp_xy.shape[0], False, mp_angle, kp_angle)


def search_by_sim3(pos1, desc1, valid1, pos2, desc2, valid2, s12, R12, t12, already,
                   cam: Camera, scale_factors: Sequence[float],
                   kp_xy1=None, kp_xy2=None, kp_octave1=None, kp_octave2=None,
                   max_dist1=None, max_dist2=None, img_wh=(640.0, 480.0), th: float = 7.5):
    """ORBmatcher::SearchBySim3 (reference ORBmatcher.cc:1735): each side's
    map points (in their own camera frames) projected into the other image
    through S12 / S21, distance (of the transformed point) inside the
    scale-invariance range, radius th * scale[pred] over levels
    [pred-1, pred+1] (two K3 launches), best <= TH_HIGH, set 1's rows masked
    by ``valid1 & ~already``; then only mutually agreeing pairs.  Returns
    (N1,) int32 index into set 2 or -1."""
    dev = pos1.device
    scales = _scales_on(tuple(float(f) for f in scale_factors), dev)
    n_levels = len(scale_factors)
    s12 = torch.as_tensor(s12, dtype=torch.float32, device=dev)
    s21 = 1.0 / torch.clamp(s12, min=1e-12)
    R21 = R12.T
    t21 = -s21 * (R12.T @ t12)

    def gated_best(pos, desc, valid, max_dist, s, R, t, kp_xy, kp_oct, desc_dst, valid_dst):
        pc = s * (pos @ R.T) + t[None]
        uv = cam.project(pc)
        dist3 = torch.linalg.vector_norm(pc, dim=-1)
        dist_ok = (dist3 >= max_dist / scales[n_levels - 1]) & (dist3 <= max_dist)
        pred = _predict_scale(dist3, max_dist, scales)
        row_ok = valid & (pc[:, 2] > 0) & _in_image(uv, img_wh) & dist_ok
        gate = Gate(uv[:, 0], uv[:, 1], th * scales[pred.long()], pred - 1, pred + 1,
                    kp_xy[:, 0], kp_xy[:, 1], kp_oct)
        r = hamming_best2(desc, row_ok, desc_dst, valid_dst, gate)
        return torch.where((r.best <= TH_HIGH) & row_ok, r.best_idx, -1)

    m12 = gated_best(pos1, desc1, valid1 & ~already, max_dist1, s21, R21, t21, kp_xy2,
                     kp_octave2, desc2, valid2)
    m21 = gated_best(pos2, desc2, valid2, max_dist2, s12, R12, t12, kp_xy1, kp_octave1,
                     desc1, valid1)
    i1 = torch.arange(pos1.shape[0], dtype=torch.int32, device=dev)
    mutual = (m12 >= 0) & (m21[m12.clamp(0, pos2.shape[0] - 1).long()] == i1)
    return torch.where(mutual, m12, -1)
