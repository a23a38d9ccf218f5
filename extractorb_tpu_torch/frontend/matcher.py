"""Descriptor matching (port of ``extractorb_tpu/frontend/matcher.py``, the
tracking subset).

All four searches reduce to one primitive, kernel K3 ``hamming_best2``:
for every query row, the best and second-best 256-bit Hamming distance
over the candidate columns that pass a per-row gate (a strict box
|u - x| < r, |v - y| < r, a level range [lo, hi], row and column
validity).  The JAX package builds the dense (N1, N2) distance matrix as
bf16 bit-plane matmuls on the MXU; the kernel XORs and popcounts and never
stores the matrix.  The accept logic around it (TH/ratio tests, conflict
resolution, the rotation histogram) is plain torch.

Semantics kept from the JAX functions: a masked pair counts as 1<<20;
ties go to the lower index (``jnp.argmin``); "second" is the minimum with
only the best column removed; a row without a candidate (or without a
second) reports distance 1<<20 and index 0.

Constants TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 (ORBmatcher.cc:36-38),
including the reference's 1/HISTO_LENGTH histogram factor quirk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import kernels
from ..core.camera import Pinhole

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


def hamming_best2_plain(q_desc, row_ok, c_desc, col_ok, gate: Gate) -> Best2:
    M, N = q_desc.shape[0], c_desc.shape[0]
    d = torch.where(_gate_mask(gate, row_ok, col_ok), hamming_matrix(q_desc, c_desc), INF)
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


# ------------------------------------------------------------- kernel K3


def hamming_best2(q_desc: torch.Tensor, row_ok: torch.Tensor, c_desc: torch.Tensor,
                  col_ok: torch.Tensor, gate: Optional[Gate] = None) -> Best2:
    """Gated best/second-best Hamming match of every query row.

    Replaces the ``hamming_matrix`` + masked min/argmin of the four JAX
    searches.  q_desc (M,32) u8 with row_ok (M,); c_desc (N,32) u8 with
    col_ok (N,).  On CUDA tensors this launches K3; on the CPU it runs
    the dense plain version."""
    M, N = q_desc.shape[0], c_desc.shape[0]
    if gate is None:
        gate = open_gate(M, N, q_desc.device)
    if not q_desc.is_cuda:
        return hamming_best2_plain(q_desc, row_ok, c_desc, col_ok, gate)
    f32 = lambda t: t.to(torch.float32).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [q_desc.contiguous(), f32(gate.u), f32(gate.v), f32(gate.r), i32(gate.lo),
            i32(gate.hi), row_ok.contiguous(), c_desc.contiguous(), f32(gate.x),
            f32(gate.y), i32(gate.octave), col_ok.contiguous()]
    kernels.require_cuda("hamming_best2", *args)
    if args[0].data_ptr() % 16 or args[7].data_ptr() % 16:
        # the kernel reads descriptors as 16-byte words: fresh allocations are aligned
        args[0], args[7] = args[0].clone(), args[7].clone()
    out = torch.empty(4, M, dtype=torch.int32, device=q_desc.device)
    p = [a.data_ptr() for a in args]
    err = kernels.lib().hamming_best2_launch(
        *p[:7], M, *p[7:], N, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(), kernels.stream(),
    )
    kernels.check(err, "hamming_best2")
    kernels.LAUNCHES["hamming_best2"] += 1
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
    best, best_idx = r.best, r.best_idx
    accept = (best <= TH_LOW) & (best.float() < nn_ratio * r.second.float()) & ok1

    i1 = torch.arange(n1, device=dev)
    claim_key = best.long() * n1 + i1  # dist-major, earlier-i1 tiebreak
    big = torch.iinfo(torch.int64).max
    winner = torch.full((n2 + 1,), big, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(accept, best_idx, n2).long(),
                           torch.where(accept, claim_key, big), "amin")
    final = accept & (winner[best_idx.long()] == claim_key)
    rot_ok = rotation_consistency_mask(angle1, angle2[best_idx.long()], accept)
    return torch.where(final & rot_ok, best_idx, -1)


def mutual_best_match(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW):
    """Mutual nearest neighbours with distance <= max_dist (the ref-KF
    fallback of the fused step).  Returns (matches12 (N1,), dmin (N1,))."""
    r12 = hamming_best2(desc1, valid1, desc2, valid2)
    r21 = hamming_best2(desc2, valid2, desc1, valid1)
    i1 = torch.arange(desc1.shape[0], dtype=torch.int32, device=desc1.device)
    mutual = r21.best_idx[r12.best_idx.long()] == i1
    ok = mutual & (r12.best <= max_dist) & valid1
    return torch.where(ok, r12.best_idx, -1), r12.best


def _project(cam: Pinhole, R, t, pos):
    pc = pos @ R.T + t[None]
    return pc, cam.project(pc)


def _in_image(uv, img_wh):
    return (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])


def search_by_projection_last_frame(
    mp_pos, mp_desc, mp_valid, mp_octave, mp_angle, R, t,
    kp_xy, kp_desc, kp_octave, kp_angle, kp_valid_and_free,
    cam: Pinhole, scale_factors: Sequence[float], img_wh, th: float = 15.0,
):
    """SearchByProjection, motion-model variant: project the last frame's
    map points with the predicted pose, search a th*scale[lastOctave]
    window in levels [lastOct-1, lastOct+1], keep best <= TH_HIGH,
    first-come conflict resolution, rotation filter.
    Returns (M,) int32 keypoint index per map point or -1."""
    N = kp_xy.shape[0]
    scales = torch.as_tensor(scale_factors, dtype=torch.float32, device=mp_pos.device)
    pc, uv = _project(cam, R, t, mp_pos)
    row_ok = mp_valid & (pc[:, 2] > 0) & _in_image(uv, img_wh)
    radius = th * scales[mp_octave.clamp(0, len(scale_factors) - 1).long()]
    gate = Gate(uv[:, 0], uv[:, 1], radius, mp_octave - 1, mp_octave + 1,
                kp_xy[:, 0], kp_xy[:, 1], kp_octave)
    r = hamming_best2(mp_desc, row_ok, kp_desc, kp_valid_and_free, gate)
    accept = (r.best <= TH_HIGH) & row_ok
    final = _first_claim(r.best_idx, accept, N)
    rot_ok = rotation_consistency_mask(mp_angle, kp_angle[r.best_idx.long()], accept)
    return torch.where(final & rot_ok, r.best_idx, -1)


def search_by_projection_local_map(
    mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist, R, t,
    kp_xy, kp_desc, kp_octave, kp_valid_and_free,
    cam: Pinhole, scale_factors: Sequence[float], img_wh,
    th: float = 1.0, nn_ratio: float = 0.8,
):
    """SearchByProjection, local-map variant: frustum (view cos >= 0.5)
    and scale-invariance checks, PredictScale level, radius 2.5 or 4.0 x
    scale x th over levels [pred-1, pred], NN ratio only when best and
    second lie on one level, TH_HIGH gate, first-come conflicts.
    Returns (M,) int32 keypoint index per map point or -1."""
    N = kp_xy.shape[0]
    n_levels = len(scale_factors)
    scales = torch.as_tensor(scale_factors, dtype=torch.float32, device=mp_pos.device)
    log_scale = torch.log(scales[1])
    pc, uv = _project(cam, R, t, mp_pos)

    Ow = -(R.T @ t)  # camera centre in world
    view = mp_pos - Ow[None]
    dist3 = torch.sqrt(torch.sum(view * view, -1))
    view_cos = torch.sum(view * mp_normal, -1) / dist3.clamp(min=1e-9)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= 0.8 * min_dist) & (dist3 <= 1.2 * mp_max_dist)
    ratio = mp_max_dist / dist3.clamp(min=1e-9)
    pred = torch.ceil(torch.log(ratio) / log_scale).to(torch.int32).clamp(0, n_levels - 1)
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
    final = _first_claim(r.best_idx, accept, N)
    return torch.where(final, r.best_idx, -1)
