"""Stereo matching of a rectified pair: per-keypoint right-image u and
depth (port of ``extractorb_tpu/frontend/stereo.py:compute_stereo_matches``).

Replaces Frame::ComputeStereoMatches (reference src/Frame.cc:813-991):
a row-banded Hamming search (band 2*scale[octave_r] + 1, octaves +-1,
disparity in [0, bf/b]), an 11x11 centre-subtracted SAD slid over +-5 px
on the left keypoint's pyramid level, a parabola through the best shift
and its neighbours, and the cut at 1.5*1.4 x the median SAD.

Both images' bordered pyramids are the ones the extractor built
(``ORBExtractor.extract_with_pyramid``): ``Pyramid.flat`` with the
per-level offsets and shapes of its ``PyramidPlan``; ``match_pair``
extracts a pair and matches it.

On CUDA tensors ``compute_stereo_matches`` launches kernel K9
(``csrc/stereo_match.cu``); on the CPU it runs
``compute_stereo_matches_plain``, which follows the JAX function operation
by operation.  The fisheye rig's matcher (``compute_stereo_fisheye_matches``,
``lapping_mask``) is not ported (ROADMAP A.12).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .extractor import Features
from .matcher import TH_HIGH, TH_LOW, hamming_matrix
from .pyramid import EDGE_THRESHOLD, Pyramid, PyramidPlan

TH_ORB = (TH_HIGH + TH_LOW) // 2  # 75
_W = 5            # half window: 11x11 SAD patches
_L = 5            # shifts -L..L
_CUT = np.float32(1.5 * 1.4)  # the median cut factor, rounded once to float32


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # (NL,) refined right-image u or -1
    depth: torch.Tensor     # (NL,) metric depth or -1
    valid: torch.Tensor     # (NL,) bool


def _level_table(plan: PyramidPlan) -> np.ndarray:
    """(L, 3) int32: (offset, h, w) of each bordered level in the flat buffer."""
    return np.ascontiguousarray([[o, h, w] for o, (h, w) in zip(plan.offsets, plan.shapes)],
                                np.int32)


def candidate_mask(xy_l, octave_l, valid_l, xy_r, octave_r, valid_r, scales, max_d):
    """(NL, NR) bool: the pairs inside the search's gates (row band of the
    right keypoint's octave, octaves +-1, disparity in [0, max_d], both
    valid)."""
    rowband = 2.0 * scales[octave_r.clamp(0, scales.shape[0] - 1).long()]
    dy = (xy_l[:, 1:2] - xy_r[None, :, 1]).abs()
    band_ok = dy <= rowband[None, :] + 1.0
    lvl_ok = (octave_r[None, :] >= (octave_l - 1)[:, None]) & \
             (octave_r[None, :] <= (octave_l + 1)[:, None])
    du = xy_l[:, 0:1] - xy_r[None, :, 0]
    disp_ok = (du >= 0.0) & (du <= max_d)
    return band_ok & lvl_ok & disp_ok & valid_l[:, None] & valid_r[None, :]


def compute_stereo_matches_plain(xy_l, octave_l, desc_l, valid_l, xy_r, octave_r, desc_r,
                                 valid_r, pyr_l: Pyramid, pyr_r: Pyramid, plan: PyramidPlan,
                                 scale_factors: Sequence[float], bf: float,
                                 baseline: float) -> StereoMatches:
    """Plain version of ``compute_stereo_matches`` (same arguments)."""
    dev = xy_l.device
    NL, n_lvl = xy_l.shape[0], len(scale_factors)
    tab = torch.as_tensor(_level_table(plan), dtype=torch.int64, device=dev)
    scales = torch.as_tensor(np.asarray(scale_factors, np.float32), device=dev)
    inv_scales = 1.0 / scales   # the float32 reciprocals, as the JAX function
    max_d = torch.tensor(np.float32(bf / baseline), device=dev)

    # banded Hamming search (reference :829-895)
    mask = candidate_mask(xy_l, octave_l, valid_l, xy_r, octave_r, valid_r, scales, max_d)
    d = torch.where(mask, hamming_matrix(desc_l, desc_r), 1 << 20)
    best, best_idx = d.min(1).values, d.argmin(1)
    cand_ok = best < TH_ORB

    # SAD refinement on the left keypoint's level (reference :896-960),
    # start indices clamped as dynamic_slice clamps them
    lvl = octave_l.clamp(0, n_lvl - 1).long()
    inv = inv_scales[lvl]
    uL = torch.round(xy_l[:, 0] * inv).long()
    vL = torch.round(xy_l[:, 1] * inv).long()
    uR0 = torch.round(xy_r[best_idx, 0] * inv).long()
    off, hs, ws = tab[lvl, 0], tab[lvl, 1], tab[lvl, 2]
    b = EDGE_THRESHOLD
    v0 = torch.minimum((vL - _W + b).clamp(min=0), hs - 11)
    u0_l = torch.minimum((uL - _W + b).clamp(min=0), ws - 11)
    u0_r = torch.minimum((uR0 - _L - _W + b).clamp(min=0), ws - (11 + 2 * _L))
    ar = lambda n: torch.arange(n, device=dev)
    rows = off[:, None, None] + (v0[:, None, None] + ar(11)[None, :, None]) * ws[:, None, None]
    il = pyr_l.flat[rows + u0_l[:, None, None] + ar(11)[None, None, :]].to(torch.int32)
    ir = pyr_r.flat[rows + u0_r[:, None, None] + ar(11 + 2 * _L)[None, None, :]].to(torch.int32)
    il = il - il[:, _W:_W + 1, _W:_W + 1]
    sads = []
    for inc in range(2 * _L + 1):
        win = ir[:, :, inc:inc + 11]
        win = win - win[:, _W:_W + 1, _W:_W + 1]
        sads.append((il - win).abs().sum((1, 2)))
    sads = torch.stack(sads, -1).to(torch.float32)
    best_inc = sads.argmin(-1)
    interior = (best_inc > 0) & (best_inc < 2 * _L)
    bi = best_inc.clamp(1, 2 * _L - 1)
    take = lambda i: sads.gather(1, i[:, None])[:, 0]
    d1, d2, d3 = take(bi - 1), take(bi), take(bi + 1)
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(denom.abs() > 1e-9, (d1 - d3) / denom, 2.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)
    shift = uR0.to(torch.float32) + (bi - _L).to(torch.float32) + delta
    u_r = scales[lvl] * shift
    ref_ok = interior & delta_ok
    # XLA contracts x_l - scale * shift into one fused multiply-add: the
    # product is exact in float64, so one rounding of the float64
    # difference reproduces it (K9 calls fmaf)
    disparity = (xy_l[:, 0].double() - scales[lvl].double() * shift.double()).float()
    disp_in = (disparity >= 0.0) & (disparity < max_d)
    # clamp tiny disparities like the reference; disp_in was taken before
    u_r = torch.where(disparity <= 0, xy_l[:, 0] - 0.01, u_r)
    disparity = torch.where(disparity <= 0, 0.01, disparity)
    ok = cand_ok & ref_ok & disp_in & valid_l

    # median-SAD outlier cut
    n_ok = int(ok.sum())
    srt = torch.sort(torch.where(ok, d2, float("inf"))).values
    median = srt[min(n_ok // 2, NL - 1)]
    ok = ok & (d2 < torch.tensor(_CUT, device=dev) * median)
    depth = torch.tensor(np.float32(bf), device=dev) / disparity
    return StereoMatches(u_right=torch.where(ok, u_r, -1.0), depth=torch.where(ok, depth, -1.0),
                         valid=ok)


def compute_stereo_matches(xy_l, octave_l, desc_l, valid_l, xy_r, octave_r, desc_r, valid_r,
                           pyr_l: Pyramid, pyr_r: Pyramid, plan: PyramidPlan,
                           scale_factors: Sequence[float], bf: float,
                           baseline: float) -> StereoMatches:
    """Rectified stereo matches of the left keypoints.

    xy (N,2) float32 raw level-0 coordinates, octave (N,) int32, desc
    (N,32) uint8, valid (N,) bool for the left (NL) and right (NR)
    keypoints; pyr_l/pyr_r the bordered pyramids of the two images, laid
    out by ``plan``; bf = fx * baseline, baseline in metres.  On CUDA
    tensors this launches K9; on the CPU it runs the plain version."""
    if not xy_l.is_cuda:
        return compute_stereo_matches_plain(xy_l, octave_l, desc_l, valid_l, xy_r, octave_r,
                                            desc_r, valid_r, pyr_l, pyr_r, plan,
                                            scale_factors, bf, baseline)
    NL, NR, n_lvl = xy_l.shape[0], xy_r.shape[0], len(scale_factors)
    f32 = lambda t: t.to(torch.float32).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [f32(xy_l), i32(octave_l), desc_l.contiguous(), valid_l.contiguous(),
            f32(xy_r), i32(octave_r), desc_r.contiguous(), valid_r.contiguous(),
            pyr_l.flat.contiguous(), pyr_r.flat.contiguous()]
    kernels.require_cuda("stereo_match", *args)
    if desc_l.shape != (NL, 32) or desc_r.shape != (NR, 32) or desc_l.dtype != torch.uint8 \
            or desc_r.dtype != torch.uint8 or pyr_l.flat.dtype != torch.uint8:
        raise TypeError("stereo_match: descriptors are (N,32) uint8, pyramids uint8")
    if valid_l.dtype != torch.bool or valid_r.dtype != torch.bool:
        raise TypeError("stereo_match: validity masks are bool")
    if NR >= 1 << 16 or n_lvl != len(plan.offsets):
        raise ValueError("stereo_match: at most 65535 right keypoints, one scale per level")
    if any(a.shape != (n, 2) for a, n in ((args[0], NL), (args[4], NR))) or any(
            a.shape != (n,) for a, n in ((args[1], NL), (args[3], NL), (args[5], NR),
                                         (args[7], NR))):
        raise ValueError("stereo_match: xy (N,2), octave and valid (N,) per side")
    if args[8].numel() != plan.total or args[9].numel() != plan.total:
        raise ValueError(f"stereo_match: pyramids of {plan.total} bytes expected (the plan's)")
    for k, align in ((0, 8), (2, 16), (4, 8), (6, 16)):
        if args[k].data_ptr() % align:
            # the kernel reads xy as float2 and descriptors as 16-byte words
            args[k] = args[k].clone()
    tab = _level_table(plan)
    sc = np.asarray(scale_factors, np.float32)
    sc = np.ascontiguousarray(np.concatenate([sc, np.float32(1.0) / sc]))
    dev = xy_l.device
    u_right = torch.empty(NL, dtype=torch.float32, device=dev)
    depth = torch.empty(NL, dtype=torch.float32, device=dev)
    valid = torch.empty(NL, dtype=torch.bool, device=dev)
    sad = torch.empty(NL, dtype=torch.float32, device=dev)
    err = kernels.lib().stereo_match_launch(
        *[a.data_ptr() for a in args], NL, NR, tab.ctypes.data, sc.ctypes.data, n_lvl,
        float(np.float32(bf)), float(np.float32(bf / baseline)), TH_ORB,
        u_right.data_ptr(), depth.data_ptr(), valid.data_ptr(), sad.data_ptr(),
        kernels.stream())
    kernels.check(err, "stereo_match")
    kernels.LAUNCHES["stereo_match"] += 1
    return StereoMatches(u_right, depth, valid)


def match_pair(extractor, img_l: torch.Tensor, img_r: torch.Tensor, bf: float,
               baseline: float) -> Tuple[Features, StereoMatches]:
    """The stereo frame of a rectified pair (reference Frame.cc:88): both
    images extracted by ``extractor`` (an ``ORBExtractor``), then the left
    keypoints matched on the pyramids that extraction built.  Returns the
    left features and their matches."""
    feats, pyr_l = extractor.extract_with_pyramid(img_l)
    feats_r, pyr_r = extractor.extract_with_pyramid(img_r)
    res = compute_stereo_matches(feats.xy, feats.octave, feats.desc, feats.valid, feats_r.xy,
                                 feats_r.octave, feats_r.desc, feats_r.valid, pyr_l, pyr_r,
                                 extractor.pyr_plan, tuple(float(s) for s in extractor.scales),
                                 bf, baseline)
    return feats, res
