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
by operation.

The fisheye rig (two KB8 cameras, not rectified): ``lapping_mask`` marks
the keypoints of the cameras' overlap, and ``compute_stereo_fisheye_matches``
takes the best and second-best Hamming match of each lapping left keypoint
among the lapping right ones (ratio 0.7) and triangulates the pairs that pass
(``core.camera.triangulate_matches``).  On CUDA tensors it launches kernel
K26 (``csrc/stereo_fisheye.cu``: the match, then the triangulation); on the
CPU it runs ``compute_stereo_fisheye_matches_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..core.camera import MIN_PARALLAX_COS, TRI_CHI2, KannalaBrandt8, triangulate_matches
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


# ------------------------------------------------------------ fisheye rig


class FisheyeStereoMatches(NamedTuple):
    right_idx: torch.Tensor  # (NL,) matched right keypoint or -1
    depth: torch.Tensor      # (NL,) depth (z) in the left camera or -1
    p3d: torch.Tensor        # (NL,3) triangulated point, left-camera coords
    valid: torch.Tensor      # (NL,) bool
    best_idx: torch.Tensor   # (NL,) int32 the best column before the gates
    candidate: torch.Tensor  # (NL,) bool the pairs that passed TH_ORB and the ratio test


def lapping_mask(xy, lap_begin: float, lap_end: float, valid):
    """The keypoints of the stereo overlap: valid with u in [lap_begin,
    lap_end] (JAX ``frontend/stereo.py:lapping_mask``; the reference moves
    them to the end of its arrays, ORBextractor.cc:1078-1162)."""
    x = xy[..., 0]
    return valid & (x >= lap_begin) & (x <= lap_end)


def fisheye_best2_plain(desc_l, lap_l, desc_r, lap_r, ratio: float = 0.7):
    """(best_idx, best, second, candidate) of each left keypoint among the
    right ones under the lapping gate: the first index of the minimum, and
    the minimum with only that column masked (so two equal best distances
    fail the ratio test), as the JAX function."""
    d = torch.where(lap_l[:, None] & lap_r[None, :], hamming_matrix(desc_l, desc_r), 1 << 20)
    best, best_idx = d.min(1).values, d.argmin(1)
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == best_idx[:, None], 1 << 20, d).min(1).values
    ratio32 = torch.tensor(np.float32(ratio), device=d.device)
    cand = (best < TH_ORB) & (best.to(torch.float32) < ratio32 * second.to(torch.float32))
    i32 = lambda t: t.to(torch.int32)
    return i32(best_idx), i32(best), i32(second), cand


def _rig(R_rl, t_rl, dev):
    f = lambda a: torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32),
                                  device=dev)
    return f(R_rl).reshape(3, 3), f(t_rl).reshape(3)


def fisheye_triangulate_plain(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, uv_l, uv_r, idx,
                              cand, octave_l, octave_r, R_rl, t_rl, sigma2):
    """Plain version of ``fisheye_triangulate``: ``triangulate_matches`` of
    every left row with its right row ``idx``, kept where ``cand``; p3d on
    every row, as the JAX function returns it."""
    dev = uv_l.device
    s2 = torch.as_tensor(np.asarray(sigma2, np.float32), device=dev)
    lvl = lambda o: o.long().clamp(0, s2.shape[0] - 1)
    j = idx.long()
    R, t = _rig(R_rl, t_rl, dev)
    p3d, depth, ok = triangulate_matches(cam_l, cam_r, uv_l, uv_r[j], R, t, s2[lvl(octave_l)],
                                         s2[lvl(octave_r[j])])
    ok = ok & cand
    return p3d, torch.where(ok, depth, -1.0), ok, torch.where(ok, idx.to(torch.int32), -1)


def compute_stereo_fisheye_matches_plain(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, xy_l,
                                         octave_l, desc_l, lap_l, xy_r, octave_r, desc_r, lap_r,
                                         R_rl, t_rl, sigma2,
                                         ratio: float = 0.7) -> FisheyeStereoMatches:
    """Plain version of ``compute_stereo_fisheye_matches`` (same arguments).
    A candidate is a lapping left keypoint (its best column passed the
    lapping gate), so JAX's final ``& lap_l`` is implied."""
    best_idx, _, _, cand = fisheye_best2_plain(desc_l, lap_l, desc_r, lap_r, ratio)
    p3d, depth, ok, right_idx = fisheye_triangulate_plain(cam_l, cam_r, xy_l, xy_r, best_idx,
                                                          cand, octave_l, octave_r, R_rl, t_rl,
                                                          sigma2)
    return FisheyeStereoMatches(right_idx=right_idx, depth=depth, p3d=p3d, valid=ok,
                                best_idx=best_idx, candidate=cand)


def tri_params(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, R_rl, t_rl, sigma2) -> np.ndarray:
    """The host float32 constants of K26's triangulation: both cameras, the
    rig, the gates, the per-octave variances."""
    f = lambda a: np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32).reshape(-1)
    cams = [np.asarray([c.fx, c.fy, c.cx, c.cy, *c.k], np.float32) for c in (cam_l, cam_r)]
    return np.ascontiguousarray(np.concatenate(
        cams + [f(R_rl), f(t_rl), np.float32([MIN_PARALLAX_COS, TRI_CHI2]), f(sigma2)]),
        np.float32)


def fisheye_match(desc_l, lap_l, desc_r, lap_r, ratio: float = 0.7):
    """K26's match kernel: ``fisheye_best2_plain`` on CUDA tensors (its plain
    version on the CPU)."""
    if not desc_l.is_cuda:
        return fisheye_best2_plain(desc_l, lap_l, desc_r, lap_r, ratio)
    NL, NR = desc_l.shape[0], desc_r.shape[0]
    args = [desc_l.contiguous(), lap_l.contiguous(), desc_r.contiguous(), lap_r.contiguous()]
    kernels.require_cuda("stereo_fisheye_match", *args)
    if desc_l.shape != (NL, 32) or desc_r.shape != (NR, 32) or desc_l.dtype != torch.uint8 \
            or desc_r.dtype != torch.uint8:
        raise TypeError("stereo_fisheye_match: descriptors are (N,32) uint8")
    if lap_l.dtype != torch.bool or lap_r.dtype != torch.bool or lap_l.shape != (NL,) \
            or lap_r.shape != (NR,):
        raise TypeError("stereo_fisheye_match: lapping masks are (N,) bool")
    if NR < 1 or NR >= 1 << 22:
        raise ValueError("stereo_fisheye_match: 1 to 2^22 - 1 right keypoints")
    for k in (0, 2):
        if args[k].data_ptr() % 4:
            args[k] = args[k].clone()   # the kernel reads descriptors as 32-bit words
    dev = desc_l.device
    best_idx, best, second = (torch.empty(NL, dtype=torch.int32, device=dev) for _ in range(3))
    cand = torch.empty(NL, dtype=torch.bool, device=dev)
    err = kernels.lib().stereo_fisheye_match_launch(
        args[0].data_ptr(), args[1].data_ptr(), NL, args[2].data_ptr(), args[3].data_ptr(), NR,
        TH_ORB, float(np.float32(ratio)), best_idx.data_ptr(), best.data_ptr(),
        second.data_ptr(), cand.data_ptr(), kernels.stream())
    kernels.check(err, "stereo_fisheye_match")
    kernels.LAUNCHES["stereo_fisheye_match"] += 1
    return best_idx, best, second, cand


def fisheye_triangulate(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, uv_l, uv_r, idx, cand,
                        octave_l, octave_r, R_rl, t_rl, sigma2):
    """K26's triangulation kernel: left row i with right row idx[i] where
    cand[i]; returns (p3d (N,3), depth, valid, right_idx), the rows that are
    no candidate with p3d 0.  The CPU runs ``fisheye_triangulate_plain``."""
    if not uv_l.is_cuda:
        return fisheye_triangulate_plain(cam_l, cam_r, uv_l, uv_r, idx, cand, octave_l,
                                         octave_r, R_rl, t_rl, sigma2)
    N = uv_l.shape[0]
    f32 = lambda a: a.to(torch.float32).contiguous()
    i32 = lambda a: a.to(torch.int32).contiguous()
    args = [f32(uv_l), f32(uv_r), i32(idx), cand.contiguous(), i32(octave_l), i32(octave_r)]
    kernels.require_cuda("fisheye_triangulate", *args)
    if args[0].shape != (N, 2) or args[1].dim() != 2 or args[1].shape[1] != 2 \
            or args[2].shape != (N,) or cand.dtype != torch.bool or cand.shape != (N,) \
            or args[4].shape != (N,) or args[5].shape != (args[1].shape[0],):
        raise ValueError("fisheye_triangulate: uv (N,2) / (NR,2), idx, cand, octave (N,) / (NR,)")
    n_lvl = len(np.asarray(sigma2).reshape(-1))
    prm = tri_params(cam_l, cam_r, R_rl, t_rl, sigma2)
    dev = uv_l.device
    p3d = torch.empty(N, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(N, dtype=torch.float32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    right_idx = torch.empty(N, dtype=torch.int32, device=dev)
    err = kernels.lib().fisheye_triangulate_launch(
        *[a.data_ptr() for a in args], N, prm.ctypes.data, n_lvl, p3d.data_ptr(),
        depth.data_ptr(), valid.data_ptr(), right_idx.data_ptr(), kernels.stream())
    kernels.check(err, "fisheye_triangulate")
    kernels.LAUNCHES["fisheye_triangulate"] += 1
    return p3d, depth, valid, right_idx


def compute_stereo_fisheye_matches(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, xy_l,
                                   octave_l, desc_l, lap_l, xy_r, octave_r, desc_r, lap_r,
                                   R_rl, t_rl, sigma2,
                                   ratio: float = 0.7) -> FisheyeStereoMatches:
    """Non-rectified (fisheye) stereo matching and triangulation.

    Replaces ``extractorb_tpu/frontend/stereo.py:compute_stereo_fisheye_matches``
    (Frame::ComputeStereoFishEyeMatches, Frame.cc:1139): each lapping left
    keypoint's best and second-best Hamming match among the lapping right
    keypoints (TH_ORB 75, ratio 0.7), each surviving pair triangulated with
    the parallax, depth and chi2 gates.  xy (N,2) raw pixels, octave (N,),
    desc (N,32) uint8, lap (N,) bool per side; [R_rl | t_rl] maps left-camera
    coordinates to right-camera ones (host arrays or tensors); sigma2 the
    per-octave variances.  On CUDA tensors this launches K26's two kernels
    (its p3d is 0 on the rows that are no candidate); on the CPU it runs the
    plain version."""
    if not xy_l.is_cuda:
        return compute_stereo_fisheye_matches_plain(cam_l, cam_r, xy_l, octave_l, desc_l, lap_l,
                                                    xy_r, octave_r, desc_r, lap_r, R_rl, t_rl,
                                                    sigma2, ratio)
    best_idx, _, _, cand = fisheye_match(desc_l, lap_l, desc_r, lap_r, ratio)
    p3d, depth, valid, right_idx = fisheye_triangulate(cam_l, cam_r, xy_l, xy_r, best_idx, cand,
                                                       octave_l, octave_r, R_rl, t_rl, sigma2)
    return FisheyeStereoMatches(right_idx=right_idx, depth=depth, p3d=p3d, valid=valid,
                                best_idx=best_idx, candidate=cand)
