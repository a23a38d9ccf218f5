"""The fused per-frame monocular tracking step
(port of ``extractorb_tpu/slam/track_device.py``, mono subset).

One call runs the chain the reference's tracking thread runs for an
ordinary frame: motion-model prediction, ORB extraction, the motion-model
search of the last frame's map points (th 15, widened to th 30 below 20
matches), pose optimisation, the reference-keyframe fallback (mutual-best
match + pose optimisation from the last pose), the local-map search and
the final pose optimisation.

The JAX program decides its two branches with ``lax.cond``.  Here both
branches are computed and ``torch.where`` selects, so a step never waits
on the host: no ``.item()``, nothing a later CUDA-graph capture would
trip over.  The cost is one extra K3 launch for the th-30 search and the
reference branch's two K3 launches and pose problem on every frame; the
motion and reference pose problems share one K4 launch.

Per frame, on the card: K1 x1, K2 x1, K3 x5, K4 x2.

Stereo, RGB-D and inertial variants, ``MapMirror`` and
``build_local_block`` (which need the map module) are not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CameraConfig, ORBConfig
from ..core.camera import Pinhole, undistort_points_pinhole
from ..frontend import matcher as fm
from ..frontend.extractor import Features, ORBExtractor, scale_factors
from ..solver import pose_opt as spo


@functools.lru_cache(maxsize=None)
def pinhole_project(fx: float, fy: float, cx: float, cy: float) -> Pinhole:
    """Canonical pinhole camera of a parameter set (its ``project`` is the
    JAX step's projection closure)."""
    return Pinhole(float(fx), float(fy), float(cx), float(cy))


class FusedOut(NamedTuple):
    feats: Features               # current frame (capacity N)
    xy_un: torch.Tensor           # (N,2) undistorted coords
    R: torch.Tensor               # (3,3) final pose
    t: torch.Tensor               # (3,)
    kp_mp: torch.Tensor           # (N,) int32 final map-point id per keypoint
    n_match_motion: torch.Tensor  # () int32 motion-model match count
    n_inl_motion: torch.Tensor    # () int32 pose-opt-1 inliers
    n_inl_final: torch.Tensor     # () int32 pose-opt-2 inliers
    lm_searched: torch.Tensor     # (M,) bool local points actually searched
    used_ref: torch.Tensor        # () bool: ref-KF fallback taken
    n_pre: torch.Tensor           # () int32 inliers entering local search


class LocalBlock(NamedTuple):
    """The local-map point block (reference UpdateLocalPoints) on the
    device: (M,) ids, (M,3) positions, (M,32) descriptors, (M,3) normals,
    (M,) max distances and validity."""
    ids: torch.Tensor
    pos: torch.Tensor
    desc: torch.Tensor
    norm: torch.Tensor
    maxd: torch.Tensor
    val: torch.Tensor


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` for idx in [0, len(base)]:
    index len(base) is the drop slot."""
    n = base.shape[0]
    buf = torch.cat([base, base[:1]])
    buf[idx.long()] = src
    return buf[:n]


class TrackStep:
    """The monocular tracking step for one static configuration."""

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: ORBConfig, img_shape: Tuple[int, int],
                 map_cap: int, local_cap: int, device):
        if cam_cfg.model == "KannalaBrandt8":
            raise NotImplementedError("TrackStep: only the pinhole camera is ported")
        self.device = torch.device(device)
        self.cam_cfg = cam_cfg
        self.orb_cfg = orb_cfg
        self.img_shape = tuple(img_shape)
        self.map_cap = map_cap
        self.local_cap = local_cap
        self.extractor = ORBExtractor(orb_cfg, self.img_shape, self.device)
        self.capacity = self.extractor.capacity
        self.cam = pinhole_project(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy)
        self.has_dist = abs(cam_cfg.k1) > 1e-12
        self.dist = (cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3)
        scales = scale_factors(orb_cfg)
        self.scale_factors = tuple(float(s) for s in scales)
        self.inv_sigma2 = torch.as_tensor(
            [1.0 / float(s * s) for s in scales], dtype=torch.float32, device=self.device)
        self.img_wh = (float(cam_cfg.width), float(cam_cfg.height))

    def __call__(
        self,
        img,                              # (H,W) uint8
        last_xy_un,                       # (N,2) previous frame undistorted coords
        last_desc, last_oct, last_ang,    # previous frame features
        last_kp_mp,                       # (N,) int32 previous associations
        map_pos, map_valid,               # (CAP,3) f32 / (CAP,) bool map mirror
        lm_ids, lm_pos, lm_desc, lm_norm, lm_maxd, lm_val,  # (M,...) local block
        ref_desc, ref_valid, ref_kp_mp,   # reference-keyframe block (fallback)
        R_last, t_last,                   # previous frame pose
        R_prev, t_prev,                   # the frame before (for the velocity)
    ) -> FusedOut:
        N, CAP = self.capacity, self.map_cap
        cam = self.cam

        # motion-model prediction: T_pred = (T_last T_prev^-1) T_last
        Rv = R_last @ R_prev.T
        tv = t_last - Rv @ t_prev
        R_pred = Rv @ R_last
        t_pred = Rv @ t_last + tv

        feats = self.extractor(img)
        xy_un = (undistort_points_pinhole(feats.xy, cam, self.dist)
                 if self.has_dist else feats.xy)

        # ---- TrackWithMotionModel: search the last frame's map points
        safe_ids = last_kp_mp.clamp(0, CAP - 1).long()
        prev_pos = map_pos[safe_ids]
        prev_val = (last_kp_mp >= 0) & map_valid[safe_ids]

        def msearch(th):
            return fm.search_by_projection_last_frame(
                prev_pos, last_desc, prev_val, last_oct, last_ang, R_pred, t_pred,
                xy_un, feats.desc, feats.octave, feats.angle, feats.valid,
                cam, self.scale_factors, self.img_wh, th,
            )

        m15, m30 = msearch(15.0), msearch(30.0)
        n15 = torch.sum((m15 >= 0).to(torch.int32))
        # the reference widens the window below 20 matches (Tracking.cc:2475)
        m = torch.where(n15 >= 20, m15, m30)
        n_match = torch.sum((m >= 0).to(torch.int32))
        kp_mp0 = _scatter_drop(torch.full((N,), -1, dtype=torch.int32, device=self.device),
                               torch.where(m >= 0, m, N), torch.where(m >= 0, last_kp_mp, -1))

        # ---- the reference-keyframe fallback's matches (TrackReferenceKeyFrame)
        m12, _ = fm.mutual_best_match(feats.desc, feats.valid, ref_desc, ref_valid)
        kp_r = torch.where(m12 >= 0, ref_kp_mp[m12.clamp(0, ref_kp_mp.shape[0] - 1).long()], -1)
        kp_r = torch.where((kp_r >= 0) & map_valid[kp_r.clamp(0, CAP - 1).long()], kp_r, -1)

        # ---- PoseOptimization #1, motion branch and ref branch in one batch
        isig = self.inv_sigma2[feats.octave.clamp(0, len(self.scale_factors) - 1).long()]
        val0 = (kp_mp0 >= 0) & map_valid[kp_mp0.clamp(0, CAP - 1).long()]
        res = spo.optimize_pose(
            torch.stack([R_pred, R_last]), torch.stack([t_pred, t_last]),
            torch.stack([map_pos[kp_mp0.clamp(0, CAP - 1).long()],
                         map_pos[kp_r.clamp(0, CAP - 1).long()]]),
            torch.stack([xy_un, xy_un]), torch.stack([isig, isig]),
            torch.stack([val0, kp_r >= 0]), cam,
        )
        kp_mp1m = torch.where(val0 & ~res.inliers[0], -1, kp_mp0)
        kp_ref = torch.where((kp_r >= 0) & ~res.inliers[1], -1, kp_r)
        ok_motion = (n_match >= 20) & (res.n_inliers[0] >= 10)
        R1 = torch.where(ok_motion, res.R[0], res.R[1])
        t1 = torch.where(ok_motion, res.t[0], res.t[1])
        kp_mp1 = torch.where(ok_motion, kp_mp1m, kp_ref)
        n_pre = torch.where(ok_motion, res.n_inliers[0], res.n_inliers[1])

        # ---- TrackLocalMap: search the local-map block
        taken = _scatter_drop(torch.zeros(CAP, dtype=torch.bool, device=self.device),
                              torch.where(kp_mp1 >= 0, kp_mp1, CAP),
                              torch.ones(N, dtype=torch.bool, device=self.device))
        lm_searched = lm_val & ~taken[lm_ids.clamp(0, CAP - 1).long()]
        kp_free = feats.valid & (kp_mp1 < 0)
        m2 = fm.search_by_projection_local_map(
            lm_pos, lm_desc, lm_searched, lm_norm, lm_maxd, R1, t1,
            xy_un, feats.desc, feats.octave, kp_free,
            cam, self.scale_factors, self.img_wh,
        )
        kp_mp2 = _scatter_drop(kp_mp1, torch.where(m2 >= 0, m2, N),
                               torch.where(m2 >= 0, lm_ids, -1))

        # ---- PoseOptimization #2
        val2 = (kp_mp2 >= 0) & map_valid[kp_mp2.clamp(0, CAP - 1).long()]
        res2 = spo.optimize_pose(
            R1[None], t1[None], map_pos[kp_mp2.clamp(0, CAP - 1).long()][None],
            xy_un[None], isig[None], val2[None], cam,
        )
        inl2 = res2.inliers[0]
        kp_mp3 = torch.where(val2 & ~inl2, -1, kp_mp2)
        return FusedOut(
            feats=feats, xy_un=xy_un, R=res2.R[0], t=res2.t[0], kp_mp=kp_mp3,
            n_match_motion=n_match, n_inl_motion=res.n_inliers[0],
            n_inl_final=torch.sum((val2 & inl2).to(torch.int32)), lm_searched=lm_searched,
            used_ref=~ok_motion, n_pre=n_pre,
        )


# program cache: one TrackStep (and its static tables) per configuration
_STEP_CACHE: dict = {}


def get_track_step(cam_cfg: CameraConfig, orb_cfg: ORBConfig, img_shape, map_cap: int,
                   local_cap: int, device) -> TrackStep:
    key = (cam_cfg, orb_cfg, tuple(img_shape), map_cap, local_cap, str(torch.device(device)))
    step = _STEP_CACHE.get(key)
    if step is None:
        step = TrackStep(cam_cfg, orb_cfg, tuple(img_shape), map_cap, local_cap, device)
        _STEP_CACHE[key] = step
    return step
