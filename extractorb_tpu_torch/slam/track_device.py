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

``MapMirror`` keeps the device copy of the map's point positions and
validity that the step reads; it updates only the rows that changed
since its last sync, with kernel K8 ``mirror_scatter``.
``build_local_block`` gathers the local-map point block on the host.

Stereo, RGB-D and inertial variants are not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
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
    ids_host: Optional[np.ndarray] = None  # (M,) int32 ids on the host


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


# --------------------------------------------------------- device mirror


def mirror_scatter_plain(pos, valid, rows, new_pos, new_valid) -> None:
    """Plain version of ``mirror_scatter``."""
    keep = (rows >= 0) & (rows < pos.shape[0])
    r = rows[keep].long()
    pos[r] = new_pos[keep]
    valid[r] = new_valid[keep]


def mirror_scatter(pos, valid, rows, new_pos, new_valid) -> None:
    """In place: ``pos[rows[i]] = new_pos[i]``, ``valid[rows[i]] =
    new_valid[i]``; rows outside [0, len(pos)) are dropped.  pos (cap,3)
    f32, valid (cap,) bool, rows (b,) int32, new_pos (b,3), new_valid (b,).
    On CUDA tensors this launches K8 ``mirror_scatter``; on the CPU it
    runs the plain version."""
    if not pos.is_cuda:
        return mirror_scatter_plain(pos, valid, rows, new_pos, new_valid)
    args = [rows.to(torch.int32).contiguous(), new_pos.to(torch.float32).contiguous(),
            new_valid.contiguous()]
    kernels.require_cuda("mirror_scatter", pos, valid, *args)
    if pos.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("mirror_scatter: the mirror is (cap,3) float32 and (cap,) bool")
    err = kernels.lib().mirror_scatter_launch(
        pos.data_ptr(), valid.data_ptr(), pos.shape[0], args[0].data_ptr(),
        args[1].data_ptr(), args[2].data_ptr(), args[0].shape[0], kernels.stream())
    kernels.check(err, "mirror_scatter")
    kernels.LAUNCHES["mirror_scatter"] += 1


class MapMirror:
    """Device mirror of a map's point block (positions + validity).

    Updated only when the map version changes (keyframe events), so
    ordinary frames move no map data; updates are incremental (only the
    rows that changed since the last sync are uploaded, through
    ``mirror_scatter``; the JAX module pads them to a row bucket for its
    compiled programs, which eager PyTorch does not need).  The capacity
    is padded to a static ladder, so a tracking step is rebuilt only when
    the map outgrows a rung.  ``n_scatter`` counts the incremental
    updates."""

    LADDER = (32768, 65536, 131072, 262144)

    def __init__(self, device):
        self.device = torch.device(device)
        self._key = None
        self.cap = 0
        self.pos = None
        self.valid = None
        self._h_pos = None     # host shadow of the device state
        self._h_valid = None
        self.n_scatter = 0

    @staticmethod
    def _pad_cap(n: int) -> int:
        for c in MapMirror.LADDER:
            if n <= c:
                return c
        return int(np.ceil(n / MapMirror.LADDER[-1])) * MapMirror.LADDER[-1]

    def _full_upload(self, mp, cap: int):
        pos = np.zeros((cap, 3), np.float32)
        valid = np.zeros((cap,), bool)
        n = mp._next_mp
        pos[: len(mp.mp_pos)] = mp.mp_pos
        valid[:n] = mp.mp_valid[:n]
        self.pos = torch.from_numpy(pos).to(self.device)
        self.valid = torch.from_numpy(valid).to(self.device)
        self._h_pos = pos
        self._h_valid = valid
        self.cap = cap

    def sync(self, mp) -> None:
        key = (mp.mid, mp.version)
        if key == self._key:
            return
        cap = self._pad_cap(len(mp.mp_valid))
        same_map = (
            self._key is not None and self._key[0] == mp.mid
            and cap == self.cap and self._h_pos is not None
        )
        self._key = key
        if not same_map:
            self._full_upload(mp, cap)
            return
        n = mp._next_mp
        changed = (mp.mp_valid[:n] != self._h_valid[:n]) | np.any(
            mp.mp_pos[:n] != self._h_pos[:n], axis=1)
        rows = np.where(changed)[0]
        if len(rows) > n // 3 and len(rows) > 4096:
            self._full_upload(mp, cap)
            return
        if not len(rows):
            return
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        mirror_scatter(self.pos, self.valid, to_dev(rows.astype(np.int32)),
                       to_dev(mp.mp_pos[rows]), to_dev(mp.mp_valid[rows]))
        self.n_scatter += 1
        self._h_pos[rows] = mp.mp_pos[rows]
        self._h_valid[rows] = mp.mp_valid[rows]


def build_local_block(mp, local_kfs, M: int, device) -> Optional[LocalBlock]:
    """Gather the local-map point block (reference UpdateLocalPoints,
    Tracking.cc:3000) into fixed-capacity device tensors."""
    pt_ids = mp.points_seen_by(local_kfs)
    if len(pt_ids) == 0:
        return None
    pt_ids = pt_ids[:M]
    k = len(pt_ids)
    pos = np.zeros((M, 3), np.float32)
    desc = np.zeros((M, 32), np.uint8)
    norm = np.zeros((M, 3), np.float32)
    maxd = np.ones((M,), np.float32)
    val = np.zeros((M,), bool)
    ids = np.zeros((M,), np.int32)
    pos[:k] = mp.mp_pos[pt_ids]
    desc[:k] = mp.mp_desc[pt_ids]
    norm[:k] = mp.mp_normal[pt_ids]
    maxd[:k] = mp.mp_max_dist[pt_ids]
    val[:k] = mp.mp_valid[pt_ids]
    ids[:k] = pt_ids
    to_dev = lambda a: torch.from_numpy(a).to(device)
    return LocalBlock(ids=to_dev(ids), pos=to_dev(pos), desc=to_dev(desc), norm=to_dev(norm),
                      maxd=to_dev(maxd), val=to_dev(val), ids_host=ids)
