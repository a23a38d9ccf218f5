"""The fused per-frame tracking step, monocular, stereo and RGB-D
(port of ``extractorb_tpu/slam/track_device.py``).  A monocular step,
visual or inertial, may take the KB8 fisheye camera (``project_for_camera``):
its keypoints stay raw and every search and pose solve projects through the
KB8 model.

One call runs the chain the reference's tracking thread runs for an
ordinary frame: motion-model prediction, ORB extraction, the motion-model
search of the last frame's map points (th 15, widened to th 30 below 20
matches), pose optimisation, the reference-keyframe fallback (mutual-best
match + pose optimisation from the last pose), the local-map search and
the final pose optimisation.

A stereo step also extracts the right image and matches the pair (K9,
``frontend/stereo.py``, on the pyramids the extractor built); an RGB-D
step samples the depth map at the keypoints.  Both give each keypoint a
right-image u (``ur``) and a depth, every pose solve takes the stereo
residual's third row, and the close-point counters of the keyframe
decision (reference NeedNewKeyFrame's bNeedToInsertClose) stay on the
device.

The JAX program decides its two branches with ``lax.cond``.  Here both
branches are computed and ``torch.where`` selects, so a step never waits
on the host: no ``.item()``, nothing a later CUDA-graph capture would
trip over.  The cost is one extra K3 launch for the th-30 search and the
reference branch's two K3 launches and pose problem on every frame; the
motion and reference pose problems share one K4 launch.

Per frame, on the card: K1 x1, K2 x1, K3 x5, K4 x2 (mono and RGB-D);
stereo adds K1 x1, K2 x1 and K9 x1.

The inertial step (``inertial=True``, monocular-inertial) takes the
frame's raw IMU window (``imu_record``: one host record, one copy to the
card) and integrates it in the step (K19, as the JAX package's
``_integrate_jit`` before its step), predicts the pose through the
preintegrated delta (PredictStateIMU, plain torch on the card, no host
synchronisation) instead of the velocity model, and replaces the second
pose solve by the joint last-frame solve against the previous frame's
state and prior (K22 ``<joint=true>``), which also gives the frame's
velocity, biases and the next prior's information; per frame that is K19
x1, K4 x1 and K22 x1.  On a card the visual and the inertial step each
run as one CUDA graph (``StepGraph``).

``MapMirror`` keeps the device copy of the map's point positions and
validity that the step reads; it updates only the rows that changed
since its last sync, with kernel K8 ``mirror_scatter`` reading them from
the mirror's page-locked staging buffer.
``build_local_block`` gathers the local-map point block on the host.

"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import CameraConfig, ORBConfig
from ..core.camera import Camera, KannalaBrandt8, Pinhole, undistort_points_pinhole
from ..frontend import matcher as fm
from ..frontend import stereo as fstereo
from ..frontend.extractor import Features, ORBExtractor, scale_factors
from ..imu import preintegration as pre
from . import imu_frontend
from ..solver import inertial as sin
from ..solver import pose_opt as spo


@functools.lru_cache(maxsize=None)
def pinhole_project(fx: float, fy: float, cx: float, cy: float) -> Pinhole:
    """Canonical pinhole camera of a parameter set (its ``project`` is the
    JAX step's projection closure)."""
    return Pinhole(float(fx), float(fy), float(cx), float(cy))


@functools.lru_cache(maxsize=None)
def kb8_project(fx: float, fy: float, cx: float, cy: float,
                k1: float, k2: float, k3: float, k4: float) -> KannalaBrandt8:
    """Canonical KB8 fisheye camera of a parameter set (the JAX step's
    ``kb8_project`` closure)."""
    return KannalaBrandt8(*(float(v) for v in (fx, fy, cx, cy, k1, k2, k3, k4)))


def project_for_camera(cam_cfg: CameraConfig) -> Camera:
    """The canonical camera of a CameraConfig (JAX ``project_for_camera``)."""
    if cam_cfg.model == "KannalaBrandt8":
        return kb8_project(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
                           cam_cfg.k1, cam_cfg.k2, cam_cfg.k3, cam_cfg.k4)
    return pinhole_project(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy)


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
    # stereo channels (reference mvuRight/mvDepth) and close-point
    # counters: None in mono steps
    ur: Optional[torch.Tensor] = None                 # (N,) right-image u or -1
    depth: Optional[torch.Tensor] = None              # (N,) metric depth or -1
    n_close_tracked: Optional[torch.Tensor] = None    # () int32 close keypoints with a map point
    n_close_untracked: Optional[torch.Tensor] = None  # () int32 close keypoints without one
    # inertial channels (body state and the next prior's information): None
    # in visual steps
    v: Optional[torch.Tensor] = None     # (3,) body velocity in the world
    bg: Optional[torch.Tensor] = None    # (3,) gyro bias
    ba: Optional[torch.Tensor] = None    # (3,) acc bias
    H15: Optional[torch.Tensor] = None   # (15,15) marginal information for the chain


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


# The inertial step's per-frame record (float32, one host-to-device copy): a
# head of the integration bias (6), the previous state v, bg, ba (9), Rcb (9)
# and tcb (3), padded to REC_HEAD floats, then the raw window at its bucketed
# length T (``imu_frontend._bucket``, 32 at least): gyro (T,3), acc (T,3),
# dt (T,) and valid (T,) as 1 / 0.  Padding steps keep the preintegration's
# state, so the window integrates as ``imu_frontend.integrate_raw`` does.
REC_HEAD = 32
_REC_STATE = slice(6, 15)


def imu_record(win, bias, v, bg, ba, Rcb, tcb, pin: bool = False) -> torch.Tensor:
    """The record of one raw (gyro, acc, dt) window (``ImuQueue.raw_window``)
    with the integration bias (bg, ba), the previous state and the
    camera-from-body extrinsics; ``pin``: in page-locked memory (for a
    copy to a card that does not block)."""
    gyro, acc, dt = win
    n = len(dt)
    T = imu_frontend._bucket(n)
    rec = torch.zeros(REC_HEAD + 8 * T, dtype=torch.float32, pin_memory=pin)
    a = rec.numpy()
    for o, x in ((0, bias), (6, v), (9, bg), (12, ba), (15, Rcb), (24, tcb)):
        x = np.asarray(x, np.float32).reshape(-1)
        a[o:o + len(x)] = x
    o = REC_HEAD
    a[o:o + 3 * n] = np.asarray(gyro, np.float32).reshape(-1)
    a[o + 3 * T:o + 3 * T + 3 * n] = np.asarray(acc, np.float32).reshape(-1)
    a[o + 6 * T:o + 6 * T + n] = dt
    a[o + 7 * T:o + 7 * T + n] = 1.0
    return rec


def imu_record_views(rec: torch.Tensor):
    """(gyro, acc, dt, valid, bias, v, bg, ba, Rcb, tcb) of a record, views
    on its device (valid as a bool tensor)."""
    T = (rec.shape[0] - REC_HEAD) // 8
    o = REC_HEAD
    return (rec[o:o + 3 * T].view(T, 3), rec[o + 3 * T:o + 6 * T].view(T, 3),
            rec[o + 6 * T:o + 7 * T], rec[o + 7 * T:o + 8 * T] > 0, rec[0:6], rec[6:9],
            rec[9:12], rec[12:15], rec[15:24].view(3, 3), rec[24:27])


class StepImu(NamedTuple):
    """The inertial step's inputs: ``record`` (``imu_record``, on the host),
    ``prior_H`` the previous frame's (15,15) prior information on the step's
    device, and ``prev``: None, or the previous state (v, bg, ba) as tensors
    on the step's device (the outputs of a step still in flight) that take
    the record's place."""
    record: torch.Tensor
    prior_H: torch.Tensor
    prev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def rgbd_right_coords(xy, xy_un, valid, depthmap, bf: float):
    """The RGB-D stereo channels (reference ComputeStereoFromRGBD,
    Frame.cc:994): depth sampled at the rounded raw keypoint coordinates,
    and the virtual right coordinate uR = u_un - bf / d.  Returns (ur,
    depth), -1 where the keypoint is invalid or the depth is not
    positive."""
    H, W = depthmap.shape
    vv = torch.round(xy[:, 1]).clamp(0, H - 1).long()
    uu = torch.round(xy[:, 0]).clamp(0, W - 1).long()
    d = depthmap[vv, uu]
    ok = valid & (d > 0)
    depth = torch.where(ok, d, -1.0)
    # a tensor numerator: ``float / tensor`` would multiply by a reciprocal;
    # filled on the device (no host copy, so the step can be captured)
    bf_t = torch.full((), bf, dtype=torch.float32, device=d.device)
    ur = torch.where(ok, xy_un[:, 0] - bf_t / d.clamp(min=1e-9), -1.0)
    return ur, depth


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` for idx in [0, len(base)]:
    index len(base) is the drop slot."""
    n = base.shape[0]
    buf = torch.cat([base, base[:1]])
    buf[idx.long()] = src
    return buf[:n]


class TrackStep:
    """The tracking step for one static configuration.

    depth_mode "none" (mono), "stereo" (``img_r`` is the rectified right
    image) or "rgbd" (``img_r`` is the (H,W) float32 metric depth map);
    the last two need ``cam_cfg.bf`` = fx * baseline > 0, and split close
    from far points at thDepth = bf * ThDepth / fx metres for the
    close-point counters."""

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: ORBConfig, img_shape: Tuple[int, int],
                 map_cap: int, local_cap: int, device, depth_mode: str = "none",
                 inertial: bool = False, graph: Optional[bool] = None,
                 imu_noise: Optional[Tuple[float, float, float, float]] = None):
        if cam_cfg.model == "KannalaBrandt8" and depth_mode != "none":
            raise NotImplementedError("TrackStep: the KB8 camera takes the monocular steps "
                                      "only; the JAX tracker never fuses a fisheye rig frame "
                                      "(ROADMAP A.12.4)")
        if depth_mode not in ("none", "stereo", "rgbd"):
            raise ValueError(f"TrackStep: depth_mode {depth_mode!r}")
        if depth_mode != "none" and cam_cfg.bf <= 0.0:
            raise ValueError(f"TrackStep: depth_mode {depth_mode!r} needs Camera.bf > 0")
        if inertial and depth_mode != "none":
            raise NotImplementedError("TrackStep: the inertial step is monocular only; the JAX "
                                      "package never builds a stereo or RGB-D inertial step")
        if inertial and imu_noise is None:
            raise ValueError("TrackStep: the inertial step needs imu_noise (ImuCalib's "
                             "noise_gyro, noise_acc, walk_gyro, walk_acc)")
        self.inertial = inertial
        self.imu_noise = None if imu_noise is None else tuple(float(x) for x in imu_noise)
        self.depth_mode = depth_mode
        self.stereo = depth_mode != "none"
        # reference Camera.bf and mThDepth = bf * ThDepth / fx
        self.bf = float(cam_cfg.bf)
        self.baseline = self.bf / cam_cfg.fx
        self.th_depth = self.bf * float(cam_cfg.th_depth) / cam_cfg.fx
        self.device = torch.device(device)
        self.cam_cfg = cam_cfg
        self.orb_cfg = orb_cfg
        self.img_shape = tuple(img_shape)
        self.map_cap = map_cap
        self.local_cap = local_cap
        self.extractor = ORBExtractor(orb_cfg, self.img_shape, self.device)
        self.capacity = self.extractor.capacity
        self.cam = project_for_camera(cam_cfg)
        # a KB8 camera's keypoints stay raw: only a distorted pinhole undistorts
        self.has_dist = abs(cam_cfg.k1) > 1e-12 and not isinstance(self.cam, KannalaBrandt8)
        self.dist = (cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3)
        scales = scale_factors(orb_cfg)
        self.scale_factors = tuple(float(s) for s in scales)
        self.inv_sigma2 = torch.as_tensor(
            [1.0 / float(s * s) for s in scales], dtype=torch.float32, device=self.device)
        self.img_wh = (float(cam_cfg.width), float(cam_cfg.height))
        self.gravity = torch.tensor([0.0, 0.0, -sin.GRAVITY], dtype=torch.float32,
                                    device=self.device)
        # the step on the card runs as one CUDA graph (``graph=False`` keeps
        # the eager launches, which the graph is held against)
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError("TrackStep: the CUDA graph captures the step on a card")
        self.graph = StepGraph(self) if graph else None

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
        img_r=None,                       # right image (stereo) or depth map (rgbd)
        imu: Optional[StepImu] = None,    # inertial inputs
    ) -> FusedOut:
        """One frame.  On the card the step is a replay of its CUDA graph
        (``StepGraph``); with ``graph=False`` and on the CPU it runs
        ``_step``."""
        args = (img, last_xy_un, last_desc, last_oct, last_ang, last_kp_mp, map_pos, map_valid,
                lm_ids, lm_pos, lm_desc, lm_norm, lm_maxd, lm_val, ref_desc, ref_valid,
                ref_kp_mp, R_last, t_last, R_prev, t_prev)
        if self.inertial != (imu is not None):
            raise ValueError("TrackStep: an inertial step takes imu inputs, a visual one none")
        if self.graph is not None:
            return self.graph(args, img_r, imu)
        return self._step(*args, img_r=img_r, imu=self._stage(imu))

    def _stage(self, imu: Optional[StepImu]):
        """``_step``'s inertial inputs: the record copied to the step's
        device, a chained previous state in its place, and the prior."""
        if imu is None:
            return None
        rec = imu.record.to(self.device, non_blocking=True)
        if imu.prev is not None:
            torch.cat(imu.prev, out=rec[_REC_STATE])
        return rec, imu.prior_H

    def _step(self, *args, img_r=None, imu=None) -> FusedOut:
        """The step as eager launches: the arguments of ``__call__``, and
        for the inertial step ``imu`` = (the record on the step's device,
        prior_H).  Integrates the record's window (K19) and runs
        ``_track``."""
        if not self.inertial:
            return self._track(*args, img_r=img_r)
        rec, prior_H = imu
        gyro, acc, dt, valid, bias, v, bg, ba, Rcb, tcb = imu_record_views(rec)
        preint = pre.index(pre.integrate_batch(gyro[None], acc[None], dt[None], valid[None],
                                               bias[None], *self.imu_noise), 0)
        return self._track(*args, imu=(preint, v, bg, ba, prior_H, Rcb, tcb))

    def _track(
        self, img, last_xy_un, last_desc, last_oct, last_ang, last_kp_mp, map_pos, map_valid,
        lm_ids, lm_pos, lm_desc, lm_norm, lm_maxd, lm_val, ref_desc, ref_valid, ref_kp_mp,
        R_last, t_last, R_prev, t_prev, img_r=None, imu=None,
    ) -> FusedOut:
        """The step after the integration: ``imu`` is the JAX step's tuple
        (preint, v_last, bg_last, ba_last, prior_H, Rcb, tcb)."""
        N, CAP = self.capacity, self.map_cap
        cam = self.cam

        if self.inertial:
            # PredictStateIMU (reference Tracking.cc:1230) from the previous
            # state through the frame's preintegration (no re-orthonormalisation)
            preint, v_last, bg_last, ba_last, prior_H, Rcb, tcb = imu
            g = self.gravity
            Rwb1 = R_last.T @ Rcb
            twb1 = R_last.T @ (tcb - t_last)
            b = torch.cat([bg_last, ba_last])
            dt = preint.dT
            Rwb2 = Rwb1 @ pre.delta_rotation(preint, b)
            v_pred = v_last + g * dt + Rwb1 @ pre.delta_velocity(preint, b)
            twb2 = twb1 + v_last * dt + 0.5 * g * dt * dt + Rwb1 @ pre.delta_position(preint, b)
            R_pred = Rcb @ Rwb2.T
            t_pred = tcb - R_pred @ twb2
        else:
            # motion-model prediction: T_pred = (T_last T_prev^-1) T_last
            Rv = R_last @ R_prev.T
            tv = t_last - Rv @ t_prev
            R_pred = Rv @ R_last
            t_pred = Rv @ t_last + tv

        # ---- extraction, and the stereo channels (reference
        # ComputeStereoMatches, Frame.cc:813, or ComputeStereoFromRGBD, :994)
        if self.depth_mode == "stereo":
            feats, sres = fstereo.match_pair(self.extractor, img, img_r, self.bf, self.baseline)
            ur, depth = sres.u_right, sres.depth
        else:
            feats = self.extractor(img)
        xy_un = (undistort_points_pinhole(feats.xy, cam, self.dist)
                 if self.has_dist else feats.xy)
        if self.depth_mode == "rgbd":
            ur, depth = rgbd_right_coords(feats.xy, xy_un, feats.valid,
                                          img_r.to(self.device, torch.float32), self.bf)
        elif self.depth_mode == "none":
            ur = depth = None
        obs_ur = ur

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
            obs_ur=None if obs_ur is None else torch.stack([obs_ur, obs_ur]), bf=self.bf,
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

        # ---- PoseOptimization #2; inertial: the joint solve against the
        # previous state and its prior (PoseInertialOptimizationLastFrame,
        # reference Tracking.cc:2574), which gives the next prior too
        val2 = (kp_mp2 >= 0) & map_valid[kp_mp2.clamp(0, CAP - 1).long()]
        pts2 = map_pos[kp_mp2.clamp(0, CAP - 1).long()]
        if self.inertial:
            prev = (Rwb1, twb1, v_last, bg_last, ba_last)
            vres = sin.optimize_pose_inertial_last_frame(
                R1.T @ Rcb, R1.T @ (tcb - t1), v_pred, bg_last, ba_last, prev, preint, pts2,
                xy_un, isig, val2, Rcb, tcb, cam, prior=(prior_H, prev))
            R2 = Rcb @ vres.Rwb.T
            t2, inl2 = tcb - R2 @ vres.twb, vres.inliers
            extra = dict(v=vres.v, bg=vres.bg, ba=vres.ba, H15=vres.H)
        else:
            res2 = spo.optimize_pose(
                R1[None], t1[None], pts2[None], xy_un[None], isig[None], val2[None], cam,
                obs_ur=None if obs_ur is None else obs_ur[None], bf=self.bf,
            )
            R2, t2, inl2 = res2.R[0], res2.t[0], res2.inliers[0]
            extra = {}
        kp_mp3 = torch.where(val2 & ~inl2, -1, kp_mp2)
        out = FusedOut(
            feats=feats, xy_un=xy_un, R=R2, t=t2, kp_mp=kp_mp3,
            n_match_motion=n_match, n_inl_motion=res.n_inliers[0],
            n_inl_final=torch.sum((val2 & inl2).to(torch.int32)), lm_searched=lm_searched,
            used_ref=~ok_motion, n_pre=n_pre, **extra,
        )
        if not self.stereo:
            return out
        close = feats.valid & (depth > 0)
        if self.th_depth > 0:
            close = close & (depth < self.th_depth)
        return out._replace(
            ur=ur, depth=depth,
            n_close_tracked=torch.sum((close & (kp_mp3 >= 0)).to(torch.int32)),
            n_close_untracked=torch.sum((close & (kp_mp3 < 0)).to(torch.int32)),
        )


class StepGraph:
    """A ``TrackStep`` as one CUDA graph on the card (the JAX step is one
    XLA program per frame, ``extractorb_tpu/slam/track_device.py:169``):
    the visual step's K15, K1, K16, K17, K2, K24 (with distortion), K9
    (stereo), K3 x5, K18 x3, K4 x2, or the inertial step's K19, K15, K1,
    K16, K17, K2, K3 x5, K18 x3, K4 x1 and K22 ``<joint=true>``, and the
    torch glue between them (the inertial step's PredictStateIMU too),
    replayed by one graph launch a frame.  Both branches of the JAX step's
    ``lax.cond``s stay decided on the device (``torch.where``), as in
    ``_step``.

    A call with a new key runs ``_step`` eagerly: the warm-up that
    initialises what a capture may not (cuBLAS, kernel attributes such as
    K4's and K22's shared-memory limits, cached tables).  When the key
    repeats the graph is captured, and that call and every later one copy
    their inputs into the graph's static buffers and replay it (a key seen
    once, such as the first frame after initialisation chaining from the 5x
    init extractor, or an IMU window of another bucket after a gap in the
    stream, runs eagerly and leaves the captured graph in place).  The key is
    everything the graph bakes in: the camera (its model and intrinsics
    select K4's and K22's instantiations and the projection's constants),
    every input's shape and type (the IMU record's length is its window's
    bucket), and the addresses of the map mirror's tensors, which the graph
    reads in place (so ``MapMirror`` growth or a new mirror recaptures).
    The host values the wrappers pass to their kernels (tables, counts,
    capacities, the IMU noise) follow from the step's configuration and
    those shapes.  The local and reference blocks are copied only when the
    caller passes other tensors (they are never changed in place); the
    previous frame's tensors, the images, the poses, the IMU record (one
    copy from the host) and the prior at every call, and a chained previous
    state (``StepImu.prev``) into the record's place.

    A replay overwrites the graph's outputs, so every replay's outputs are
    packed in the graph into one flat buffer, which one device copy after
    the replay snapshots: each call returns tensors of its own (views of
    its snapshot), which in-flight pipelined frames and keyframes keep.

    ``kernels.LAUNCHES`` counts launches where a wrapper launches its
    kernel: a replay adds the launches counted while capturing (which
    themselves are taken back: a capture launches nothing), and
    ``kernels.GRAPH_LAUNCHES["track_step"]`` (the visual step) or
    ``["track_step_inertial"]`` counts the replays.  A failed capture
    raises."""

    _MIRROR = (6, 7)                     # map_pos, map_valid: read in place
    _BLOCKS = tuple(range(8, 17))        # local block, reference block
    _PER_FRAME = (0, 1, 2, 3, 4, 5, 17, 18, 19, 20)
    _N_ARGS = 21

    def __init__(self, step: "TrackStep"):
        self.step = step
        self.name = "track_step_inertial" if step is not None and step.inertial else "track_step"
        self.key = None
        self._warm = None      # the key of the last eager call
        self.cuda_graph = None
        self.static = None
        self.sources = None
        self.flat = None
        self.pieces = None     # (offset, nbytes, dtype, shape) of each packed output
        self.template = None   # the FusedOut with piece indices in place of tensors
        self.launches = collections.Counter()   # wrapper launches in one replay
        self.kernel_nodes = 0
        self.nodes = 0
        self.n_captures = 0
        self.n_replays = 0
        self.n_warm = 0        # eager calls (a key's first)

    @staticmethod
    def inputs(args, img_r=None, imu: Optional[StepImu] = None) -> list:
        """The step's tensors in the graph's static order: the 21
        arguments, then the right image or depth map, or the IMU record and
        the prior."""
        extra = [] if img_r is None else [img_r]
        if imu is not None:
            extra += [imu.record, imu.prior_H]
        return list(args) + extra

    def split(self, inputs):
        """``_step``'s (args, img_r, imu) from a list in ``inputs``' order
        (imu as (record, prior_H))."""
        args, rest = inputs[:self._N_ARGS], inputs[self._N_ARGS:]
        if self.step.inertial:
            return args, None, (rest[0], rest[1])
        return args, (rest[0] if rest else None), None

    def key_of(self, inputs) -> tuple:
        return (self.step.cam,) + tuple((tuple(t.shape), t.dtype) for t in inputs) + tuple(
            inputs[i].data_ptr() for i in self._MIRROR)

    def __call__(self, args, img_r=None, imu: Optional[StepImu] = None) -> FusedOut:
        inputs = self.inputs(args, img_r, imu)
        prev = None if imu is None else imu.prev
        key = self.key_of(inputs)
        if key != self.key:
            if key != self._warm:
                self._warm = key
                self.n_warm += 1
                return self.step._step(*args, img_r=img_r, imu=self.step._stage(imu))
            self._capture(key, inputs, prev)
        else:
            for i in self._PER_FRAME + tuple(range(self._N_ARGS, len(inputs))):
                self.static[i].copy_(inputs[i], non_blocking=True)
            for i in self._BLOCKS:
                if inputs[i] is not self.sources[i]:
                    self.static[i].copy_(inputs[i])
                    self.sources[i] = inputs[i]
            self._chain(prev)
        self.cuda_graph.replay()
        kernels.LAUNCHES.update(self.launches)
        kernels.GRAPH_LAUNCHES[self.name] += 1
        self.n_replays += 1
        return self._unpack(self.flat.clone())

    def _chain(self, prev):
        """A chained previous state into the static IMU record's place."""
        if prev is not None:
            torch.cat(prev, out=self.static[self._N_ARGS][_REC_STATE])

    def _capture(self, key, inputs, prev):
        dev = self.step.device
        self.key = self.cuda_graph = self.flat = None
        static = [t if i in self._MIRROR else torch.empty(t.shape, dtype=t.dtype, device=dev)
                  for i, t in enumerate(inputs)]
        for i, t in enumerate(inputs):
            if i not in self._MIRROR:
                static[i].copy_(t)
        self.static = static
        self._chain(prev)
        before = collections.Counter(kernels.LAUNCHES)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(g):
                a, r, i = self.split(static)
                out = self.step._step(*a, img_r=r, imu=i)
                flat = self._pack(out)
        finally:
            self.launches = kernels.LAUNCHES - before
            kernels.LAUNCHES.clear()
            kernels.LAUNCHES.update(before)
        g.instantiate()
        total = ctypes.c_int(0)
        self.kernel_nodes = kernels.lib().graph_kernel_nodes(g.raw_cuda_graph(),
                                                             ctypes.byref(total))
        self.nodes = total.value
        if self.kernel_nodes < 0:
            raise RuntimeError("TrackStep graph: its nodes cannot be read")
        self.sources = list(inputs)
        self.cuda_graph, self.flat, self.key = g, flat, key
        self.n_captures += 1

    def _pack(self, out: FusedOut) -> torch.Tensor:
        """Record ``out``'s layout and return its tensors packed into one
        uint8 buffer, each at a 16-byte offset (a tensor that is two fields,
        such as xy_un and feats.xy without distortion, is packed once)."""
        index, parts, pieces = {}, [], []
        size = 0

        def slot(t):
            nonlocal size
            if t is None:
                return None
            if id(t) not in index:
                index[id(t)] = len(pieces)
                nb = t.numel() * t.element_size()
                pieces.append((size, nb, t.dtype, tuple(t.shape)))
                parts.append(t.contiguous().reshape(-1).view(torch.uint8))
                pad = -nb % 16
                if pad:
                    parts.append(parts[-1].new_empty(pad))
                size += nb + pad
            return index[id(t)]

        feats = Features(*(slot(getattr(out.feats, f.name))
                           for f in dataclasses.fields(Features)))
        self.template = out._replace(feats=feats, **{
            name: slot(getattr(out, name)) for name in FusedOut._fields if name != "feats"})
        self.pieces = pieces
        return torch.cat(parts)

    def _unpack(self, snap: torch.Tensor) -> FusedOut:
        views = [snap[o:o + nb].view(dt).view(shape) for o, nb, dt, shape in self.pieces]
        get = lambda i: None if i is None else views[i]
        feats = Features(*(get(getattr(self.template.feats, f.name))
                           for f in dataclasses.fields(Features)))
        return self.template._replace(feats=feats, **{
            name: get(getattr(self.template, name)) for name in FusedOut._fields
            if name != "feats"})


# program cache: one TrackStep (and its static tables) per configuration
_STEP_CACHE: dict = {}


def get_track_step(cam_cfg: CameraConfig, orb_cfg: ORBConfig, img_shape, map_cap: int,
                   local_cap: int, device, depth_mode: str = "none",
                   inertial: bool = False, graph: Optional[bool] = None,
                   imu_noise: Optional[Tuple[float, float, float, float]] = None) -> TrackStep:
    """The cached ``TrackStep`` of a configuration; ``graph`` as
    ``TrackStep``'s (None: the CUDA graph on a card)."""
    key = (cam_cfg, orb_cfg, tuple(img_shape), map_cap, local_cap, str(torch.device(device)),
           depth_mode, inertial, graph, imu_noise)
    step = _STEP_CACHE.get(key)
    if step is None:
        step = TrackStep(cam_cfg, orb_cfg, tuple(img_shape), map_cap, local_cap, device,
                         depth_mode=depth_mode, inertial=inertial, graph=graph,
                         imu_noise=imu_noise)
        _STEP_CACHE[key] = step
    return step


# --------------------------------------------------------- device mirror


def mirror_scatter_plain(pos, valid, rows, new_pos, new_valid) -> None:
    """Plain version of ``mirror_scatter``."""
    keep = (rows >= 0) & (rows < pos.shape[0])
    r = rows[keep].long()
    pos[r] = new_pos[keep]
    valid[r] = new_valid[keep]


def _as(a: torch.Tensor, dtype) -> torch.Tensor:
    """``a`` as a contiguous tensor of ``dtype``, converted only if it is not."""
    return a if a.dtype == dtype and a.is_contiguous() else a.to(dtype).contiguous()


def mirror_scatter(pos, valid, rows, new_pos, new_valid) -> None:
    """In place: ``pos[rows[i]] = new_pos[i]``, ``valid[rows[i]] =
    new_valid[i]``; rows outside [0, len(pos)) are dropped.  pos (cap,3)
    f32, valid (cap,) bool, rows (b,) int32, new_pos (b,3), new_valid (b,),
    all on one device.  On CUDA tensors this launches K8 ``mirror_scatter``;
    on the CPU it runs the plain version."""
    if not pos.is_cuda:
        return mirror_scatter_plain(pos, valid, rows, new_pos, new_valid)
    rows, new_pos, new_valid = _as(rows, torch.int32), _as(new_pos, torch.float32), \
        _as(new_valid, torch.bool)
    if pos.dtype != torch.float32 or valid.dtype != torch.bool or not (
            pos.is_contiguous() and valid.is_contiguous()):
        raise TypeError("mirror_scatter: the mirror is (cap,3) float32 and (cap,) bool")
    dev = pos.get_device()
    if not valid.get_device() == rows.get_device() == new_pos.get_device() \
            == new_valid.get_device() == dev:
        raise ValueError(f"mirror_scatter: every argument must be on {pos.device}")
    err = kernels.entry("mirror_scatter_launch")(
        pos.data_ptr(), valid.data_ptr(), pos.shape[0], rows.data_ptr(), new_pos.data_ptr(),
        new_valid.data_ptr(), rows.shape[0], kernels.stream(dev))
    kernels.check(err, "mirror_scatter")
    kernels.LAUNCHES["mirror_scatter"] += 1


def record_offsets(b: int):
    """Byte offsets of new_pos and new_valid in a scatter record of b rows,
    and its length: rows (b,) int32 at 0, new_pos (b,3) float32 and
    new_valid (b,) bool each at a 16-byte aligned offset (``csrc/map_io.cu``)."""
    o_pos = (4 * b + 15) & ~15
    o_val = o_pos + ((12 * b + 15) & ~15)
    return o_pos, o_val, o_val + b


def record_views(record: np.ndarray, b: int):
    """rows, new_pos and new_valid: numpy views into a uint8 record of b rows."""
    o_pos, o_val, _ = record_offsets(b)
    return (record[:4 * b].view(np.int32), record[o_pos:o_pos + 12 * b].view(np.float32)
            .reshape(b, 3), record[o_val:o_val + b].view(np.bool_))


def mirror_scatter_record(pos, valid, record: torch.Tensor, b: int) -> None:
    """``mirror_scatter`` of b rows given as one record (``record_offsets``)
    in a uint8 host tensor, which on a card must be page-locked: K8 reads it
    there in place, with no copy.  ``pos`` and ``valid`` are a mirror's own
    tensors (``MapMirror`` allocates them, (cap,3) float32 and (cap,) bool,
    contiguous on one device), so they are not checked here.  On the CPU it
    runs the plain version on the record's views."""
    if not pos.is_cuda:
        rows, new_pos, new_valid = (torch.from_numpy(a) for a in record_views(record.numpy(), b))
        return mirror_scatter_plain(pos, valid, rows, new_pos, new_valid)
    err = kernels.entry("mirror_scatter_record_launch")(
        pos.data_ptr(), valid.data_ptr(), pos.shape[0], record.data_ptr(), b,
        kernels.stream(pos.get_device()))
    kernels.check(err, "mirror_scatter")
    kernels.LAUNCHES["mirror_scatter"] += 1


class MapMirror:
    """Device mirror of a map's point block (positions + validity).

    Updated only when the map version changes (keyframe events), so
    ordinary frames move no map data; updates are incremental (only the
    rows that changed since the last sync are uploaded, through
    ``mirror_scatter_record``; the JAX module pads them to a row bucket for
    its compiled programs, which eager PyTorch does not need).  Host data
    reaches the card only through the mirror's staging buffer, page-locked
    on a card and grown on demand: a sync packs the changed rows into it as
    one record, which K8 reads in place, or the whole block, copied without
    blocking.  An event recorded after each such read guards the buffer, and
    the next sync waits on it before writing.  The capacity is padded to a
    static ladder, so a tracking step is rebuilt only when the map outgrows
    a rung.  ``n_scatter`` counts the incremental updates."""

    LADDER = (32768, 65536, 131072, 262144)

    def __init__(self, device):
        self.device = torch.device(device)
        self._key = None
        self.cap = 0
        self.pos = None
        self.valid = None
        self._h_pos = None     # host shadow of the device state
        self._h_valid = None
        self._stage = None     # the staging buffer (uint8)
        self._read = torch.cuda.Event() if self.device.type == "cuda" else None
        self._pending = False  # the card may still read the staging buffer
        self.n_scatter = 0

    @staticmethod
    def _pad_cap(n: int) -> int:
        for c in MapMirror.LADDER:
            if n <= c:
                return c
        return int(np.ceil(n / MapMirror.LADDER[-1])) * MapMirror.LADDER[-1]

    def _staging(self, nbytes: int) -> torch.Tensor:
        """The staging buffer, at least nbytes, once the card has read it."""
        if self._pending:
            self._read.synchronize()
            self._pending = False
        if self._stage is None or self._stage.numel() < nbytes:
            size = max(nbytes, 2 * (0 if self._stage is None else self._stage.numel()), 1 << 16)
            self._stage = torch.empty(size, dtype=torch.uint8,
                                      pin_memory=self.device.type == "cuda")
        return self._stage

    def _read_after(self) -> None:
        """Mark the staging buffer as read by the work just enqueued."""
        if self._read is not None:
            self._read.record()
            self._pending = True

    def _full_upload(self, mp, cap: int):
        buf = self._staging(13 * cap)
        pos = buf[:12 * cap].view(torch.float32).view(cap, 3)
        valid = buf[12 * cap:13 * cap].view(torch.bool)
        n = mp._next_mp
        h_pos, h_valid = pos.numpy(), valid.numpy()
        h_pos[:] = 0.0
        h_pos[: len(mp.mp_pos)] = mp.mp_pos
        h_valid[:] = False
        h_valid[:n] = mp.mp_valid[:n]
        if cap != self.cap:
            self.pos = torch.empty((cap, 3), dtype=torch.float32, device=self.device)
            self.valid = torch.empty((cap,), dtype=torch.bool, device=self.device)
        # the same tensors at the same capacity: a captured tracking step
        # reads them in place
        self.pos.copy_(pos, non_blocking=True)
        self.valid.copy_(valid, non_blocking=True)
        self._read_after()
        self._h_pos = h_pos.copy()
        self._h_valid = h_valid.copy()
        self.cap = cap

    def upload_rows(self, rows: np.ndarray, new_pos: np.ndarray, new_valid: np.ndarray) -> None:
        """``pos[rows[i]] = new_pos[i]``, ``valid[rows[i]] = new_valid[i]``
        from host arrays (rows outside [0, cap) dropped): one record in the
        staging buffer, scattered by ``mirror_scatter_record``."""
        b = len(rows)
        buf = self._staging(record_offsets(b)[2])
        r, p_, v = record_views(buf.numpy(), b)
        r[:], p_[:], v[:] = rows, new_pos, new_valid
        mirror_scatter_record(self.pos, self.valid, buf, b)
        self._read_after()

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
        self.upload_rows(rows, mp.mp_pos[rows], mp.mp_valid[rows])
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
