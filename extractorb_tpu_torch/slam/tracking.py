"""Visual tracking, monocular, rectified stereo and RGB-D: the per-frame
hot path (port of ``extractorb_tpu/slam/tracking.py``, visual-only subset).

Replaces Tracking (reference: src/Tracking.cc:1390-1907 Track(), :2018
MonocularInitialization, :1924 StereoInitialization, :2437
TrackWithMotionModel, :2308 TrackReferenceKeyFrame, :2532 TrackLocalMap,
:2647 NeedNewKeyFrame, :2907 CreateNewKeyFrame).  The host runs the state
machine; the dense stages run on the device: extraction (K1, K2), the
searches (K3), pose optimisation (K4, with the stereo residual), the
two-view initialisation (K5), bundle adjustment (K6), the triangulation
search (K7), the map mirror and packed fetches (K8), the stereo match
(K9, or K26 on a fisheye rig) and the relocalization PnP (K10).  With a vocabulary every new
keyframe goes through the loop closer (``slam/loop_closing.py``: the
vocabulary descent K11, Sim3 K12, the essential graph K13, the global BA
K14), which corrects a loop in the map or welds the map into an older
Atlas map, and a lost frame takes its relocalization candidates from the
keyframe database.

The steady state is the fused step (``TrackStep``): one call per frame,
confirmed by one packed fetch.  Frames that fail its gates replay through
the reference-exact path (``_track_existing``).  With
``tracking.pipeline_depth = K > 0`` consecutive fused frames chain device
to device (each step reads the previous step's pose and feature tensors)
and the host confirms them in batches with one packed fetch, leaving the
newest frames in flight; in that mode a visual keyframe's triangulation
and fuse results ride the next confirmation too (``LocalMapper.apply_tf``).
Stereo and RGB-D maps start from one frame's depths (no two-view init) and
create close points at every keyframe.

Recovery (reference Tracking.cc:1549-1625, :3184): a frame that fails to
track goes LOST, or RECENTLY_LOST on a map of more than 10 keyframes for
``time_recently_lost`` seconds; later frames relocalize against the map's
database's candidates, or without a vocabulary the map's three most recent
keyframes (K3 match, K10 RANSAC PnP, K4), and more than five failed LOST
frames start a new Atlas map (the failed one is dropped below 10
keyframes).

A Kannala-Brandt 8 fisheye camera (``camera.model="KannalaBrandt8"``):
keypoints stay raw, and every projecting search and solve goes through the
KB8 projection (K3's gates see KB8 pixels; K4, K6, K20 and K22 take the
camera as a template parameter); relocalization unprojects the keypoints to
unit bearings and runs MLPnP (K25) in place of K10.  The two-view
initialisation and the triangulation program keep the pinhole K on raw
fisheye pixels, as the JAX package does (ROADMAP C.2).  A fisheye stereo
rig (``camera2`` and ``T_lr`` with sensor "stereo" or "imu-stereo",
``track_stereo``): both images are extracted, the lapping keypoints matched
and triangulated (K26, ``frontend/stereo.compute_stereo_fisheye_matches``),
and each matched keypoint keeps its depth and its triangulated point
(``Frame.p3d_stereo``), from which stereo initialisation and keyframes make
map points; the residuals stay monocular (no right-image u), and every rig
frame takes the legacy path (the JAX tracker never fuses one).

Monocular-inertial (``sensor="imu-monocular"`` with an ``IMUConfig``):
frames carry their preintegration from the last frame and the last
keyframe (K19, ``slam/imu_frontend.py``); before the IMU is initialised
keyframes come at >= 4 Hz and tracking is visual; the staged
initialisation (InitializeIMU at 2 s, VIBA1 at 5 s, VIBA2 at 15 s: K21,
then the full visual-inertial BA K20) rotates and rescales the map to
metric gravity-aligned coordinates; afterwards frames are predicted by the
IMU (PredictStateIMU), solved with the inertial edge (K22), keyframe
events run the local inertial BA (K20), and the fused step runs the IMU
prediction and the joint last-frame solve with its marginalisation prior.
Stereo-inertial (``sensor="imu-stereo"``, ``track_stereo(l, r, ts,
imu=...)``) starts from the first stereo frame, initialises the IMU after
1 s with the scale fixed, and tracks every frame after it through the
legacy inertial solve (the JAX module's fused step is monocular-inertial
only).  On an inertial map the loop closer takes the 4-DoF essential graph
(K23), the inertial global BA and the inertial weld.

With a vocabulary the KB8 camera goes through place recognition, loop
closing (K12 and K14 through ``CamKB8``), Atlas merging and BoW
relocalization (K25) as the pinhole does.

Not in this slice, and raising ``NotImplementedError``: imu-rgbd (the JAX
package has no such entry point), the KB8 camera with RGB-D or on a stereo
sensor without ``camera2``, ``camera2`` with a pinhole first camera (the
JAX tracker ignores it; all three ROADMAP A.12.5) and ``octree="host"``
(not ported: it is the JAX package's oracle).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import SLAMConfig
from ..core.camera import KannalaBrandt8, camera_from_config, undistort_points_pinhole
from ..frontend import matcher as fm
from ..frontend import stereo as fstereo
from ..frontend.extractor import Features, ORBExtractor
from ..geometry import two_view as tv
from ..solver import pnp
from ..solver import pose_opt as spo
from ..imu import preintegration as pre
from ..imu.calib import ImuCalib
from ..solver import inertial as sin
from ..utils.packed_fetch import pack_fetch
from . import imu_frontend, local_mapping
from . import track_device as td
from .loop_closing import LoopCloser, decode_dbid, encode_dbid
from .map import INVALID, Atlas, KeyFrame, SLAMMap


def _img(a: np.ndarray) -> torch.Tensor:
    """An image (or depth map) as a host tensor; the step or extractor
    moves it to its device."""
    return torch.from_numpy(np.ascontiguousarray(a))


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    feats: Features            # device
    xy_un: np.ndarray          # (N,2) undistorted (host)
    octave: np.ndarray
    angle: np.ndarray
    desc: np.ndarray
    valid: np.ndarray
    kp_mp: np.ndarray          # (N,) associated map point or -1
    R: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    # stereo/RGB-D channels (reference mvuRight/mvDepth); None for mono
    ur: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    # fisheye rig: each keypoint's triangulated point in left-camera
    # coordinates (reference mvStereo3Dpoints); None for rectified rigs
    p3d_stereo: Optional[np.ndarray] = None
    # inertial state (reference Frame mVw / mImuBias / mpImuPreintegratedFrame)
    v: Optional[np.ndarray] = None
    bg: Optional[np.ndarray] = None
    ba: Optional[np.ndarray] = None
    preint_frame: Optional[object] = None   # from the previous frame (host)
    preint_kf: Optional[object] = None      # from the last keyframe (host)
    # device-resident copies for the fused step: undistorted coords,
    # associations and the stereo channels stay on the device between
    # frames; host copies are fetched on demand
    un_dev: Optional[torch.Tensor] = None
    kp_mp_dev: Optional[torch.Tensor] = None
    ur_dev: Optional[torch.Tensor] = None
    depth_dev: Optional[torch.Tensor] = None
    p3d_dev: Optional[torch.Tensor] = None
    kp_mp_dirty: bool = False               # host kp_mp modified since fetch
    host_ready: bool = True

    def host_handles(self):
        """Device tensors of the feature arrays, in ``set_host`` order;
        stereo frames append their ur/depth channels, fisheye rig frames
        their depth and triangulated points."""
        un = self.un_dev if self.un_dev is not None else self.feats.xy
        base = (un, self.feats.octave, self.feats.angle, self.feats.desc, self.feats.valid)
        if self.ur_dev is not None:
            return base + (self.ur_dev, self.depth_dev)
        if self.p3d_dev is not None:
            return base + (self.depth_dev, self.p3d_dev)
        return base

    def set_host(self, vals):
        """Install already-fetched host copies (host_handles order)."""
        xy_un, octave, angle, desc, valid = vals[:5]
        self.xy_un = np.asarray(xy_un, np.float32)
        self.octave = np.asarray(octave)
        self.angle = np.asarray(angle)
        self.desc = np.asarray(desc)
        self.valid = np.asarray(valid)
        if len(vals) > 5 and self.p3d_dev is not None:
            self.depth = np.asarray(vals[5], np.float32)
            self.p3d_stereo = np.asarray(vals[6], np.float32)
        elif len(vals) > 5:
            self.ur = np.asarray(vals[5], np.float32)
            self.depth = np.asarray(vals[6], np.float32)
        self.host_ready = True

    def ensure_host(self):
        """Materialise the host copies of the feature arrays (one packed
        fetch); no-op for frames that have them."""
        if self.host_ready:
            return
        fetch_kp = self.kp_mp is None and self.kp_mp_dev is not None
        handles = self.host_handles()
        n_base = len(handles)
        if fetch_kp:
            handles = handles + (self.kp_mp_dev,)
        vals = pack_fetch(handles)
        self.set_host(vals[:n_base])
        if fetch_kp:
            self.kp_mp = np.asarray(vals[n_base]).copy()


@dataclasses.dataclass
class _PipeEntry:
    """One dispatched fused frame: the step's outputs plus what the
    confirmation needs to commit it."""
    frame: Frame
    out: object                # track_device.FusedOut (device tensors)
    ts: float
    prev_frame: Frame          # chain predecessor (for the velocity)
    blk_ids: np.ndarray        # local-block ids used at dispatch


INERTIAL_SENSORS = ("imu-monocular", "imu-stereo")


def _unported(cfg: SLAMConfig) -> Optional[str]:
    if cfg.sensor == "imu-rgbd":
        return ("sensor 'imu-rgbd': the JAX package has no such entry point (its track_rgbd "
                "takes no IMU measurements), so the port has none")
    if cfg.sensor not in ("monocular", "stereo", "rgbd") + INERTIAL_SENSORS:
        return (f"sensor {cfg.sensor!r}: only 'monocular', 'stereo', 'rgbd', 'imu-monocular' "
                "and 'imu-stereo' are ported")
    if cfg.sensor in INERTIAL_SENSORS and cfg.imu is None:
        return f"sensor {cfg.sensor!r} needs an IMUConfig (cfg.imu)"
    if cfg.imu is not None and cfg.sensor not in INERTIAL_SENSORS:
        return (f"an IMU with sensor {cfg.sensor!r}: pass sensor='imu-monocular' or "
                "'imu-stereo'")
    rig = cfg.sensor in ("stereo", "imu-stereo")
    if cfg.camera.model == "KannalaBrandt8":
        if cfg.sensor == "rgbd":
            return ("the KannalaBrandt8 camera with sensor 'rgbd' is not ported (ROADMAP A.12.5: "
                    "the JAX package's RGB-D frame unprojects through the pinhole K)")
        if rig and cfg.camera2 is None:
            return (f"the KannalaBrandt8 camera with sensor {cfg.sensor!r} needs camera2 and "
                    "T_lr, the fisheye rig (ROADMAP A.12.5: a rectified KB8 pair is not ported)")
    elif rig and cfg.camera2 is not None:
        return ("camera2 with a pinhole first camera: the JAX tracker ignores it and runs the "
                "rectified rig (ROADMAP A.12.5; the fisheye rig of A.12.4 needs "
                "model='KannalaBrandt8'); pass camera2=None")
    if cfg.orb.octree != "device":
        return "octree='host' is not ported (ROADMAP: 'Not to be ported'; the JAX oracle)"
    return None


class Tracker:
    def __init__(self, cfg: SLAMConfig, vocab=None, device=None):
        why = _unported(cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.device = kernels.resolve_device(device, "the tracker")
        cam_cfg = cfg.camera
        # the camera every projecting search and solve goes through; a KB8
        # camera's keypoints stay raw (reference mvKeysUn == mvKeys), so only
        # a distorted pinhole undistorts
        self.cam = camera_from_config(cam_cfg)
        self.is_fisheye = isinstance(self.cam, KannalaBrandt8)
        # the fisheye rig (reference Tracking::ParseCamParamFile's KB8
        # two-camera branch): the right camera and p_right = R_rl p_left + t_rl
        self.cam_r = None
        self.R_rl = self.t_rl = None
        if cfg.camera2 is not None and self.is_fisheye:
            self.cam_r = KannalaBrandt8.from_config(cfg.camera2)
            T = (np.asarray(cfg.T_lr, np.float32).reshape(4, 4) if cfg.T_lr is not None
                 else np.eye(4, dtype=np.float32))
            R_lr, t_lr = T[:3, :3], T[:3, 3]
            self.R_rl = R_lr.T.copy()
            self.t_rl = (-R_lr.T @ t_lr).astype(np.float32)
        self.dist = (cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3)
        self.has_dist = abs(cam_cfg.k1) > 1e-12 and not self.is_fisheye
        fx, fy, cx, cy = cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.img_wh = (float(cam_cfg.width), float(cam_cfg.height))
        self._init_orb = dataclasses.replace(cfg.orb, n_features=5 * cfg.orb.n_features)
        self._extractors = {}      # (init, image shape) -> ORBExtractor
        scales = td.scale_factors(cfg.orb)
        self.scale_factors = tuple(float(s) for s in scales)
        sig = [s * s for s in self.scale_factors]
        self.sigma2 = tuple(sig)
        self.inv_sigma2 = tuple(1.0 / v for v in sig)
        # stereo/RGB-D geometry (reference Camera.bf, ThDepth: mThDepth =
        # mbf * ThDepth / fx) and the thFarPoints gate on point creation
        self.bf = float(cam_cfg.bf)
        self.baseline = self.bf / fx if self.bf > 0 else 0.0
        self.th_depth = self.bf * float(cam_cfg.th_depth) / fx if self.bf > 0 else 0.0
        self.th_far_points = float(cam_cfg.th_far_points)

        self.state = TrackState.NO_IMAGES_YET
        self.atlas = Atlas()
        # counts of the device work the tracker dispatched: "two_view"
        # (init attempts), "ba" (solves), "tri_groups" (triangulation
        # launches), "stereo_match" (stereo matches of a pair), "pnp"
        # (RANSAC PnP calls); "reloc" counts relocalization attempts and
        # "reloc_ok" the ones that brought tracking back to OK
        self.stats: collections.Counter = collections.Counter()
        self.local_mapper = local_mapping.LocalMapper(
            self.cam, self.scale_factors, self.inv_sigma2, self.K, self.device, self.stats)
        # place recognition, loop closing and Atlas merging (a no-op
        # without a vocabulary); a culled keyframe leaves the database
        self.loop_closer = LoopCloser(
            vocab, self.cam, scale_factors=self.scale_factors,
            img_wh=(cam_cfg.width, cam_cfg.height), inv_sigma2=self.inv_sigma2,
            fix_scale=cfg.sensor in ("stereo", "rgbd"), device=self.device, stats=self.stats)
        if self.loop_closer.db is not None:
            self.local_mapper.on_kf_removed = lambda m, k: self.loop_closer.db.erase(
                encode_dbid(m.mid, k))
        self._next_frame_id = 0
        self.init_frame: Optional[Frame] = None
        self.prev_matched: Optional[np.ndarray] = None
        self.last_frame: Optional[Frame] = None
        self.ref_kf: Optional[int] = None
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_kf_frame_id = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        # each frame pose relative to its reference keyframe: (ts, map mid,
        # kf_id, R_rel, t_rel), kf_id -1 for an absolute pose
        self.traj_rel: List[Tuple[float, int, int, np.ndarray, np.ndarray]] = []
        # first trajectory index in the current Atlas map's coordinates
        self._map_traj_start = 0
        self._rng = np.random.default_rng(0)
        self._frames_lost = 0
        self._lost_ts = 0.0       # timestamp of the OK -> RECENTLY_LOST drop

        # fused device tracking step
        self._mirror = td.MapMirror(self.device)
        self._fused_local = None   # (key, LocalBlock) cache
        self._ref_blk = None       # (key, device ref-KF block) cache
        self._ref_tracked_cache = None
        self._pipe: List[_PipeEntry] = []
        # (last_frame_id, R, t) of the frame BEFORE last_frame
        self._prev_pose = None
        # first frame id whose dispatch could see the latest keyframe's
        # triangulated points (set when deferred results land)
        self._pts_fresh_fid = 0
        self.local_mapper.on_tf_applied = (
            lambda: setattr(self, "_pts_fresh_fid", self._next_frame_id))
        self._fused_local_cap = 4096
        self.n_fused_frames = 0   # frames on the fused path
        # the step's CUDA graph (None: TrackStep's default, the graph for a
        # visual step on a card; False keeps the eager launches)
        self.step_graph: Optional[bool] = None

        # inertial mode (reference sensors IMU_MONOCULAR, IMU_STEREO)
        self.inertial = cfg.sensor in INERTIAL_SENSORS
        self.imu_calib: Optional[ImuCalib] = None
        self.imu_queue: Optional[imu_frontend.ImuQueue] = None
        self.last_kf_ts: Optional[float] = None
        self.first_kf_ts: Optional[float] = None
        self.cur_bias = np.zeros(6, np.float32)   # (bg, ba) carried forward
        self._prev_kf_id = -1     # temporal predecessor of the IMU chain
        # (frame_id, (mid, version), (H15, state)): the ConstraintPoseImu of the
        # last inertially solved frame (reference mpcpi)
        self._marg_prior = None
        self._eye_prior = None    # the fused step's prior without one: 1e4 I on the device
        self._vi_stage_fired = False
        if self.inertial:
            self.imu_calib = ImuCalib.from_config(cfg.imu)
            self.imu_queue = imu_frontend.ImuQueue(self.imu_calib, self.device, self.stats)
            self.local_mapper.imu_calib = self.imu_calib
            self.loop_closer.imu_calib = self.imu_calib

    # ------------------------------------------------------------ frames

    def _extractor(self, shape, init: bool) -> ORBExtractor:
        key = (init, tuple(shape))
        ext = self._extractors.get(key)
        if ext is None:
            ext = ORBExtractor(self._init_orb if init else self.cfg.orb, tuple(shape), self.device)
            self._extractors[key] = ext
        return ext

    def _make_frame(self, img: np.ndarray, ts: float, init: bool = False,
                    lazy: bool = False) -> Frame:
        return self._frame(self._extractor(img.shape, init)(_img(img)), ts, lazy)

    def _make_frame_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float) -> Frame:
        """Stereo Frame ctor (reference src/Frame.cc:88): extract both
        images, then ComputeStereoMatches on the extractor's pyramids
        (K9); one packed fetch lands the host copies with ur/depth.  On a
        fisheye rig: the lapping keypoints matched and triangulated (K26,
        reference ComputeStereoFishEyeMatches, Frame.cc:1139), the host
        copies landing with the depths and points."""
        if self.cam_r is not None:
            return self._make_frame_rig(img_l, img_r, ts)
        feats, res = fstereo.match_pair(self._extractor(img_l.shape, False), _img(img_l),
                                        _img(img_r), self.bf, self.baseline)
        self.stats["stereo_match"] += 1
        frame = self._frame(feats, ts, lazy=True)
        frame.ur_dev, frame.depth_dev = res.u_right, res.depth
        frame.ensure_host()
        return frame

    def _make_frame_rig(self, img_l: np.ndarray, img_r: np.ndarray, ts: float) -> Frame:
        ext = self._extractor(img_l.shape, False)
        feats, feats_r = ext(_img(img_l)), ext(_img(img_r))
        band = lambda c: (c.lapping_begin if c.lapping_begin >= 0 else 0.0,
                          c.lapping_end if c.lapping_end >= 0 else float(c.width))
        lap_l = fstereo.lapping_mask(feats.xy, *band(self.cfg.camera), feats.valid)
        lap_r = fstereo.lapping_mask(feats_r.xy, *band(self.cfg.camera2), feats_r.valid)
        res = fstereo.compute_stereo_fisheye_matches(
            self.cam, self.cam_r, feats.xy, feats.octave, feats.desc, lap_l, feats_r.xy,
            feats_r.octave, feats_r.desc, lap_r, self.R_rl, self.t_rl, self.sigma2)
        self.stats["stereo_match"] += 1
        frame = self._frame(feats, ts, lazy=True)
        frame.depth_dev, frame.p3d_dev = res.depth, res.p3d
        frame.ensure_host()
        return frame

    def _make_frame_rgbd(self, img: np.ndarray, depthmap: np.ndarray, ts: float) -> Frame:
        """RGB-D Frame ctor (reference src/Frame.cc:191 +
        ComputeStereoFromRGBD :994): depth sampled at the raw keypoint
        coordinates, virtual right coordinate uR = u_un - bf / d."""
        frame = self._frame(self._extractor(img.shape, False)(_img(img)), ts, lazy=True)
        frame.ur_dev, frame.depth_dev = td.rgbd_right_coords(
            frame.feats.xy, frame.un_dev, frame.feats.valid,
            self._t(np.asarray(depthmap, np.float32)), self.bf)
        frame.ensure_host()
        return frame

    def _frame(self, feats: Features, ts: float, lazy: bool = False) -> Frame:
        un_dev = (undistort_points_pinhole(feats.xy, self.cam, self.dist)
                  if self.has_dist else feats.xy)
        f = Frame(
            frame_id=self._next_frame_id, timestamp=ts, feats=feats,
            xy_un=None, octave=None, angle=None, desc=None, valid=None,
            kp_mp=np.full(feats.valid.shape[0], INVALID, np.int32),
            un_dev=un_dev, host_ready=False,
        )
        self._next_frame_id += 1
        if not lazy:
            f.ensure_host()
        return f

    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array on the tracker's device, its shape kept (a 0-dim
        array stays 0-dim: the preintegration's dT)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(np.shape(a))
        return t.to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------- entry

    def grab_imu(self, measurements):
        """Reference Tracking::GrabImuData (src/Tracking.cc:1111):
        measurements are (t, acc(3,), gyro(3,)) tuples."""
        if self.imu_queue is not None and measurements is not None:
            self.imu_queue.extend(measurements)

    def _preintegrate(self, frame: Frame):
        """Reference Tracking::PreintegrateIMU (src/Tracking.cc:1117): the
        queue over (last frame, frame] and (last keyframe, frame] with the
        current bias, both windows in one K19 launch and one packed fetch."""
        if not self.inertial or self.last_frame is None:
            return
        q = self.imu_queue
        wins = [q.raw_window(self.last_frame.timestamp, frame.timestamp),
                q.raw_window(self.last_kf_ts, frame.timestamp)
                if self.last_kf_ts is not None else None]
        have = [w for w in wins if w is not None]
        if not have:
            return
        res = imu_frontend.to_host(imu_frontend.integrate_raw_batch(
            have, [self.cur_bias] * len(have), self.imu_calib, self.device, self.stats))
        out = iter(range(len(have)))
        p = [None if w is None else pre.index(res, next(out)) for w in wins]
        frame.preint_frame, frame.preint_kf = p

    def _check_timestamps(self, ts: float) -> bool:
        """Clock-sanity guards (reference Tracking.cc:1415-1451): a
        timestamp regression starts a fresh Atlas map (and clears the IMU
        queue) and drops the frame; for inertial runs a jump of more than
        one second resets the active map, or starts a new one once the IMU
        is fully initialised, and drops the frame; visual-only runs process
        a jump normally."""
        if self.state == TrackState.NO_IMAGES_YET or self.last_frame is None:
            return False
        last_ts = self.last_frame.timestamp
        if last_ts > ts:
            if self.inertial:
                self.imu_queue.drop_before(float("inf"))
            self._reset_map()
            return True
        if ts > last_ts + 1.0 and self.inertial:
            mp = self.atlas.current
            if mp.imu_initialized and mp.imu_ba2:
                self._reset_map()
            else:
                self._reset_active_map()
            return True
        return False

    def _reset_active_map(self):
        """System::ResetActiveMap (src/System.cc:441): discard the current
        map's contents and restart in place."""
        old_mid = self.atlas.current.mid
        self._reset_map()
        self.atlas.remove_map(old_mid)

    def track(self, img: np.ndarray, ts: float, imu=None):
        """GrabImageMonocular + Track (reference Tracking.cc:1038, :1390);
        ``imu`` is the list of (t, acc, gyro) measurements since the
        previous frame (inertial sensor)."""
        self.grab_imu(imu)
        if self._check_timestamps(ts):
            return self.state
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._monocular_initialization(img, ts)
            return self.state
        if self._fused_applicable():
            st = self._track_fused(img, ts)
            if st is not None:
                return st
        # leaving the fused fast path: settle any dispatched frames first
        self._confirm_pipe()
        frame = self._make_frame(img, ts)
        self._preintegrate(frame)
        return self._track_existing(frame, ts)

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float, imu=None):
        """GrabImageStereo + Track (reference Tracking.cc, System.cc:222);
        the pair must be rectified.  ``imu``: the (t, acc, gyro)
        measurements since the previous frame (sensor imu-stereo)."""
        self.grab_imu(imu)
        return self._track_depth(img_l, img_r, ts, "stereo", self._make_frame_stereo)

    def track_rgbd(self, img: np.ndarray, depthmap: np.ndarray, ts: float):
        """GrabImageRGBD + Track (reference System.cc:288); depthmap is
        metric depth, 0 or negative where unknown."""
        return self._track_depth(img, np.asarray(depthmap, np.float32), ts, "rgbd",
                                 self._make_frame_rgbd)

    def _track_depth(self, img: np.ndarray, second: np.ndarray, ts: float, depth_mode: str,
                     make_frame):
        """Track for a depth sensor: the fused step when it applies, else
        the frame from ``make_frame(img, second, ts)`` through stereo
        initialization or the legacy state machine."""
        if self.bf <= 0:
            raise ValueError(f"track_{depth_mode} needs Camera.bf (fx * baseline) > 0 "
                             "in the config")
        if self._check_timestamps(ts):
            return self.state
        if self._fused_applicable():
            st = self._track_fused(img, ts, img_r=second, depth_mode=depth_mode)
            if st is not None:
                return st
        self._confirm_pipe()
        frame = make_frame(img, second, ts)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._stereo_initialization(frame)
            return self.state
        self._preintegrate(frame)
        return self._track_existing(frame, ts)

    # --------------------------------------------------- fused fast path

    def _fused_applicable(self) -> bool:
        """The fused step covers the steady state: OK with a motion model
        and the previous frame device-resident.  The previous frame's
        capacity may differ (the first frame after initialisation chains
        from the 5x init extractor's arrays).  The inertial step engages once
        the IMU is initialised and the previous frame has a velocity, for
        imu-monocular only (the JAX module's rule): imu-stereo frames take
        the legacy inertial solve."""
        last = self.last_frame
        common = (
            self.cfg.tracking.use_fused
            and self.state == TrackState.OK
            and last is not None
            and (last.R is not None or bool(self._pipe))
            and last.un_dev is not None
        )
        if self.inertial:
            return (common and self.cfg.sensor == "imu-monocular"
                    and self.atlas.current.imu_initialized
                    and (last.v is not None or bool(self._pipe)))
        # the JAX rule: a fisheye rig frame is never fused
        return common and self.velocity is not None and self.cam_r is None

    def _track_fused(self, img: np.ndarray, ts: float, img_r: Optional[np.ndarray] = None,
                     depth_mode: str = "none"):
        """One fused step: extract -> motion-model search -> pose opt ->
        local-map search -> pose opt, confirmed by one packed fetch.
        ``img_r`` is the right image (depth_mode "stereo") or the depth
        map ("rgbd").  Returns the new state, or None to take the legacy
        path before any work was done."""
        mp = self.atlas.current
        if self.ref_kf is None:
            return None
        if self.ref_kf not in mp.keyframes:  # culled by local mapping
            if not mp.keyframes:
                return None
            self.ref_kf = max(mp.keyframes.keys())
        self._mirror.sync(mp)
        key = (mp.mid, mp.version, self.ref_kf)
        if self._fused_local is None or self._fused_local[0] != key:
            local_kfs = [self.ref_kf] + [
                k for k, _ in mp.covisible_keyframes(self.ref_kf, min_weight=1)[:10]]
            blk = td.build_local_block(mp, local_kfs, self._fused_local_cap, self.device)
            if blk is None:
                return None
            self._fused_local = (key, blk)
        blk = self._fused_local[1]
        imu_in = noise = None
        last = self.last_frame   # the pipe's tail while frames are in flight
        f32 = lambda a: self._t(np.asarray(a, np.float32))
        if self.inertial:
            # the window (last frame, this frame], integrated in the step with
            # the current bias, rides in one host record with the previous
            # state (from the pipe tail's outputs while chaining) and the
            # extrinsics; the prior is on the device
            win = self.imu_queue.raw_window(last.timestamp, ts)
            if win is None:
                return None  # no IMU coverage: legacy path
            calib = self.imu_calib
            if self._pipe:
                tail = self._pipe[-1].out
                prev, H_in = (tail.v, tail.bg, tail.ba), tail.H15
                state = (np.zeros(3, np.float32),) * 3
            else:
                prev = None
                state = (last.v, last.bg if last.bg is not None else self.cur_bias[:3],
                         last.ba if last.ba is not None else self.cur_bias[3:])
                mh = self._marg_prior
                # the JAX package reuses the prior after checking the frame
                # id only, not the map version (ROADMAP C, matched reference
                # fault)
                if mh is not None and mh[0] == last.frame_id:
                    H_in = mh[2][0]
                    self.stats["fused_prior"] += 1
                else:
                    if self._eye_prior is None:
                        self._eye_prior = torch.eye(15, dtype=torch.float32,
                                                    device=self.device) * 1e4
                    H_in = self._eye_prior
            rec = td.imu_record(win, self.cur_bias, *state, calib.Rcb, calib.tcb,
                                pin=self.device.type == "cuda")
            imu_in = td.StepImu(rec, H_in, prev)
            # the step's K19 launch, and its joint solve (K22)
            self.stats["preint"] += 1
            self.stats["fused_inertial"] += 1
            noise = (calib.noise_gyro, calib.noise_acc, calib.walk_gyro, calib.walk_acc)
        step = td.get_track_step(self.cfg.camera, self.cfg.orb, img.shape, self._mirror.cap,
                                 self._fused_local_cap, self.device, depth_mode=depth_mode,
                                 inertial=self.inertial, graph=self.step_graph,
                                 imu_noise=noise)
        ref_desc, ref_valid, ref_kp = self._ref_block(mp)
        if self._pipe:
            # chaining: the pose inputs are the in-flight steps' outputs
            tail = self._pipe[-1]
            R_last, t_last = tail.out.R, tail.out.t
            if len(self._pipe) >= 2:
                R_prev, t_prev = self._pipe[-2].out.R, self._pipe[-2].out.t
            else:
                R_prev, t_prev = f32(tail.prev_frame.R), f32(tail.prev_frame.t)
        else:
            R1, t1 = last.R, last.t
            if self.inertial:
                Rp, tp = R1, t1   # the IMU prediction ignores the velocity inputs
            elif self._prev_pose is not None and self._prev_pose[0] == last.frame_id:
                # the actual predecessor pose: the in-step velocity
                # R_last R_prev^T then matches the host formula exactly
                _, Rp, tp = self._prev_pose
            else:
                Rv, tv_ = self.velocity
                Rp = (Rv.T @ R1).astype(np.float32)
                tp = (Rv.T @ (t1 - tv_)).astype(np.float32)
            R_last, t_last, R_prev, t_prev = f32(R1), f32(t1), f32(Rp), f32(tp)
        last_kp = (last.kp_mp_dev if last.kp_mp_dev is not None and not last.kp_mp_dirty
                   else self._t(last.kp_mp.astype(np.int32)))
        out = step(
            _img(img),
            last.un_dev, last.feats.desc, last.feats.octave, last.feats.angle, last_kp,
            self._mirror.pos, self._mirror.valid,
            blk.ids, blk.pos, blk.desc, blk.norm, blk.maxd, blk.val,
            ref_desc, ref_valid, ref_kp,
            R_last, t_last, R_prev, t_prev,
            img_r=None if img_r is None else _img(img_r), imu=imu_in,
        )
        self.stats["stereo_match"] += depth_mode == "stereo"
        self.n_fused_frames += 1
        frame = Frame(
            frame_id=self._next_frame_id, timestamp=ts, feats=out.feats,
            xy_un=None, octave=None, angle=None, desc=None, valid=None,
            kp_mp=None, un_dev=out.xy_un, kp_mp_dev=out.kp_mp, host_ready=False,
            ur_dev=out.ur, depth_dev=out.depth,
        )
        self._next_frame_id += 1
        self._pipe.append(_PipeEntry(frame=frame, out=out, ts=ts, prev_frame=last,
                                     blk_ids=blk.ids_host))
        # optimistic: an in-flight frame reports OK; its confirmation
        # corrects the state and the trajectory, replaying it through the
        # legacy path when it fails a gate
        self.last_frame = frame
        self.state = TrackState.OK
        depth = self.cfg.tracking.pipeline_depth
        if len(self._pipe) > depth:
            # the newest frames (at most 2) keep computing on the card
            # while the host confirms the older ones
            self._confirm_pipe(keep=min(2, depth - 1))
        return self.state

    def _ref_block(self, mp: SLAMMap):
        """Device block of the reference keyframe's map-point-bearing
        keypoints (descriptors + map-point ids) for the in-step
        TrackReferenceKeyFrame fallback; cached per (map version, ref_kf)."""
        key = (mp.mid, mp.version, self.ref_kf)
        if self._ref_blk is not None and self._ref_blk[0] == key:
            return self._ref_blk[1]
        kf = mp.keyframes[self.ref_kf]
        N = self.cfg.orb.n_features + self.cfg.orb.n_levels * 16
        desc = np.zeros((N, 32), np.uint8)
        valid = np.zeros((N,), bool)
        kp_mp_arr = np.full((N,), -1, np.int32)
        idx = np.where(kf.valid & (kf.kp_mp >= 0))[0][:N]
        k = len(idx)
        if k:
            desc[:k] = kf.desc[idx]
            mpids = kf.kp_mp[idx]
            live = mp.mp_valid[mpids]
            valid[:k] = live
            kp_mp_arr[:k] = np.where(live, mpids, -1)
        blk = (self._t(desc), self._t(valid), self._t(kp_mp_arr))
        self._ref_blk = (key, blk)
        return blk

    def flush(self):
        """Settle dispatched frames (states, trajectory, keyframe
        decisions), the deferred triangulation and fuse, the in-flight
        window BA and the loop closer's in-flight global or welding BA."""
        self._confirm_pipe()
        self.local_mapper.flush_tf(self.atlas.current)
        self.local_mapper.flush_ba(self.atlas.current)
        self.loop_closer.finish(self.atlas.current)

    def _confirm_pipe(self, keep: int = 0):
        """One packed fetch confirms the dispatched frames: gates,
        velocity/trajectory commits, keyframe decisions.  A frame that
        fails its gates, and every frame after a keyframe whose loop
        closure, merge or IMU stage rewrote the map poses, is replayed
        through the legacy state machine.  The in-flight window BA and the
        deferred triangulation and fuse results ride the same fetch.

        ``keep`` leaves that many of the newest frames in flight, so the
        fetch waits only for work dispatched ``keep`` frames ago while the
        card computes the chain's tail."""
        if not self._pipe:
            self.local_mapper.flush_tf(self.atlas.current)
            return
        keep = min(keep, len(self._pipe) - 1)
        n_confirm = len(self._pipe) - keep
        pending, self._pipe = self._pipe[:n_confirm], self._pipe[n_confirm:]
        tf_handles = self.local_mapper.pending_tf_handles()
        # kp_mp + lm_searched ride along for every entry: the found/visible
        # counters must tick every frame (MapPointCulling's probation);
        # stereo/RGB-D steps add their device-counted close points
        payload = [
            [e.out.R, e.out.t, e.out.n_match_motion, e.out.n_inl_motion, e.out.n_inl_final,
             e.out.used_ref, e.out.n_pre, e.out.kp_mp, e.out.lm_searched]
            + ([] if e.out.n_close_tracked is None
               else [e.out.n_close_tracked, e.out.n_close_untracked])
            + ([] if e.out.v is None else [e.out.v, e.out.bg, e.out.ba])
            for e in pending
        ]
        n_gate = len(payload)
        ba_handles = self.local_mapper.pending_ba_handles()
        if ba_handles:
            payload.append(ba_handles)
        if tf_handles:
            payload.append(tf_handles)
        # the cadence keyframe trigger is known from frame ids: prefetch
        # that frame's feature host copies on the same fetch
        spec_idx = None
        for i, e in enumerate(pending):
            if e.frame.frame_id >= self.last_kf_frame_id + self.cfg.tracking.max_frames:
                spec_idx = i
                break
        if spec_idx is not None:
            payload.append(pending[spec_idx].frame.host_handles())
        fetched = pack_fetch(payload)
        extra = n_gate
        if ba_handles:
            # the older result first: the window BA predates the deferred
            # triangulation and fuse of the newest keyframe
            self.local_mapper.apply_ba_fetched(self.atlas.current, fetched[extra])
            extra += 1
        spec_vals = fetched[extra + bool(tf_handles)] if spec_idx is not None else None
        if tf_handles:
            self.local_mapper.apply_tf(self.atlas.current, fetched[extra])
        kf_created = False
        for i, (e, vals) in enumerate(zip(pending, fetched[:n_gate])):
            R, t, n_match, n1, n2, used_ref, n_pre, kp_mp_h, lm_searched = vals[:9]
            frame = e.frame
            # motion-model gates (reference Tracking.cc:2475-2528) or the
            # in-step TrackReferenceKeyFrame fallback's (>=10 inliers,
            # :2308); TrackLocalMap then needs >=30 final inliers (:2612),
            # 15 with the inertial edge
            min_final = 15 if self.inertial else 30
            ok = int(n2) >= min_final and (
                (int(n_match) >= 20 and int(n1) >= 10) or (bool(used_ref) and int(n_pre) >= 10))
            if not ok:
                rest, self._pipe = pending[i:] + self._pipe, []
                self._replay(rest)
                return
            frame.R = np.asarray(R).copy()
            frame.t = np.asarray(t).copy()
            if e.out.v is not None:
                frame.v, frame.bg, frame.ba = (np.asarray(a).copy() for a in vals[-3:])
                self.cur_bias = np.concatenate([frame.bg, frame.ba]).astype(np.float32)
            self.state = TrackState.OK
            self._frames_lost = 0
            prev = e.prev_frame
            Rv = frame.R @ prev.R.T
            self.velocity = (Rv, frame.t - Rv @ prev.t)
            self._prev_pose = (frame.frame_id, prev.R.copy(), prev.t.copy())
            mp = self.atlas.current
            # per-frame found/visible bookkeeping (IncreaseVisible/Found)
            frame.kp_mp = np.asarray(kp_mp_h).copy()
            ids = e.blk_ids[np.asarray(lm_searched)]
            ids = ids[ids < len(mp.mp_visible)]
            mp.mp_visible[ids] += 1
            found = frame.kp_mp[frame.kp_mp >= 0]
            found = found[found < len(mp.mp_found)]
            mp.mp_found[found] += 1
            # at most one keyframe per confirmation batch (the later frames
            # were tracked against the map before it); stereo frames pass
            # their device-counted close points
            close_counts = ((int(vals[9]), int(vals[10])) if e.out.n_close_tracked is not None
                            else None)
            if not kf_created and self._need_new_keyframe(frame, tracked=int(n2),
                                                          close_counts=close_counts):
                kf_created = True
                vals = spec_vals if i == spec_idx else pack_fetch(frame.host_handles())
                frame.set_host(vals)
                self._create_keyframe(frame)
                stale = self.velocity is None or self._vi_stage_fired
                self._vi_stage_fired = False
                if stale and (i + 1 < len(pending) or self._pipe):
                    # a loop closure, merge or IMU stage rewrote the map
                    # poses: the frames after it were predicted in the old
                    # frame of reference
                    rest, self._pipe = pending[i + 1:] + self._pipe, []
                    self._replay(rest)
                    return
            self._record_traj(e.ts, frame.R, frame.t)
            if i == len(pending) - 1 and not self._pipe:
                self.last_frame = frame

    def _replay(self, entries):
        """Re-run dispatched frames through the legacy state machine
        (reference falls back to TrackReferenceKeyFrame / relocalization
        on a failed motion-model track, Tracking.cc:1549)."""
        prev = entries[0].prev_frame
        prev.ensure_host()
        self.last_frame = prev
        for e in entries:
            f = e.frame
            f.ensure_host()
            f.R = f.t = None
            f.kp_mp[:] = INVALID
            f.kp_mp_dirty = True
            self._preintegrate(f)
            self._track_existing(f, e.ts)

    def _track_existing(self, frame: Frame, ts: float):
        """Shared post-initialization state machine (Track(), :1390): a
        LOST frame relocalizes and then tracks the local map (no motion
        model, no keyframe decision); more than five failed LOST frames
        start a new Atlas map (reference Tracking.cc:1607-1625)."""
        if self.state == TrackState.RECENTLY_LOST:
            return self._track_recently_lost(frame, ts)
        if self.state == TrackState.LOST:
            if self._relocalize(frame) and self._track_local_map(frame):
                self.state = TrackState.OK
                self.velocity = None
                self.stats["reloc_ok"] += 1
            else:
                self._frames_lost += 1
                if self._frames_lost > 5:
                    # a map of 10 keyframes or more is kept; a smaller one
                    # is discarded (reference Tracking.cc:1607)
                    failed_mid = self.atlas.current.mid
                    small = len(self.atlas.current.keyframes) < 10
                    self._reset_map()
                    if small:
                        self.atlas.remove_map(failed_mid)
                    self._frames_lost = 0
            self.last_frame = frame
            if frame.R is not None and self.state == TrackState.OK:
                self._record_traj(ts, frame.R, frame.t)
            return self.state
        ok = self._track_frame(frame)
        if ok:
            self.state = TrackState.OK
            self._frames_lost = 0
        else:
            self._enter_lost(ts)
        self.last_frame = frame
        if frame.R is not None and ok:
            self._record_traj(ts, frame.R, frame.t)
        return self.state

    def _enter_lost(self, ts: float):
        """Track-failure transition (reference Tracking.cc:1576-1605): a
        mature map (more than 10 keyframes, and the IMU initialised when
        inertial) holds RECENTLY_LOST from ``ts`` for ``time_recently_lost``
        seconds, a younger one drops to LOST."""
        mp = self.atlas.current
        if len(mp.keyframes) > 10 and (not self.inertial or mp.imu_initialized):
            self.state = TrackState.RECENTLY_LOST
            self._lost_ts = ts
        else:
            self.state = TrackState.LOST

    def _predict_imu(self, frame: Frame):
        """PredictStateIMU (reference Tracking.cc:1230) from the last frame:
        the frame's pose, velocity and the current bias."""
        last = self.last_frame
        Rwb1, twb1 = self.imu_calib.body_from_cam(last.R, last.t)
        Rwb2, twb2, v2 = imu_frontend.predict_state(Rwb1, twb1, last.v, self.cur_bias,
                                                    frame.preint_frame)
        frame.R, frame.t = self.imu_calib.cam_from_body(Rwb2, twb2)
        frame.v = v2
        frame.bg = self.cur_bias[:3].copy()
        frame.ba = self.cur_bias[3:].copy()

    def _track_recently_lost(self, frame: Frame, ts: float):
        """RECENTLY_LOST (reference Tracking.cc:1576-1605): inertial runs keep
        predicting the pose with the IMU while every frame retries
        relocalization; after ``time_recently_lost`` seconds without success
        the state drops to LOST."""
        predicted = self._imu_ready(frame)
        if predicted:
            self._predict_imu(frame)
        pred_Rt = (frame.R, frame.t) if predicted else None
        if self._relocalize(frame) and self._track_local_map(frame):
            self.state = TrackState.OK
            self.velocity = None
            self._frames_lost = 0
            self.stats["reloc_ok"] += 1
            frame.v = None   # the dead-reckoned velocity is stale after relocalization
        else:
            if pred_Rt is not None:
                # failed relocalization attempts leave candidate poses and
                # matches in the frame: restore the IMU prediction
                frame.R, frame.t = pred_Rt
                frame.kp_mp[:] = INVALID
            if ts - self._lost_ts > self.cfg.tracking.time_recently_lost:
                self.state = TrackState.LOST
        self.last_frame = frame
        if frame.R is not None and (self.state == TrackState.OK or predicted):
            self._record_traj(ts, frame.R, frame.t)
        return self.state

    def _reloc_candidates(self, frame: Frame) -> List[int]:
        """DetectRelocalizationCandidates (reference KeyFrameDatabase.cc:783):
        the database's covisibility groups within 0.75x of the best
        accumulated score, this map's keyframes only, at most 5; without a
        vocabulary (or no candidate) the map's three most recent keyframes."""
        mp = self.atlas.current
        db = self.loop_closer.db
        candidates = []
        if db is not None:
            def covis_keys(key):
                m, k = decode_dbid(key)
                target = self.atlas.map_by_mid(m)
                if target is None or k not in target.keyframes:
                    return []
                return [encode_dbid(m, nk) for nk, _ in target.covisible_keyframes(k, 1)[:10]]

            candidates = [k for key, _ in db.query(frame.desc, valid=frame.valid, n_best=5,
                                                   covis_fn=covis_keys, rel_score_ratio=0.75)
                          for m, k in [decode_dbid(key)] if m == mp.mid][:5]
        return candidates or sorted(mp.keyframes.keys())[-3:]

    def _relocalize(self, frame: Frame) -> bool:
        """Relocalization (reference Tracking.cc:3184): the candidates of
        ``_reloc_candidates``.  Each goes through a mutual-best descriptor
        match against its map-point-bearing keypoints (K3), RANSAC PnP on
        the matched points in normalized coordinates (K10, 256 hypotheses,
        3 px / fx) or, with a KB8 camera, MLPnP on unit bearings (K25, 256
        hypotheses, 0.6 degrees, then its refinement on the inliers), the
        candidate's own pose where PnP fails, and the robust pose
        optimisation (K4, with the stereo rows for stereo and RGB-D
        frames); the first candidate with 20 inliers becomes the reference
        keyframe.  One packed fetch per candidate carries PnP's ok, R and
        t."""
        self.stats["reloc"] += 1
        mp = self.atlas.current
        fx, fy = self.K[0, 0], self.K[1, 1]
        for cand in self._reloc_candidates(frame):
            if cand not in mp.keyframes:
                continue
            kf = mp.keyframes[cand]
            m12, _ = fm.mutual_best_match(frame.feats.desc, frame.feats.valid,
                                          self._t(kf.desc), self._t(kf.valid & (kf.kp_mp >= 0)))
            m12 = m12.cpu().numpy()
            mids = np.where(m12 >= 0, kf.kp_mp[np.maximum(m12, 0)], INVALID)
            live = mids >= 0
            live[live] = mp.mp_valid[mids[live]]
            frame.kp_mp[:] = INVALID
            frame.kp_mp[live] = mids[live]
            if live.sum() < 15:
                continue
            p3d = np.zeros((len(frame.kp_mp), 3), np.float32)
            p3d[live] = mp.mp_pos[frame.kp_mp[live]]
            sets = pnp.sample_pnp_sets(frame.frame_id, torch.from_numpy(live)).to(self.device)
            if self.is_fisheye:
                ok, R, t = self._mlpnp(frame, p3d, live, sets)
            else:
                xy_n = (frame.xy_un - self.K[:2, 2]) / np.array([fx, fy], np.float32)
                res = pnp.ransac_pnp(self._t(p3d), self._t(xy_n, torch.float32), self._t(live),
                                     sets, th=float(3.0 / fx), min_inliers=12)
                ok, R, t = pack_fetch([res.ok, res.R, res.t])
            self.stats["pnp"] += 1
            if bool(ok):
                frame.R, frame.t = np.asarray(R).copy(), np.asarray(t).copy()
            else:
                frame.R, frame.t = kf.R.copy(), kf.t.copy()
            if self._pose_opt(frame, min_inliers=20):
                self.ref_kf = cand
                return True
        return False

    def _mlpnp(self, frame: Frame, p3d: np.ndarray, live: np.ndarray, sets):
        """The fisheye branch of relocalization (JAX ``slam/tracking.py:
        1100-1131``): the keypoints unprojected through the KB8 model to
        unit bearings (on the host, as the JAX tracker reads them back),
        MLPnP RANSAC with 12 inliers (K25), and on success K25's
        refinement on the RANSAC inliers with info = inv_sigma2[octave] *
        fx^2.  Returns the packed fetch of (ok, R, t)."""
        bear = self.cam.unproject(torch.from_numpy(np.asarray(frame.xy_un, np.float32))).numpy()
        bear = (bear / np.maximum(np.linalg.norm(bear, axis=1, keepdims=True), 1e-12)
                ).astype(np.float32)
        P, B, V = self._t(p3d), self._t(bear), self._t(live)
        res = pnp.mlpnp_ransac(P, B, V, sets, min_inliers=12)
        fx = float(self.K[0, 0])
        info = np.asarray(self.inv_sigma2, np.float32)[
            np.clip(frame.octave, 0, len(self.inv_sigma2) - 1)] * np.float32(fx * fx)
        R_r, t_r = pnp.mlpnp_refine(res.R, res.t, P, B, self._t(info), V & res.inliers)
        # the refinement is taken only where RANSAC succeeded, decided on
        # the device so one fetch carries it
        R = torch.where(res.ok, R_r, res.R)
        t = torch.where(res.ok, t_r, res.t)
        return pack_fetch([res.ok, R, t])

    # ---------------------------------------------------- initialization

    def _monocular_initialization(self, img, ts):
        """Reference MonocularInitialization (Tracking.cc:2018).  Frames
        are extracted lazily; the window search runs on the device and
        one packed fetch lands the match vector with both frames' host
        copies."""
        frame = self._make_frame(img, ts, init=True, lazy=True)
        n_kps = int(frame.feats.valid.sum())
        if self.init_frame is None or self.state == TrackState.NO_IMAGES_YET:
            if n_kps >= 100:
                self.init_frame = frame
                self.prev_matched = None  # host copy lands on the fetch
                self.state = TrackState.NOT_INITIALIZED
            self.last_frame = frame
            return
        if n_kps <= 100:
            self.init_frame = None
            self.state = TrackState.NO_IMAGES_YET
            self.last_frame = frame
            return

        f1, f2 = self.init_frame, frame
        un1 = f1.un_dev if f1.un_dev is not None else f1.feats.xy
        un2 = f2.un_dev if f2.un_dev is not None else f2.feats.xy
        prev = self._t(self.prev_matched) if self.prev_matched is not None else un1
        m12_dev = fm.search_for_initialization(
            f1.feats.desc, un1, f1.feats.angle, f1.feats.octave, f1.feats.valid,
            f2.feats.desc, un2, f2.feats.angle, f2.feats.octave, f2.feats.valid,
            100, prev,
        )
        fetch = pack_fetch(
            [m12_dev]
            + [list(f1.host_handles()) if not f1.host_ready else []]
            + [list(f2.host_handles()) if not f2.host_ready else []]
        )
        m12 = np.asarray(fetch[0])
        if not f1.host_ready:
            f1.set_host(fetch[1])
        if not f2.host_ready:
            f2.set_host(fetch[2])
        if self.prev_matched is None:
            self.prev_matched = f1.xy_un.copy()
        if (m12 >= 0).sum() < 100:
            self.init_frame = None
            self.state = TrackState.NO_IMAGES_YET
            self.last_frame = frame
            return
        # update prev_matched like the reference
        idx1 = np.where(m12 >= 0)[0]
        self.prev_matched[idx1] = f2.xy_un[m12[idx1]]

        cap = 1024
        sel = idx1[:cap]
        x1 = np.zeros((cap, 2), np.float32)
        x2 = np.zeros((cap, 2), np.float32)
        vmask = np.zeros(cap, bool)
        x1[: len(sel)] = f1.xy_un[sel]
        x2[: len(sel)] = f2.xy_un[m12[sel]]
        vmask[: len(sel)] = True
        sets = tv.sample_sets(int(self._rng.integers(1 << 30)), vmask).to(self.device)
        # H/F with the pinhole K on the keypoints, raw ones for a KB8 camera:
        # the JAX tracker's order (its tracking.py:1220-1229), a matched
        # reference fault (ROADMAP C.2)
        res = tv.reconstruct(sets, self._t(x1), self._t(x2), self._t(vmask),
                             torch.from_numpy(self.K))
        self.stats["two_view"] += 1
        success, R21, t21, tri, pts = pack_fetch(
            [res.success, res.R21, res.t21, res.is_triangulated, res.points3d])
        if not bool(success):
            self.last_frame = frame
            return
        self._create_initial_map(f1, f2, sel, m12, R21, t21, tri, pts)
        self.last_frame = frame

    def _stereo_initialization(self, frame: Frame):
        """Reference StereoInitialization (Tracking.cc:1924): with more
        than 500 keypoints the frame becomes a keyframe at the origin and
        every keypoint with a positive depth (up to thFarPoints) is
        unprojected into a map point; fewer than 100 points reset the map."""
        if int(frame.valid.sum()) <= 500:
            self.last_frame = frame
            return
        mp = self.atlas.current
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        kf = self._promote(frame, mp)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        n_pts = 0
        for i in np.where(frame.valid & (frame.depth > 0))[0]:
            z = float(frame.depth[i])
            if self.th_far_points > 0 and z > self.th_far_points:
                continue
            pos = self._stereo_point(frame, i, z, fx, fy, cx, cy)
            mid = mp.add_point(pos, frame.desc[i], np.zeros(3, np.float32), 1.0, kf.kid)
            mp.add_observation(mid, kf.kid, int(i))
            frame.kp_mp[i] = mid
            n_pts += 1
        mp.update_point_stats_batch(frame.kp_mp[frame.kp_mp >= 0])
        if n_pts < 100:
            self._reset_map()
            self.last_frame = frame
            return
        if self.inertial:
            # the first keyframe starts the temporal IMU chain
            self._prev_kf_id = kf.kid
            self.last_kf_ts = self.first_kf_ts = frame.timestamp
            kf.bg = self.cur_bias[:3].copy()
            kf.ba = self.cur_bias[3:].copy()
            self.imu_queue.drop_before(frame.timestamp - 0.01)
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.frame_id
        self.velocity = None
        self.state = TrackState.OK
        self.last_frame = frame
        self._record_traj(frame.timestamp, frame.R, frame.t)

    def _create_initial_map(self, f1: Frame, f2: Frame, sel, m12, R21, t21, tri, pts):
        """Reference CreateInitialMapMonocular (Tracking.cc:2099)."""
        mp = self.atlas.current
        f1.R, f1.t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        f2.R, f2.t = R21.astype(np.float32), t21.astype(np.float32)
        kf1 = self._promote(f1, mp)
        kf2 = self._promote(f2, mp)
        for j, i1 in enumerate(sel):
            if not tri[j]:
                continue
            i2 = int(m12[i1])
            mid = mp.add_point(pts[j], f2.desc[i2], np.zeros(3, np.float32), 1.0, kf2.kid)
            mp.add_observation(mid, kf1.kid, int(i1))
            mp.add_observation(mid, kf2.kid, i2)

        # global BA on the 2-KF map (the JAX package's 12 LM x 40 PCG)
        local_mapping.run_ba(mp, [kf1.kid, kf2.kid], set(), self.cam, self.inv_sigma2,
                             self.device, n_iters=12, cg_iters=40, stats=self.stats)

        # median-depth normalisation (reference Tracking.cc:2166-2195)
        valid_ids = np.where(mp.mp_valid[: mp._next_mp])[0]
        if len(valid_ids) < 50:
            self._reset_map()
            return
        pc1 = mp.mp_pos[valid_ids] @ kf1.R.T + kf1.t
        median_depth = float(np.median(pc1[:, 2]))
        if median_depth <= 0:
            self._reset_map()
            return
        inv_md = 1.0 / median_depth
        kf2.t = kf2.t * inv_md
        mp.mp_pos[valid_ids] *= inv_md
        mp.update_point_stats_batch(valid_ids)

        f2.R, f2.t = kf2.R.copy(), kf2.t.copy()
        f1.kp_mp = kf1.kp_mp
        f2.kp_mp = kf2.kp_mp
        if self.inertial:
            # seed the temporal IMU chain with the two init keyframes
            self.first_kf_ts = f1.timestamp
            kf2.prev_kf = kf1.kid
            kf2.imu_meas = self.imu_queue.raw_window(f1.timestamp, f2.timestamp)
            kf2.preint = self.imu_queue.preintegrate(f1.timestamp, f2.timestamp, self.cur_bias,
                                                     host=True)
            kf1.bg = kf2.bg = self.cur_bias[:3].copy()
            kf1.ba = kf2.ba = self.cur_bias[3:].copy()
            self._prev_kf_id = kf2.kid
            self.last_kf_ts = f2.timestamp
            self.imu_queue.drop_before(f2.timestamp - 0.01)
        self.ref_kf = kf2.kid
        self.last_kf_frame_id = f2.frame_id
        if self.inertial:
            # no velocity until the first tracked frame: early inertial frames
            # go through TrackReferenceKeyFrame while the init window builds
            self.velocity = None
        else:
            # seed the motion model from the two init frames, so the first
            # post-init frame takes the fused step
            Rv = (f2.R @ f1.R.T).astype(np.float32)
            self.velocity = (Rv, (f2.t - Rv @ f1.t).astype(np.float32))
            self._prev_pose = (f2.frame_id, f1.R.copy(), f1.t.copy())
        self.state = TrackState.OK
        self._record_traj(f1.timestamp, f1.R, f1.t)
        self._record_traj(f2.timestamp, f2.R, f2.t)

    def _record_traj(self, ts: float, R: np.ndarray, t: np.ndarray):
        """Append to both trajectory forms (absolute for live reads,
        reference-keyframe-relative for corrected saves)."""
        self.trajectory.append((ts, R.copy(), t.copy()))
        mp = self.atlas.current
        k = self.ref_kf
        if k is not None and k in mp.keyframes:
            kf = mp.keyframes[k]
            R_rel = (R @ kf.R.T).astype(np.float32)
            t_rel = (t - R_rel @ kf.t).astype(np.float32)
            self.traj_rel.append((ts, mp.mid, k, R_rel, t_rel))
        else:
            self.traj_rel.append((ts, mp.mid, -1, R.copy(), t.copy()))

    def final_trajectory(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Frame poses with all map corrections applied (reference
        SaveTrajectoryTUM, src/System.cc:480): each stored relative pose
        composed with its reference keyframe's current pose, walking the
        tombstones of culled keyframes up the spanning tree."""
        self._confirm_pipe()
        out = []
        for i, (ts, mid, kf_id, R_rel, t_rel) in enumerate(self.traj_rel):
            mp = self.atlas.map_by_mid(mid)
            if kf_id < 0:
                out.append((ts, R_rel, t_rel))
                continue
            if mp is None:
                _, Ra, ta = self.trajectory[i]
                out.append((ts, Ra, ta))
                continue
            R_acc, t_acc = R_rel, t_rel
            k = kf_id
            guard = 0
            while k >= 0 and k not in mp.keyframes and k in mp.dead_kfs and guard < 1000:
                pk, R_cp, t_cp = mp.dead_kfs[k]
                t_acc = (R_acc @ t_cp + t_acc).astype(np.float32)
                R_acc = (R_acc @ R_cp).astype(np.float32)
                k = pk
                guard += 1
            kf = mp.keyframes.get(k)
            if kf is None:
                _, Ra, ta = self.trajectory[i]
                out.append((ts, Ra, ta))
            else:
                out.append((ts, (R_acc @ kf.R).astype(np.float32),
                            (R_acc @ kf.t + t_acc).astype(np.float32)))
        return out

    def _reset_map(self):
        # in-flight frames belong to the abandoned map: dropped, not confirmed
        self._pipe = []
        self.local_mapper.discard_ba()
        self.atlas.create_new_map()
        self._map_traj_start = len(self.trajectory)
        self.init_frame = None
        self.state = TrackState.NO_IMAGES_YET
        self.ref_kf = None
        self.velocity = None
        self._prev_kf_id = -1
        self.last_kf_ts = None
        self.first_kf_ts = None
        self.cur_bias = np.zeros(6, np.float32)

    def _promote(self, f: Frame, mp: SLAMMap) -> KeyFrame:
        kf = KeyFrame(
            kid=-1, frame_id=f.frame_id, timestamp=f.timestamp,
            R=f.R.copy(), t=f.t.copy(), feats=f.feats,
            xy_un=f.xy_un, octave=f.octave, angle=f.angle,
            desc=f.desc, valid=f.valid, kp_mp=f.kp_mp.copy(),
            ur=None if f.ur is None else f.ur.copy(),
            depth=None if f.depth is None else f.depth.copy(),
        )
        mp.add_keyframe(kf)
        # share the association array so frame/keyframe stay consistent;
        # mapping mutates it on the host, so the device copy is stale now
        f.kp_mp = kf.kp_mp
        f.kp_mp_dirty = True
        return kf

    # ----------------------------------------------------------- tracking

    def _imu_ready(self, frame: Frame) -> bool:
        return (self.inertial and self.atlas.current.imu_initialized
                and self.last_frame is not None and self.last_frame.v is not None
                and frame.preint_frame is not None)

    def _track_frame(self, frame: Frame) -> bool:
        if self.last_frame is not None:
            # the fused step leaves frames device-resident
            self.last_frame.ensure_host()
        ok = False
        if (self.velocity is not None or self._imu_ready(frame)) and self.last_frame is not None:
            ok = self._track_with_motion_model(frame)
        if not ok and self.last_frame is not None:
            ok = self._track_reference_keyframe(frame)
        if not ok or not self._track_local_map(frame):
            self.velocity = None
            return False
        # motion model (reference: mVelocity = Tcw * Twl)
        lR, lt = self.last_frame.R, self.last_frame.t
        if lR is not None:
            Rv = frame.R @ lR.T
            self.velocity = (Rv, frame.t - Rv @ lt)
            self._prev_pose = (frame.frame_id, lR.copy(), lt.copy())
        if self._need_new_keyframe(frame):
            self._create_keyframe(frame)
        return True

    def _predict_pose(self):
        Rv, tv_ = self.velocity
        lR, lt = self.last_frame.R, self.last_frame.t
        return (Rv @ lR).astype(np.float32), (Rv @ lt + tv_).astype(np.float32)

    def _track_with_motion_model(self, frame: Frame) -> bool:
        """Reference TrackWithMotionModel (Tracking.cc:2437); inertial runs
        predict with the IMU once it is initialised."""
        mp = self.atlas.current
        last = self.last_frame
        if self._imu_ready(frame):
            self._predict_imu(frame)
            R, t = frame.R, frame.t
        else:
            R, t = self._predict_pose()
        frame.R, frame.t = R, t
        lm_idx = np.where(last.kp_mp >= 0)[0]
        if len(lm_idx) < 10:
            return False
        M = 2048
        lm_idx = lm_idx[:M]
        mp_ids = last.kp_mp[lm_idx]
        mp_pos = np.zeros((M, 3), np.float32)
        mp_desc = np.zeros((M, 32), np.uint8)
        mp_oct = np.zeros((M,), np.int32)
        mp_ang = np.zeros((M,), np.float32)
        mp_val = np.zeros((M,), bool)
        k = len(lm_idx)
        mp_pos[:k] = mp.mp_pos[mp_ids]
        mp_desc[:k] = last.desc[lm_idx]   # reference matches vs LAST FRAME desc
        mp_oct[:k] = last.octave[lm_idx]
        mp_ang[:k] = last.angle[lm_idx]
        mp_val[:k] = mp.mp_valid[mp_ids]
        args = [self._t(a) for a in (mp_pos, mp_desc, mp_val, mp_oct, mp_ang, R, t, frame.xy_un)]

        def run(th):
            m = fm.search_by_projection_last_frame(
                *args, frame.feats.desc, frame.feats.octave, frame.feats.angle,
                frame.feats.valid, self.cam, self.scale_factors, self.img_wh, th)
            return m.cpu().numpy()

        matches = run(15.0)
        if (matches >= 0).sum() < 20:
            matches = run(30.0)  # reference widens the window
        if (matches >= 0).sum() < 20:
            return False
        frame.kp_mp[:] = INVALID
        rows = np.where(matches >= 0)[0]
        frame.kp_mp[matches[rows]] = mp_ids[rows]
        return self._pose_opt(frame, min_inliers=10)

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """Reference TrackReferenceKeyFrame (Tracking.cc:2308); BoW match
        replaced by a mutual-best descriptor match, as in the JAX package."""
        mp = self.atlas.current
        if self.ref_kf is None or self.ref_kf not in mp.keyframes:
            return False
        kf = mp.keyframes[self.ref_kf]
        m12, _ = fm.mutual_best_match(frame.feats.desc, frame.feats.valid, self._t(kf.desc),
                                      self._t(kf.valid))
        m12 = m12.cpu().numpy()
        frame.kp_mp[:] = INVALID
        for i, j in enumerate(m12):
            if j >= 0 and kf.kp_mp[j] >= 0 and mp.mp_valid[kf.kp_mp[j]]:
                frame.kp_mp[i] = kf.kp_mp[j]
        if (frame.kp_mp >= 0).sum() < 15:
            return False
        last = self.last_frame
        frame.R = last.R.copy() if last.R is not None else np.eye(3, dtype=np.float32)
        frame.t = last.t.copy() if last.t is not None else np.zeros(3, np.float32)
        return self._pose_opt(frame, min_inliers=10)

    def _track_local_map(self, frame: Frame) -> bool:
        """Reference TrackLocalMap (Tracking.cc:2532)."""
        mp = self.atlas.current
        if self.ref_kf is None:
            return False
        if self.ref_kf not in mp.keyframes:  # culled by local mapping
            if not mp.keyframes:
                return False
            self.ref_kf = max(mp.keyframes.keys())
        local_kfs = [self.ref_kf] + [
            k for k, _ in mp.covisible_keyframes(self.ref_kf, min_weight=1)[:10]]
        M = 4096
        blk = td.build_local_block(mp, local_kfs, M, self.device)
        if blk is None:
            return False
        n_pts = min(len(mp.points_seen_by(local_kfs)), M)
        pt_ids = blk.ids_host[:n_pts]
        # points already matched in the frame are not searched again
        mp_val = np.zeros(M, bool)
        mp_val[:n_pts] = mp.mp_valid[pt_ids] & ~np.isin(pt_ids, frame.kp_mp[frame.kp_mp >= 0])
        kp_free = frame.valid & (frame.kp_mp < 0)
        matches = fm.search_by_projection_local_map(
            blk.pos, blk.desc, self._t(mp_val), blk.norm, blk.maxd,
            self._t(frame.R), self._t(frame.t), self._t(frame.xy_un), frame.feats.desc,
            frame.feats.octave, self._t(kp_free), self.cam, self.scale_factors, self.img_wh,
        ).cpu().numpy()
        rows = np.where(matches >= 0)[0]
        frame.kp_mp[matches[rows]] = pt_ids[rows]
        mp.mp_visible[pt_ids[mp_val[:n_pts]]] += 1
        if self._imu_ready(frame) and self.state == TrackState.OK:
            # PoseInertialOptimizationLastFrame (reference Optimizer.cc:7722):
            # the inertial edge keeps tracking with 15 visual inliers; only
            # after a normally tracked frame (a dead-reckoned one would drag
            # the solution off the map)
            ok = self._pose_opt_inertial(frame, min_inliers=15)
        else:
            ok = self._pose_opt(frame, min_inliers=30)
        if ok:
            mp.mp_found[frame.kp_mp[frame.kp_mp >= 0]] += 1
        return ok

    def _pose_opt(self, frame: Frame, min_inliers: int) -> bool:
        """Motion-only BA; drops outlier associations like the reference."""
        mp = self.atlas.current
        idx = np.where(frame.kp_mp >= 0)[0]
        if len(idx) < min_inliers:
            return False
        N = 2048
        idx = idx[:N]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        isig = np.ones((N,), np.float32)
        val = np.zeros((N,), bool)
        k = len(idx)
        pts[:k] = mp.mp_pos[frame.kp_mp[idx]]
        uv[:k] = frame.xy_un[idx]
        isig[:k] = np.asarray(self.inv_sigma2, np.float32)[
            np.clip(frame.octave[idx], 0, len(self.inv_sigma2) - 1)]
        val[:k] = True
        f32 = lambda a: self._t(np.asarray(a, np.float32))[None]
        obs_ur = None
        if frame.ur is not None and self.bf > 0:
            # stereo observations: the 3-row residual with the right-image u
            ur = np.full((N,), -1.0, np.float32)
            ur[:k] = frame.ur[idx]
            obs_ur = f32(ur)
        res = spo.optimize_pose(f32(frame.R), f32(frame.t), f32(pts), f32(uv), f32(isig),
                                self._t(val)[None], self.cam, obs_ur=obs_ur, bf=self.bf)
        inl, R_new, t_new = pack_fetch([res.inliers[0], res.R[0], res.t[0]])
        inl = inl[:k]
        frame.R = np.asarray(R_new)
        frame.t = np.asarray(t_new)
        frame.kp_mp[idx[~inl]] = INVALID
        return int(inl.sum()) >= min_inliers

    def _pose_opt_inertial(self, frame: Frame, min_inliers: int) -> bool:
        """The tracking-time visual-inertial solve (reference
        PoseInertialOptimizationLastFrame, Optimizer.cc:7722, K22): with a
        prior on the previous frame from an unchanged map, both states
        jointly and the previous one marginalised into the next prior;
        otherwise the frame's state against the fixed previous one
        (reference Tracking.cc:2554-2574, by mbMapUpdated)."""
        mp = self.atlas.current
        last = self.last_frame
        calib = self.imu_calib
        idx = np.where(frame.kp_mp >= 0)[0]
        if len(idx) < min_inliers:
            return False
        N = 2048
        idx = idx[:N]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        isig = np.ones((N,), np.float32)
        val = np.zeros((N,), bool)
        k = len(idx)
        pts[:k] = mp.mp_pos[frame.kp_mp[idx]]
        uv[:k] = frame.xy_un[idx]
        isig[:k] = np.asarray(self.inv_sigma2, np.float32)[
            np.clip(frame.octave[idx], 0, len(self.inv_sigma2) - 1)]
        val[:k] = True
        f32 = lambda a: self._t(np.asarray(a, np.float32))
        Rwb1, twb1 = calib.body_from_cam(last.R, last.t)
        bg1 = last.bg if last.bg is not None else self.cur_bias[:3]
        ba1 = last.ba if last.ba is not None else self.cur_bias[3:]
        prev_state = tuple(f32(a) for a in (Rwb1, twb1, last.v, bg1, ba1))
        Rwb0, twb0 = calib.body_from_cam(frame.R, frame.t)
        v0 = frame.v if frame.v is not None else last.v
        mp_ver = (mp.mid, mp.version)
        prior = None
        if (self._marg_prior is not None and self._marg_prior[0] == last.frame_id
                and self._marg_prior[1] == mp_ver):
            prior = self._marg_prior[2]
        pk = pre.Preintegrated(*(f32(a) for a in frame.preint_frame))
        args = (f32(Rwb0), f32(twb0), f32(v0), f32(bg1), f32(ba1), prev_state, pk, f32(pts),
                f32(uv), f32(isig), self._t(val), f32(calib.Rcb), f32(calib.tcb), self.cam)
        if prior is not None:
            self.stats["pose_inertial_joint"] += 1
            res = sin.optimize_pose_inertial_last_frame(*args, prior=prior)
        else:
            self.stats["pose_inertial"] += 1
            res = sin.optimize_pose_inertial(*args)
        Rwb, twb, v_n, bg_n, ba_n, inl, H = pack_fetch(
            [res.Rwb, res.twb, res.v, res.bg, res.ba, res.inliers, res.H])
        # this frame's ConstraintPoseImu for the next call
        self._marg_prior = (frame.frame_id, mp_ver,
                            (f32(H), tuple(f32(a) for a in (Rwb, twb, v_n, bg_n, ba_n))))
        frame.R, frame.t = calib.cam_from_body(Rwb, twb)
        frame.v, frame.bg, frame.ba = v_n, bg_n, ba_n
        self.cur_bias = np.concatenate([frame.bg, frame.ba]).astype(np.float32)
        inl = inl[:k]
        frame.kp_mp[idx[~inl]] = INVALID
        return int(inl.sum()) >= min_inliers

    # ---------------------------------------------------------- keyframes

    def _need_new_keyframe(self, frame: Frame, tracked: Optional[int] = None,
                           close_counts: Optional[Tuple[int, int]] = None) -> bool:
        """Reference NeedNewKeyFrame (Tracking.cc:2647), visual subset.
        ``tracked`` and ``close_counts`` (tracked, untracked close points)
        let the fused path pass its device counts, so the frame's
        associations and depths need no host copy."""
        mp = self.atlas.current
        if tracked is None:
            tracked = int((frame.kp_mp >= 0).sum())
        if self.ref_kf is None or self.ref_kf not in mp.keyframes:
            return False
        ref = mp.keyframes[self.ref_kf]
        rt_key = (mp.mid, mp.version, self.ref_kf)
        if self._ref_tracked_cache is None or self._ref_tracked_cache[0] != rt_key:
            mids = ref.kp_mp[ref.kp_mp >= 0]
            ref_tracked = int(sum(1 for m in mids
                                  if mp.mp_valid[m] and mp.n_observations(int(m)) >= 3))
            self._ref_tracked_cache = (rt_key, ref_tracked)
        ref_tracked = self._ref_tracked_cache[1]
        # stereo/RGB-D close-point pressure (bNeedToInsertClose: fewer than
        # 100 tracked close points and more than 70 untracked; thRefRatio 0.75)
        need_close = False
        th_ref_ratio = 0.9
        if close_counts is None and frame.depth is not None and self.th_depth > 0:
            close = frame.valid & (frame.depth > 0) & (frame.depth < self.th_depth)
            close_counts = (int((close & (frame.kp_mp >= 0)).sum()),
                            int((close & (frame.kp_mp < 0)).sum()))
        if close_counts is not None:
            tracked_close, untracked_close = close_counts
            need_close = tracked_close < 100 and untracked_close > 70
            th_ref_ratio = 0.75
        c1a = frame.frame_id >= self.last_kf_frame_id + self.cfg.tracking.max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + self.cfg.tracking.min_frames
        # the weak-tracking trigger waits until the map the frame saw holds
        # the last keyframe's deferred triangulation (frames dispatched
        # before it could not match the new points)
        c2_allowed = (not self.local_mapper.has_pending_tf()
                      and frame.frame_id >= self._pts_fresh_fid)
        c2 = c2_allowed and (tracked < ref_tracked * th_ref_ratio or need_close) and tracked > 15
        # inertial pre-init: keyframes at >= 4 Hz so the IMU initialisation
        # window fills (reference Tracking.cc:2647: IMU sensor, not
        # initialised, dt >= 0.25)
        if (self.inertial and not mp.imu_initialized and self.last_kf_ts is not None
                and frame.timestamp - self.last_kf_ts >= 0.25 and tracked > 15):
            return True
        return bool((c1a or (c1b and c2)) and tracked > 15)

    def _attach_inertial(self, kf: KeyFrame, frame: Frame):
        """The IMU chain link of a new keyframe (reference CreateNewKeyFrame:
        mpImuPreintegratedFromLastKF, mPrevKF)."""
        if not self.inertial:
            return
        kf.prev_kf = self._prev_kf_id
        if self.last_kf_ts is not None:
            kf.imu_meas = self.imu_queue.raw_window(self.last_kf_ts, frame.timestamp)
            kf.preint = frame.preint_kf or (
                None if kf.imu_meas is None
                else imu_frontend.integrate_raw_host(kf.imu_meas, self.cur_bias, self.imu_calib,
                                                     self.device, self.stats))
        kf.bg = self.cur_bias[:3].copy()
        kf.ba = self.cur_bias[3:].copy()
        kf.v = None if frame.v is None else frame.v.copy()
        self._prev_kf_id = kf.kid
        self.last_kf_ts = frame.timestamp
        if self.first_kf_ts is None:
            self.first_kf_ts = frame.timestamp
        # keep only the measurements the next keyframe's preintegration needs
        self.imu_queue.drop_before(frame.timestamp - 0.01)

    def _imu_init_stage(self, frame: Frame) -> bool:
        """The staged inertial initialisation (reference LocalMapping.cc
        :162-219): InitializeIMU(1e2, 1e10) once 2 s (monocular; 1 s with
        stereo) and 10 keyframes are in, VIBA1 (1, 1e5) at 5 s, VIBA2 (0, 0)
        at 15 s; stereo fixes the scale.  A stage that fired rotated (and
        for monocular rescaled) the map: the recorded trajectory is
        re-expressed (reference Tracking::UpdateFrameIMU) and the frame
        takes its keyframe's state."""
        mp = self.atlas.current
        if not self.inertial or self.first_kf_ts is None:
            return False
        elapsed = frame.timestamp - self.first_kf_ts
        mono = self.cfg.sensor == "imu-monocular"
        done = False
        stage = dict(calib=self.imu_calib, cam=self.cam, fix_scale=not mono, device=self.device,
                     stats=self.stats)
        if not mp.imu_initialized:
            if elapsed >= (2.0 if mono else 1.0) and len(mp.keyframes) >= 10:
                done = imu_frontend.initialize_imu(mp, prior_g=1e2, prior_a=1e10, **stage)
        elif not mp.imu_ba1 and elapsed >= 5.0:
            done = imu_frontend.initialize_imu(mp, prior_g=1.0, prior_a=1e5, **stage)
            mp.imu_ba1 = True
        elif mp.imu_ba1 and not mp.imu_ba2 and elapsed >= 15.0:
            done = imu_frontend.initialize_imu(mp, prior_g=0.0, prior_a=0.0, **stage)
            mp.imu_ba2 = True
        if not done:
            return False
        self.local_mapper.discard_ba()
        Ryw, s_up = done
        for i, (ts_i, mid, kk, R_rel, t_rel) in enumerate(self.traj_rel):
            if mid != mp.mid:
                continue
            if kk >= 0:
                self.traj_rel[i] = (ts_i, mid, kk, R_rel, (s_up * t_rel).astype(np.float32))
            else:
                self.traj_rel[i] = (ts_i, mid, kk, (R_rel @ Ryw.T).astype(np.float32),
                                    (s_up * t_rel).astype(np.float32))
        for i in range(self._map_traj_start, len(self.trajectory)):
            ts_i, R_i, t_i = self.trajectory[i]
            self.trajectory[i] = (ts_i, (R_i @ Ryw.T).astype(np.float32),
                                  (s_up * t_i).astype(np.float32))
        kf = mp.keyframes[self._prev_kf_id]
        frame.R, frame.t = kf.R.copy(), kf.t.copy()
        frame.v = None if kf.v is None else kf.v.copy()
        frame.bg, frame.ba = kf.bg.copy(), kf.ba.copy()
        self.cur_bias = np.concatenate([kf.bg, kf.ba]).astype(np.float32)
        self.velocity = None
        return True

    def _create_keyframe(self, frame: Frame):
        mp = self.atlas.current
        frame.ensure_host()
        kf = self._promote(frame, mp)
        self._attach_inertial(kf, frame)
        touched = []
        for kp in np.where(kf.kp_mp >= 0)[0]:
            mid = int(kf.kp_mp[kp])
            if mp.mp_valid[mid]:
                mp.add_observation(mid, kf.kid, int(kp))
                touched.append(mid)
            else:
                kf.kp_mp[kp] = INVALID
        mp.update_point_stats_batch(touched)
        if frame.depth is not None and self.th_depth > 0:
            self._create_close_points(frame, kf, mp)
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.frame_id
        # pipelined visual tracking defers the triangulation and fuse fetch
        # to the next confirmation (the reference's LocalMapping queue
        # latency); synchronous mode applies them in the event
        defer = (self.cfg.tracking.pipeline_depth > 0 and not self.inertial
                 and self.cam_r is None)
        self.local_mapper.process_keyframe(mp, kf.kid, defer_fetch=defer)
        # the staged IMU initialisation; a stage that fired moved the map
        self._vi_stage_fired = self._imu_init_stage(frame)
        lc = self.loop_closer.process_keyframe(mp, kf.kid, atlas=self.atlas)
        if lc:
            # poses and points moved: drop the motion model and the stale
            # in-flight window BA, refresh the frame from its keyframe
            self.local_mapper.discard_ba()
            self.velocity = None
            if isinstance(lc, dict) and lc.get("type") == "merge":
                self._after_map_merge(lc, frame)
            else:
                frame.R = mp.keyframes[kf.kid].R.copy()
                frame.t = mp.keyframes[kf.kid].t.copy()

    def _after_map_merge(self, info: dict, frame: Frame):
        """Fix-ups after an Atlas merge (reference MergeLocal tail,
        LoopClosing.cc:1252): the active map changed, the welded keyframes
        have new ids, and what was recorded in the dropped map's
        coordinates is re-expressed."""
        remap = info["kf_remap"]
        mp = self.atlas.current
        if self.ref_kf is not None:
            self.ref_kf = remap.get(self.ref_kf, info["kf_cur"])
        kf = mp.keyframes[info["kf_cur"]]
        frame.R = kf.R.copy()
        frame.t = kf.t.copy()
        frame.kp_mp = kf.kp_mp.copy()
        frame.kp_mp_dirty = True
        Rw, tw, sw = info["world_sim3"]
        for i in range(self._map_traj_start, len(self.trajectory)):
            ts, R, t = self.trajectory[i]
            Rn = (R @ Rw.T).astype(np.float32)
            self.trajectory[i] = (ts, Rn, (sw * t - Rn @ tw).astype(np.float32))
        self._map_traj_start = 0
        # relative trajectory: the dropped map's entries move onto the
        # welded keyframe ids (the relative translation scales by sw)
        dropped_mid = info["dropped_mid"]
        dead_remap = info.get("dead_remap", {})
        for i, (ts, mid, k, R_rel, t_rel) in enumerate(self.traj_rel):
            if mid != dropped_mid:
                continue
            nk = remap.get(k, dead_remap.get(k, -1)) if k >= 0 else -1
            if nk >= 0:
                self.traj_rel[i] = (ts, mp.mid, nk, R_rel, (sw * t_rel).astype(np.float32))
            elif k < 0:
                Rn = (R_rel @ Rw.T).astype(np.float32)
                self.traj_rel[i] = (ts, mp.mid, -1, Rn, (sw * t_rel - Rn @ tw).astype(np.float32))
            else:
                _, Ra, ta = self.trajectory[i]
                self.traj_rel[i] = (ts, mp.mid, -1, Ra.copy(), ta.copy())

    @staticmethod
    def _stereo_point(frame: Frame, i: int, z: float, fx, fy, cx, cy) -> np.ndarray:
        """Keypoint i's point in its camera at depth z: the rig's
        triangulated point, else the back-projection of its undistorted
        pixel (reference UnprojectStereo)."""
        if frame.p3d_stereo is not None:
            return frame.p3d_stereo[i].astype(np.float32)
        u, v = frame.xy_un[i]
        return np.array([(u - cx) * z / fx, (v - cy) * z / fy, z], np.float32)

    def _create_close_points(self, frame: Frame, kf: KeyFrame, mp: SLAMMap):
        """Stereo/RGB-D CreateNewKeyFrame (reference Tracking.cc:2907):
        unproject the keyframe's unmatched keypoints with a depth, nearest
        first, until 100 are made and the depth passes thDepth, and never
        past thFarPoints."""
        free = np.where(frame.valid & (frame.depth > 0) & (kf.kp_mp < 0))[0]
        order = free[np.argsort(frame.depth[free])]
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        n_created = 0
        touched = []
        for i in order:
            z = float(frame.depth[i])
            if n_created >= 100 and z > self.th_depth:
                break
            if self.th_far_points > 0 and z > self.th_far_points:
                break  # depth-sorted: everything after is farther
            pc = self._stereo_point(frame, i, z, fx, fy, cx, cy)
            pos = kf.R.T @ (pc - kf.t)
            mid = mp.add_point(pos, frame.desc[i], np.zeros(3, np.float32), 1.0, kf.kid)
            mp.add_observation(mid, kf.kid, int(i))
            touched.append(mid)
            kf.kp_mp[i] = mid
            n_created += 1
        mp.update_point_stats_batch(touched)
