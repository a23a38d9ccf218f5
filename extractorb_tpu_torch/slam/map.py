"""Map state: keyframes, map points, observations, covisibility
(port of ``extractorb_tpu/slam/map.py``; host numpy, nearly verbatim).

Replaces the reference's mutex-guarded object graph (Map/KeyFrame/
MapPoint, src/Map.cc, src/KeyFrame.cc, src/MapPoint.cc) with a
single-writer host-side arena of numpy arrays (SoA) mirroring onto
device tensors for the device stages.  There are no locks: the host
scheduler is the only writer, and versioned snapshots are cheap because
state is arrays.  The only difference from the JAX module: a keyframe's
``feats`` is the port's ``Features`` (torch tensors on the tracker's
device).

Capacities are grow-on-demand amortised doublings; the device-side
consumers always receive fixed-capacity padded views.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frontend.extractor import Features

INVALID = -1


@dataclasses.dataclass
class KeyFrame:
    """Frozen frame promoted to the map (reference KeyFrame.cc ctor)."""

    kid: int
    frame_id: int
    timestamp: float
    R: np.ndarray                 # (3,3) world->cam
    t: np.ndarray                 # (3,)
    feats: Features               # device tensors (padded)
    xy_un: np.ndarray             # (N,2) undistorted kp coords (host)
    octave: np.ndarray            # (N,) host copy
    angle: np.ndarray             # (N,)
    desc: np.ndarray              # (N,32) host copy
    valid: np.ndarray             # (N,)
    kp_mp: np.ndarray             # (N,) map-point id per keypoint or -1
    is_bad: bool = False
    # Stereo/RGBD channels (reference mvuRight/mvDepth, inc/Frame.h);
    # None for monocular keyframes.
    ur: Optional[np.ndarray] = None     # (N,) right-image u or -1
    depth: Optional[np.ndarray] = None  # (N,) metric depth or -1
    # Inertial state (reference KeyFrame mVw/mImuBias/mpImuPreintegrated
    # and the temporal chain mPrevKF, inc/KeyFrame.h).
    v: Optional[np.ndarray] = None      # (3,) body velocity in world
    bg: Optional[np.ndarray] = None     # (3,) gyro bias
    ba: Optional[np.ndarray] = None     # (3,) acc bias
    # Spanning tree + loop edges (reference KeyFrame mpParent /
    # mspLoopEdges, inc/KeyFrame.h:304-330): parent = strongest earlier
    # covisible at insertion; loop edges accumulate in CorrectLoop and
    # feed OptimizeEssentialGraph's edge set.
    parent: int = -1
    loop_edges: List[int] = dataclasses.field(default_factory=list)
    preint: Optional[object] = None     # imu.Preintegrated from prev_kf
    prev_kf: int = -1                   # temporal predecessor keyframe id
    imu_meas: Optional[tuple] = None    # raw (gyro, acc, dt) window from
                                        # prev_kf (for MergePrevious on cull)

    @property
    def n_kps(self) -> int:
        return int(self.valid.sum())

    def center(self) -> np.ndarray:
        return -self.R.T @ self.t


class SLAMMap:
    """One map of the Atlas (reference Map, inc/Map.h:75)."""

    def __init__(self, capacity: int = 20000, scale_factor: float = 1.2):
        self.mid = 0  # stable Atlas-wide map id (set by Atlas)
        self.scale_factor = float(scale_factor)  # pyramid scale for PredictScale
        self.keyframes: Dict[int, KeyFrame] = {}
        self._next_kf = 0
        self._next_mp = 0
        cap = capacity
        self.mp_pos = np.zeros((cap, 3), np.float32)
        self.mp_desc = np.zeros((cap, 32), np.uint8)
        self.mp_normal = np.zeros((cap, 3), np.float32)
        self.mp_max_dist = np.zeros((cap,), np.float32)
        self.mp_valid = np.zeros((cap,), bool)
        self.mp_first_kf = np.full((cap,), INVALID, np.int32)
        self.mp_visible = np.zeros((cap,), np.int32)
        self.mp_found = np.zeros((cap,), np.int32)
        # observations: mp -> {kf: kp_idx}
        self.obs: Dict[int, Dict[int, int]] = {}
        # tombstones of culled keyframes: kf_id -> (parent_id, R_cp,
        # t_cp) with T_cw(kf) = T_cp @ T_cw(parent) at cull time
        # (reference KeyFrame::SetBadFlag stores mTcp so saved
        # trajectories can still resolve through dead keyframes)
        self.dead_kfs: Dict[int, Tuple[int, np.ndarray, np.ndarray]] = {}
        self.version = 0  # change index (reference Map::GetMapChangeIndex)
        # inertial staging flags (reference Map::SetImuInitialized,
        # GetIniertialBA1/2, inc/Map.h:120-129)
        self.imu_initialized = False
        self.imu_ba1 = False
        self.imu_ba2 = False

    # ------------------------------------------------------------ points

    def _ensure_capacity(self, n_more: int):
        cap = len(self.mp_valid)
        if self._next_mp + n_more <= cap:
            return
        new = max(cap * 2, self._next_mp + n_more)
        grow = lambda a: np.concatenate(
            [a, np.zeros((new - cap,) + a.shape[1:], a.dtype)], 0
        )
        self.mp_pos = grow(self.mp_pos)
        self.mp_desc = grow(self.mp_desc)
        self.mp_normal = grow(self.mp_normal)
        self.mp_max_dist = grow(self.mp_max_dist)
        self.mp_valid = grow(self.mp_valid)
        self.mp_first_kf = np.concatenate(
            [self.mp_first_kf, np.full(new - cap, INVALID, np.int32)]
        )
        self.mp_visible = grow(self.mp_visible)
        self.mp_found = grow(self.mp_found)

    def add_point(self, pos, desc, normal, max_dist, first_kf) -> int:
        self._ensure_capacity(1)
        i = self._next_mp
        self._next_mp += 1
        self.mp_pos[i] = pos
        self.mp_desc[i] = desc
        self.mp_normal[i] = normal
        self.mp_max_dist[i] = max_dist
        self.mp_valid[i] = True
        self.mp_first_kf[i] = first_kf
        self.obs[i] = {}
        self.version += 1
        return i

    def remove_point(self, mp: int):
        if not self.mp_valid[mp]:
            return
        self.mp_valid[mp] = False
        for kf_id, kp in self.obs.get(mp, {}).items():
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.kp_mp[kp] == mp:
                kf.kp_mp[kp] = INVALID
        self.obs.pop(mp, None)
        self.version += 1

    def add_observation(self, mp: int, kf_id: int, kp_idx: int):
        self.obs[mp][kf_id] = kp_idx
        self.keyframes[kf_id].kp_mp[kp_idx] = mp

    def erase_observation(self, mp: int, kf_id: int):
        kp = self.obs.get(mp, {}).pop(kf_id, None)
        if kp is not None:
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.kp_mp[kp] == mp:
                kf.kp_mp[kp] = INVALID
        if mp in self.obs and len(self.obs[mp]) <= 1:
            self.remove_point(mp)

    def n_observations(self, mp: int) -> int:
        return len(self.obs.get(mp, {}))

    # --------------------------------------------------------- keyframes

    def add_keyframe(self, kf: KeyFrame) -> int:
        kf.kid = self._next_kf
        self._next_kf += 1
        self.keyframes[kf.kid] = kf
        self.version += 1
        return kf.kid

    def update_point_stats(self, mp: int):
        """UpdateNormalAndDepth + descriptor refresh (reference
        MapPoint.cc:427, :330): mean viewing normal, max scale-invariance
        distance, median-Hamming distinctive descriptor."""
        o = self.obs.get(mp)
        if not o:
            return
        pos = self.mp_pos[mp]
        normals = []
        descs = []
        for kf_id, kp in o.items():
            kf = self.keyframes[kf_id]
            v = pos - kf.center()
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
            descs.append(kf.desc[kp])
        if normals:
            m = np.mean(normals, 0)
            nm = np.linalg.norm(m)
            if nm > 1e-9:
                self.mp_normal[mp] = m / nm
        # distinctive descriptor: min median distance to the others
        if len(descs) == 1:
            self.mp_desc[mp] = descs[0]
        else:
            D = np.array(descs)
            bits = np.unpackbits(D, axis=1).astype(np.int32)
            dist = (bits[:, None, :] != bits[None, :, :]).sum(-1)
            med = np.median(dist, axis=1)
            self.mp_desc[mp] = D[int(np.argmin(med))]
        # reference: maxDist = dist(refKF) * scaleFactor^octave; fall back
        # to any observing keyframe, keeping the (kf, kp) pair consistent
        ref_id = int(self.mp_first_kf[mp])
        if ref_id in self.keyframes and ref_id in o:
            kf_id, kp = ref_id, o[ref_id]
        else:
            kf_id, kp = next(iter(o.items()))
        kf = self.keyframes[kf_id]
        d = np.linalg.norm(pos - kf.center())
        level = int(kf.octave[kp])
        self.mp_max_dist[mp] = d * (self.scale_factor ** level)

    def update_point_stats_batch(self, mids):
        """Vectorized update_point_stats over many points at once: one
        padded (P, Kmax) gather instead of P python loops (the KF
        pipeline refreshes ~10^3 points per keyframe; per-point calls
        were ~40% of the keyframe budget)."""
        mids = np.unique(np.asarray(mids, np.int64))
        mids = mids[(mids >= 0) & self.mp_valid[mids]]
        obs_lists = [list(self.obs.get(int(m), {}).items()) for m in mids]
        keep = np.asarray([len(o) > 0 for o in obs_lists], bool)
        mids, obs_lists = mids[keep], [o for o, k in zip(obs_lists, keep) if k]
        P = len(mids)
        if P == 0:
            return
        kmax = max(len(o) for o in obs_lists)
        # gather per-observation keyframe centers and descriptors
        kf_ids = sorted({k for o in obs_lists for k, _ in o})
        kf_row = {k: i for i, k in enumerate(kf_ids)}
        centers = np.stack([self.keyframes[k].center() for k in kf_ids])
        descs_by_kf = [self.keyframes[k].desc for k in kf_ids]
        octs_by_kf = [self.keyframes[k].octave for k in kf_ids]

        obs_kf = np.zeros((P, kmax), np.int32)
        obs_kp = np.zeros((P, kmax), np.int32)
        obs_ok = np.zeros((P, kmax), bool)
        for i, o in enumerate(obs_lists):
            for j, (k, kp) in enumerate(o):
                obs_kf[i, j] = kf_row[k]
                obs_kp[i, j] = kp
                obs_ok[i, j] = True

        pos = self.mp_pos[mids]                            # (P,3)
        ctr = centers[obs_kf]                              # (P,K,3)
        v = pos[:, None, :] - ctr
        n = np.linalg.norm(v, axis=-1)
        good = obs_ok & (n > 1e-9)
        vn = np.where(good[..., None], v / np.maximum(n, 1e-9)[..., None], 0.0)
        m = vn.sum(1)
        nm = np.linalg.norm(m, axis=-1)
        upd = nm > 1e-9
        self.mp_normal[mids[upd]] = (m[upd] / nm[upd, None]).astype(np.float32)

        # distinctive descriptor: min median Hamming among observations
        D = np.zeros((P, kmax, 32), np.uint8)
        for i, o in enumerate(obs_lists):
            for j, (k, kp) in enumerate(o):
                D[i, j] = descs_by_kf[kf_row[k]][kp]
        bits = np.unpackbits(D.reshape(P * kmax, 32), axis=1).reshape(
            P, kmax, 256
        ).astype(np.int16)
        dist = np.abs(bits[:, :, None, :] - bits[:, None, :, :]).sum(-1)
        BIG = 10 ** 6
        dist = np.where(obs_ok[:, :, None] & obs_ok[:, None, :], dist, BIG)
        # median over the valid columns only: sort and index by count
        cnt = obs_ok.sum(1)
        ds = np.sort(dist, axis=2)
        rows = np.arange(P)[:, None]
        ks = np.arange(kmax)[None, :]
        lo = ds[rows, ks, ((cnt - 1) // 2)[:, None]]
        hi = ds[rows, ks, (cnt // 2)[:, None]]
        med = 0.5 * (lo + hi)
        med = np.where(obs_ok, med, BIG)
        best = np.argmin(med, axis=1)
        self.mp_desc[mids] = D[np.arange(P), best]

        # max scale-invariance distance from the reference keyframe
        ref = self.mp_first_kf[mids]
        ref_j = np.zeros(P, np.int64)
        for i, o in enumerate(obs_lists):
            for j, (k, kp) in enumerate(o):
                if k == ref[i]:
                    ref_j[i] = j
                    break
        rkf = obs_kf[np.arange(P), ref_j]
        rkp = obs_kp[np.arange(P), ref_j]
        d = np.linalg.norm(pos - centers[rkf], axis=-1)
        oct_arr = np.asarray(
            [octs_by_kf[k][p] for k, p in zip(rkf, rkp)], np.int64
        )
        self.mp_max_dist[mids] = (
            d * self.scale_factor ** oct_arr
        ).astype(np.float32)

    def apply_scaled_rotation(self, Ryw: np.ndarray, s: float,
                              scale_vel: bool = True):
        """Reference Map::ApplyScaledRotation (inc/Map.h:122): re-express
        the whole map in a new world frame p_y = s * Ryw @ p_w (used
        after IMU init to align gravity with -z and fix monocular
        scale).  Camera poses become Rcy = Rcw Ryw^T, tcy = s*tcw;
        world-frame velocities v_y = s * Ryw v_w."""
        Ryw = np.asarray(Ryw, np.float32)
        s = float(s)
        for kf in self.keyframes.values():
            kf.R = (kf.R @ Ryw.T).astype(np.float32)
            kf.t = (s * kf.t).astype(np.float32)
            if kf.v is not None and scale_vel:
                kf.v = (s * (Ryw @ kf.v)).astype(np.float32)
            elif kf.v is not None:
                kf.v = (Ryw @ kf.v).astype(np.float32)
        n = self._next_mp
        self.mp_pos[:n] = s * (self.mp_pos[:n] @ Ryw.T)
        self.mp_normal[:n] = self.mp_normal[:n] @ Ryw.T
        self.mp_max_dist[:n] *= s
        # tombstone relative transforms are rotation-invariant under a
        # world re-expression but their translations carry the scale
        self.dead_kfs = {
            k: (pk, R_cp, (s * t_cp).astype(np.float32))
            for k, (pk, R_cp, t_cp) in self.dead_kfs.items()
        }
        self.version += 1

    # ------------------------------------------------------- covisibility

    def covisible_keyframes(self, kf_id: int, min_weight: int = 15
                            ) -> List[Tuple[int, int]]:
        """(neighbor_kf, shared-point count), strongest first (reference
        KeyFrame::UpdateConnections, weight>=15 with strongest forced)."""
        kf = self.keyframes[kf_id]
        own = kf.kp_mp[kf.kp_mp >= 0]
        if len(own) == 0:
            return []
        mask = np.zeros(len(self.mp_valid), bool)
        mask[own] = True
        counts: Dict[int, int] = {}
        for other_id, other in self.keyframes.items():
            if other_id == kf_id:
                continue
            om = other.kp_mp[other.kp_mp >= 0]
            c = int(mask[om].sum()) if len(om) else 0
            if c:
                counts[other_id] = c
        pairs = sorted(counts.items(), key=lambda it: -it[1])
        out = [p for p in pairs if p[1] >= min_weight]
        if not out and pairs:
            out = [pairs[0]]
        return out

    def points_seen_by(self, kf_ids) -> np.ndarray:
        arrs = [
            kf.kp_mp[kf.kp_mp >= 0]
            for kf in (self.keyframes.get(k) for k in kf_ids)
            if kf is not None
        ]
        if not arrs:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(arrs)).astype(np.int32)


class Atlas:
    """Multi-map container (reference Atlas, inc/Atlas.h:76): tracking
    loss with a big enough map starts a fresh map; when place
    recognition later finds a keyframe of an old map, loop closing welds
    the maps back together (slam/merge.py)."""

    def __init__(self):
        self._next_mid = 0
        self.maps: List[SLAMMap] = [self._new()]
        self.active = 0

    def _new(self) -> SLAMMap:
        m = SLAMMap()
        m.mid = self._next_mid
        self._next_mid += 1
        return m

    @property
    def current(self) -> SLAMMap:
        return self.maps[self.active]

    def create_new_map(self):
        self.maps.append(self._new())
        self.active = len(self.maps) - 1

    def map_by_mid(self, mid: int) -> Optional[SLAMMap]:
        for m in self.maps:
            if m.mid == mid:
                return m
        return None

    def remove_map(self, mid: int):
        """Drop a (merged-away) map, keeping `active` pointing at the
        same SLAMMap object."""
        cur = self.current
        self.maps = [m for m in self.maps if m.mid != mid]
        self.active = self.maps.index(cur) if cur in self.maps else 0
