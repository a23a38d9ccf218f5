"""Loop closing: place recognition, Sim3 verification, loop correction and
Atlas merging (port of ``extractorb_tpu/slam/loop_closing.py``, visual).

Replaces LoopClosing (reference src/LoopClosing.cc:56 Run, :263
NewDetectCommonRegions, :502 DetectAndReffineSim3FromLastKF, :557
DetectCommonRegionsFromBoW, :958 FindMatchesByProjection, :1013
CorrectLoop) as a synchronous per-keyframe stage with the reference's
verification cascade:

  BoW candidates -> covisible-window SearchByBoW (>= 20 distinct points)
  -> Sim3 RANSAC (>= 15 inliers) -> guided projection (>= 50)
  -> OptimizeSim3 (>= 20 inliers) -> re-projection with the optimised
  Sim3 (>= 80) -> spatial consistency over the current keyframe's
  covisibles -> else temporal consistency over the next keyframes.

Correction follows CorrectLoop: the corrected Sim3 is propagated through
the current covisible window, matched duplicates are fused, the loop cloud
is fused into the window, the essential graph is optimised and a
full-map bundle adjustment is dispatched.  A candidate of another Atlas
map welds the current map into it (``slam/merge.py``).

The device work: the vocabulary descent (K11) once per keyframe, the BoW
and projection searches (K3), the Sim3 RANSAC and OptimizeSim3 (K12), the
essential graph (K13), the global BA (K14) and the weld BA (K6).  The host
keeps the JAX module's control flow and its ``np.random.default_rng(7)``
draws, in the same order.  The inertial branches (the 4-DoF graph, the
inertial GBA and weld) are ROADMAP A.11.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.camera import Pinhole
from ..dist import global_ba
from ..frontend import matcher as fm
from ..geometry import sim3 as gsim3
from ..place.database import KeyFrameDatabase
from ..solver import pose_graph as pg
from ..utils.packed_fetch import pack_fetch
from . import merge as mg
from .map import SLAMMap

# Keyframe-database keys are Atlas-global: (map id, keyframe id) packed into
# one int64, so entries of different maps never collide
_MID_STRIDE = 1 << 32


def encode_dbid(mid: int, kf_id: int) -> int:
    return mid * _MID_STRIDE + kf_id


def decode_dbid(key: int) -> Tuple[int, int]:
    return int(key) // _MID_STRIDE, int(key) % _MID_STRIDE


@dataclasses.dataclass(frozen=True)
class LoopThresholds:
    """Reference acceptance constants (LoopClosing.cc:557-565, :510-512)."""

    min_kfs: int = 12                 # :291 map-size gate
    n_bow_matches: int = 20           # nBoWMatches
    n_bow_inliers: int = 15           # nBoWInliers (Sim3 RANSAC)
    n_sim3_inliers: int = 20          # nSim3Inliers (OptimizeSim3)
    n_proj_matches: int = 50          # nProjMatches (coarse Sim3)
    n_proj_opt_matches: int = 80      # nProjOptMatches (refined Sim3)
    n_covis_consistency: int = 3      # spatial/temporal coincidences
    n_proj_refine: int = 30           # DetectAndReffine nProjMatches
    n_proj_opt_refine: int = 50       # DetectAndReffine nProjOptMatches
    n_proj_rep: int = 100             # DetectAndReffine nProjMatchesRep


@dataclasses.dataclass
class _Pending:
    """Temporal-consistency hypothesis (LoopClosing.cc:302-360)."""

    mid: int
    matched_kf: int
    last_cur_kf: int
    Scw: Tuple[np.ndarray, np.ndarray, float]   # world -> last current camera
    cloud: np.ndarray                            # loop map-point ids
    n_coincidences: int
    n_not_found: int = 0
    matched_pairs: Optional[List[Tuple[int, int]]] = None  # (current kp, map point)


def _sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) o (Rb,tb,sb): x -> sa Ra (sb Rb x + tb) + ta."""
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


def _sim3_inverse(R, t, s):
    """Float32 inverse of a Sim3 (lie.sim3_inverse on host arrays)."""
    R = np.asarray(R, np.float32)
    si = np.float32(1.0) / np.float32(s)
    return R.T, (-si * (R.T @ np.asarray(t, np.float32))).astype(np.float32), float(si)


class LoopCloser:
    def __init__(self, vocab, cam: Pinhole, scale_factors=None, img_wh=None, inv_sigma2=None,
                 thresholds: Optional[LoopThresholds] = None, fix_scale: bool = False,
                 device="cpu", stats=None):
        self.device = torch.device(device)
        self.db = KeyFrameDatabase(vocab, device=self.device) if vocab else None
        self.vocab = vocab
        self.cam = cam
        self.scale_factors = tuple(scale_factors or tuple(1.2 ** i for i in range(8)))
        self.img_wh = tuple(img_wh or (640, 480))
        self.inv_sigma2 = inv_sigma2
        self.fix_scale = fix_scale
        self.th = thresholds or LoopThresholds()
        self.n_loops = 0
        self.n_merges = 0
        # the post-loop GBA and the weld BA are dispatched and applied on a
        # later keyframe event or at finish()
        self.pending_gba: Optional[global_ba.PendingGBA] = None
        self.n_gba_applied = 0
        self.pending_weld = None   # (mid, PendingBA)
        # the tracker's counter of device work ("ba": window and weld BAs)
        self.stats = stats
        self._rng = np.random.default_rng(7)
        self._pending: Optional[_Pending] = None
        self._words: Dict[Tuple[int, int], np.ndarray] = {}

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dtype)

    def _project_np(self, p) -> np.ndarray:
        c = self.cam
        p = np.asarray(p, np.float32)
        return np.array([np.float32(c.fx) * p[0] / p[2] + np.float32(c.cx),
                         np.float32(c.fy) * p[1] / p[2] + np.float32(c.cy)], np.float32)

    # ------------------------------------------------------- pending GBA

    def poll_gba(self, mp: SLAMMap, force: bool = False):
        """Apply a finished in-flight GBA (with force, wait for it)."""
        p = self.pending_gba
        if p is None:
            return
        if p.mid != mp.mid:
            self.pending_gba = None
            return
        if force or p.is_ready():
            self.pending_gba = None
            if p.apply(mp):
                self.n_gba_applied += 1

    def poll_weld(self, mp: SLAMMap, force: bool = False):
        """Apply a finished in-flight post-merge welding BA."""
        w = self.pending_weld
        if w is None:
            return
        mid, pend = w
        if mid != mp.mid:
            self.pending_weld = None
            return
        if force or pend.ready():
            self.pending_weld = None
            pend.apply(mp)

    def finish(self, mp: SLAMMap):
        """Settle any in-flight GBA / welding BA (Tracker.flush)."""
        self.poll_gba(mp, force=True)
        self.poll_weld(mp, force=True)

    # ------------------------------------------------------------ per-KF

    def process_keyframe(self, mp: SLAMMap, kf_id: int, atlas=None):
        """Detect and correct a loop (same map) or merge (another Atlas
        map) for the new keyframe.  Returns False, True (loop closed) or
        the merge-info dict of ``slam.merge.merge_maps``."""
        if self.db is None:
            return False
        self.poll_gba(mp)
        self.poll_weld(mp)
        mid = mp.mid
        kf = mp.keyframes[kf_id]
        covis = {k for k, _ in mp.covisible_keyframes(kf_id, 15)} | {kf_id}

        def covis_keys(key, _atlas=atlas, _mp=mp):
            m, k = decode_dbid(key)
            target = _mp if m == _mp.mid else (
                _atlas.map_by_mid(m) if _atlas is not None else None)
            if target is None or k not in target.keyframes:
                return []
            return [encode_dbid(m, nk) for nk, _ in target.covisible_keyframes(k, 1)[:10]]

        # the keyframe's words once (K11); the database takes its BoW
        words = self._kf_words(mp, kf_id)
        bow = self.vocab.bow_of_words(words[np.asarray(kf.valid)])
        min_score = self.db.min_score_against(
            [encode_dbid(mid, k) for k in covis if k != kf_id], kf.desc, valid=kf.valid, bow=bow)
        cands = self.db.query(kf.desc, valid=kf.valid,
                              exclude={encode_dbid(mid, k) for k in covis}, n_best=3,
                              covis_fn=covis_keys, min_score=min_score, bow=bow)
        self.db.add(encode_dbid(mid, kf_id), kf.desc, valid=kf.valid, bow=bow)

        same_map_enabled = len(mp.keyframes) >= self.th.min_kfs

        # 1. temporal-consistency continuation of the pending hypothesis
        if same_map_enabled and self._pending is not None and self._pending.mid == mid:
            if self._refine_pending(mp, kf_id):
                if self._pending.n_coincidences >= self.th.n_covis_consistency:
                    p = self._pending
                    self._pending = None
                    self._do_correct(mp, kf_id, p.matched_kf, p.Scw, p.matched_pairs or [],
                                     p.cloud)
                    self.n_loops += 1
                    return True
                return False
            elif self._pending is not None:
                self._pending.n_not_found += 1
                if self._pending.n_not_found >= 2:
                    self._pending = None

        same = [(k, s) for key, s in cands for m, k in [decode_dbid(key)]
                if m == mid and k in mp.keyframes]
        cross = [(m, k, s) for key, s in cands for m, k in [decode_dbid(key)] if m != mid]

        # 2. fresh BoW detection over the candidates
        for cand_id, _ in same if same_map_enabled else []:
            got = self._detect_from_bow(mp, kf_id, cand_id)
            if got is None:
                continue
            Scw, pairs, cloud, n_spatial = got
            if n_spatial + 1 >= self.th.n_covis_consistency:
                self._pending = None
                self._do_correct(mp, kf_id, cand_id, Scw, pairs, cloud)
                self.n_loops += 1
                return True
            self._pending = _Pending(mid=mid, matched_kf=cand_id, last_cur_kf=kf_id, Scw=Scw,
                                     cloud=cloud, n_coincidences=n_spatial + 1,
                                     matched_pairs=pairs)
            break

        # cross-map candidate -> Atlas merge (LoopClosing.cc:129 -> MergeLocal)
        if atlas is not None:
            for m, k, _ in cross[:3]:
                other = atlas.map_by_mid(m)
                if other is None or k not in other.keyframes:
                    continue
                info = self._verify_and_merge(atlas, mp, kf_id, other, k)
                if info:
                    self.n_merges += 1
                    return info
        return False

    # ----------------------------------------------------- word caching

    def _kf_words(self, mp: SLAMMap, kf_id: int) -> np.ndarray:
        key = (mp.mid, kf_id)
        w = self._words.get(key)
        if w is None:
            kf = mp.keyframes[kf_id]
            w = self.vocab.transform_words(kf.desc, self.device)
            w = np.where(kf.valid, w, -1).astype(np.int32)
            self._words[key] = w
        return w

    # -------------------------------------------------- projection match

    def _window_cloud(self, mp: SLAMMap, kf_id: int,
                      exclude_connected_to: Optional[int] = None) -> np.ndarray:
        """Loop map-point cloud: the matched keyframe, its 5 best
        covisibles and up to 5 covisibles of each (FindMatchesByProjection
        :958-984)."""
        window = [kf_id]
        cov = [k for k, _ in mp.covisible_keyframes(kf_id, 1)[:5]]
        window += cov
        seen = set(window)
        cur_cov: Set[int] = set()
        if exclude_connected_to is not None:
            cur_cov = {k for k, _ in mp.covisible_keyframes(exclude_connected_to, 1)}
        for c in cov:
            n_ins = 0
            for k2, _ in mp.covisible_keyframes(c, 1):
                if k2 in seen or k2 in cur_cov:
                    continue
                seen.add(k2)
                window.append(k2)
                n_ins += 1
                if n_ins >= 5:
                    break
        return mp.points_seen_by(window)

    def _project_matches(self, mp: SLAMMap, cur_kf, cloud: np.ndarray, Scw,
                         th: float) -> List[Tuple[int, int]]:
        """SearchByProjection through Scw into cur_kf (ORBmatcher.cc:473):
        (current kp, cloud point) pairs, a keypoint claimed once (first
        point wins)."""
        if len(cloud) == 0:
            return []
        R, t, s = Scw
        t_ = self._t
        best_kp = fm.search_by_projection_sim3(
            t_(mp.mp_pos[cloud]), t_(mp.mp_desc[cloud]), t_(mp.mp_valid[cloud]),
            t_(mp.mp_normal[cloud]), t_(mp.mp_max_dist[cloud]),
            torch.tensor(float(s), dtype=torch.float32, device=self.device),
            t_(np.asarray(R, np.float32)), t_(np.asarray(t, np.float32)),
            t_(np.asarray(cur_kf.xy_un, np.float32)), t_(cur_kf.desc), t_(cur_kf.octave),
            t_(cur_kf.valid), self.cam, self.scale_factors, self.img_wh, float(th),
        ).cpu().numpy()
        pairs: List[Tuple[int, int]] = []
        claimed: Set[int] = set()
        for row, kp in enumerate(best_kp):
            if kp < 0 or int(kp) in claimed:
                continue
            claimed.add(int(kp))
            pairs.append((int(kp), int(cloud[row])))
        return pairs

    def _search_by_sim3_mutual(self, mp: SLAMMap, cur, cand, Scw, Scm):
        """SearchBySim3 (ORBmatcher.cc:1735): projection both ways through
        the hypothesis, keeping mutually consistent keypoint pairs.
        Returns (current kp, candidate point) pairs."""
        cloud2 = mp.points_seen_by([cand.kid])
        cloud1 = mp.points_seen_by([cur.kid])
        if len(cloud1) == 0 or len(cloud2) == 0:
            return []
        pairs_a = self._project_matches(mp, cur, cloud2, Scw, th=7.5)
        S_mc = _sim3_inverse(*Scm)
        S_mw = _sim3_compose(S_mc[0], S_mc[1], S_mc[2], cur.R.astype(np.float32),
                             cur.t.astype(np.float32), 1.0)
        pairs_b = self._project_matches(mp, cand, cloud1, S_mw, th=7.5)
        b = {kp2: pid1 for kp2, pid1 in pairs_b}
        mutual = []
        for kp1, pid2 in pairs_a:
            kp2 = mp.obs.get(pid2, {}).get(cand.kid)
            if kp2 is None or kp2 not in b:
                continue
            if mp.obs.get(b[kp2], {}).get(cur.kid) == kp1:
                mutual.append((kp1, pid2))
        return mutual

    # ------------------------------------------------------ verification

    def _ransac(self, p1, p2, uv1, uv2, valid, fix_scale: bool):
        """Sim3 RANSAC (K12) on 512 padded pairs with the next seed of the
        closer's draw; one fetch of (success, R, t, s, inlier mask)."""
        sets = gsim3.sample_sim3_sets(int(self._rng.integers(1 << 30)), torch.from_numpy(valid))
        t_ = self._t
        res = gsim3.solve_sim3_ransac(sets.to(self.device), t_(p1), t_(p2), t_(uv1), t_(uv2),
                                      t_(valid), self.cam, fix_scale)
        ok, R, t, s, inl = pack_fetch([res.success, res.R12, res.t12, res.s12, res.inliers])
        return bool(ok), np.asarray(R), np.asarray(t), float(s), np.asarray(inl)

    def _detect_from_bow(self, mp: SLAMMap, kf_id: int, cand_id: int):
        """DetectCommonRegionsFromBoW for one candidate (:557-868).
        Returns (Scw, matched pairs, cloud, n_spatial) or None."""
        th_ = self.th
        cur = mp.keyframes[kf_id]
        cur_words = self._kf_words(mp, kf_id)
        connected = {k for k, _ in mp.covisible_keyframes(kf_id, 15)}
        cov_kfs = [cand_id] + [k for k, _ in mp.covisible_keyframes(cand_id, 15)[:5]]
        if any(k in connected for k in cov_kfs):
            return None  # bAbortByNearKF

        t_ = self._t
        matched_mp = np.full(len(cur.valid), -1, np.int64)
        seen_mps: Set[int] = set()
        cur_args = (t_(cur.desc), t_(cur_words), t_(cur.angle), t_(cur.valid))
        for ck in cov_kfs:
            ckf = mp.keyframes.get(ck)
            if ckf is None:
                continue
            cw = self._kf_words(mp, ck)
            m = fm.search_by_bow(*cur_args, t_(ckf.desc), t_(cw), t_(ckf.angle),
                                 t_(ckf.valid & (ckf.kp_mp >= 0)), 0.9).cpu().numpy()
            for i in np.where(m >= 0)[0]:
                p = int(ckf.kp_mp[m[i]])
                if p < 0 or not mp.mp_valid[p] or p in seen_mps:
                    continue
                seen_mps.add(p)
                if matched_mp[i] < 0:
                    matched_mp[i] = p
        if len(seen_mps) < th_.n_bow_matches:
            return None

        rows = [i for i in np.where(matched_mp >= 0)[0]
                if cur.kp_mp[i] >= 0 and mp.mp_valid[cur.kp_mp[i]]]
        if len(rows) < th_.n_bow_inliers:
            return None
        cand = mp.keyframes[cand_id]
        cap = 512
        p1 = np.zeros((cap, 3), np.float32)
        p2 = np.zeros((cap, 3), np.float32)
        uv1 = np.zeros((cap, 2), np.float32)
        uv2 = np.zeros((cap, 2), np.float32)
        val = np.zeros(cap, bool)
        for n, i in enumerate(rows[:cap]):
            mpi = int(cur.kp_mp[i])
            mpj = int(matched_mp[i])
            p1[n] = cur.R @ mp.mp_pos[mpi] + cur.t
            p2[n] = cand.R @ mp.mp_pos[mpj] + cand.t
            uv1[n] = cur.xy_un[i]
            kp2 = mp.obs.get(mpj, {}).get(cand_id)
            uv2[n] = cand.xy_un[kp2] if kp2 is not None else self._project_np(p2[n])
            val[n] = p1[n, 2] > 0 and p2[n, 2] > 0
        _, R_mc, t_mc, s_mc, inl = self._ransac(p1, p2, uv1, uv2, val, self.fix_scale)
        if int(np.sum(inl)) < th_.n_bow_inliers:
            return None
        Scm = _sim3_inverse(R_mc, t_mc, s_mc)   # RANSAC gives cur cam -> cand cam
        Smw = (cand.R.astype(np.float32), cand.t.astype(np.float32), 1.0)
        Scw = _sim3_compose(*Scm, *Smw)

        cloud = self._window_cloud(mp, cand_id, exclude_connected_to=kf_id)
        pairs = self._project_matches(mp, cur, cloud, Scw, th=8.0)
        if len(pairs) < th_.n_proj_matches:
            return None
        have = {kp for kp, _ in pairs}
        for kp, pid in self._search_by_sim3_mutual(mp, cur, cand, Scw, Scm):
            if kp not in have:
                have.add(kp)
                pairs.append((kp, pid))

        got = self._optimize_scm(mp, cur, cand, pairs, Scm)
        if got is None:
            return None
        Scm, n_opt = got
        if n_opt < th_.n_sim3_inliers:
            return None
        Scw = _sim3_compose(*Scm, *Smw)
        pairs = self._project_matches(mp, cur, cloud, Scw, th=5.0)
        if len(pairs) < th_.n_proj_opt_matches:
            return None

        # spatial consistency: the current keyframe's covisibles re-find
        # the cloud through their propagated Sim3
        n_spatial = 0
        for j, _ in mp.covisible_keyframes(kf_id, 1)[:5]:
            if n_spatial >= th_.n_covis_consistency:
                break
            kfj = mp.keyframes[j]
            Tjc_R = kfj.R @ cur.R.T
            Tjc_t = kfj.t - Tjc_R @ cur.t
            Sjw = _sim3_compose(Tjc_R.astype(np.float32), Tjc_t.astype(np.float32), 1.0, *Scw)
            if len(self._project_matches(mp, kfj, cloud, Sjw, th=4.5)) >= th_.n_proj_refine:
                n_spatial += 1
        return Scw, pairs, cloud, n_spatial

    def _optimize_scm(self, mp: SLAMMap, cur, cand, pairs, Scm):
        """OptimizeSim3 (K12) on (current kp, loop point) pairs: p1 is the
        current keyframe's own point where it has one, else the loop point
        through the current Scm."""
        cap = 1024
        p1 = np.zeros((cap, 3), np.float32)
        p2 = np.zeros((cap, 3), np.float32)
        uv1 = np.zeros((cap, 2), np.float32)
        uv2 = np.zeros((cap, 2), np.float32)
        val = np.zeros(cap, bool)
        R_cm, t_cm, s_cm = Scm
        for n, (kp, pid) in enumerate(pairs[:cap]):
            p2c = cand.R @ mp.mp_pos[pid] + cand.t
            own = int(cur.kp_mp[kp])
            if own >= 0 and mp.mp_valid[own]:
                p1c = cur.R @ mp.mp_pos[own] + cur.t
            else:
                p1c = s_cm * (R_cm @ p2c) + t_cm
            p1[n] = p1c
            p2[n] = p2c
            uv1[n] = cur.xy_un[kp]
            kp2 = mp.obs.get(pid, {}).get(cand.kid)
            uv2[n] = cand.xy_un[kp2] if kp2 is not None else self._project_np(p2c)
            val[n] = p2c[2] > 0
        t_ = self._t
        res = gsim3.optimize_sim3(t_(np.asarray(R_cm, np.float32)),
                                  t_(np.asarray(t_cm, np.float32)),
                                  torch.tensor(float(s_cm), dtype=torch.float32,
                                               device=self.device),
                                  t_(p1), t_(p2), t_(uv1), t_(uv2), t_(val), self.cam,
                                  self.fix_scale)
        R, t, s, n_in = pack_fetch([res.R12, res.t12, res.s12, res.n_in])
        n_in = int(n_in)
        if n_in == 0:
            return None
        return (np.asarray(R), np.asarray(t), float(s)), n_in

    def _refine_pending(self, mp: SLAMMap, kf_id: int) -> bool:
        """DetectAndReffineSim3FromLastKF (:502): the pending Scw moved to
        the new keyframe and verified by projection, OptimizeSim3 and
        re-projection."""
        th_ = self.th
        p = self._pending
        cur = mp.keyframes[kf_id]
        last = mp.keyframes.get(p.last_cur_kf)
        if last is None or p.matched_kf not in mp.keyframes:
            self._pending = None
            return False
        R_cl = cur.R @ last.R.T
        t_cl = cur.t - R_cl @ last.t
        Scw = _sim3_compose(R_cl.astype(np.float32), t_cl.astype(np.float32), 1.0, *p.Scw)
        pairs = self._project_matches(mp, cur, p.cloud, Scw, th=8.0)
        if len(pairs) < th_.n_proj_refine:
            return False
        cand = mp.keyframes[p.matched_kf]
        Smw = (cand.R.astype(np.float32), cand.t.astype(np.float32), 1.0)
        Scm = _sim3_compose(*Scw, *_sim3_inverse(*Smw))
        got = self._optimize_scm(mp, cur, cand, pairs, Scm)
        if got is None:
            return False
        Scm, n_opt = got
        if n_opt <= th_.n_proj_opt_refine:
            return False
        Scw = _sim3_compose(*Scm, *Smw)
        pairs = self._project_matches(mp, cur, p.cloud, Scw, th=5.0)
        if len(pairs) < th_.n_proj_rep:
            return False
        self._pending = _Pending(mid=p.mid, matched_kf=p.matched_kf, last_cur_kf=kf_id, Scw=Scw,
                                 cloud=p.cloud, n_coincidences=p.n_coincidences + 1,
                                 matched_pairs=pairs)
        return True

    # ------------------------------------------------------------- merge

    def _sim3_between(self, mp1_map: SLAMMap, kf1, mp2_map: SLAMMap, kf2):
        """Mutual-best descriptor match between the point-bearing keypoints
        of two keyframes and the Sim3 RANSAC (K3, K12).  Returns (S_R, S_t,
        S_s, inlier point pairs) with p_cam2 = s R p_cam1 + t, or None."""
        t_ = self._t
        m12, _ = fm.mutual_best_match(t_(kf1.desc), t_(kf1.valid & (kf1.kp_mp >= 0)),
                                      t_(kf2.desc), t_(kf2.valid & (kf2.kp_mp >= 0)))
        m12 = m12.cpu().numpy()
        rows = np.where(m12 >= 0)[0]
        if len(rows) < 20:
            return None
        cap = 512
        p1 = np.zeros((cap, 3), np.float32)
        p2 = np.zeros((cap, 3), np.float32)
        uv1 = np.zeros((cap, 2), np.float32)
        uv2 = np.zeros((cap, 2), np.float32)
        valid = np.zeros(cap, bool)
        n = 0
        pair_rows = []
        for i1 in rows:
            i2 = int(m12[i1])
            mp1 = int(kf1.kp_mp[i1])
            mp2 = int(kf2.kp_mp[i2])
            if mp1 < 0 or mp2 < 0 or not mp1_map.mp_valid[mp1] or not mp2_map.mp_valid[mp2]:
                continue
            if n >= cap:
                break
            p1[n] = kf1.R @ mp1_map.mp_pos[mp1] + kf1.t
            p2[n] = kf2.R @ mp2_map.mp_pos[mp2] + kf2.t
            uv1[n] = kf1.xy_un[i1]
            uv2[n] = kf2.xy_un[i2]
            valid[n] = True
            pair_rows.append((mp1, mp2))
            n += 1
        if n < 20:
            return None
        ok, R, t, s, inl = self._ransac(p1, p2, uv1, uv2, valid, False)
        if not ok:
            return None
        pairs = [pr for j, pr in enumerate(pair_rows) if j < len(inl) and inl[j]]
        return R, t, s, pairs

    def _verify_and_merge(self, atlas, mp: SLAMMap, kf_id: int, other: SLAMMap, cand_id: int):
        """Weld the active map into ``other`` (MergeLocal, :1252)."""
        got = self._sim3_between(mp, mp.keyframes[kf_id], other, other.keyframes[cand_id])
        if got is None:
            return None
        S_R, S_t, S_s, pairs = got
        info = mg.merge_maps(atlas, drop=mp, keep=other, kf_drop_id=kf_id, kf_keep_id=cand_id,
                             S_R=S_R, S_t=S_t, S_s=S_s)
        for old_id, new_id in info["kf_remap"].items():
            self.db.rekey(encode_dbid(mp.mid, old_id), encode_dbid(other.mid, new_id))
        remap = info["mp_remap"]
        for mp1, mp2 in pairs:
            m1 = remap.get(mp1, -1)
            if m1 >= 0 and m1 != mp2:
                self._merge_points(other, keep=mp2, drop=m1)
        if self.inv_sigma2 is not None:
            pend = mg.weld_bundle_adjustment(other, info["kf_cur"], info["kf_matched"], self.cam,
                                             self.inv_sigma2, self.device, stats=self.stats)
            if pend is not None:
                self.pending_weld = (other.mid, pend)
        return info

    def _merge_points(self, mp: SLAMMap, keep: int, drop: int):
        """MapPoint::Replace: the observations of ``drop`` move to ``keep``."""
        if not (mp.mp_valid[keep] and mp.mp_valid[drop]):
            return
        for kf_id, kp in list(mp.obs.get(drop, {}).items()):
            if kf_id in mp.obs.get(keep, {}):
                kf = mp.keyframes[kf_id]
                if kf.kp_mp[kp] == drop:
                    kf.kp_mp[kp] = -1
            else:
                mp.obs[keep][kf_id] = kp
                mp.keyframes[kf_id].kp_mp[kp] = keep
        mp.obs[drop] = {}
        mp.remove_point(drop)
        mp.update_point_stats(keep)

    # -------------------------------------------------------- correction

    def _do_correct(self, mp: SLAMMap, kf_id: int, cand_id: int, Scw, matched_pairs, cloud):
        """CorrectLoop (:1013): window Sim3 propagation, loop fusion,
        SearchAndFuse, the essential graph, the dispatched GBA."""
        cur = mp.keyframes[kf_id]
        window = [k for k, _ in mp.covisible_keyframes(kf_id, 1)] + [kf_id]
        Twc_R = cur.R.T
        Twc_t = -cur.R.T @ cur.t
        corrected: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        non_corrected: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        for k in window:
            kf = mp.keyframes[k]
            non_corrected[k] = (kf.R.copy(), kf.t.copy(), 1.0)
            if k == kf_id:
                corrected[k] = Scw
            else:
                Tic_R = kf.R @ Twc_R
                Tic_t = kf.R @ Twc_t + kf.t
                corrected[k] = _sim3_compose(Tic_R.astype(np.float32),
                                             Tic_t.astype(np.float32), 1.0, *Scw)

        # window map points: p' = S_corr^-1 (S_old p)
        done: Set[int] = set()
        for k in window:
            kf = mp.keyframes[k]
            R_o, t_o, _ = non_corrected[k]
            R_c, t_c, s_c = corrected[k]
            pts = [int(p) for p in kf.kp_mp if p >= 0 and p not in done and mp.mp_valid[p]]
            if not pts:
                continue
            done.update(pts)
            cam = mp.mp_pos[pts] @ R_o.T + t_o
            mp.mp_pos[pts] = ((cam - t_c) @ R_c) / s_c
        for k in window:
            R_c, t_c, s_c = corrected[k]
            mp.keyframes[k].R = R_c
            mp.keyframes[k].t = t_c / s_c

        # covisibility before the fusion: what the fusion adds across the
        # loop are the new loop connections (LoopClosing.cc:1013+104-126)
        prev_cov = {k: {n for n, _ in mp.covisible_keyframes(k, 1)} for k in window}

        # loop fusion: the current keyframe's matched duplicates
        for kp, loop_mp in matched_pairs:
            if not mp.mp_valid[loop_mp]:
                continue
            own = int(cur.kp_mp[kp])
            if own >= 0 and mp.mp_valid[own] and own != loop_mp:
                self._merge_points(mp, keep=loop_mp, drop=own)
            elif own < 0:
                cur.kp_mp[kp] = loop_mp
                mp.add_observation(loop_mp, kf_id, kp)

        # SearchAndFuse of the loop cloud into every corrected keyframe
        cloud = np.asarray([p for p in cloud if mp.mp_valid[p]], np.int64)
        for k in window:
            kf = mp.keyframes[k]
            for kp, loop_mp in self._project_matches(mp, kf, cloud, (kf.R, kf.t, 1.0), th=4.0):
                own = int(kf.kp_mp[kp])
                if own >= 0 and mp.mp_valid[own] and own != loop_mp:
                    self._merge_points(mp, keep=loop_mp, drop=own)
                elif own < 0 and mp.mp_valid[loop_mp]:
                    kf.kp_mp[kp] = loop_mp
                    mp.add_observation(loop_mp, k, kp)

        # the essential graph, its edges measured with the pre-correction
        # poses (NonCorrectedSim3, Optimizer.cc:2303), the new loop
        # connections with the corrected ones
        self._optimize_essential_graph(mp, kf_id, cand_id, window, non_corrected,
                                       self._loop_connections(mp, window, prev_cov))
        mp.keyframes[kf_id].loop_edges.append(cand_id)
        mp.keyframes[cand_id].loop_edges.append(kf_id)
        self._run_gba(mp)
        mp.version += 1

    @staticmethod
    def _loop_connections(mp: SLAMMap, window: List[int], prev_cov) -> Dict[int, Set[int]]:
        """LoopConnections (LoopClosing.cc:1013+104-126): each window
        keyframe's strong (>= 100 points) covisibles that the fusion
        added, outside the window."""
        return {k: {n for n, _ in mp.covisible_keyframes(k, 100)} - prev_cov[k] - set(window)
                for k in window}

    def _run_gba(self, mp: SLAMMap):
        """RunGlobalBundleAdjustment (:2430): the full-map Schur BA (K14),
        dispatched; a previous in-flight solve is superseded."""
        self.pending_gba = None
        pending = global_ba.dispatch_global_ba(
            mp, self.cam, self.inv_sigma2 if self.inv_sigma2 is not None else [1.0] * 8,
            self.device, n_iters=10)
        self.pending_gba = pending

    def _optimize_essential_graph(self, mp: SLAMMap, kf_id: int, cand_id: int,
                                  window: List[int], non_corrected=None, connections=None):
        """OptimizeEssentialGraph (Optimizer.cc:2303) on one device (K13):
        all keyframes, edges of the spanning tree, loop edges, strong
        covisibility (>= 100) and the new loop connection; the matched
        keyframe fixed.  ``fix_scale`` for stereo / RGB-D (:2621).

        ``connections`` (window keyframe -> keyframes the fusion newly
        connected it to with >= 100 points) are the reference's
        LoopConnections: their edges come first and are measured with the
        corrected poses.  The JAX function has no such edges and measures
        these pairs as covisibility edges with the pre-correction pose of
        the window keyframe, which undoes the correction once the fused
        loop shares 100 points (ROADMAP C)."""
        non_corrected = non_corrected or {}
        kf_ids = sorted(mp.keyframes.keys())
        index = {k: i for i, k in enumerate(kf_ids)}
        K = len(kf_ids)
        Rs = np.stack([mp.keyframes[k].R for k in kf_ids]).astype(np.float32)
        ts = np.stack([mp.keyframes[k].t for k in kf_ids]).astype(np.float32)
        edges = []
        seen = set()

        def pose_meas(i):
            got = non_corrected.get(i)
            if got is not None:
                return got[0], got[1]
            kf = mp.keyframes[i]
            return kf.R, kf.t

        def rel(i, j, w=1.0, corrected=False):
            key = (min(i, j), max(i, j))
            if key in seen or i == j:
                return
            seen.add(key)
            meas = (lambda k: (mp.keyframes[k].R, mp.keyframes[k].t)) if corrected else pose_meas
            Ri, ti = meas(i)
            Rj, tj = meas(j)
            Rm = (Rj @ Ri.T).astype(np.float32)
            tm = (tj - Rm @ ti).astype(np.float32)
            edges.append((index[i], index[j], Rm, tm, np.float32(1.0), w))

        for k in sorted(connections or {}):
            for nk in sorted(connections[k]):
                rel(k, nk, 8.0 if {k, nk} == {kf_id, cand_id} else 1.0, corrected=True)
        for k in kf_ids:
            par = getattr(mp.keyframes[k], "parent", -1)
            if par in mp.keyframes:
                rel(k, par)
        for a, b in zip(kf_ids[:-1], kf_ids[1:]):
            if (min(a, b), max(a, b)) not in seen and \
                    getattr(mp.keyframes[b], "parent", -1) not in mp.keyframes:
                rel(a, b)
        for k in kf_ids:
            for le in getattr(mp.keyframes[k], "loop_edges", []):
                if le in mp.keyframes:
                    rel(k, le)
        for k in kf_ids:
            for nk, _ in mp.covisible_keyframes(k, min_weight=100)[:8]:
                rel(k, nk)
        key = (min(kf_id, cand_id), max(kf_id, cand_id))
        if key not in seen:
            seen.add(key)
            Ri, ti = mp.keyframes[kf_id].R, mp.keyframes[kf_id].t
            Rj, tj = mp.keyframes[cand_id].R, mp.keyframes[cand_id].t
            Rm = (Rj @ Ri.T).astype(np.float32)
            tm = (tj - Rm @ ti).astype(np.float32)
            edges.append((index[kf_id], index[cand_id], Rm, tm, np.float32(1.0), 8.0))
        if not edges:
            return
        t_ = self._t
        prob = pg.PoseGraphProblem(
            R=t_(Rs), t=t_(ts), s=t_(np.ones(K, np.float32)),
            edge_i=t_(np.array([e[0] for e in edges], np.int32)),
            edge_j=t_(np.array([e[1] for e in edges], np.int32)),
            m_R=t_(np.stack([e[2] for e in edges])), m_t=t_(np.stack([e[3] for e in edges])),
            m_s=t_(np.array([e[4] for e in edges], np.float32)),
            weight=t_(np.array([e[5] for e in edges], np.float32)),
            edge_valid=t_(np.ones(len(edges), bool)),
            fixed=t_(np.array([k == cand_id for k in kf_ids])),
        )
        R_new, t_new, s_new, _ = pg.optimize_pose_graph(prob, n_iters=15,
                                                        fix_scale=self.fix_scale)
        R_new, t_new, s_new = pack_fetch([R_new, t_new, s_new])
        self._apply_graph_result(mp, kf_ids, index, np.asarray(R_new), np.asarray(t_new),
                                 np.asarray(s_new))

    def _apply_graph_result(self, mp: SLAMMap, kf_ids, index, R_new, t_new, s_new):
        """Write back the graph's poses and move each map point with its
        reference keyframe (p' = S_new^-1 (S_old p))."""
        by_ref: Dict[int, List[int]] = {}
        for p in np.where(mp.mp_valid[: mp._next_mp])[0]:
            o = mp.obs.get(int(p))
            if not o:
                continue
            ref = int(mp.mp_first_kf[p])
            if ref not in mp.keyframes:
                ref = next(iter(o))
            by_ref.setdefault(ref, []).append(int(p))
        for ref, pts in by_ref.items():
            i = index.get(ref)
            if i is None:
                continue
            R_old, t_old = mp.keyframes[ref].R, mp.keyframes[ref].t
            cam = mp.mp_pos[pts] @ R_old.T + t_old
            mp.mp_pos[pts] = ((cam - t_new[i]) @ R_new[i]) / float(s_new[i])
        for k in kf_ids:
            i = index[k]
            mp.keyframes[k].R = R_new[i]
            mp.keyframes[k].t = t_new[i] / s_new[i]
        mp.version += 1
