"""Local mapping: per-keyframe map growth and refinement
(port of ``extractorb_tpu/slam/local_mapping.py``, monocular).

Replaces LocalMapping (reference: src/LocalMapping.cc:67-276 Run loop,
:341 MapPointCulling, :383 CreateNewMapPoints, :935 KeyFrameCulling) and
the window BA (src/Optimizer.cc:1694 LocalBundleAdjustment).  Runs
synchronously after keyframe insertion with a bounded amount of device
work per event:

* the triangulation of new points: kernel K7 ``tri_search`` (epipolar
  search, claim, DLT and gates), one launch per neighbour-capacity group;
  it builds P1/P2, F12 and its reprojection gate from the pinhole K even
  for a KB8 camera, as the JAX program does (a matched reference fault,
  ROADMAP C.2: ORB-SLAM3 goes through the camera model there);
* the fuse (SearchInNeighbors): one K3 launch per (points, keyframe) job,
  its boxes from the tracker's camera (pinhole or KB8), then the local-map
  accept logic of ``frontend/matcher.py``;
* the window BA: kernel K6 through the tracker's camera, dispatched without waiting and applied at the
  next confirmation fetch or keyframe event.  A keyframe event only polls
  it (a CUDA event's ``query()``): a solve still running stays in flight,
  the reference's mbAbortBA semantics.

With an IMU (``imu_calib`` set by the tracker): keyframe culling keeps the
temporal chain (nothing before the IMU is initialised, then only while the
merged preintegration spans <= 0.5 s, or 3 s after the last refinement), a
culled keyframe's successor inherits its predecessor and the merged
measurement window, re-integrated by K19, and once the IMU is initialised
the local inertial BA (K20, ``imu_frontend.local_inertial_ba``) takes the
window BA's place.

In the tracker's pipelined mode (``pipeline_depth > 0``, visual sensors)
``process_keyframe(..., defer_fetch=True)`` only dispatches the
triangulation and fuse launches: their results ride the tracker's next
confirmation fetch (``pending_tf_handles`` / ``apply_tf``, the reference's
LocalMapping queue latency), and the window BA is dispatched when they
land.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Set

import numpy as np
import torch

from ..core.camera import Camera
from ..frontend import matcher as fm
from ..solver import ba as sba
from ..utils.packed_fetch import pack_fetch
from . import imu_frontend
from .map import SLAMMap


def run_ba(
    mp: SLAMMap,
    kf_ids: Sequence[int],
    fixed_ids: Set[int],
    cam: Camera,
    inv_sigma2: Sequence[float],
    device,
    n_iters: int = 10,
    max_points: int = 8192,
    max_obs: int = 32768,
    cg_iters: int = 40,
    async_apply: bool = False,
    stats: Optional[collections.Counter] = None,
):
    """Build a BAProblem from a keyframe window and write results back.

    kf_ids: optimised + fixed keyframes (fixed ones listed in fixed_ids).
    Points: all points observed by the non-fixed keyframes.  Outlier
    observations (chi2 > 5.991 after optimisation) are erased from the
    map like the reference's post-BA loop (Optimizer.cc:2190 region).
    With ``async_apply`` the solve is left running and a ``PendingBA``
    returned; ``stats["ba"]`` counts the solves dispatched."""
    kf_ids = [k for k in kf_ids if k in mp.keyframes]
    if len(kf_ids) < 2:
        return None
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    opt_ids = [k for k in kf_ids if k not in fixed_ids]

    pt_ids = mp.points_seen_by(opt_ids)[:max_points]
    if len(pt_ids) < 8:
        return None

    lookup = np.full(len(mp.mp_valid), -1, np.int32)
    lookup[pt_ids] = np.arange(len(pt_ids), dtype=np.int32)
    inv_s = np.asarray(inv_sigma2, np.float32)
    okf_l, omp_l, ouv_l, osig_l = [], [], [], []
    for ki, kf_id in enumerate(kf_ids):
        kf = mp.keyframes[kf_id]
        rows = np.where(kf.kp_mp >= 0)[0]
        pidx = lookup[kf.kp_mp[rows]]
        keep = pidx >= 0
        rows, pidx = rows[keep], pidx[keep]
        okf_l.append(np.full(len(rows), ki, np.int32))
        omp_l.append(pidx.astype(np.int32))
        ouv_l.append(kf.xy_un[rows])
        osig_l.append(inv_s[np.clip(kf.octave[rows], 0, len(inv_s) - 1)])
    obs_kf = np.concatenate(okf_l)
    obs_mp = np.concatenate(omp_l)
    obs_uv = np.concatenate(ouv_l, 0)
    obs_sig = np.concatenate(osig_l)
    if len(obs_kf) < 16:
        return None
    O = min(len(obs_kf), max_obs)

    K = len(kf_ids)
    P = len(pt_ids)
    Rs = np.stack([mp.keyframes[k].R for k in kf_ids]).astype(np.float32)
    ts = np.stack([mp.keyframes[k].t for k in kf_ids]).astype(np.float32)
    fixed = np.array([k in fixed_ids for k in kf_ids])
    if not fixed.any():
        fixed[0] = True  # gauge

    def bucket(n, ladder):
        for b in ladder:
            if n <= b:
                return b
        return int(np.ceil(n / ladder[-1]) * ladder[-1])

    # the JAX module's padding ladders: the same problem shapes on both sides
    Kp = bucket(K, (32, 64, 128, 256))
    Pp = bucket(P, (2048, 4096, 8192, 16384, 32768))
    Op = bucket(O, (8192, 16384, 32768, 65536, 131072))
    Rs_p = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
    ts_p = np.zeros((Kp, 3), np.float32)
    Rs_p[:K], ts_p[:K] = Rs, ts
    fixed_p = np.ones(Kp, bool)
    fixed_p[:K] = fixed
    pts_p = np.zeros((Pp, 3), np.float32)
    pts_p[:P] = mp.mp_pos[pt_ids]
    pts_p[P:, 2] = 1.0  # keep padded points off the camera plane
    fixed_mp_p = np.ones(Pp, bool)
    fixed_mp_p[:P] = False
    okf = np.zeros(Op, np.int32)
    omp = np.zeros(Op, np.int32)
    ouv = np.zeros((Op, 2), np.float32)
    osig = np.ones(Op, np.float32)
    oval = np.zeros(Op, bool)
    okf[:O] = obs_kf[:O]
    omp[:O] = obs_mp[:O]
    ouv[:O] = obs_uv[:O]
    osig[:O] = obs_sig[:O]
    oval[:O] = True

    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prob = sba.BAProblem(
        R=to_dev(Rs_p), t=to_dev(ts_p), points=to_dev(pts_p), obs_kf=to_dev(okf),
        obs_mp=to_dev(omp), obs_uv=to_dev(ouv), inv_sigma2=to_dev(osig), obs_valid=to_dev(oval),
        fixed_kf=to_dev(fixed_p), fixed_mp=to_dev(fixed_mp_p),
    )
    # matrix-free CG on purpose, as the JAX module: its truncated step is an
    # implicit trust region along the window's weakly observable directions
    res = sba.optimize(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
    if stats is not None:
        stats["ba"] += 1
    pending = PendingBA(res=res, kf_ids=kf_ids, kf_index=kf_index, fixed=fixed, pt_ids=pt_ids,
                        obs_kf=obs_kf, obs_mp=obs_mp, K=K, P=P, O=O)
    if async_apply:
        return pending
    pending.apply(mp)
    return None


class PendingBA:
    """A dispatched-but-unfetched window BA (see run_ba async_apply).  On
    the card a CUDA event recorded after the dispatch tells whether the
    solve has finished (``ready``); CPU results are always ready."""

    def __init__(self, res, kf_ids, kf_index, fixed, pt_ids, obs_kf, obs_mp, K, P, O):
        self.res = res
        self.kf_ids = kf_ids
        self.kf_index = kf_index
        self.fixed = fixed
        self.pt_ids = pt_ids
        self.obs_kf = obs_kf
        self.obs_mp = obs_mp
        self.K, self.P, self.O = K, P, O
        self.event = None
        if res.R.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def handles(self):
        r = self.res
        return [r.R, r.t, r.points, r.inliers]

    def apply(self, mp: SLAMMap):
        self.apply_fetched(mp, pack_fetch(self.handles()))

    def apply_fetched(self, mp: SLAMMap, fetched):
        R_all, t_all, pts_out, inl = fetched
        R_out = np.asarray(R_all)[: self.K]
        t_out = np.asarray(t_all)[: self.K]
        for k, i in self.kf_index.items():
            if not self.fixed[i] and k in mp.keyframes:
                mp.keyframes[k].R = R_out[i]
                mp.keyframes[k].t = t_out[i]
        live = mp.mp_valid[self.pt_ids]
        mp.mp_pos[self.pt_ids[live]] = np.asarray(pts_out)[: self.P][live]

        inl = np.asarray(inl)
        for o in np.where(~inl[: self.O])[0]:
            p = int(self.pt_ids[self.obs_mp[o]])
            kf_id = self.kf_ids[self.obs_kf[o]]
            if kf_id in mp.keyframes:
                mp.erase_observation(p, kf_id)
        mp.version += 1


def fundamental_matrix(K, R1, t1, R2, t2) -> np.ndarray:
    """ComputeF12 (reference LocalMapping.cc:1032 region): the fundamental
    matrix from keyframe 2 to keyframe 1, with (R, t) world->camera."""
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]], np.float32)
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ R12 @ Kinv


def _triangulation_program(scale_factors, inv_sigma2, K):
    """CreateNewMapPoints device stage for one neighbour-capacity group:
    epipolar search + DLT triangulation + acceptance checks over B
    neighbour keyframes, in one K7 launch on the card."""
    sigma2_list = [1.0 / s for s in inv_sigma2]
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    factor = float(np.float32(1.5 * float(scale_factors[1])))

    def run(desc1, xy1, oct1, free1, desc2B, xy2B, oct2B, free2B,
            F12B, P1, P2B, R1, t1, R2B, t2B, O1, O2B):
        dev = desc1.device
        sigma2 = torch.tensor(sigma2_list, dtype=torch.float32, device=dev)
        sf = torch.tensor(scale_factors, dtype=torch.float32, device=dev)
        geom = fm.TriGeometry(P1=P1, P2=P2B, R1=R1, t1=t1, R2=R2B, t2=t2B, O1=O1, O2=O2B,
                              K=(fx, fy, cx, cy), scale_factors=sf, factor=factor)
        return fm.tri_search(desc1, xy1, oct1, free1, desc2B, xy2B, oct2B, free2B, F12B,
                             sigma2, geom)

    return run


def _fuse_program(cam, scale_factors):
    """SearchInNeighbors device stage: the local-map projection search of
    each (point block, keyframe) job, one K3 launch per job.  The JAX
    module passes th=0.75 and img_wh=(1e9, 1e9); so does this."""

    def run(mp_posB, mp_descB, mp_valB, mp_normB, mp_maxdB, R_B, t_B, xyB, descB, octB,
            validB, n_jobs: int):
        return torch.stack([
            fm.search_by_projection_local_map(
                mp_posB[j], mp_descB[j], mp_valB[j], mp_normB[j], mp_maxdB[j], R_B[j], t_B[j],
                xyB[j], descB[j], octB[j], validB[j], cam, scale_factors, (1e9, 1e9), 0.75)
            for j in range(n_jobs)])

    return run


class LocalMapper:
    def __init__(self, cam: Camera, scale_factors, inv_sigma2, K, device,
                 stats: Optional[collections.Counter] = None):
        self.cam = cam
        self.scale_factors = scale_factors
        self.inv_sigma2 = inv_sigma2
        self.K = K
        self.device = torch.device(device)
        # counts of the device work dispatched: "ba" solves, "tri_groups"
        self.stats = stats if stats is not None else collections.Counter()
        self.recent_points: List[int] = []
        # called with (map, kf_id) when KeyFrameCulling removes a keyframe
        # (KeyFrame::SetBadFlag -> KeyFrameDatabase::erase)
        self.on_kf_removed = None
        # in-flight window BA: applied at the next fetch that carries it
        self._pending_ba: Optional[PendingBA] = None
        self._pending_ba_mid = -1
        # the IMU calibration of an inertial tracker (None: visual-only)
        self.imu_calib = None
        # deferred triangulation and fuse (defer_fetch): (mid, kf_id, tri,
        # fuse) dispatched at the keyframe event, fetched with the tracker's
        # next confirmation
        self._pending_tf = None
        # called when deferred results landed or were dropped (the tracker
        # gates its weak-tracking keyframe trigger on it)
        self.on_tf_applied = None

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def flush_ba(self, mp: SLAMMap, force: bool = True):
        """Apply the in-flight window BA, if any (and still valid).

        With force=False (polled at keyframe events) a solve still
        running on the card is LEFT in flight instead of waited on — the
        reference's mbAbortBA semantics (src/Tracking.cc:2770
        InterruptBA)."""
        p = self._pending_ba
        if p is None:
            return
        if not force and not p.ready():
            return
        self._pending_ba = None
        if self._pending_ba_mid == mp.mid:
            p.apply(mp)

    def pending_ba_handles(self):
        """Device tensors of the in-flight window BA result, for riding the
        tracker's confirmation fetch.  [] when nothing is pending."""
        if self._pending_ba is None:
            return []
        return self._pending_ba.handles()

    def apply_ba_fetched(self, mp: SLAMMap, vals):
        """Apply the in-flight window BA from already-fetched host values
        (the pending_ba_handles structure)."""
        p = self._pending_ba
        self._pending_ba = None
        if p is not None and self._pending_ba_mid == mp.mid:
            p.apply_fetched(mp, vals)

    def discard_ba(self):
        """Drop the in-flight window BA and the deferred triangulation and
        fuse results: the map poses under them were rewritten (a loop
        correction, a merge, the IMU alignment) or the map is gone.  The
        keyframe whose results are dropped keeps a sparser local map; the
        next keyframe's triangulation refills it, as in the JAX module.
        The notifier fires as it does when results land."""
        self._pending_ba = None
        self._pending_tf = None
        if self.on_tf_applied is not None:
            self.on_tf_applied()

    # ---- deferred triangulation and fuse (the fetch rides a confirmation)

    def has_pending_tf(self) -> bool:
        """True while deferred triangulation/fuse results are in flight."""
        return self._pending_tf is not None

    def pending_tf_handles(self):
        """Device tensors of the deferred triangulation and fuse results,
        for riding the tracker's confirmation fetch.  [] when nothing is
        pending."""
        if self._pending_tf is None:
            return []
        _, _, tri, fuse = self._pending_tf
        return [[g[-1] for g in tri], [g[-1] for g in fuse]]

    def apply_tf(self, mp: SLAMMap, fetched):
        """Apply the deferred triangulation and fuse from already-fetched
        host values (the pending_tf_handles structure), then dispatch the
        window BA, so that its problem holds the points that just landed."""
        if self._pending_tf is None:
            return
        mid, kf_id, tri, fuse = self._pending_tf
        self._pending_tf = None
        if mid == mp.mid and kf_id in mp.keyframes:
            self._create_new_points_apply(mp, kf_id, tri, fetched[0])
            self._fuse_apply_all(mp, fuse, fetched[1])
            self._local_ba(mp, kf_id)
        if self.on_tf_applied is not None:
            self.on_tf_applied()

    def flush_tf(self, mp: SLAMMap):
        """Fetch and apply the deferred triangulation and fuse, if any."""
        if self._pending_tf is None:
            return
        self.apply_tf(mp, pack_fetch(self.pending_tf_handles()))

    # ----------------------------------------------------------- pipeline

    def process_keyframe(self, mp: SLAMMap, kf_id: int, defer_fetch: bool = False):
        """ProcessNewKeyFrame + culling + CreateNewMapPoints +
        SearchInNeighbors fuse + local BA + KeyFrameCulling (reference
        LocalMapping::Run body, :78-230).  The triangulation and fuse
        launches are enqueued together and fetched with one copy; the
        fuse therefore projects the PRE-triangulation point set, as in
        the JAX module.  With ``defer_fetch`` the copy rides the tracker's
        next confirmation (``apply_tf`` then dispatches the window BA)."""
        self.flush_tf(mp)
        self.flush_ba(mp, force=False)
        self._assign_parent(mp, kf_id)
        self._cull_map_points(mp)
        tri = self._create_new_points_dispatch(mp, kf_id)
        fuse = self._fuse_dispatch(mp, kf_id)
        if defer_fetch:
            self._pending_tf = (mp.mid, kf_id, tri, fuse)
        else:
            fetched = pack_fetch([[g[-1] for g in tri], [g[-1] for g in fuse]])
            self._create_new_points_apply(mp, kf_id, tri, fetched[0])
            self._fuse_apply_all(mp, fuse, fetched[1])
            self._local_ba(mp, kf_id)
        self._cull_keyframes(mp, kf_id)

    def _assign_parent(self, mp: SLAMMap, kf_id: int):
        """Spanning-tree parent: the strongest earlier covisible at
        insertion (reference KeyFrame::UpdateConnections)."""
        kf = mp.keyframes.get(kf_id)
        if kf is None or kf.parent >= 0:
            return
        for nk, _ in mp.covisible_keyframes(kf_id, 1):
            if nk < kf_id:
                kf.parent = nk
                return

    def _cull_map_points(self, mp: SLAMMap):
        """MapPointCulling (reference :341): drop points with found/visible
        ratio < 0.25 or too few observations soon after creation."""
        still = []
        for p in self.recent_points:
            if not mp.mp_valid[p]:
                continue
            vis = max(int(mp.mp_visible[p]), 1)
            ratio = mp.mp_found[p] / vis
            n_obs = mp.n_observations(p)
            if ratio < 0.25 and vis >= 3:
                mp.remove_point(p)
            elif vis >= 4 and n_obs <= 2:
                mp.remove_point(p)
            elif vis >= 6:
                pass  # survived probation
            else:
                still.append(p)
        self.recent_points = still

    def _create_new_points_dispatch(self, mp: SLAMMap, kf_id: int, n_neighbors: int = 10):
        """CreateNewMapPoints device stage (reference :383) over the
        covisible neighbours, one K7 launch per neighbour-capacity group.
        Returns [(group kfs, device outputs)] without waiting."""
        kf1 = mp.keyframes[kf_id]
        neighbors = [k for k, _ in mp.covisible_keyframes(kf_id, 1)[:n_neighbors]]
        O1 = kf1.center()
        free1 = kf1.valid & (kf1.kp_mp < 0)
        use = []
        for nk in neighbors:
            kf2 = mp.keyframes[nk]
            baseline = np.linalg.norm(kf2.center() - O1)
            med_depth = self._median_depth(mp, kf2)
            if med_depth > 0 and baseline / med_depth >= 0.01:
                use.append(kf2)
        if not use:
            return []
        # the pinhole K on raw pixels whatever the camera, as the JAX
        # program (its local_mapping.py:204-245): a matched fault (ROADMAP C.2)
        P1 = (self.K @ np.concatenate([kf1.R, kf1.t[:, None]], 1)).astype(np.float32)
        prog = _triangulation_program(tuple(self.scale_factors), tuple(self.inv_sigma2), self.K)
        out = []
        # neighbour keyframes may have different keypoint capacities (the
        # init extractor runs at 5x): one launch per capacity group.  The
        # JAX module pads each group to a bucket of 4/8/12 for its compiled
        # programs; eager PyTorch launches the real neighbours only.
        groups = {}
        for k2 in use:
            groups.setdefault(len(k2.valid), []).append(k2)
        for grp in groups.values():
            desc2 = torch.stack([k2.feats.desc for k2 in grp])
            oct2 = torch.stack([k2.feats.octave for k2 in grp])
            xy2 = np.stack([k2.xy_un for k2 in grp])
            free2 = np.stack([k2.valid & (k2.kp_mp < 0) for k2 in grp])
            F12 = np.stack([self._fundamental(kf1, k2) for k2 in grp])
            P2 = np.stack([(self.K @ np.concatenate([k2.R, k2.t[:, None]], 1)).astype(np.float32)
                           for k2 in grp])
            R2 = np.stack([k2.R for k2 in grp])
            t2 = np.stack([k2.t for k2 in grp])
            O2 = np.stack([k2.center() for k2 in grp])
            d = self._dev
            res = prog(
                kf1.feats.desc, d(kf1.xy_un.astype(np.float32)), kf1.feats.octave, d(free1),
                desc2, d(xy2.astype(np.float32)), oct2, d(free2),
                d(F12.astype(np.float32)), d(P1), d(P2),
                d(kf1.R.astype(np.float32)), d(kf1.t.astype(np.float32)),
                d(R2.astype(np.float32)), d(t2.astype(np.float32)),
                d(O1.astype(np.float32)), d(O2.astype(np.float32)),
            )
            self.stats["tri_groups"] += 1
            out.append((grp, res))
        return out

    def _create_new_points_apply(self, mp: SLAMMap, kf_id: int, dispatched, fetched):
        """Host side of CreateNewMapPoints: claim keypoints (first
        neighbour wins, the reference's sequential order) and create the
        accepted points."""
        kf1 = mp.keyframes.get(kf_id)
        if kf1 is None:
            return
        created = []
        for (grp, _), (m12B, XB, okB) in zip(dispatched, fetched):
            for b, kf2 in enumerate(grp):
                if kf2.kid not in mp.keyframes:
                    continue
                for i1 in np.where(okB[b])[0]:
                    i2 = int(m12B[b, i1])
                    if kf1.kp_mp[i1] >= 0 or kf2.kp_mp[i2] >= 0:
                        continue  # claimed by an earlier neighbour
                    mid = mp.add_point(XB[b, i1], kf1.desc[i1], np.zeros(3, np.float32),
                                       1.0, kf1.kid)
                    mp.add_observation(mid, kf1.kid, int(i1))
                    mp.add_observation(mid, kf2.kid, i2)
                    created.append(mid)
                    self.recent_points.append(mid)
        mp.update_point_stats_batch(created)

    def _median_depth(self, mp: SLAMMap, kf) -> float:
        ids = kf.kp_mp[kf.kp_mp >= 0]
        ids = ids[mp.mp_valid[ids]] if len(ids) else ids
        if len(ids) == 0:
            return -1.0
        pc = mp.mp_pos[ids] @ kf.R.T + kf.t
        return float(np.median(pc[:, 2]))

    def _fundamental(self, kf1, kf2) -> np.ndarray:
        return fundamental_matrix(self.K, kf1.R, kf1.t, kf2.R, kf2.t)

    def _fuse_dispatch(self, mp: SLAMMap, kf_id: int, n_neighbors: int = 10):
        """SearchInNeighbors device stage (reference LocalMapping.cc:729):
        the B+1 projection searches, grouped by target-keyframe capacity.
        Returns [(jobs, device matches)] without waiting."""
        kf1 = mp.keyframes[kf_id]
        neighbors = [k for k, _ in mp.covisible_keyframes(kf_id, 1)[:n_neighbors]]
        if not neighbors:
            return []
        M_CAP = 4096
        own = mp.points_seen_by([kf_id])
        jobs = [(kf_id, mp.points_seen_by(neighbors))] + [(nk, own) for nk in neighbors]
        # per-job filter: drop points already observed by the target
        filt = []
        for tgt, pt_ids in jobs:
            pt_ids = np.asarray([p for p in pt_ids if tgt not in mp.obs.get(int(p), {})],
                                np.int32)[:M_CAP]
            if len(pt_ids):
                filt.append((tgt, pt_ids))
        if not filt:
            return []
        biggest = max(len(p) for _, p in filt)
        M = next(b for b in (512, 1024, 2048, 4096) if biggest <= b)
        by_cap = {}
        for tgt, pt_ids in filt:
            by_cap.setdefault(len(mp.keyframes[tgt].valid), []).append((tgt, pt_ids))
        prog = _fuse_program(self.cam, tuple(self.scale_factors))
        out = []
        for N, jobs in by_cap.items():
            B = len(jobs)
            posB = np.zeros((B, M, 3), np.float32)
            descB = np.zeros((B, M, 32), np.uint8)
            normB = np.zeros((B, M, 3), np.float32)
            maxdB = np.ones((B, M), np.float32)
            valB = np.zeros((B, M), bool)
            R_B = np.zeros((B, 3, 3), np.float32)
            t_B = np.zeros((B, 3), np.float32)
            xyB = np.zeros((B, N, 2), np.float32)
            kvalidB = np.zeros((B, N), bool)
            for j, (tgt, pt_ids) in enumerate(jobs):
                k = len(pt_ids)
                posB[j, :k] = mp.mp_pos[pt_ids]
                descB[j, :k] = mp.mp_desc[pt_ids]
                normB[j, :k] = mp.mp_normal[pt_ids]
                maxdB[j, :k] = mp.mp_max_dist[pt_ids]
                valB[j, :k] = mp.mp_valid[pt_ids]
                kf = mp.keyframes[tgt]
                R_B[j], t_B[j] = kf.R, kf.t
                xyB[j] = kf.xy_un
                kvalidB[j] = kf.valid
            kdesc = torch.stack([mp.keyframes[tgt].feats.desc for tgt, _ in jobs])
            koct = torch.stack([mp.keyframes[tgt].feats.octave for tgt, _ in jobs])
            d = self._dev
            matchesB = prog(d(posB), d(descB), d(valB), d(normB), d(maxdB), d(R_B), d(t_B),
                            d(xyB), kdesc, koct, d(kvalidB), B)
            out.append((jobs, matchesB))
        return out

    def _fuse_apply_all(self, mp: SLAMMap, dispatched, fetched):
        touched = []
        for (jobs, _), matchesB in zip(dispatched, fetched):
            for j, (tgt, pt_ids) in enumerate(jobs):
                if tgt in mp.keyframes:
                    touched.extend(self._apply_fuse(mp, tgt, pt_ids, np.asarray(matchesB[j])))
        mp.update_point_stats_batch(touched)

    def _apply_fuse(self, mp: SLAMMap, kf_id: int, pt_ids: np.ndarray, matches: np.ndarray):
        """Attach-or-merge the accepted projections (reference
        ORBmatcher::Fuse tail, ORBmatcher.cc:2028 region).  Returns the
        touched point ids (the caller refreshes their stats)."""
        kf = mp.keyframes[kf_id]
        touched = []
        for row in np.where(matches >= 0)[0]:
            p = int(pt_ids[row])
            if not mp.mp_valid[p]:
                continue  # merged away by an earlier job of this batch
            kp = int(matches[row])
            existing = int(kf.kp_mp[kp])
            if existing >= 0 and mp.mp_valid[existing]:
                # merge: keep the point with more observations
                if mp.n_observations(existing) >= mp.n_observations(p):
                    keep, drop = existing, p
                else:
                    keep, drop = p, existing
                if keep == drop:
                    continue
                for okf, okp in list(mp.obs.get(drop, {}).items()):
                    if okf not in mp.obs.get(keep, {}):
                        mp.obs[keep][okf] = okp
                        mp.keyframes[okf].kp_mp[okp] = keep
                    elif mp.keyframes[okf].kp_mp[okp] == drop:
                        mp.keyframes[okf].kp_mp[okp] = -1
                mp.obs[drop] = {}
                mp.remove_point(drop)
                touched.append(keep)
            else:
                mp.add_observation(p, kf_id, kp)
                touched.append(p)
        return touched

    def _cull_keyframes(self, mp: SLAMMap, kf_id: int):
        """KeyFrameCulling (reference :935): a covisible keyframe is
        redundant if >=90% of its map points are observed by >=3 other
        keyframes at the same or finer scale."""
        for cand, _ in mp.covisible_keyframes(kf_id, 1):
            kf = mp.keyframes.get(cand)
            if kf is None or cand <= 1:  # keep the initial pair
                continue
            # inertial maps: culling must not starve or break the temporal
            # chain (reference KeyFrameCulling's inertial branch, :935+)
            if self.imu_calib is not None:
                if not mp.imu_initialized:
                    continue
                prev = mp.keyframes.get(kf.prev_kf)
                succ = next((k for k in mp.keyframes.values() if k.prev_kf == cand), None)
                if prev is not None and succ is not None:
                    if succ.timestamp - prev.timestamp > (3.0 if mp.imu_ba2 else 0.5):
                        continue
            kp_rows = np.where(kf.kp_mp >= 0)[0]
            if len(kp_rows) < 10:
                continue
            ids = kf.kp_mp[kp_rows]
            ok = mp.mp_valid[ids]
            kp_rows, ids = kp_rows[ok], ids[ok]
            n_pts = len(ids)
            if n_pts == 0:
                continue
            lvls = kf.octave[kp_rows].astype(np.int32)
            lookup = np.full(len(mp.mp_valid), -1, np.int32)
            lookup[ids] = np.arange(n_pts, dtype=np.int32)
            n_better = np.zeros(n_pts, np.int32)
            for okf_id, okf in mp.keyframes.items():
                if okf_id == cand:
                    continue
                orows = np.where(okf.kp_mp >= 0)[0]
                pidx = lookup[okf.kp_mp[orows]]
                keep = pidx >= 0
                orows, pidx = orows[keep], pidx[keep]
                fine = okf.octave[orows] <= lvls[pidx] + 1
                np.add.at(n_better, pidx[fine], 1)
            if int((n_better >= 3).sum()) > 0.9 * n_pts:
                self._remove_keyframe(mp, cand)

    def _remove_keyframe(self, mp: SLAMMap, kf_id: int):
        """SetBadFlag analog: detach all observations and drop the KF."""
        kf = mp.keyframes.get(kf_id)
        if kf is None:
            return
        for kp in np.where(kf.kp_mp >= 0)[0]:
            p = int(kf.kp_mp[kp])
            if p in mp.obs and kf_id in mp.obs[p]:
                mp.erase_observation(p, kf_id)
        # inertial chain repair (reference KeyFrame::SetBadFlag +
        # Preintegrated::MergePrevious, ImuTypes.cc:312): the successor
        # inherits prev_kf and the merged measurement window
        succ = next((k for k in mp.keyframes.values() if k.prev_kf == kf_id), None)
        if succ is not None:
            succ.prev_kf = kf.prev_kf
            if self.imu_calib is not None and (kf.imu_meas is not None
                                               or succ.imu_meas is not None):
                succ.imu_meas = imu_frontend.merge_measurements(kf.imu_meas, succ.imu_meas)
                bias = (np.concatenate([succ.bg, succ.ba]).astype(np.float32)
                        if succ.bg is not None else np.zeros(6, np.float32))
                if succ.imu_meas is not None:
                    succ.preint = imu_frontend.integrate_raw_host(
                        succ.imu_meas, bias, self.imu_calib, self.device, self.stats)
        # spanning-tree surgery: reparent children to this KF's parent
        for other in mp.keyframes.values():
            if other.parent == kf_id:
                other.parent = kf.parent
        kf.is_bad = True
        # tombstone for trajectory resolution (reference SetBadFlag's mTcp)
        parent = mp.keyframes.get(kf.parent)
        if parent is not None:
            R_cp = (kf.R @ parent.R.T).astype(np.float32)
            t_cp = (kf.t - R_cp @ parent.t).astype(np.float32)
            mp.dead_kfs[kf_id] = (kf.parent, R_cp, t_cp)
        del mp.keyframes[kf_id]
        mp.version += 1
        if self.on_kf_removed is not None:
            self.on_kf_removed(mp, kf_id)

    def _local_ba(self, mp: SLAMMap, kf_id: int):
        """LocalBundleAdjustment window build (reference Optimizer.cc:1698):
        local = covisibles of the new KF; fixed = other KFs observing the
        local points.  Dispatched without waiting, like the reference's
        concurrent mapping thread.  An inertial map with its IMU initialised
        runs LocalInertialBA over the temporal window instead (reference
        LocalMapping.cc:149-154), synchronously as the JAX module does."""
        if self.imu_calib is not None and mp.imu_initialized:
            if imu_frontend.local_inertial_ba(mp, self.imu_calib, self.cam, kf_id, n_window=10,
                                              device=self.device, stats=self.stats):
                return
        local = [kf_id] + [k for k, _ in mp.covisible_keyframes(kf_id, 1)]
        local_set = set(local)
        pt_ids = mp.points_seen_by(local)
        fixed: Set[int] = set()
        for p in pt_ids:
            for k in mp.obs.get(int(p), {}):
                if k not in local_set:
                    fixed.add(k)
        all_ids = local + sorted(fixed)
        all_ids = all_ids[:24]  # keep the problem bounded
        if len(local) >= len(all_ids):
            fixed_ids = {all_ids[-1]} if len(all_ids) > 2 else set()
        else:
            fixed_ids = set(all_ids) - set(local)
        self._pending_ba = run_ba(
            mp, all_ids, fixed_ids, self.cam, self.inv_sigma2, self.device,
            n_iters=5, cg_iters=25, async_apply=True, stats=self.stats,
        )
        self._pending_ba_mid = mp.mid
