"""Global bundle adjustment after a loop correction (port of
``extractorb_tpu/dist/global_ba.py``, one device).

Replaces LoopClosing::RunGlobalBundleAdjustment (reference
src/LoopClosing.cc:2430): the whole active map is refined by the Schur
LM solver (``dist/sharded_ba.optimize_schur``, kernel K14 on the card).
The problem is built once on the host in the JAX module's layout (points
in contiguous shard blocks, observations grouped by their point's shard
and padded to a multiple of 128); on one device that is one shard.  The
solve is dispatched without waiting (``PendingGBA``) and applied on a
later keyframe event or at ``finish``, which also propagates the
correction to keyframes and points outside the problem through the
spanning tree and the points' reference keyframes (LoopClosing.cc
:2430+8-66).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.camera import Pinhole
from ..solver import ba as sba
from ..utils.packed_fetch import pack_fetch
from .sharded_ba import optimize_schur


def build_global_problem(mp, inv_sigma2: Sequence[float], n_shards: int,
                         fixed_ids: Optional[Set[int]] = None, device="cpu"):
    """Full-map BAProblem on ``device`` with landmarks in ``n_shards``
    contiguous blocks and each observation stored on its point's shard.

    Returns (problem, kf_ids, pt_ids, obs_kf, obs_mp, obs_valid) with the
    host observation arrays, or None if the map is too small."""
    kf_ids = sorted(mp.keyframes.keys())
    if len(kf_ids) < 2:
        return None
    if fixed_ids is None:
        fixed_ids = {kf_ids[0]}
    pt_ids = mp.points_seen_by(kf_ids)
    if len(pt_ids) < 8:
        return None
    P = len(pt_ids)
    Ps = -(-P // n_shards)
    P_pad = Ps * n_shards

    lookup = np.full(len(mp.mp_valid), -1, np.int32)
    lookup[pt_ids] = np.arange(P, dtype=np.int32)
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
    obs_uv = np.concatenate(ouv_l, 0).astype(np.float32)
    obs_sig = np.concatenate(osig_l)
    if len(obs_kf) < 16:
        return None

    shard_of = obs_mp // Ps
    order = np.argsort(shard_of, kind="stable")
    obs_kf, obs_mp = obs_kf[order], obs_mp[order]
    obs_uv, obs_sig = obs_uv[order], obs_sig[order]
    shard_of = shard_of[order]
    counts = np.bincount(shard_of, minlength=n_shards)
    Os = int(np.ceil(max(int(counts.max()), 1) / 128) * 128)
    O_pad = Os * n_shards
    okf = np.zeros(O_pad, np.int32)
    omp = np.zeros(O_pad, np.int32)
    ouv = np.zeros((O_pad, 2), np.float32)
    osig = np.ones(O_pad, np.float32)
    oval = np.zeros(O_pad, bool)
    start = 0
    for s in range(n_shards):
        n = int(counts[s])
        dst = s * Os
        okf[dst:dst + n] = obs_kf[start:start + n]
        omp[dst:dst + n] = obs_mp[start:start + n]
        ouv[dst:dst + n] = obs_uv[start:start + n]
        osig[dst:dst + n] = obs_sig[start:start + n]
        oval[dst:dst + n] = True
        omp[dst + n:dst + Os] = s * Ps   # padding addresses a point of its own shard
        start += n

    Rs = np.stack([mp.keyframes[k].R for k in kf_ids]).astype(np.float32)
    ts = np.stack([mp.keyframes[k].t for k in kf_ids]).astype(np.float32)
    fixed = np.array([k in fixed_ids for k in kf_ids])
    if not fixed.any():
        fixed[0] = True
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0                  # padded points off the camera plane
    pts[:P] = mp.mp_pos[pt_ids]
    fixed_mp = np.ones(P_pad, bool)
    fixed_mp[:P] = False

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prob = sba.BAProblem(R=to(Rs), t=to(ts), points=to(pts), obs_kf=to(okf), obs_mp=to(omp),
                         obs_uv=to(ouv), inv_sigma2=to(osig), obs_valid=to(oval),
                         fixed_kf=to(fixed), fixed_mp=to(fixed_mp))
    return prob, kf_ids, pt_ids, okf, omp, oval


class PendingGBA:
    """A dispatched-but-unfetched global BA (reference: the transient
    RunGlobalBundleAdjustment thread, LoopClosing.cc:1013+231, :2430).  On
    the card a CUDA event recorded after the dispatch tells whether the
    solve has finished; CPU results are always ready.  ``apply`` fetches
    the result, writes it back, erases outlier observations and
    propagates the correction."""

    def __init__(self, res, fixed, kf_ids, pt_ids, obs_kf, obs_mp, obs_valid, old_poses, mid):
        self.res = res
        self.fixed = fixed
        self.kf_ids = kf_ids
        self.pt_ids = pt_ids
        self.obs_kf = obs_kf
        self.obs_mp = obs_mp
        self.obs_valid = obs_valid
        self.old_poses = old_poses
        self.mid = mid
        self.event = None
        if res.R.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def apply(self, mp) -> bool:
        """Write back; False (and nothing done) when ``mp`` is not the map
        this solve was dispatched for."""
        if mp.mid != self.mid:
            return False
        kf_ids, pt_ids = self.kf_ids, self.pt_ids
        R_all, t_all, pts_out, inl = pack_fetch(
            [self.res.R, self.res.t, self.res.points, self.res.inliers])
        for i, k in enumerate(kf_ids):
            if not self.fixed[i] and k in mp.keyframes:
                mp.keyframes[k].R = np.asarray(R_all[i])
                mp.keyframes[k].t = np.asarray(t_all[i])
        live = mp.mp_valid[pt_ids]
        mp.mp_pos[pt_ids[live]] = np.asarray(pts_out)[: len(pt_ids)][live]
        inl = np.asarray(inl)
        for o in np.where(self.obs_valid & ~inl)[0]:
            p = int(pt_ids[self.obs_mp[o]]) if self.obs_mp[o] < len(pt_ids) else -1
            if p >= 0 and mp.mp_valid[p] and kf_ids[self.obs_kf[o]] in mp.keyframes:
                mp.erase_observation(p, kf_ids[self.obs_kf[o]])
        propagate_corrections(mp, self.old_poses, set(kf_ids), set(pt_ids.tolist()))
        mp.version += 1
        return True


def dispatch_global_ba(mp, cam: Pinhole, inv_sigma2: Sequence[float], device, n_iters: int = 10,
                       world_size: int = 1,
                       fixed_ids: Optional[Set[int]] = None) -> Optional[PendingGBA]:
    """Build and dispatch the full-map BA without waiting; None when the
    map is too small.  ``world_size`` > 1 raises (ROADMAP A.14)."""
    built = build_global_problem(mp, inv_sigma2, world_size, fixed_ids, device)
    if built is None:
        return None
    prob, kf_ids, pt_ids, obs_kf, obs_mp, obs_valid = built
    old_poses = {k: (mp.keyframes[k].R.copy(), mp.keyframes[k].t.copy()) for k in kf_ids}
    res = optimize_schur(prob, cam, n_iters=n_iters, world_size=world_size)
    return PendingGBA(res=res, fixed=prob.fixed_kf.cpu().numpy(), kf_ids=kf_ids, pt_ids=pt_ids,
                      obs_kf=obs_kf, obs_mp=obs_mp, obs_valid=obs_valid, old_poses=old_poses,
                      mid=mp.mid)


def run_global_ba(mp, cam: Pinhole, inv_sigma2: Sequence[float], device, n_iters: int = 10,
                  world_size: int = 1, fixed_ids: Optional[Set[int]] = None) -> bool:
    """Synchronous full-map BA: dispatch and apply.  True when a BA ran."""
    pending = dispatch_global_ba(mp, cam, inv_sigma2, device, n_iters, world_size, fixed_ids)
    if pending is None:
        return False
    return pending.apply(mp)


def propagate_corrections(mp, old_poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
                          optimized_kfs: Set[int], optimized_pts: Set[int]):
    """Spanning-tree propagation (reference LoopClosing.cc:2430+8-66):
    keyframes outside the BA inherit their parent's correction through the
    relative pose; points outside it follow their reference keyframe."""
    pending = [k for k in sorted(mp.keyframes.keys()) if k not in optimized_kfs]
    for k in pending:
        kf = mp.keyframes[k]
        old_poses.setdefault(k, (kf.R.copy(), kf.t.copy()))
    corrected: Set[int] = set(optimized_kfs)
    changed = True
    while changed and pending:
        changed = False
        still = []
        for k in pending:
            kf = mp.keyframes[k]
            par = kf.parent
            if par in corrected and par in mp.keyframes:
                Rp_old, tp_old = old_poses.get(par, (mp.keyframes[par].R, mp.keyframes[par].t))
                Rc_old, tc_old = old_poses[k]
                R_cp = Rc_old @ Rp_old.T
                t_cp = tc_old - R_cp @ tp_old
                pkf = mp.keyframes[par]
                kf.R = (R_cp @ pkf.R).astype(np.float32)
                kf.t = (R_cp @ pkf.t + t_cp).astype(np.float32)
                corrected.add(k)
                changed = True
            else:
                still.append(k)
        pending = still

    n = mp._next_mp
    for p in np.where(mp.mp_valid[:n])[0]:
        p = int(p)
        if p in optimized_pts:
            continue
        ref = int(mp.mp_first_kf[p])
        if ref not in mp.keyframes or ref not in old_poses:
            ref = next((k for k in mp.obs.get(p, {}) if k in old_poses), -1)
            if ref < 0:
                continue
        R_old, t_old = old_poses[ref]
        kf = mp.keyframes[ref]
        pc = R_old @ mp.mp_pos[p] + t_old
        mp.mp_pos[p] = (kf.R.T @ (pc - kf.t)).astype(np.float32)
