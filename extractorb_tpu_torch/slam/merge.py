"""Atlas map merging (port of ``extractorb_tpu/slam/merge.py``, visual).

Replaces LoopClosing::MergeLocal (reference src/LoopClosing.cc:1252) and
MergeBundleAdjustmentVisual (src/Optimizer.cc:5759).  When place
recognition matches the current keyframe against a keyframe of another
Atlas map, the active (newer) map is welded into the matched (older) one:
every keyframe pose and map point is moved by the verified camera Sim3
lifted to a world Sim3 (scale folded into translations and points),
appended with new ids, and a welding bundle adjustment (the port's window
BA, kernel K6) runs over the covisible windows around the seam.  The
inertial weld (MergeInertialBA) is ROADMAP A.11.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..core.camera import Pinhole
from .map import Atlas, SLAMMap

F32 = np.float32


def world_sim3_from_camera_sim3(kf_drop_R, kf_drop_t, kf_keep_R, kf_keep_t, S_R, S_t,
                                S_s: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lift a camera-frame Sim3 (p_keepcam = s S_R p_dropcam + S_t) to the
    world Sim3 p_keepworld = sw Rw p_dropworld + tw."""
    R1, t1 = kf_drop_R, kf_drop_t
    R2, t2 = kf_keep_R, kf_keep_t
    Rw = (R2.T @ S_R @ R1).astype(F32)
    tw = (R2.T @ (S_s * (S_R @ t1) + S_t - t2)).astype(F32)
    return Rw, tw, float(S_s)


def merge_maps(atlas: Atlas, drop: SLAMMap, keep: SLAMMap, kf_drop_id: int, kf_keep_id: int,
               S_R: np.ndarray, S_t: np.ndarray, S_s: float) -> Dict:
    """Weld ``drop`` into ``keep`` and make ``keep`` the active map.
    Returns {"kf_remap", "mp_remap", "world_sim3", "kf_cur", "kf_matched",
    "dropped_mid", "dead_remap"} for the caller's fix-ups."""
    kf1 = drop.keyframes[kf_drop_id]
    kf2 = keep.keyframes[kf_keep_id]
    Rw, tw, sw = world_sim3_from_camera_sim3(kf1.R, kf1.t, kf2.R, kf2.t, S_R, S_t, S_s)

    for kf in drop.keyframes.values():
        Rn = (kf.R @ Rw.T).astype(F32)
        tn = (sw * kf.t - Rn @ tw).astype(F32)
        kf.R, kf.t = Rn, tn
        if kf.v is not None:
            kf.v = (sw * (Rw @ kf.v)).astype(F32)

    kf_remap: Dict[int, int] = {}
    old_prev: Dict[int, int] = {}
    for kid in sorted(drop.keyframes):
        kf = drop.keyframes[kid]
        old_prev[kid] = kf.prev_kf
        keep.add_keyframe(kf)  # reassigns kf.kid
        kf_remap[kid] = kf.kid
    for kid, new_id in kf_remap.items():
        keep.keyframes[new_id].prev_kf = kf_remap.get(old_prev[kid], -1)

    n = drop._next_mp
    new_pos = (sw * drop.mp_pos[:n] @ Rw.T + tw).astype(F32)
    new_normal = (drop.mp_normal[:n] @ Rw.T).astype(F32)
    mp_remap: Dict[int, int] = {}
    for p in range(n):
        if not drop.mp_valid[p]:
            continue
        first = kf_remap.get(int(drop.mp_first_kf[p]), -1)
        new_id = keep.add_point(new_pos[p], drop.mp_desc[p], new_normal[p],
                                sw * float(drop.mp_max_dist[p]), first)
        keep.mp_visible[new_id] = drop.mp_visible[p]
        keep.mp_found[new_id] = drop.mp_found[p]
        mp_remap[p] = new_id
        keep.obs[new_id] = {kf_remap[k]: kp for k, kp in drop.obs.get(p, {}).items()
                            if k in kf_remap}
    for new_id in kf_remap.values():
        kf = keep.keyframes[new_id]
        kf.kp_mp = np.array([mp_remap.get(int(m), -1) if m >= 0 else -1 for m in kf.kp_mp],
                            kf.kp_mp.dtype)

    # tombstones of culled keyframes move under fresh ids (kf ids are
    # per-map counters); their translations carry the scale
    dead_remap: Dict[int, int] = {}
    for k in sorted(drop.dead_kfs):
        dead_remap[k] = keep._next_kf
        keep._next_kf += 1
    for k, (pk, R_cp, t_cp) in drop.dead_kfs.items():
        new_pk = kf_remap.get(pk, dead_remap.get(pk, -1))
        keep.dead_kfs[dead_remap[k]] = (new_pk, R_cp, (sw * t_cp).astype(F32))

    keep.imu_initialized = keep.imu_initialized or drop.imu_initialized
    keep.imu_ba1 = keep.imu_ba1 or drop.imu_ba1
    keep.imu_ba2 = keep.imu_ba2 or drop.imu_ba2

    atlas.remove_map(drop.mid)
    if keep in atlas.maps:
        atlas.active = atlas.maps.index(keep)
    keep.version += 1
    return {
        "type": "merge", "kf_remap": kf_remap, "mp_remap": mp_remap,
        "world_sim3": (Rw, tw, sw), "kf_cur": kf_remap[kf_drop_id], "kf_matched": kf_keep_id,
        "dropped_mid": drop.mid, "dead_remap": dead_remap,
    }


def weld_bundle_adjustment(mp: SLAMMap, kf_cur: int, kf_matched: int, cam: Pinhole,
                           inv_sigma2: Sequence[float], device, n_iters: int = 10,
                           window: int = 8, stats=None):
    """MergeBundleAdjustmentVisual analog: the covisible windows around
    both seam keyframes are optimised, other observers of their points are
    held fixed (the matched keyframe alone when there are none).  The BA is
    dispatched: the returned ``PendingBA`` (None when there is nothing to
    solve) is applied later (``LoopCloser.poll_weld``)."""
    from .local_mapping import run_ba

    local = {kf_cur, kf_matched}
    for seed in (kf_cur, kf_matched):
        if seed not in mp.keyframes:
            continue
        for k, _ in mp.covisible_keyframes(seed, min_weight=5)[:window]:
            local.add(k)
    fixed = set()
    for p in mp.points_seen_by(sorted(local)):
        for k in mp.obs.get(int(p), {}):
            if k not in local:
                fixed.add(k)
    fixed = set(sorted(fixed)[: 2 * window])
    if not fixed:
        fixed = {kf_matched}
        local.discard(kf_matched)
    return run_ba(mp, sorted(local | fixed), fixed, cam, inv_sigma2, device, n_iters=n_iters,
                  async_apply=True, stats=stats)
