"""Checkpoint / resume of a SLAM session (port of
``extractorb_tpu/slam/checkpoint.py``; host numpy, no kernel).

The reference serializes its object graph with boost (inc/System.h:180-186
SaveAtlas/LoadAtlas).  The map state is explicit arrays, so a checkpoint is
one compressed npz, in the JAX package's format key for key and dtype for
dtype: either package reads the other's files.

- ``save_map``/``load_map``: one ``SLAMMap`` with every keyframe field.
- ``save_session``/``load_session``: the whole ``Tracker``: all Atlas maps
  and the tracking resume state (state, frame ids, recovery counters, last
  and init frames, velocity, both trajectory forms), so a session can stop
  mid-sequence, or while lost, and go on.

Inertial sessions carry the IMU chain: each keyframe's preintegration
(``*_preint_*``, host numpy fields) and raw measurement window
(``*_imu_*``), the last frame's preintegration, the maps' staging flags,
the tracker's previous keyframe, keyframe timestamps and bias, and the
measurement queue (``imuq_*``).  The keyframe database's entries
(``db_keys``, ``db_lens``, ``db_words``, ``db_weights``) are saved and, for
a tracker with a vocabulary, restored.  Loaded features and frames live on
the tracker's device (``device=None``: the card, as ``Tracker``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..imu import preintegration as pre
from ..interop import features_from_numpy
from .map import Atlas, KeyFrame, SLAMMap

_PREINT_FIELDS = ("dR", "dV", "dP", "C", "JRg", "JVg", "JVa", "JPg", "JPa", "dT", "bias")


def _put_preint(blobs: dict, prefix: str, preint):
    if preint is None:
        return
    for f in _PREINT_FIELDS:
        v = getattr(preint, f)
        blobs[f"{prefix}_preint_{f}"] = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _get_preint(z, prefix: str):
    """A keyframe's or frame's preintegration, host numpy fields."""
    if f"{prefix}_preint_dR" not in z:
        return None
    return pre.Preintegrated(**{f: np.asarray(z[f"{prefix}_preint_{f}"])
                                for f in _PREINT_FIELDS})


def _put_opt(blobs: dict, key: str, arr):
    if arr is not None:
        blobs[key] = np.asarray(arr)


def _get_opt(z, key: str):
    return np.asarray(z[key]) if key in z else None


def _features(z, p: str, xy_key: str, device):
    n_cap = len(z[f"{p}_valid"])
    return features_from_numpy({
        "xy": z[xy_key],
        "response": z[f"{p}_resp"] if f"{p}_resp" in z else np.zeros(n_cap, np.float32),
        "angle": z[f"{p}_angle"], "octave": z[f"{p}_octave"],
        "size": z[f"{p}_size"] if f"{p}_size" in z else np.full(n_cap, 31.0, np.float32),
        "desc": z[f"{p}_desc"], "valid": z[f"{p}_valid"],
    }, device)


def _put_kf(blobs: dict, p: str, kf: KeyFrame):
    blobs[f"{p}_R"] = kf.R
    blobs[f"{p}_t"] = kf.t
    blobs[f"{p}_meta"] = np.asarray([kf.frame_id, kf.timestamp, kf.parent, kf.prev_kf],
                                    np.float64)
    blobs[f"{p}_xy_un"] = kf.xy_un
    blobs[f"{p}_octave"] = kf.octave
    blobs[f"{p}_angle"] = kf.angle
    blobs[f"{p}_desc"] = kf.desc
    blobs[f"{p}_valid"] = kf.valid
    blobs[f"{p}_kp_mp"] = kf.kp_mp
    blobs[f"{p}_xy"] = kf.feats.xy.cpu().numpy()
    blobs[f"{p}_resp"] = kf.feats.response.cpu().numpy()
    blobs[f"{p}_size"] = kf.feats.size.cpu().numpy()
    blobs[f"{p}_loop_edges"] = np.asarray(kf.loop_edges, np.int64)
    for name in ("ur", "depth", "v", "bg", "ba"):
        _put_opt(blobs, f"{p}_{name}", getattr(kf, name))
    if kf.imu_meas is not None:
        blobs[f"{p}_imu_gyro"] = kf.imu_meas[0]
        blobs[f"{p}_imu_acc"] = kf.imu_meas[1]
        blobs[f"{p}_imu_dt"] = kf.imu_meas[2]
    _put_preint(blobs, p, kf.preint)


def _get_kf(z, p: str, kid: int, device) -> KeyFrame:
    meta = z[f"{p}_meta"]
    imu_meas = None
    if f"{p}_imu_gyro" in z:
        imu_meas = (np.asarray(z[f"{p}_imu_gyro"]), np.asarray(z[f"{p}_imu_acc"]),
                    np.asarray(z[f"{p}_imu_dt"]))
    return KeyFrame(
        kid=kid, frame_id=int(meta[0]), timestamp=float(meta[1]),
        R=np.asarray(z[f"{p}_R"]), t=np.asarray(z[f"{p}_t"]),
        feats=_features(z, p, f"{p}_xy", device),
        xy_un=np.asarray(z[f"{p}_xy_un"]), octave=np.asarray(z[f"{p}_octave"]),
        angle=np.asarray(z[f"{p}_angle"]), desc=np.asarray(z[f"{p}_desc"]),
        valid=np.asarray(z[f"{p}_valid"]), kp_mp=z[f"{p}_kp_mp"].copy(),
        parent=int(meta[2]), prev_kf=int(meta[3]),
        loop_edges=[int(e) for e in z[f"{p}_loop_edges"]] if f"{p}_loop_edges" in z else [],
        ur=_get_opt(z, f"{p}_ur"), depth=_get_opt(z, f"{p}_depth"),
        v=_get_opt(z, f"{p}_v"), bg=_get_opt(z, f"{p}_bg"), ba=_get_opt(z, f"{p}_ba"),
        imu_meas=imu_meas, preint=_get_preint(z, p),
    )


def _put_frame(blobs: dict, p: str, f):
    """A live frame with its raw keypoint fields (xy, response, size): a
    resumed distorted-lens session must not substitute xy_un."""
    f.ensure_host()
    blobs[f"{p}_meta"] = np.asarray([f.frame_id, f.timestamp], np.float64)
    blobs[f"{p}_xy_un"] = f.xy_un
    blobs[f"{p}_octave"] = f.octave
    blobs[f"{p}_angle"] = f.angle
    blobs[f"{p}_desc"] = f.desc
    blobs[f"{p}_valid"] = f.valid
    blobs[f"{p}_kp_mp"] = f.kp_mp
    blobs[f"{p}_xy"] = f.feats.xy.cpu().numpy()
    blobs[f"{p}_resp"] = f.feats.response.cpu().numpy()
    blobs[f"{p}_size"] = f.feats.size.cpu().numpy()
    for name in ("R", "t", "ur", "depth", "v", "bg", "ba"):
        _put_opt(blobs, f"{p}_{name}", getattr(f, name))
    _put_preint(blobs, p, f.preint_frame)


def _get_frame(z, p: str, Frame, device):
    """A frame with its device copies (features, undistorted coords and the
    stereo channels), so it can seed the fused step."""
    xy_key = f"{p}_xy" if f"{p}_xy" in z else f"{p}_xy_un"
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ur, depth = _get_opt(z, f"{p}_ur"), _get_opt(z, f"{p}_depth")
    return Frame(
        frame_id=int(z[f"{p}_meta"][0]), timestamp=float(z[f"{p}_meta"][1]),
        feats=_features(z, p, xy_key, device), xy_un=np.asarray(z[f"{p}_xy_un"]),
        octave=np.asarray(z[f"{p}_octave"]), angle=np.asarray(z[f"{p}_angle"]),
        desc=np.asarray(z[f"{p}_desc"]), valid=np.asarray(z[f"{p}_valid"]),
        kp_mp=z[f"{p}_kp_mp"].copy(), R=_get_opt(z, f"{p}_R"), t=_get_opt(z, f"{p}_t"),
        ur=ur, depth=depth, v=_get_opt(z, f"{p}_v"), bg=_get_opt(z, f"{p}_bg"),
        ba=_get_opt(z, f"{p}_ba"), preint_frame=_get_preint(z, p),
        un_dev=to_dev(np.asarray(z[f"{p}_xy_un"], np.float32)),
        ur_dev=None if ur is None else to_dev(ur.astype(np.float32)),
        depth_dev=None if depth is None else to_dev(depth.astype(np.float32)),
    )


def _put_map(blobs: dict, p: str, mp: SLAMMap):
    n = mp._next_mp
    kf_ids = sorted(mp.keyframes.keys())
    for name in ("mp_pos", "mp_desc", "mp_normal", "mp_max_dist", "mp_valid", "mp_first_kf",
                 "mp_visible", "mp_found"):
        blobs[f"{p}{name}"] = getattr(mp, name)[:n]
    blobs[f"{p}kf_ids"] = np.asarray(kf_ids, np.int64)
    blobs[f"{p}map_meta"] = np.asarray(
        [mp._next_kf, mp.mid, int(mp.imu_initialized), int(mp.imu_ba1), int(mp.imu_ba2),
         mp.version], np.int64)
    blobs[f"{p}scale_factor"] = np.asarray([mp.scale_factor])
    blobs[f"{p}obs"] = np.asarray(
        [(q, k, i) for q, d in mp.obs.items() for k, i in d.items()], np.int64).reshape(-1, 3)
    if mp.dead_kfs:
        dk = sorted(mp.dead_kfs.items())
        blobs[f"{p}dead_ids"] = np.asarray([(k, pk) for k, (pk, _, _) in dk], np.int64)
        blobs[f"{p}dead_R"] = np.stack([R for _, (_, R, _) in dk])
        blobs[f"{p}dead_t"] = np.stack([t for _, (_, _, t) in dk])
    for k in kf_ids:
        _put_kf(blobs, f"{p}kf{k}", mp.keyframes[k])


def _get_map(z, p: str, device) -> SLAMMap:
    n = len(z[f"{p}mp_pos"])
    mp = SLAMMap(capacity=max(n, 1024))
    mp._next_mp = n
    for name in ("mp_pos", "mp_desc", "mp_normal", "mp_max_dist", "mp_valid", "mp_first_kf",
                 "mp_visible", "mp_found"):
        getattr(mp, name)[:n] = z[f"{p}{name}"]
    meta = z[f"{p}map_meta"]
    mp._next_kf, mp.mid, mp.version = int(meta[0]), int(meta[1]), int(meta[5])
    mp.imu_initialized, mp.imu_ba1, mp.imu_ba2 = bool(meta[2]), bool(meta[3]), bool(meta[4])
    if f"{p}scale_factor" in z:
        mp.scale_factor = float(z[f"{p}scale_factor"][0])
    mp.obs = {}
    for q, k, i in z[f"{p}obs"]:
        mp.obs.setdefault(int(q), {})[int(k)] = int(i)
    if f"{p}dead_ids" in z:
        for (k, pk), R, t in zip(z[f"{p}dead_ids"], z[f"{p}dead_R"], z[f"{p}dead_t"]):
            mp.dead_kfs[int(k)] = (int(pk), np.asarray(R), np.asarray(t))
    for k in z[f"{p}kf_ids"]:
        mp.keyframes[int(k)] = _get_kf(z, f"{p}kf{int(k)}", int(k), device)
    return mp


# ------------------------------------------------------------- map API


def save_map(mp: SLAMMap, path: str):
    blobs: dict = {}
    _put_map(blobs, "", mp)
    blobs["next_kf"] = np.asarray([mp._next_kf])   # legacy single-map key
    np.savez_compressed(path, **blobs)


def load_map(path: str, device=None) -> SLAMMap:
    """A map saved by either package; keyframe features on ``device``."""
    return _get_map(np.load(path), "", kernels.resolve_device(device, "a loaded map"))


# --------------------------------------------------------- session API


def save_session(tracker, path: str):
    """Serialize the Tracker (all Atlas maps and the resume state) after
    settling its dispatched frames and in-flight window BA."""
    tracker.flush()
    atlas = tracker.atlas
    blobs: dict = {
        "n_maps": np.asarray([len(atlas.maps)]),
        "active": np.asarray([atlas.active]),
        "next_mid": np.asarray([atlas._next_mid]),
    }
    for j, m in enumerate(atlas.maps):
        _put_map(blobs, f"m{j}_", m)
    st = tracker
    blobs["trk_meta"] = np.asarray([
        st.state.value, st._next_frame_id, st.last_kf_frame_id,
        st.ref_kf if st.ref_kf is not None else -1, st._prev_kf_id, st._frames_lost,
        st._map_traj_start,
    ], np.int64)
    nan_if_none = lambda v: np.nan if v is None else v
    blobs["trk_fmeta"] = np.asarray([nan_if_none(st.last_kf_ts), nan_if_none(st.first_kf_ts),
                                     st._lost_ts], np.float64)
    blobs["trk_bias"] = st.cur_bias
    if st.velocity is not None:
        blobs["trk_vel_R"] = st.velocity[0]
        blobs["trk_vel_t"] = st.velocity[1]
    if st.trajectory:
        blobs["traj_ts"] = np.asarray([t for t, _, _ in st.trajectory])
        blobs["traj_R"] = np.stack([R for _, R, _ in st.trajectory])
        blobs["traj_t"] = np.stack([t for _, _, t in st.trajectory])
    if st.traj_rel:
        blobs["trel_meta"] = np.asarray([(ts, mid, k) for ts, mid, k, _, _ in st.traj_rel],
                                        np.float64)
        blobs["trel_R"] = np.stack([R for _, _, _, R, _ in st.traj_rel])
        blobs["trel_t"] = np.stack([t for _, _, _, _, t in st.traj_rel])
    if st.last_frame is not None:
        _put_frame(blobs, "lf", st.last_frame)
    # mid-initialization state: without it a session saved between the two
    # init frames would restart initialization on resume
    if st.init_frame is not None:
        _put_frame(blobs, "if", st.init_frame)
    if st.prev_matched is not None:
        blobs["prev_matched"] = st.prev_matched
    if st.imu_queue is not None:
        blobs["imuq_t"], blobs["imuq_gyro"], blobs["imuq_acc"] = st.imu_queue.snapshot()
    db = st.loop_closer.db
    if db is not None and db.entries:
        keys = sorted(db.entries.keys())
        words = [db.entries[k][0] for k in keys]
        blobs["db_keys"] = np.asarray(keys, np.int64)
        blobs["db_lens"] = np.asarray([len(w) for w in words], np.int64)
        blobs["db_words"] = np.concatenate(words)
        blobs["db_weights"] = np.concatenate([db.entries[k][1] for k in keys])
    np.savez_compressed(path, **blobs)


def load_session(path: str, cfg, vocab=None, device=None):
    """A Tracker from a session checkpoint of either package.  ``cfg`` must
    match the one the session was made with; ``device`` as ``Tracker``'s."""
    from .tracking import Frame, Tracker, TrackState

    z = np.load(path)
    tr = Tracker(cfg, vocab=vocab, device=device)
    atlas: Atlas = tr.atlas
    atlas.maps = [_get_map(z, f"m{j}_", tr.device) for j in range(int(z["n_maps"][0]))]
    atlas.active = int(z["active"][0])
    atlas._next_mid = int(z["next_mid"][0])
    meta = z["trk_meta"]
    tr.state = TrackState(int(meta[0]))
    tr._next_frame_id = int(meta[1])
    tr.last_kf_frame_id = int(meta[2])
    tr.ref_kf = int(meta[3]) if int(meta[3]) >= 0 else None
    tr._prev_kf_id = int(meta[4])
    tr._frames_lost = int(meta[5])
    tr._map_traj_start = int(meta[6])
    fmeta = z["trk_fmeta"]
    tr.last_kf_ts = None if np.isnan(fmeta[0]) else float(fmeta[0])
    tr.first_kf_ts = None if np.isnan(fmeta[1]) else float(fmeta[1])
    tr._lost_ts = float(fmeta[2])
    tr.cur_bias = np.asarray(z["trk_bias"], np.float32).copy()
    if "trk_vel_R" in z:
        tr.velocity = (np.asarray(z["trk_vel_R"]), np.asarray(z["trk_vel_t"]))
    if "traj_ts" in z:
        tr.trajectory = [(float(ts), R.copy(), t.copy())
                         for ts, R, t in zip(z["traj_ts"], z["traj_R"], z["traj_t"])]
    if "trel_meta" in z:
        tr.traj_rel = [(float(m[0]), int(m[1]), int(m[2]), R.copy(), t.copy())
                       for m, R, t in zip(z["trel_meta"], z["trel_R"], z["trel_t"])]
    if "lf_meta" in z:
        tr.last_frame = _get_frame(z, "lf", Frame, tr.device)
    if "if_meta" in z:
        tr.init_frame = _get_frame(z, "if", Frame, tr.device)
    if "prev_matched" in z:
        tr.prev_matched = np.asarray(z["prev_matched"]).copy()
    if tr.imu_queue is not None and "imuq_t" in z:
        tr.imu_queue.restore(np.asarray(z["imuq_t"]), np.asarray(z["imuq_gyro"]),
                             np.asarray(z["imuq_acc"]))
    db = tr.loop_closer.db
    if db is not None and "db_keys" in z:
        off = 0
        for key, ln in zip(z["db_keys"], z["db_lens"]):
            db.entries[int(key)] = (np.asarray(z["db_words"][off:off + ln]),
                                    np.asarray(z["db_weights"][off:off + ln]))
            off += int(ln)
        db._dirty = True
        db._rev += 1   # the device backend's arena too
    return tr
