"""Inertial frontend: the IMU queue, per-frame preintegration, state
prediction and the staged IMU initialisation (port of
``extractorb_tpu/slam/imu_frontend.py``).

Replaces the reference's inertial tracking plumbing (Tracking::GrabImuData
src/Tracking.cc:1111, PreintegrateIMU :1117, PredictStateIMU :1230) and
LocalMapping's staged initialisation (InitializeIMU src/LocalMapping.cc:1213,
the VIBA1 / VIBA2 schedule :162-219).

Measurements accumulate in a host queue; a window is padded to a bucketed
length and integrated by kernel K19 (several windows in one launch), and
host consumers take the result with one packed fetch.  The initialisation
solves gravity, scale and bias with ``solver.inertial.inertial_only`` (K21)
and refines with the visual-inertial BA (K20); the local inertial BA (K20)
runs at keyframe events once the IMU is initialised.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera
from ..imu import preintegration as pre
from ..imu.calib import ImuCalib
from ..solver import inertial as sin
from ..utils.packed_fetch import pack_fetch

GRAVITY = 9.81

_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


class ImuQueue:
    """Measurement buffer (reference mlQueueImuData, src/Tracking.cc:1111).

    Measurements are (t, acc[3], gyro[3]); ``preintegrate(t0, t1, bias)``
    integrates the samples covering (t0, t1] with the boundary dt clipping
    of the reference's PreintegrateIMU (src/Tracking.cc:1117)."""

    def __init__(self, calib: ImuCalib, device=None, stats=None):
        self.calib = calib
        self.device = kernels.resolve_device(device, "the IMU queue")
        self.stats = stats    # counts the integrations ("preint"), when given
        self.t: List[float] = []
        self.acc: List[np.ndarray] = []
        self.gyro: List[np.ndarray] = []

    def add(self, t: float, acc, gyro):
        self.t.append(float(t))
        self.acc.append(np.asarray(acc, np.float32))
        self.gyro.append(np.asarray(gyro, np.float32))

    def extend(self, measurements):
        """measurements: iterable of (t, acc(3,), gyro(3,))."""
        for t, a, w in measurements:
            self.add(t, a, w)

    def drop_before(self, t0: float):
        while len(self.t) > 1 and self.t[1] <= t0:
            self.t.pop(0)
            self.acc.pop(0)
            self.gyro.pop(0)

    def snapshot(self):
        """(t, gyro, acc) arrays for checkpointing (slam/checkpoint.py)."""
        return (
            np.asarray(self.t, np.float64),
            np.stack(self.gyro) if self.gyro else np.zeros((0, 3), np.float32),
            np.stack(self.acc) if self.acc else np.zeros((0, 3), np.float32),
        )

    def restore(self, t, gyro, acc):
        self.t = [float(x) for x in t]
        self.gyro = [np.asarray(g, np.float32) for g in gyro]
        self.acc = [np.asarray(a, np.float32) for a in acc]

    def raw_window(self, t0: float, t1: float):
        """Unpadded (gyro, acc, dt) window covering (t0, t1] with boundary
        dt clipping; None when no sample covers it."""
        ts = np.asarray(self.t)
        if len(ts) < 2 or t1 <= t0:
            return None
        # sample intervals [t_i, t_{i+1}) clipped to (t0, t1)
        lo = np.maximum(ts[:-1], t0)
        hi = np.minimum(ts[1:], t1)
        dts = np.maximum(hi - lo, 0.0).astype(np.float32)
        sel = np.where(dts > 1e-9)[0]
        if len(sel) == 0:
            return None
        # the midpoint measurement of each interval (the reference averages
        # the two endpoint samples)
        a = np.stack(self.acc)
        w = np.stack(self.gyro)
        gyro = 0.5 * (w[sel] + w[sel + 1])
        acc = 0.5 * (a[sel] + a[sel + 1])
        return gyro.astype(np.float32), acc.astype(np.float32), dts[sel]

    def preintegrate(self, t0: float, t1: float, bias: np.ndarray,
                     host: bool = False) -> Optional[pre.Preintegrated]:
        """Integrate the measurements spanning (t0, t1]; None when no
        sample covers it.  host=True fetches the result with one packed
        copy."""
        win = self.raw_window(t0, t1)
        if win is None:
            return None
        if host:
            return integrate_raw_host(win, bias, self.calib, self.device, self.stats)
        return integrate_raw(win, bias, self.calib, self.device, self.stats)


def integrate_raw_batch(windows, biases, calib: ImuCalib, device,
                        stats=None) -> pre.Preintegrated:
    """Pad raw (gyro, acc, dt) windows to one bucketed length and
    integrate them in one K19 launch (on the CPU: the plain version);
    the result has a leading batch dimension.  Padding steps keep the
    state, so each window's result is the one of its own bucket.
    ``stats["preint"]`` counts the calls."""
    cap = _bucket(max(len(w[2]) for w in windows))
    B = len(windows)
    gyro = np.zeros((B, cap, 3), np.float32)
    acc = np.zeros((B, cap, 3), np.float32)
    dt = np.zeros((B, cap), np.float32)
    ok = np.zeros((B, cap), bool)
    for i, (g, a, d) in enumerate(windows):
        n = len(d)
        gyro[i, :n], acc[i, :n], dt[i, :n], ok[i, :n] = g, a, d, True
    b = np.stack([np.asarray(x, np.float32) for x in biases])
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    if stats is not None:
        stats["preint"] += 1
    return pre.integrate_batch(t(gyro), t(acc), t(dt), t(ok), t(b), calib.noise_gyro,
                               calib.noise_acc, calib.walk_gyro, calib.walk_acc)


def integrate_raw(meas, bias, calib: ImuCalib, device=None, stats=None) -> pre.Preintegrated:
    """One raw window, integrated on ``device`` (result stays there)."""
    device = kernels.resolve_device(device, "the preintegration")
    return pre.index(integrate_raw_batch([meas], [bias], calib, device, stats), 0)


def to_host(p: pre.Preintegrated) -> pre.Preintegrated:
    """A Preintegrated with numpy fields, by one packed fetch."""
    return pre.Preintegrated(*pack_fetch(list(p)))


def integrate_raw_host(meas, bias, calib: ImuCalib, device=None,
                       stats=None) -> pre.Preintegrated:
    """integrate_raw and one packed fetch of all eleven fields."""
    return to_host(integrate_raw(meas, bias, calib, device, stats))


def merge_measurements(a, b):
    """Concatenate two raw windows (reference Preintegrated::MergePrevious,
    src/ImuTypes.cc:312, which re-runs integration over the joined list)."""
    if a is None:
        return b
    if b is None:
        return a
    return (np.concatenate([a[0], b[0]], 0), np.concatenate([a[1], b[1]], 0),
            np.concatenate([a[2], b[2]], 0))


def _host_tensors(p: pre.Preintegrated) -> pre.Preintegrated:
    return pre.Preintegrated(*(torch.as_tensor(np.asarray(f) if not torch.is_tensor(f)
                                               else f.cpu().numpy()) for f in p))


def predict_state(Rwb1, twb1, v1, bias, preint: pre.Preintegrated):
    """Reference Tracking::PredictStateIMU (src/Tracking.cc:1230): the body
    state propagated through a preintegrated delta under gravity (host
    arithmetic on the fetched preintegration)."""
    g = np.array([0.0, 0.0, -GRAVITY], np.float32)
    p = _host_tensors(preint)
    b = torch.as_tensor(np.asarray(bias, np.float32))
    dt = float(p.dT)
    dR = pre.delta_rotation(p, b).numpy()
    dV = pre.delta_velocity(p, b).numpy()
    dP = pre.delta_position(p, b).numpy()
    Rwb2 = Rwb1 @ dR
    v2 = v1 + g * dt + Rwb1 @ dV
    twb2 = twb1 + v1 * dt + 0.5 * g * dt * dt + Rwb1 @ dP
    u, _, vt = np.linalg.svd(Rwb2)   # re-orthonormalise (float32 drift)
    return (u @ vt).astype(np.float32), twb2.astype(np.float32), v2.astype(np.float32)


def identity_preint() -> pre.Preintegrated:
    """A zero-length preintegration (the invalid first edge of a chain), as
    numpy fields."""
    return pre.Preintegrated(*(f.numpy() for f in pre.init_preintegrated()))


def _temporal_chain(mp, calib: ImuCalib):
    """Sorted keyframes with body poses and stacked preintegrations; edge k
    connects KF k-1 -> KF k (the first edge invalid)."""
    kids = sorted(mp.keyframes.keys())
    Rwb, twb, preints, valids = [], [], [], []
    for i, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        R, t = calib.body_from_cam(kf.R, kf.t)
        Rwb.append(R)
        twb.append(t)
        if i == 0 or kf.preint is None or kf.prev_kf != kids[i - 1]:
            preints.append(identity_preint())
            valids.append(False)
        else:
            preints.append(kf.preint)
            valids.append(True)
    return kids, np.stack(Rwb), np.stack(twb), preints, valids


def initialize_imu(mp, calib: ImuCalib, cam: Optional[Camera] = None, prior_g: float = 1e2,
                   prior_a: float = 1e10, fix_scale: bool = False, fiba: bool = True,
                   min_kfs: int = 10, device=None, stats=None):
    """Reference LocalMapping::InitializeIMU (src/LocalMapping.cc:1213):
    velocities seeded from pose differences over the temporal chain, the
    inertial-only solve (gravity direction, scale, shared bias) with the
    poses fixed, the map re-expressed in the gravity frame at metric scale
    (ApplyScaledRotation), then the full visual-inertial BA with bias
    priors.  Returns (Ryw, s) when the map was initialised, else False."""
    dev = kernels.resolve_device(device, "the IMU initialisation")
    kids, Rwb, twb, preints, valids = _temporal_chain(mp, calib)
    K = len(kids)
    if K < min_kfs or sum(valids) < K - 1:
        return False

    # scale observability: short keyframe edges attenuate the estimated
    # scale, so the init solve re-chains over merged edges of >= 0.8 s
    # (the raw windows stored per keyframe concatenate exactly)
    min_edge_dt = 0.8
    kts = [mp.keyframes[k].timestamp for k in kids]
    sel = [0]
    for i in range(1, K):
        if kts[i] - kts[sel[-1]] >= min_edge_dt or i == K - 1:
            sel.append(i)
    if len(sel) >= 4:
        merged, ok_chain = [], True
        for a, b in zip(sel[:-1], sel[1:]):
            meas = None
            for i in range(a + 1, b + 1):
                m = mp.keyframes[kids[i]].imu_meas
                if m is None:
                    ok_chain = False
                    break
                meas = merge_measurements(meas, m)
            if not ok_chain:
                break
            merged.append(meas)
        if ok_chain:
            batch = to_host(integrate_raw_batch(merged, [np.zeros(6, np.float32)] * len(merged),
                                                calib, dev, stats))
            kids = [kids[i] for i in sel]
            Rwb, twb = Rwb[sel], twb[sel]
            preints = [identity_preint()] + [pre.index(batch, i) for i in range(len(merged))]
            valids = [False] + [True] * len(merged)
            K = len(kids)

    # seed velocities: finite differences of the body centres
    dTs = np.asarray([float(np.asarray(p.dT)) for p in preints])
    v0 = np.zeros((K, 3), np.float32)
    for k in range(1, K):
        if dTs[k] > 1e-6:
            v0[k] = (twb[k] - twb[k - 1]) / dTs[k]
    v0[0] = v0[1]

    # gravity-direction seed from the preintegrated velocity deltas
    # (reference LocalMapping.cc:1258: dirG = -sum Rwb_i dV_i)
    dirG = np.zeros(3)
    for k in range(1, K):
        if valids[k]:
            dirG += Rwb[k - 1] @ np.asarray(preints[k].dV)
    nG = np.linalg.norm(dirG)
    Rwg0 = np.eye(3, dtype=np.float32)
    if nG > 1e-6:
        d = dirG / nG
        z = np.array([0.0, 0.0, 1.0])
        ax = np.cross(z, d)
        na = np.linalg.norm(ax)
        if na > 1e-8:
            ang = float(np.arctan2(na, float(z @ d)))
            Rwg0 = lie.so3_exp(torch.as_tensor((ax / na * ang).astype(np.float32))).numpy()

    chain = sin.stack_chain(preints, valids, dev)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    res = sin.inertial_only(f32(Rwb), f32(twb), chain, f32(v0), f32(np.zeros(6)),
                            prior_g=prior_g, prior_a=prior_a, fix_scale=fix_scale,
                            Rwg0=f32(Rwg0))
    if stats is not None:
        stats["inertial_init"] += 1
    s_, bg, ba, v, Rwg = pack_fetch([res.scale, res.bg, res.ba, res.v, res.Rwg])
    s = float(s_)
    # a collapsed scale means the fixed-pose solve failed (reference
    # InitializeIMU rejects mScale < 0.1 for monocular): retry later
    if not np.isfinite(s) or s < 1e-1:
        return False

    Ryw = Rwg.T
    s_applied = s if not fix_scale else 1.0
    mp.apply_scaled_rotation(Ryw, s_applied)
    for k, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        kf.v = (s * (Ryw @ v[k])).astype(np.float32) if not fix_scale \
            else (Ryw @ v[k]).astype(np.float32)
        kf.bg = bg.copy()
        kf.ba = ba.copy()
    # keyframes outside the (possibly subsampled) init chain: velocity
    # from finite differences of the now metric poses
    solved = set(kids)
    all_kids = sorted(mp.keyframes.keys())
    for i, kid in enumerate(all_kids):
        kf = mp.keyframes[kid]
        if kid in solved:
            continue
        if i > 0:
            pa = mp.keyframes[all_kids[i - 1]]
            dt = kf.timestamp - pa.timestamp
            if dt > 1e-6:
                _, ta = calib.body_from_cam(pa.R, pa.t)
                _, tb = calib.body_from_cam(kf.R, kf.t)
                kf.v = ((tb - ta) / dt).astype(np.float32)
        if kf.v is None:
            kf.v = np.zeros(3, np.float32)
        kf.bg = bg.copy()
        kf.ba = ba.copy()
    mp.imu_initialized = True

    if fiba and cam is not None:
        # the reference's init-time FullInertialBA runs to convergence
        full_inertial_ba(mp, calib, cam, prior_g=prior_g, prior_a=prior_a, n_iters=25,
                         device=dev, stats=stats)
    # the applied world update, so the tracker re-expresses its recorded
    # trajectory (reference Tracking::UpdateFrameIMU)
    return (Ryw, s_applied)


def _observations(mp, pt_ids, kf_index):
    """Padded observation arrays of the points ``pt_ids`` in the keyframes
    of ``kf_index`` (kid -> problem index)."""
    remap = {int(p): i for i, p in enumerate(pt_ids)}
    obs_kf, obs_mp, obs_uv, obs_sig = [], [], [], []
    for p in pt_ids:
        for kid, kp in mp.obs.get(int(p), {}).items():
            i = kf_index.get(kid)
            if i is None or kid not in mp.keyframes:
                continue
            kf = mp.keyframes[kid]
            obs_kf.append(i)
            obs_mp.append(remap[int(p)])
            obs_uv.append(kf.xy_un[kp])
            obs_sig.append(1.0 / (1.2 ** (2 * int(kf.octave[kp]))))
    return obs_kf, obs_mp, obs_uv, obs_sig


def _problem(mp, calib: ImuCalib, kids, Rwb, twb, v, bg, ba, preints, valids, pt_ids, obs,
             fixed_kf, prior_g, prior_a, device, pad_points_z: bool) -> sin.VIBAProblem:
    obs_kf, obs_mp, obs_uv, obs_sig = obs
    O = _bucket(max(len(obs_kf), 1))
    pad = O - len(obs_kf)
    P = _bucket(len(pt_ids))
    pts = np.zeros((P, 3), np.float32)
    pts[: len(pt_ids)] = mp.mp_pos[pt_ids]
    if pad_points_z:
        pts[len(pt_ids):, 2] = 1.0
    fixed_mp = np.ones(P, bool)
    fixed_mp[: len(pt_ids)] = False
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return sin.VIBAProblem(
        Rwb=t(Rwb, np.float32), twb=t(twb, np.float32), v=t(v, np.float32),
        bg=t(bg, np.float32), ba=t(ba, np.float32), points=t(pts),
        obs_kf=t(np.asarray(obs_kf + [0] * pad, np.int32)),
        obs_mp=t(np.asarray(obs_mp + [0] * pad, np.int32)),
        obs_uv=t(np.concatenate([np.asarray(obs_uv, np.float32).reshape(-1, 2),
                                 np.zeros((pad, 2), np.float32)], 0)),
        inv_sigma2=t(np.asarray(obs_sig + [1.0] * pad, np.float32)),
        obs_valid=t(np.concatenate([np.ones(O - pad, bool), np.zeros(pad, bool)])),
        chain=sin.stack_chain(preints, valids, device),
        fixed_kf=t(fixed_kf), fixed_mp=t(fixed_mp),
        Rcb=t(calib.Rcb, np.float32), tcb=t(calib.tcb, np.float32),
        prior_g=prior_g, prior_a=prior_a,
    )


def _apply_result(mp, calib: ImuCalib, kids, res, pt_ids, skip=None):
    Rwb_n, twb_n, v_n, bg_n, ba_n, pts_n = pack_fetch(
        [res.Rwb, res.twb, res.v, res.bg, res.ba, res.points])
    for k, kid in enumerate(kids):
        if skip is not None and skip[k]:
            continue
        kf = mp.keyframes[kid]
        kf.R, kf.t = calib.cam_from_body(Rwb_n[k], twb_n[k])
        kf.v = v_n[k]
        kf.bg = bg_n[k]
        kf.ba = ba_n[k]
    mp.mp_pos[pt_ids] = pts_n[: len(pt_ids)]
    mp.version += 1


def full_inertial_ba(mp, calib: ImuCalib, cam: Camera, prior_g: float = 1.0,
                     prior_a: float = 1e5, n_iters: int = 8, cg_iters: int = 40, mesh=None,
                     device=None, stats=None):
    """FullInertialBA (reference src/Optimizer.cc:420): the joint
    visual-inertial BA over the whole temporal chain, the first keyframe
    fixed and the biases anchored by priors.  On a ``mesh`` of more than
    one shard the points are padded to a multiple of the mesh (fixed, at
    z = 1), the observations regrouped by their point's shard
    (``dist/sharded_ba.relayout_point_sharded``) and the problem solved by
    ``optimize_vi_sharded`` (K32 on cards, its plain version on the CPU);
    else by ``optimize_vi_ba`` (K20)."""
    device = kernels.resolve_device(device, "the full inertial BA")
    kids, Rwb, twb, preints, valids = _temporal_chain(mp, calib)
    K = len(kids)
    if K < 3:
        return
    v = np.zeros((K, 3), np.float32)
    bg = np.zeros((K, 3), np.float32)
    ba = np.zeros((K, 3), np.float32)
    for k, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        if kf.v is not None:
            v[k] = kf.v
        if kf.bg is not None:
            bg[k] = kf.bg
            ba[k] = kf.ba
    pt_ids = np.where(mp.mp_valid[: mp._next_mp])[0]
    if len(pt_ids) == 0:
        return
    obs = _observations(mp, pt_ids, {kid: k for k, kid in enumerate(kids)})
    fixed_kf = np.zeros(K, bool)
    fixed_kf[0] = True
    prob = _problem(mp, calib, kids, Rwb, twb, v, bg, ba, preints, valids, pt_ids, obs,
                    fixed_kf, prior_g, prior_a, device, pad_points_z=False)
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    if n_dev > 1:
        from ..dist import sharded_ba as dba

        res = dba.optimize_vi_sharded(mesh, _relayout_vi(prob, n_dev), cam, n_iters=n_iters,
                                      cg_iters=cg_iters)
    else:
        res = sin.optimize_vi_ba(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
    if stats is not None:
        stats["vi_ba"] += 1
    _apply_result(mp, calib, kids, res, pt_ids)


def _relayout_vi(prob: sin.VIBAProblem, n_dev: int) -> sin.VIBAProblem:
    """``prob`` in the landmark-sharded layout of ``n_dev`` shards: its
    (bucket-padded) points padded to a multiple of ``n_dev`` with fixed
    points at z = 1, its observations regrouped by
    ``relayout_point_sharded`` (host numpy, as the JAX module)."""
    from ..dist import sharded_ba as dba

    host = lambda a: a.detach().cpu().numpy()
    P = prob.points.shape[0]
    P_pad = -(-P // n_dev) * n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:P] = host(prob.points)
    fmp = np.ones(P_pad, bool)
    fmp[:P] = host(prob.fixed_mp)
    out = dba.relayout_point_sharded(host(prob.obs_kf), host(prob.obs_mp), host(prob.obs_uv),
                                     host(prob.inv_sigma2), host(prob.obs_valid), P_pad, n_dev)
    t = lambda a: torch.from_numpy(a).to(prob.points.device)
    okf, omp, ouv, osig, oval = (t(a) for a in out)
    return prob._replace(points=t(pts), obs_kf=okf, obs_mp=omp, obs_uv=ouv, inv_sigma2=osig,
                         obs_valid=oval, fixed_mp=t(fmp))


def local_inertial_ba(mp, calib: ImuCalib, cam: Camera, kf_id: int, n_window: int = 10,
                      max_fixed: int = 20, n_iters: int = 6, cg_iters: int = 40, device=None,
                      stats=None) -> bool:
    """LocalInertialBA (reference src/Optimizer.cc:4413): the temporal
    window of ``n_window`` keyframes along the prev_kf chain ending at the
    new keyframe, with visual, preintegration and bias-walk edges.  The
    window's predecessor is included fixed; other keyframes observing the
    window's points are fixed visual anchors (lFixedKeyFrames)."""
    device = kernels.resolve_device(device, "the local inertial BA")
    window: List[int] = []
    k = kf_id
    while k in mp.keyframes and len(window) < n_window:
        window.append(k)
        k = mp.keyframes[k].prev_kf
    window.reverse()
    if len(window) < 3:
        return False
    boundary = mp.keyframes[window[0]].prev_kf
    kids = ([boundary] if boundary in mp.keyframes else []) + window
    n_anchor = 1 if boundary in mp.keyframes else 0

    win_set = set(kids)
    pt_ids = mp.points_seen_by(window)
    obs_count: dict = {}
    for p in pt_ids:
        for kid in mp.obs.get(int(p), {}):
            if kid not in win_set and kid in mp.keyframes:
                obs_count[kid] = obs_count.get(kid, 0) + 1
    anchors = sorted(obs_count, key=lambda kk: -obs_count[kk])[:max_fixed]
    kids = kids + anchors

    K = len(kids)
    Rwb = np.zeros((K, 3, 3), np.float32)
    twb = np.zeros((K, 3), np.float32)
    v = np.zeros((K, 3), np.float32)
    bg = np.zeros((K, 3), np.float32)
    ba = np.zeros((K, 3), np.float32)
    preints, valids = [], []
    for i, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        Rwb[i], twb[i] = calib.body_from_cam(kf.R, kf.t)
        if kf.v is not None:
            v[i] = kf.v
        if kf.bg is not None:
            bg[i] = kf.bg
            ba[i] = kf.ba
        if (0 < i < n_anchor + len(window) and kf.preint is not None
                and kf.prev_kf == kids[i - 1]):
            preints.append(kf.preint)
            valids.append(True)
        else:
            preints.append(identity_preint())
            valids.append(False)

    if len(pt_ids) < 8:
        return False
    obs = _observations(mp, pt_ids, {kid: i for i, kid in enumerate(kids)})
    if len(obs[0]) < 16:
        return False
    fixed_kf = np.zeros(K, bool)
    if n_anchor:
        fixed_kf[0] = True
    fixed_kf[n_anchor + len(window):] = True  # visual anchors
    if not fixed_kf.any():
        fixed_kf[0] = True  # gauge
    prob = _problem(mp, calib, kids, Rwb, twb, v, bg, ba, preints, valids, pt_ids, obs,
                    fixed_kf, 0.0, 0.0, device, pad_points_z=True)
    res = sin.optimize_vi_ba(prob, cam, n_iters=n_iters, cg_iters=cg_iters)
    if stats is not None:
        stats["vi_ba"] += 1
    _apply_result(mp, calib, kids, res, pt_ids, skip=fixed_kf)
    return True
