"""Shared fixtures of the PyTorch port's tests and of ``chip_smoke.py``.

numpy only (no cv2, no jax, no torch): a seeded procedural texture, a
two-plane scene renderer with true poses and per-pixel depth (the
geometry of ``tests/test_slam_e2e.py:render_sequence``), black frames
that make tracking fail, and the helper that seeds a map from one frame's
keypoints and the true depth.
"""

from __future__ import annotations

import numpy as np

# Thresholds of the tracked-sequence check (chip_smoke.track_sequence at
# 640x480, 1000 features, 12 steps), shared by the CPU test and the chip
# run.  The plain CPU path keeps >= 495 final inliers per frame with a
# camera-centre error <= 0.0053 m; the thresholds allow half the inliers
# and about four times the error.
MIN_INLIERS = 250
MAX_CENTER_ERR = 0.02


def _upsample(grid: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsampling of a small square grid to (size, size)."""
    n = grid.shape[0]
    c = np.linspace(0.0, n - 1.0, size)
    i0 = np.minimum(np.floor(c).astype(np.int64), n - 2)
    f = c - i0
    rows = grid[i0] * (1 - f)[:, None] + grid[i0 + 1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]


def procedural_texture(size: int = 1024, seed: int = 0) -> np.ndarray:
    """uint8 (size, size) texture: multi-scale smoothed noise plus sharp
    discs and rectangles of random intensity, so FAST fires on every
    level of an 8-level, scale-1.2 pyramid."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size))
    for cells, amp in ((4, 60.0), (8, 45.0), (16, 35.0), (32, 30.0), (64, 25.0), (128, 20.0)):
        img += amp * _upsample(rng.standard_normal((cells + 1, cells + 1)), size)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(900):
        r = rng.uniform(3.0, 40.0)
        cx, cy = rng.uniform(0, size, 2)
        val = rng.uniform(-90, 90)
        if rng.random() < 0.5:
            x0, x1 = int(max(cx - r, 0)), int(min(cx + r, size))
            y0, y1 = int(max(cy - r, 0)), int(min(cy + r, size))
            sub = (xx[y0:y1, x0:x1] - cx) ** 2 + (yy[y0:y1, x0:x1] - cy) ** 2 < r * r
            img[y0:y1, x0:x1][sub] += val
        else:
            h = r * rng.uniform(0.3, 1.0)
            img[int(max(cy - h, 0)):int(cy + h), int(max(cx - r, 0)):int(cx + r)] += val
    img = 128.0 + img
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def so3_exp_np(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * (W @ W)


def camera_matrix(width: int, height: int) -> np.ndarray:
    """The scene's pinhole K: f = 500 px at 640x480, scaled with width."""
    f = 500.0 * width / 640.0
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float64)


def true_pose(k: int, speed: float = 0.06):
    """World->camera (R, t) of frame k (k may be negative): a camera
    translating in front of the scene while it yaws."""
    sc = speed / 0.12
    R = so3_exp_np([0.0, 0.015 * sc * k, 0.0])
    C = np.array([speed * k, 0.015 * sc * k, 0.01 * sc * k])
    return R, -R @ C


def _sample_bilinear(tex: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Bilinear texture lookup at float coords, replicate border."""
    h, w = tex.shape
    s = np.clip(s, 0.0, w - 1.0)
    t = np.clip(t, 0.0, h - 1.0)
    s0 = np.minimum(np.floor(s).astype(np.int64), w - 2)
    t0 = np.minimum(np.floor(t).astype(np.int64), h - 2)
    fs, ft = s - s0, t - t0
    tf = tex.astype(np.float64)
    top = tf[t0, s0] * (1 - fs) + tf[t0, s0 + 1] * fs
    bot = tf[t0 + 1, s0] * (1 - fs) + tf[t0 + 1, s0 + 1] * fs
    return top * (1 - ft) + bot * ft


def render_two_plane(tex: np.ndarray, pose, width: int = 640, height: int = 480):
    """Render the far wall (z = 5) and the near poster (z = 3, mirrored
    texture) by inverse warping.  Returns (uint8 image, float32 depth)."""
    R, t = pose
    K = camera_matrix(width, height)
    n = tex.shape[0]
    s_far, s_near = 5.0 / n, 1.6 / n
    A_far = np.array([[s_far, 0, -2.5], [0, s_far, -2.5], [0, 0, 5.0]])
    A_near = np.array([[s_near, 0, -1.1], [0, s_near, -0.8], [0, 0, 3.0]])
    e3 = np.array([[0.0, 0.0, 1.0]])
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)])

    def plane(A):
        # texture coords h = M^-1 [u v 1]; depth = 1 / h_z
        M = K @ (R @ A + t[:, None] @ e3)
        h = np.linalg.solve(M, pix)
        return h[0] / h[2], h[1] / h[2], 1.0 / h[2]

    s, tt, z = plane(A_far)
    img = _sample_bilinear(tex, s, tt)
    depth = z
    s2, t2, z2 = plane(A_near)
    on_near = (s2 >= 0) & (s2 <= n - 1) & (t2 >= 0) & (t2 <= n - 1) & (z2 > 0)
    img = np.where(on_near, _sample_bilinear(tex[:, ::-1], s2, t2), img)
    depth = np.where(on_near, z2, depth)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(height, width)
    return img, depth.astype(np.float32).reshape(height, width)


def render_sequence(tex: np.ndarray, n_frames: int, speed: float = 0.06,
                    width: int = 640, height: int = 480):
    """Frames 0..n_frames-1: (images, depths, poses)."""
    out = [render_two_plane(tex, true_pose(k, speed), width, height) for k in range(n_frames)]
    poses = [true_pose(k, speed) for k in range(n_frames)]
    return [o[0] for o in out], [o[1] for o in out], poses


def render_stereo_sequence(tex: np.ndarray, n_frames: int, speed: float = 0.06,
                           width: int = 640, height: int = 480, baseline: float = 0.1):
    """A rectified stereo rig over the frames of ``render_sequence``: the
    right camera sits ``baseline`` m along the left camera's x axis (the
    rig of tests/test_slam_stereo_rgbd.py).  Returns (left images, right
    images, left depths, poses)."""
    left, depths, poses = render_sequence(tex, n_frames, speed, width, height)
    right = [render_two_plane(tex, (R, t - np.array([baseline, 0.0, 0.0])), width, height)[0]
             for R, t in poses]
    return left, right, depths, poses


def blackout(images, black) -> list:
    """The images with those at the indices in ``black`` replaced by black
    (all-zero) images of the same shape: a covered lens, on which tracking
    finds no keypoint and fails."""
    black = set(black)
    return [np.zeros_like(img) if k in black else img for k, img in enumerate(images)]


def seed_map(xy, octave, valid, desc, depth, pose, K, scale_factors,
             map_cap: int, local_cap: int):
    """Lift one frame's keypoints to map points with the true depth.

    xy (N,2) f32 level-0 coords, octave (N,), valid (N,), desc (N,32) u8,
    depth (H,W) f32 of that frame, pose its world->camera (R, t).
    Returns numpy arrays: kp_mp (N,) int32 (map-point id per keypoint or
    -1), the map mirror (map_cap,3)/(map_cap,), the local block
    (ids, pos, desc, norm, maxd, val of local_cap rows) and the
    reference-keyframe block (desc, valid, kp_mp).  A point's normal is
    the unit ray from the camera centre, and its max_dist is
    distance * scale[octave] (slam/map.py:216)."""
    R, t = pose
    H, W = depth.shape
    N = xy.shape[0]
    ui = np.clip(np.rint(xy[:, 0]).astype(np.int64), 0, W - 1)
    vi = np.clip(np.rint(xy[:, 1]).astype(np.int64), 0, H - 1)
    z = depth[vi, ui].astype(np.float64)
    ok = valid & (z > 0)
    ids = np.nonzero(ok)[0]
    n = min(len(ids), map_cap, local_cap)
    ids = ids[:n]
    ray = np.linalg.solve(K, np.stack([xy[ids, 0], xy[ids, 1], np.ones(n)]))
    pc = ray * z[ids]
    pw = (R.T @ (pc - t[:, None])).T
    centre = -R.T @ t
    view = pw - centre
    dist = np.linalg.norm(view, axis=1)
    kp_mp = np.full(N, -1, np.int32)
    kp_mp[ids] = np.arange(n, dtype=np.int32)

    map_pos = np.zeros((map_cap, 3), np.float32)
    map_valid = np.zeros(map_cap, bool)
    map_pos[:n] = pw
    map_valid[:n] = True

    local = dict(
        ids=np.zeros(local_cap, np.int32), pos=np.zeros((local_cap, 3), np.float32),
        desc=np.zeros((local_cap, 32), np.uint8), norm=np.zeros((local_cap, 3), np.float32),
        maxd=np.ones(local_cap, np.float32), val=np.zeros(local_cap, bool),
    )
    local["ids"][:n] = np.arange(n)
    local["pos"][:n] = pw
    local["desc"][:n] = desc[ids]
    local["norm"][:n] = view / dist[:, None]
    local["maxd"][:n] = dist * np.asarray(scale_factors, np.float64)[octave[ids]]
    local["val"][:n] = True

    ref = dict(desc=desc.copy(), valid=kp_mp >= 0, kp_mp=kp_mp.copy())
    return kp_mp, map_pos, map_valid, local, ref


def synthetic_pose_problems(rng, B: int, N: int, fx: float, fy: float, cx: float, cy: float,
                            outlier_frac: float = 0.2):
    """B mono pose problems of N observations: points 2-8 m in front of
    the camera, bounded pixel noise (chi2 <= 2.25 at the true pose),
    ``outlier_frac`` gross outliers (>= 10 px, chi2 >= 100), a few padded
    slots and a perturbed start pose, so that no residual of the solution
    lies near the chi2 threshold 5.991.  Returns float32/bool numpy
    (R0, t0, pts, obs, isig, valid) and the true (R, t)."""
    R_true = np.stack([so3_exp_np(rng.normal(0, 0.1, 3)) for _ in range(B)])
    t_true = rng.normal(0, 0.2, (B, 3))
    pc = np.stack([rng.uniform(-2, 2, (B, N)), rng.uniform(-1.5, 1.5, (B, N)),
                   rng.uniform(2, 8, (B, N))], -1)
    pts = np.einsum("bji,bnj->bni", R_true, pc - t_true[:, None])
    uv = np.stack([fx * pc[..., 0] / pc[..., 2] + cx, fy * pc[..., 1] / pc[..., 2] + cy], -1)
    scale = 1.2 ** rng.integers(0, 4, (B, N))
    isig = 1.0 / (scale * scale)
    outlier = rng.random((B, N)) < outlier_frac
    mag = np.where(outlier, rng.uniform(10.0, 40.0, (B, N)), rng.uniform(0.0, 1.5, (B, N)))
    ang = rng.uniform(0, 2 * np.pi, (B, N))
    obs = uv + np.stack([np.cos(ang), np.sin(ang)], -1) * (mag * scale)[..., None]
    valid = rng.random((B, N)) < 0.97
    R0 = np.einsum("bij,bjk->bik", R_true,
                   np.stack([so3_exp_np(rng.normal(0, 0.02, 3)) for _ in range(B)]))
    t0 = t_true + rng.normal(0, 0.05, (B, 3))
    f = lambda a: np.asarray(a, np.float32)
    return f(R0), f(t0), f(pts), f(obs), f(isig), valid, (R_true, t_true)


def pnp_scene(rng, n: int = 200, out_frac: float = 0.3, noise: float = 0.001):
    """A PnP problem as ``tests/test_pnp.py:_scene``: n points 4-9 m in
    front of the camera at a fixed pose, their normalized image
    coordinates with Gaussian ``noise``, and a share ``out_frac`` of them
    moved by 0.1-0.5 (gross outliers).  Returns float32 (pts (n,3),
    xy (n,2)), the true (R, t) and the outlier indices."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)],
                   -1).astype(np.float32)
    R = so3_exp_np([0.1, -0.2, 0.05]).astype(np.float32)
    t = np.array([0.3, -0.1, 0.5], np.float32)
    pc = pts @ R.T + t
    xy = pc[:, :2] / pc[:, 2:3]
    if noise:
        xy = xy + rng.normal(0, noise, xy.shape)
    n_out = int(round(out_frac * n))
    out_idx = rng.choice(n, n_out, replace=False)
    xy[out_idx] += rng.uniform(0.1, 0.5, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return pts, xy.astype(np.float32), R, t, out_idx


def camera_centre_error(R, t, pose) -> float:
    """Distance between the camera centres of an estimate and a truth."""
    Rt, tt = pose
    c_est = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
    return float(np.linalg.norm(c_est - (-Rt.T @ tt)))


def umeyama_align(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Sim3 alignment (scale, R, t) of est (n,3) onto gt (n,3); returns the
    aligned est (the alignment of tests/test_slam_e2e.py)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / len(est))
    return (s * (R @ est.T)).T + mu_g - s * R @ mu_e


def metric_error(trajectory, poses, fps: float = 30.0):
    """Metric accuracy of a stereo or RGB-D trajectory [(ts, R, t)] against
    the true poses, without alignment (frame 0 is the world origin in
    both): the largest camera-centre error (m) and the ratio of the
    estimated path length to the true one (the measures of
    tests/test_slam_stereo_rgbd.py)."""
    est = np.array([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                    for _, R, t in trajectory])
    gt = np.array([-poses[int(round(ts * fps))][0].T @ poses[int(round(ts * fps))][1]
                   for ts, _, _ in trajectory])
    err = float(np.linalg.norm(est - gt, axis=1).max())
    path = lambda c: float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    return err, path(est) / path(gt)


def trajectory_ate(trajectory, poses, fps: float = 30.0):
    """ATE (m) of a tracker trajectory [(ts, R, t)] after Sim3 alignment
    against the true poses (frame k at ts = k / fps), and the scene scale
    (distance between the first and last true camera centres)."""
    est = np.array([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                    for _, R, t in trajectory])
    gt = []
    for ts, _, _ in trajectory:
        R, t = poses[int(round(ts * fps))]
        gt.append(-R.T @ t)
    gt = np.array(gt)
    aligned = umeyama_align(est, gt)
    ate = float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
    return ate, float(np.linalg.norm(gt[-1] - gt[0]))


# ----------------------------------------------------------- loop closing


def se3_exp_np(xi):
    """se(3) -> (R, t) for xi = (rho, phi), float64 (the JAX lie.se3_exp)."""
    rho, phi = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(phi)
    W = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-8:
        V = np.eye(3) + 0.5 * W
    else:
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * W
             + (th - np.sin(th)) / th ** 3 * (W @ W))
    return so3_exp_np(phi), V @ rho


def build_looped_map(seed: int, SLAMMap, KeyFrame, make_features, n_kf: int = 12,
                     n_pts: int = 200, drift_per_kf: float = 0.02, step: float = 0.3,
                     n_cap: int = 512, fx: float = 500.0, cx: float = 320.0,
                     cy: float = 240.0, return_shift: float = 0.0):
    """The constructed map of tests/test_loop_closing.py:build_looped_map,
    for either package (its ``SLAMMap`` and ``KeyFrame`` classes, and
    ``make_features(desc, xy, valid)`` building its ``Features``).

    Keyframes on a line out (x = 0, step, ...) and back over the same
    viewpoints; the first pass observes landmarks at their true positions,
    the return pass (under a growing pose drift) triangulates a duplicate
    of every landmark it sees.  Returns (map, true points, descriptors,
    true camera centres of the keyframes).  ``return_shift`` moves the
    return pass along x: at 0 the first return keyframe sits where the
    last outbound one does, a pair between which the Sim3 scale is not
    observable (no baseline)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 7, n_pts)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    mp = SLAMMap()
    first_id = {}
    half = n_kf // 2
    centres = []
    for k in range(n_kf):
        x = step * k if k < half else step * (n_kf - 1 - k) + return_shift
        centres.append(np.array([x, 0.0, 0.0]))
        R = np.eye(3, dtype=np.float32)
        t = -np.array([x, 0, 0], np.float32)
        drift = max(0, k - half + 1) * drift_per_kf
        dR, dt = se3_exp_np([drift, drift * 0.5, 0, 0, 0, drift * 0.3])
        R_est = (R @ dR).astype(np.float32)
        t_est = (R @ dt + t).astype(np.float32)
        pc = pts @ R.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy], -1)
        vis = (uv[:, 0] > 20) & (uv[:, 0] < 2 * cx - 20) & (uv[:, 1] > 20) & (uv[:, 1] < 2 * cy - 20)
        obs_idx = np.where(vis)[0][:n_cap]
        xy = np.zeros((n_cap, 2), np.float32)
        d = np.zeros((n_cap, 32), np.uint8)
        v = np.zeros(n_cap, bool)
        xy[:len(obs_idx)] = uv[obs_idx]
        d[:len(obs_idx)] = desc[obs_idx]
        v[:len(obs_idx)] = True
        kf = KeyFrame(kid=-1, frame_id=k, timestamp=k / 30.0, R=R_est, t=t_est,
                      feats=make_features(d, xy, v), xy_un=xy,
                      octave=np.zeros(n_cap, np.int32), angle=np.zeros(n_cap, np.float32),
                      desc=d, valid=v, kp_mp=np.full(n_cap, -1, np.int32))
        mp.add_keyframe(kf)
        for row, p in enumerate(obs_idx):
            if k < half:
                if p not in first_id:
                    first_id[p] = mp.add_point(pts[p], desc[p], np.zeros(3), 10.0, kf.kid)
                mid = first_id[p]
                if kf.kid not in mp.obs[mid]:
                    mp.add_observation(mid, kf.kid, row)
            else:
                pos = (pts[p] @ R.T + t - t_est) @ R_est   # through the drifted pose
                mid = mp.add_point(pos, desc[p], np.zeros(3), 10.0, kf.kid)
                mp.add_observation(mid, kf.kid, row)
    for p in range(mp._next_mp):
        if mp.mp_valid[p]:
            mp.update_point_stats(p)
    return mp, pts, desc, np.array(centres)


def wide_texture(height: int = 1024, tiles: int = 4, seed: int = 0) -> np.ndarray:
    """uint8 (height, tiles x height): ``tiles`` procedural textures of
    different seeds side by side, a wall with no repeated content."""
    return np.concatenate([procedural_texture(height, seed + i) for i in range(tiles)], 1)


def loop_pose(k: int, n_frames: int):
    """World->camera (R, t) of frame k of the out-and-back sweep of
    tests/test_loop_from_pixels.py:render_loop_sequence."""
    half = n_frames // 2
    j = k if k < half else (n_frames - 1 - k)
    R = so3_exp_np([0.0, 0.008 * j, 0.0])
    return R, -R @ np.array([0.35 * j, 0.012 * j, 0.01 * j])


def render_loop_sequence(tex: np.ndarray, n_frames: int = 40, width: int = 640,
                         height: int = 480):
    """The out-and-back sweep over a wide wall (tests/test_loop_from_pixels.py
    :26-75, without cv2): the wall z = 5 spans x in [-3.4, 10.6], y in
    [-3, 3] with ``tex`` stretched over it, the mirrored poster z = 3 spans
    x from -1.1 and y in [-0.8, 0.8] at 1.6 m per texture height.  The
    turnaround view shares nothing with the start.  Returns (images,
    poses)."""
    K = camera_matrix(width, height)
    h, w = tex.shape
    A_far = np.array([[14.0 / w, 0, -3.4], [0, 6.0 / h, -3.0], [0, 0, 5.0]])
    s_near = 1.6 / h
    A_near = np.array([[s_near, 0, -1.1], [0, s_near, -0.8], [0, 0, 3.0]])
    e3 = np.array([[0.0, 0.0, 1.0]])
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)])
    frames, poses = [], []
    for k in range(n_frames):
        R, t = loop_pose(k, n_frames)

        def plane(A):
            hh = np.linalg.solve(K @ (R @ A + t[:, None] @ e3), pix)
            return hh[0] / hh[2], hh[1] / hh[2], hh[2]

        s, tt, _ = plane(A_far)
        img = _sample_bilinear(tex, s, tt)
        s2, t2, z2 = plane(A_near)
        on_near = (s2 >= 0) & (s2 <= w - 1) & (t2 >= 0) & (t2 <= h - 1) & (z2 > 0)
        img = np.where(on_near, _sample_bilinear(tex[:, ::-1], s2, t2), img)
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(height, width))
        poses.append((R, t))
    return frames, poses
