"""Shared fixtures of the PyTorch port's tests and of ``chip_smoke.py``.

numpy only (no cv2, no jax, no torch): a seeded procedural texture, a
two-plane scene renderer with true poses and per-pixel depth (the
geometry of ``tests/test_slam_e2e.py:render_sequence``), and the helper
that seeds a map from one frame's keypoints and the true depth.
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
