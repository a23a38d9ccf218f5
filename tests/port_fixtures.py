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


# TUM fr1's pinhole intrinsics and radial-tangential distortion at 640x480
# (ORB-SLAM3 Examples/Monocular/TUM1.yaml, as tests/test_camera.py:33-36):
# fx, fy, cx, cy and k1, k2, p1, p2, k3
FR1_INTRINSICS = (517.306408, 516.469215, 318.643040, 255.313989)
FR1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)


def fr1_camera_matrix(width: int, height: int) -> np.ndarray:
    """FR1's K scaled to width x height (the distortion acts on normalised
    coordinates and keeps its coefficients)."""
    s = width / 640.0
    fx, fy, cx, cy = FR1_INTRINSICS
    return np.array([[fx * s, 0, cx * s], [0, fy * s, cy * s], [0, 0, 1]], np.float64)


def distort_normalized(x, y, dist):
    """Radial-tangential distortion of normalised coordinates (float64)."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def undistort_normalized(xd, yd, dist, tol: float = 1e-14, max_iter: int = 50):
    """The normalised (x, y) that ``distort_normalized`` maps to (xd, yd),
    by Newton's method on the 2x2 Jacobian, in float64 to convergence
    (independent of the 8-step fixed-point iteration the trackers use)."""
    k1, k2, p1, p2, k3 = dist
    x, y = np.array(xd, np.float64), np.array(yd, np.float64)
    for _ in range(max_iter):
        fx_, fy_ = distort_normalized(x, y, dist)
        ex, ey = fx_ - xd, fy_ - yd
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dr = k1 + r2 * (2 * k2 + 3 * k3 * r2)          # d radial / d r2
        a = radial + 2 * x * x * dr + 2 * p1 * y + 6 * p2 * x
        b = 2 * x * y * dr + 2 * p1 * x + 2 * p2 * y
        d = radial + 2 * y * y * dr + 6 * p1 * y + 2 * p2 * x
        det = a * d - b * b
        sx, sy = (d * ex - b * ey) / det, (a * ey - b * ex) / det
        x, y = x - sx, y - sy
        if max(np.abs(sx).max(), np.abs(sy).max()) < tol:
            break
    return x, y


# TUM-VI's 512x512 fisheye (ORB-SLAM3 Examples/Monocular/TUM_512.yaml, as
# tests/test_camera.py:26-31): fx, fy, cx, cy and the KB8 k1, k2, k3, k4
KB8_TUMVI = (190.978477, 190.973307, 254.931706, 256.897442,
             0.003482389402, 0.000715034845, -0.002053236141, 0.000202936736)
# the grey of pixels whose ray meets no plane (the KB8 camera sees past them)
BACKGROUND = 128


def kb8_camera(width: int = 512, height: int = 512):
    """TUM-VI's KB8 parameters scaled to width (fx, fy, cx, cy scale; the
    k's act on the angle and stay)."""
    s = width / 512.0
    fx, fy, cx, cy, k1, k2, k3, k4 = KB8_TUMVI
    return (fx * s, fy * s, cx * s, cy * height / 512.0, k1, k2, k3, k4)


def kb8_project_np(pc, kb8):
    """Pixels (..., 2) of camera-frame points (..., 3) through the KB8
    model ``kb8`` in float64 (the polynomial of ``kb8_rays``)."""
    fx, fy, cx, cy, k1, k2, k3, k4 = kb8
    pc = np.asarray(pc, np.float64)
    r = np.hypot(pc[..., 0], pc[..., 1])
    th = np.arctan2(r, pc[..., 2])
    t2 = th * th
    d = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    s = np.where(r > 0, d / np.where(r > 0, r, 1.0), 0.0)
    return np.stack([fx * s * pc[..., 0] + cx, fy * s * pc[..., 1] + cy], -1)


def kb8_rays(u, v, kb8, tol: float = 1e-14, max_iter: int = 50):
    """Unit rays (3, n) of pixels (u, v) through the KB8 model ``kb8`` =
    (fx, fy, cx, cy, k1..k4): r(theta) = theta (1 + k1 theta^2 + k2 theta^4 +
    k3 theta^6 + k4 theta^8) solved for theta by Newton's method in float64
    to convergence (independent of the trackers' 10-step unprojection).
    Rays may point past 90 degrees (z < 0)."""
    fx, fy, cx, cy, k1, k2, k3, k4 = kb8
    mx, my = (np.asarray(u, np.float64) - cx) / fx, (np.asarray(v, np.float64) - cy) / fy
    r_d = np.hypot(mx, my)
    th = r_d.copy()
    for _ in range(max_iter):
        t2 = th * th
        f = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r_d
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        step = f / fp
        th = th - step
        if np.abs(step).max() < tol:
            break
    s = np.where(r_d > 0, np.sin(th) / np.where(r_d > 0, r_d, 1.0), 1.0)
    return np.stack([mx * s, my * s, np.cos(th)])


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


def render_two_plane(tex: np.ndarray, pose, width: int = 640, height: int = 480,
                     K=None, dist=None, kb8=None):
    """Render the far wall (z = 5) and the near poster (z = 3, mirrored
    texture) by inverse warping.  Returns (uint8 image, float32 depth).
    ``K`` defaults to ``camera_matrix``; with ``dist`` (k1, k2, p1, p2, k3)
    each pixel shows the ray of its undistorted coordinates
    (``undistort_normalized``), so the image is the distorted camera's.
    With ``kb8`` (fx, fy, cx, cy, k1..k4) each pixel shows the ray of the
    KB8 model (``kb8_rays``); the wall then ends at its texture's edge, and
    a ray that meets neither plane in front of the camera shows
    ``BACKGROUND`` (depth 0)."""
    if kb8 is not None:
        return _render_kb8(tex, pose, width, height, kb8)
    R, t = pose
    K = camera_matrix(width, height) if K is None else np.asarray(K, np.float64)
    n = tex.shape[0]
    s_far, s_near = 5.0 / n, 1.6 / n
    A_far = np.array([[s_far, 0, -2.5], [0, s_far, -2.5], [0, 0, 5.0]])
    A_near = np.array([[s_near, 0, -1.1], [0, s_near, -0.8], [0, 0, 3.0]])
    e3 = np.array([[0.0, 0.0, 1.0]])
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    if dist is not None:
        x, y = undistort_normalized((uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1], dist)
        uu, vv = K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]
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


_A_FAR = lambda n: np.array([[5.0 / n, 0, -2.5], [0, 5.0 / n, -2.5], [0, 0, 5.0]])
_A_NEAR = lambda n: np.array([[1.6 / n, 0, -1.1], [0, 1.6 / n, -0.8], [0, 0, 3.0]])


def _render_kb8(tex, pose, width, height, kb8, wrap: bool = False, scene_scale: float = 1.0,
                planes=None, rays=None):
    """``render_two_plane`` through the KB8 model: each plane is hit where
    its texture coordinates h = (R A + t e3^T)^-1 ray have h_z > 0 (in
    front of the camera) and lie inside the texture; with ``wrap`` the
    wall's coordinates are taken modulo the texture's size, so the wall
    fills every ray that meets its plane in front of the camera;
    ``scene_scale`` scales both planes about the world origin.  ``planes``
    (A of the wall, A of the poster) replaces the two planes of
    ``render_two_plane``; ``rays`` the pixels' rays (``kb8_rays``)."""
    R, t = pose
    th, tw = tex.shape
    if planes is None:
        planes = (_A_FAR(th), _A_NEAR(th))
    if rays is None:
        vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
        rays = kb8_rays(uu.ravel(), vv.ravel(), kb8)
    e3 = np.array([[0.0, 0.0, 1.0]])
    img = np.full(rays.shape[1], float(BACKGROUND))
    depth = np.zeros(rays.shape[1])
    for A, flip in zip(planes, (False, True)):
        h = np.linalg.solve(R @ (scene_scale * A) + t[:, None] @ e3, rays)
        front = h[2] > 1e-12
        hz = np.where(front, h[2], 1.0)
        s, tt = h[0] / hz, h[1] / hz
        if wrap and not flip:
            s, tt = np.mod(s, tw - 1.0), np.mod(tt, th - 1.0)
        hit = front & (s >= 0) & (s <= tw - 1) & (tt >= 0) & (tt <= th - 1)
        img = np.where(hit, _sample_bilinear(tex[:, ::-1] if flip else tex, s, tt), img)
        depth = np.where(hit, rays[2] / hz, depth)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(height, width)
    return img, depth.astype(np.float32).reshape(height, width)


def render_sequence(tex: np.ndarray, n_frames: int, speed: float = 0.06,
                    width: int = 640, height: int = 480, K=None, dist=None,
                    camera: str = "pinhole"):
    """Frames 0..n_frames-1: (images, depths, poses); ``K`` and ``dist`` as
    ``render_two_plane``'s; ``camera="kb8"`` renders through TUM-VI's KB8
    fisheye (``kb8_camera(width, height)``)."""
    if camera not in ("pinhole", "kb8"):
        raise ValueError(f"render_sequence: camera {camera!r}")
    kb8 = kb8_camera(width, height) if camera == "kb8" else None
    out = [render_two_plane(tex, true_pose(k, speed), width, height, K, dist, kb8)
           for k in range(n_frames)]
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


def rig_extrinsics(T_lr):
    """(R_rl, t_rl) of a rig whose right camera has the pose ``T_lr`` (4x4,
    or its 16 values row by row) in the left camera's frame, as the
    trackers read ``SLAMConfig.T_lr``: p_right = R_rl p_left + t_rl."""
    T = np.asarray(T_lr, np.float64).reshape(4, 4)
    R_rl = T[:3, :3].T
    return R_rl, -R_rl @ T[:3, 3]


def _right_pose(pose, T_lr):
    R_rl, t_rl = rig_extrinsics(T_lr)
    R, t = pose
    return R_rl @ R, R_rl @ t + t_rl


def _render_rig(tex, poses, width, height, T_lr, right: bool = True):
    kb8 = kb8_camera(width, height)
    draw = lambda p: _render_kb8(tex, p, width, height, kb8, wrap=True,
                                 scene_scale=KB8_RIG_SCENE_SCALE)[0]
    left = [draw(p) for p in poses]
    if not right:
        return left
    return left, [draw(_right_pose(p, KB8_RIG_T_LR if T_lr is None else T_lr)) for p in poses]


# the right camera 0.101 m along the left camera's x axis (TUM-VI's rig,
# tests/test_stereo_fisheye.py:140-143), row-major 4x4
KB8_RIG_T_LR = (1.0, 0.0, 0.0, 0.101, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)
# the rig's scenes are the two planes at 0.3 of their distance (wall 1.5 m,
# poster 0.9 m), a room's depth: the 0.101 m baseline gives a point the 1.15
# degrees of parallax that the triangulation's gate (cos < 0.9998) asks for
# only up to ~5 m, and the stereo depths, gated at chi2 5.991 (~2.4 px at
# octave 0), scatter by +-15-25% at 2.5 m (``chip_smoke.run_system`` over
# [stereo-kb8]'s 30 frames on the CPU plain path: 5.6% of the path lost with
# the wall at 2.5 m, 0.6% at 1.5 m)
KB8_RIG_SCENE_SCALE = 0.3


def render_kb8_stereo_sequence(tex: np.ndarray, n_frames: int, speed: float = 0.06,
                               width: int = 512, height: int = 512, T_lr=None):
    """A fisheye stereo rig over ``render_sequence``'s motion, both cameras
    TUM-VI's KB8 (``kb8_camera(width, height)``), the planes at
    ``KB8_RIG_SCENE_SCALE`` of their distance and the wall wrapped so it
    fills the field of view; the right camera has the pose ``T_lr`` in the
    left camera's frame (default ``KB8_RIG_T_LR``: 0.101 m along x, TUM-VI's
    baseline).  Returns (left images, right images, poses)."""
    poses = [true_pose(k, speed) for k in range(n_frames)]
    return _render_rig(tex, poses, width, height, T_lr) + (poses,)


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
                            outlier_frac: float = 0.2, kb8=None):
    """B mono pose problems of N observations: points 2-8 m in front of
    the camera, bounded pixel noise (chi2 <= 2.25 at the true pose),
    ``outlier_frac`` gross outliers (>= 10 px, chi2 >= 100), a few padded
    slots and a perturbed start pose, so that no residual of the solution
    lies near the chi2 threshold 5.991.  With ``kb8`` (fx, fy, cx, cy,
    k1..k4; the other intrinsics unused) the points spread to about 60
    degrees off the axis and project through the KB8 model.  Returns
    float32/bool numpy (R0, t0, pts, obs, isig, valid) and the true (R, t)."""
    R_true = np.stack([so3_exp_np(rng.normal(0, 0.1, 3)) for _ in range(B)])
    t_true = rng.normal(0, 0.2, (B, 3))
    w = 3.0 if kb8 is not None else 1.0
    pc = np.stack([rng.uniform(-2 * w, 2 * w, (B, N)), rng.uniform(-1.5 * w, 1.5 * w, (B, N)),
                   rng.uniform(2, 8, (B, N))], -1)
    pts = np.einsum("bji,bnj->bni", R_true, pc - t_true[:, None])
    uv = (kb8_project_np(pc, kb8) if kb8 is not None else
          np.stack([fx * pc[..., 0] / pc[..., 2] + cx, fy * pc[..., 1] / pc[..., 2] + cy], -1))
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


def umeyama_scale(est: np.ndarray, gt: np.ndarray) -> float:
    """The scale of umeyama_align's Sim3 (est onto gt)."""
    xe, xg = est - est.mean(0), gt - gt.mean(0)
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    return float(np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / len(est)))


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
                     cy: float = 240.0, return_shift: float = 0.0, inertial: bool = False,
                     preintegrate=None, maps=None, camera=None):
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
    observable (no baseline).

    ``inertial``: the map of an initialised inertial session.  The camera
    is the body (T_bc = I), the image's y axis points down along gravity,
    and the map is expressed in a gravity-aligned world (z up,
    ``CAM_IN_GRAVITY_WORLD``).  The keyframes are stamped along a smooth
    out-and-back motion (a half cosine out and back in 2 T_TURN seconds),
    drift in yaw and translation only (gravity stays observable), and carry
    the prev_kf chain, their true velocities, zero biases and the IMU
    window from their predecessor: 100 Hz accelerometer samples of the
    true motion under gravity, integrated by ``preintegrate(meas)`` (the
    package's ``integrate_raw_host`` with zero bias); ``imu_initialized``
    is set.

    ``maps``: two maps (an Atlas's) to fill in place of one new map, the
    outbound pass into the first and the return pass, with its own
    keyframe ids and IMU chain, into the second; the first is returned.

    ``camera``: a KB8 camera (fx, fy, cx, cy, k1..k4; ``kb8_camera``) whose
    image the keypoints lie in, projected by ``kb8_project_np``, in place of
    the pinhole (fx, fx, cx, cy); the margins are 20 px inside (2 cx, 2 cy)
    for both."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 7, n_pts)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    maps = tuple(maps) if maps is not None else (SLAMMap(),) * 2
    first_id = {}
    half = n_kf // 2
    centres = []
    x_turn = step * (half - 1) + max(return_shift, 0.0) + step / 2
    for k in range(n_kf):
        x = step * k if k < half else step * (n_kf - 1 - k) + return_shift
        centres.append(np.array([x, 0.0, 0.0]))
        R = np.eye(3, dtype=np.float32)
        t = -np.array([x, 0, 0], np.float32)
        drift = max(0, k - half + 1) * drift_per_kf
        # the drift turns the camera about its z axis, or for an inertial
        # map about gravity (the image's y axis): yaw
        dR, dt = se3_exp_np([drift, drift * 0.5, 0, 0, drift * 0.3, 0] if inertial
                            else [drift, drift * 0.5, 0, 0, 0, drift * 0.3])
        R_est = (R @ dR).astype(np.float32)
        t_est = (R @ dt + t).astype(np.float32)
        pc = pts @ R.T + t
        if camera is None:
            uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy], -1)
        else:
            uv = kb8_project_np(pc, camera)
            cx, cy = camera[2], camera[3]
        vis = (uv[:, 0] > 20) & (uv[:, 0] < 2 * cx - 20) & (uv[:, 1] > 20) & (uv[:, 1] < 2 * cy - 20)
        obs_idx = np.where(vis)[0][:n_cap]
        xy = np.zeros((n_cap, 2), np.float32)
        d = np.zeros((n_cap, 32), np.uint8)
        v = np.zeros(n_cap, bool)
        xy[:len(obs_idx)] = uv[obs_idx]
        d[:len(obs_idx)] = desc[obs_idx]
        v[:len(obs_idx)] = True
        ts = _turn_time(x, x_turn, k >= half) if inertial else k / 30.0
        mp = maps[int(k >= half)]
        kf = KeyFrame(kid=-1, frame_id=k, timestamp=ts, R=R_est, t=t_est,
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
    for mp in set(maps):
        for p in range(mp._next_mp):
            if mp.mp_valid[p]:
                mp.update_point_stats(p)
        if inertial:
            _make_inertial(mp, x_turn, preintegrate)
    centres = np.array(centres)
    if inertial:
        A = CAM_IN_GRAVITY_WORLD
        pts = (pts @ A.T).astype(np.float32)
        centres = centres @ A.T
    return maps[0], pts, desc, centres


def move_world(mp, R: np.ndarray, t: np.ndarray):
    """Re-express a map in another world frame, p' = R p + t: keyframe
    poses, velocities, points and normals."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    for kf in mp.keyframes.values():
        Rn = kf.R @ R.T
        kf.t = (kf.t - Rn @ t).astype(np.float32)
        kf.R = Rn.astype(np.float32)
        if kf.v is not None:
            kf.v = (R @ kf.v).astype(np.float32)
    n = mp._next_mp
    mp.mp_pos[:n] = (mp.mp_pos[:n] @ R.T + t).astype(np.float32)
    mp.mp_normal[:n] = (mp.mp_normal[:n] @ R.T).astype(np.float32)


T_TURN = 4.0   # seconds from the start of an inertial looped map to its turn


def _turn_time(x: float, x_turn: float, back: bool) -> float:
    """The time the motion x(t) = x_turn (1 - cos(pi t / T_TURN)) / 2
    reaches x, on the way out or back."""
    a = float(np.arccos(np.clip(1.0 - 2.0 * x / x_turn, -1.0, 1.0)))
    return T_TURN / np.pi * (2 * np.pi - a if back else a)


def _make_inertial(mp, x_turn: float, preintegrate):
    """The inertial state of build_looped_map's keyframes, then the map
    moved into the gravity-aligned world."""
    w = np.pi / T_TURN
    vel = lambda t: np.array([x_turn * w / 2 * np.sin(w * t), 0.0, 0.0])
    acc = lambda t: np.array([x_turn * w * w / 2 * np.cos(w * t), 0.0, 0.0])
    g_cam = np.array([0.0, 9.81, 0.0])   # gravity in the original (camera-aligned) frame
    kids = sorted(mp.keyframes)
    for i, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        kf.v = vel(kf.timestamp).astype(np.float32)
        kf.bg = np.zeros(3, np.float32)
        kf.ba = np.zeros(3, np.float32)
        if i == 0:
            continue
        t0, t1 = mp.keyframes[kids[i - 1]].timestamp, kf.timestamp
        n = max(1, int(np.ceil((t1 - t0) * VI_IMU_HZ)))
        dts = np.full(n, (t1 - t0) / n)
        mids = t0 + (np.arange(n) + 0.5) * (t1 - t0) / n
        a = np.stack([acc(t) - g_cam for t in mids])   # the body is the world-aligned camera
        kf.prev_kf = kids[i - 1]
        kf.imu_meas = (np.zeros((n, 3), np.float32), a.astype(np.float32),
                       dts.astype(np.float32))
        kf.preint = preintegrate(kf.imu_meas)
    A = CAM_IN_GRAVITY_WORLD
    for kf in mp.keyframes.values():
        kf.R = (kf.R @ A.T).astype(np.float32)
        kf.v = (A @ kf.v).astype(np.float32)
    n = mp._next_mp
    mp.mp_pos[:n] = (mp.mp_pos[:n] @ A.T).astype(np.float32)
    mp.mp_normal[:n] = (mp.mp_normal[:n] @ A.T).astype(np.float32)
    mp.imu_initialized = True


def _rz(a: float) -> np.ndarray:
    return so3_exp_np([0.0, 0.0, a])


# camera axes (x right, y down, z forward) in a gravity-aligned world whose
# z axis points up: the camera looks along world x
CAM_IN_GRAVITY_WORLD = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def pose_graph_4dof_circle(K: int = 24):
    """The inertial essential graph of tests/test_sim3_posegraph.py:153-210:
    K keyframes yawing around a circle of radius 3 m, the chain's odometry
    drifting in yaw and translation, one loop edge of weight 5, keyframe 0
    fixed.  Returns (the problem's numpy fields, true camera centres)."""
    Rs_gt, ts_gt = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        R = _rz(a).T
        Rs_gt.append(R)
        ts_gt.append(-R @ (np.array([np.cos(a), np.sin(a), 0.0]) * 3.0))
    rel = lambda i, j: (Rs_gt[j] @ Rs_gt[i].T, ts_gt[j] - Rs_gt[j] @ Rs_gt[i].T @ ts_gt[i])
    dR, dt = se3_exp_np([0.0, 0.0, 0.02, 0.015, 0.01, 0.0])
    Rs, ts, edges = [Rs_gt[0]], [ts_gt[0]], []
    for k in range(1, K):
        mR, mt = rel(k - 1, k)
        edges.append((k - 1, k, mR, mt, 1.0))
        mRd, mtd = dR @ mR, dR @ mt + dt
        Rs.append(mRd @ Rs[-1])
        ts.append(mRd @ ts[-1] + mtd)
    mR, mt = rel(K - 1, 0)
    edges.append((K - 1, 0, mR, mt, 5.0))
    centres = np.stack([-R.T @ t for R, t in zip(Rs_gt, ts_gt)])
    return _graph_fields(Rs, ts, edges, np.arange(K) == 0), centres


def pose_graph_4dof_random(rng, K: int = 40, extra: int = 3, far: int = 2):
    """A seeded inertial essential graph: K cameras looking horizontally
    (each with its own small roll and pitch) along a noisy circle of radius
    2 m, a chain, ``extra`` edges from each keyframe to random ones 2-8
    later and ``far`` to random ones anywhere, measurements from the true
    poses with 1 mrad / 1 mm noise, the start poses drifting in yaw (5 mrad)
    and translation (1 cm) per step, keyframe 0 fixed."""
    Rs_gt, ts_gt = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        tilt = so3_exp_np([rng.normal(0, 0.05), rng.normal(0, 0.05), 0.0])
        Rwc = _rz(a + np.pi / 2) @ CAM_IN_GRAVITY_WORLD @ tilt
        C = np.array([2 * np.cos(a), 2 * np.sin(a), rng.normal(0, 0.05)])
        Rs_gt.append(Rwc.T)
        ts_gt.append(-Rwc.T @ C)
    pairs = [(i, i + 1) for i in range(K - 1)]
    for i in range(K):
        pairs += [(i, int(j) % K) for j in rng.choice(np.arange(i + 2, i + 9), extra,
                                                      replace=False) if int(j) % K != i]
        pairs += [(i, int(j)) for j in rng.choice(K, far, replace=False) if abs(int(j) - i) > 8]
    edges = []
    for i, j in pairs:
        nR = so3_exp_np(rng.normal(0, 1e-3, 3))
        mR = nR @ Rs_gt[j] @ Rs_gt[i].T
        mt = ts_gt[j] - Rs_gt[j] @ Rs_gt[i].T @ ts_gt[i] + rng.normal(0, 1e-3, 3)
        edges.append((i, j, mR, mt, 1.0))
    Rs, ts, yaw, drift = [], [], 0.0, np.zeros(3)
    for k in range(K):
        if k:
            yaw += rng.normal(0, 5e-3)
            drift += rng.normal(0, 1e-2, 3)
        # T_wc' = [Rz(yaw), drift] T_wc: yaw and translation only
        Rwc = _rz(yaw) @ Rs_gt[k].T
        C = _rz(yaw) @ (-Rs_gt[k].T @ ts_gt[k]) + drift
        Rs.append(Rwc.T)
        ts.append(-Rwc.T @ C)
    return _graph_fields(Rs, ts, edges, np.arange(K) == 0)


def _graph_fields(Rs, ts, edges, fixed) -> dict:
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(R=f32(np.stack(Rs)), t=f32(np.stack(ts)),
                edge_i=np.array([e[0] for e in edges], np.int32),
                edge_j=np.array([e[1] for e in edges], np.int32),
                m_R=f32(np.stack([e[2] for e in edges])), m_t=f32(np.stack([e[3] for e in edges])),
                weight=f32([e[4] for e in edges]), edge_valid=np.ones(len(edges), bool),
                fixed=np.asarray(fixed, bool))


def gravity_in_cameras(R) -> np.ndarray:
    """Each world->camera rotation's image of the world z axis (K,3): the
    gravity direction a camera sees, fixed by its roll and pitch."""
    return np.asarray(R, np.float64)[:, :, 2]


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
                         height: int = 480, camera: str = "pinhole"):
    """The out-and-back sweep over a wide wall (tests/test_loop_from_pixels.py
    :26-75, without cv2): the wall z = 5 spans x in [-3.4, 10.6], y in
    [-3, 3] with ``tex`` stretched over it, the mirrored poster z = 3 spans
    x from -1.1 and y in [-0.8, 0.8] at 1.6 m per texture height.  The
    pinhole's turnaround view shares nothing with the start.
    ``camera="kb8"`` renders through TUM-VI's KB8 fisheye
    (``kb8_camera(width, height)``, ``_render_kb8``) with the wall wrapped
    to fill the view (it repeats every 14 m in x and 6 m in y).  Returns
    (images, poses)."""
    if camera not in ("pinhole", "kb8"):
        raise ValueError(f"render_loop_sequence: camera {camera!r}")
    h, w = tex.shape
    A_far = np.array([[14.0 / w, 0, -3.4], [0, 6.0 / h, -3.0], [0, 0, 5.0]])
    s_near = 1.6 / h
    A_near = np.array([[s_near, 0, -1.1], [0, s_near, -0.8], [0, 0, 3.0]])
    if camera == "kb8":
        kb8 = kb8_camera(width, height)
        vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
        rays = kb8_rays(uu.ravel(), vv.ravel(), kb8)
        poses = [loop_pose(k, n_frames) for k in range(n_frames)]
        return [_render_kb8(tex, pose, width, height, kb8, wrap=True, planes=(A_far, A_near),
                            rays=rays)[0] for pose in poses], poses
    K = camera_matrix(width, height)
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


# ------------------------------------------------------ visual-inertial scene
# tests/test_vi_e2e.py's analytic trajectory (body = camera, gravity along
# -y in the world): the camera oscillates on three axes with rich
# acceleration while it yaws, seen at VI_FPS with IMU samples at VI_IMU_HZ.
VI_FPS = 10.0
VI_IMU_HZ = 100.0
VI_G_W = np.array([0.0, -9.81, 0.0])
_VI_AMP = np.array([0.70, 0.25, 0.12])
_VI_OM = np.array([1.9, 1.4, 1.1])
_VI_PH = np.array([0.0, 1.0, 0.5])


def vi_pose(t: float):
    """World->camera (R, t) at time t."""
    ang = 0.10 * np.sin(0.9 * t)
    C = _VI_AMP * np.sin(_VI_OM * t + _VI_PH) - _VI_AMP * np.sin(_VI_PH)
    R = so3_exp_np([0.0, ang, 0.0])
    return R, -R @ C


def imu_window(t0: float, t1: float):
    """(t, acc, gyro) samples in [t0, t1] at VI_IMU_HZ in the body frame;
    the sample at t0 is included (a duplicate across windows collapses to a
    zero-length interval in the queue)."""
    out = []
    n = int(round((t1 - t0) * VI_IMU_HZ))
    for i in range(n + 1):
        t = t0 + i / VI_IMU_HZ
        R, _ = vi_pose(t)
        accel = -_VI_AMP * _VI_OM ** 2 * np.sin(_VI_OM * t + _VI_PH)
        gyro = np.array([0.0, -0.10 * 0.9 * np.cos(0.9 * t), 0.0])
        out.append((t, (R @ (accel - VI_G_W)).astype(np.float32), gyro.astype(np.float32)))
    return out


def render_vi_sequence(tex: np.ndarray, n_frames: int, width: int = 640, height: int = 480):
    """Frames 0..n_frames-1 of the trajectory at VI_FPS: (images, poses),
    the two-plane scene of render_two_plane."""
    poses = [vi_pose(k / VI_FPS) for k in range(n_frames)]
    return [render_two_plane(tex, p, width, height)[0] for p in poses], poses


def render_vi_stereo_sequence(tex: np.ndarray, n_frames: int, width: int = 640,
                              height: int = 480, baseline: float = 0.1):
    """The frames of ``render_vi_sequence`` seen by a rectified rig whose
    right camera sits ``baseline`` m along the left camera's x axis (as
    ``render_stereo_sequence``): (left images, right images, poses)."""
    left, poses = render_vi_sequence(tex, n_frames, width, height)
    right = [render_two_plane(tex, (R, t - np.array([baseline, 0.0, 0.0])), width, height)[0]
             for R, t in poses]
    return left, right, poses


def render_vi_kb8_sequence(tex: np.ndarray, n_frames: int, width: int = 512,
                           height: int = 512):
    """The trajectory of ``render_vi_sequence`` through TUM-VI's KB8 camera
    in the scene of ``render_kb8_stereo_sequence``: (images, poses)."""
    poses = [vi_pose(k / VI_FPS) for k in range(n_frames)]
    return _render_rig(tex, poses, width, height, None, right=False), poses


def render_vi_kb8_stereo_sequence(tex: np.ndarray, n_frames: int, width: int = 512,
                                  height: int = 512, T_lr=None):
    """``render_vi_kb8_sequence`` seen by the fisheye rig of
    ``render_kb8_stereo_sequence``: (left images, right images, poses)."""
    poses = [vi_pose(k / VI_FPS) for k in range(n_frames)]
    return _render_rig(tex, poses, width, height, T_lr) + (poses,)


def vi_ate_scale(trajectory):
    """ATE (m) after Sim3 alignment of a trajectory [(ts, R, t)] of the
    visual-inertial scene, and the alignment's scale (1 for a metric
    trajectory; tests/test_vi_e2e.py:140-153)."""
    est = np.array([-np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
                    for _, R, t in trajectory])
    gt = np.array([-vi_pose(ts)[0].T @ vi_pose(ts)[1] for ts, _, _ in trajectory])
    aligned = umeyama_align(est, gt)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean())), umeyama_scale(est, gt)


# the level-gate cases of tests/test_grid.py:test_features_in_area_mask_matches_oracle:
# (x, y, r, min_level, max_level)
GRID_AREA_QUERIES = ((320.0, 240.0, 50.0, -1, -1), (100.0, 100.0, 30.0, 0, 0),
                     (500.0, 400.0, 120.0, 2, 7), (320.0, 240.0, 15.0, 0, -1))


def grid_cases(seed: int = 0, n: int = 1500):
    """Seeded edge cases of the frame grid (``frontend/grid.py``): a dict of
    name -> (xy (N,2) float32, valid (N,) bool, octave (N,) int32, bounds
    (4,) float32, cell capacity).  Points outside the bounds, points exactly
    on them (both the 640x480 image's and off-pixel ones), 100 points in one
    cell with capacity 8, and nothing valid."""
    rng = np.random.default_rng(seed)
    image = np.array([0.0, 640.0, 0.0, 480.0], np.float32)

    def scatter():
        xy = np.stack([rng.uniform(-20, 660, n), rng.uniform(-20, 500, n)], -1)
        return xy.astype(np.float32), rng.random(n) > 0.1, rng.integers(0, 8, n).astype(np.int32)

    cases = {}
    xy, valid, octave = scatter()
    cases["outside"] = (xy, valid, octave, image, 16)
    xy, valid, octave = scatter()
    odd = np.array([1.3, 639.7, -0.4, 481.1], np.float32)
    for b, (lo, hi) in ((image, (0, 100)), (odd, (100, 200))):
        k = (hi - lo) // 4
        xy[lo:lo + k, 0] = b[0]
        xy[lo + k:lo + 2 * k, 0] = b[1]
        xy[lo + 2 * k:lo + 3 * k, 1] = b[2]
        xy[lo + 3 * k:hi, 1] = b[3]
    valid[:200] = True
    cases["on-bounds"] = (xy, valid, octave, image, 16)
    cases["on-bounds-odd"] = (xy, valid, octave, odd, 16)
    xy, valid, octave = scatter()
    xy[:100] = 5.0
    valid[:100] = True
    cases["one-cell-cap8"] = (xy, valid, octave, image, 8)
    xy, _, octave = scatter()
    cases["all-invalid"] = (xy, np.zeros(n, bool), octave, image, 16)
    return cases
