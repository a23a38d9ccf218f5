"""Map rendering (reference MapDrawer, src/MapDrawer.cc).

The reference draws map points, keyframe frusta, the covisibility
graph, and the current camera with Pangolin/OpenGL.  Headless
equivalent: a matplotlib (Agg) 3D-ish top/iso view rendered to an RGB
array or PNG.  Geometry helpers (`frustum_segments`,
`covisibility_segments`) are pure and separately testable.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def frustum_segments(R: np.ndarray, t: np.ndarray, size: float = 0.1
                     ) -> np.ndarray:
    """The 8 line segments of a keyframe frustum (reference
    MapDrawer::DrawKeyFrames' glVertex pattern), world coords, (16,3)."""
    w, h, z = size, size * 0.75, size * 0.6
    corners_cam = np.array(
        [[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
        np.float32,
    )
    Rwc, twc = R.T, -R.T @ t
    c = corners_cam @ Rwc.T + twc
    segs = [
        c[0], c[1], c[0], c[2], c[0], c[3], c[0], c[4],
        c[1], c[2], c[2], c[3], c[3], c[4], c[4], c[1],
    ]
    return np.stack(segs)


def covisibility_segments(mp, min_weight: int = 15) -> np.ndarray:
    """Line segments between covisible keyframe centres (reference
    MapDrawer::DrawKeyFrames graph pass), (2E,3)."""
    segs = []
    seen = set()
    for kid in mp.keyframes:
        for nk, w in mp.covisible_keyframes(kid, min_weight):
            key = (min(kid, nk), max(kid, nk))
            if key in seen or nk not in mp.keyframes:
                continue
            seen.add(key)
            segs.append(mp.keyframes[kid].center())
            segs.append(mp.keyframes[nk].center())
    if not segs:
        return np.zeros((0, 3), np.float32)
    return np.stack(segs).astype(np.float32)


class MapDrawer:
    def __init__(self, point_size: float = 1.0, frustum_size: float = 0.1):
        self.point_size = point_size
        self.frustum_size = frustum_size

    def render(
        self,
        mp,
        current_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        view: str = "top",
        figsize: Tuple[float, float] = (6.0, 6.0),
    ) -> np.ndarray:
        """Render one map to an (H,W,3) uint8 array.  view: 'top' (x-z)
        or 'side' (x-y)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        ax_idx = (0, 2) if view == "top" else (0, 1)
        fig, ax = plt.subplots(figsize=figsize, dpi=100)
        n = mp._next_mp
        pts = mp.mp_pos[:n][mp.mp_valid[:n]]
        if len(pts):
            ax.scatter(
                pts[:, ax_idx[0]], pts[:, ax_idx[1]],
                s=self.point_size, c="k", alpha=0.4, linewidths=0,
            )
        for kf in mp.keyframes.values():
            segs = frustum_segments(kf.R, kf.t, self.frustum_size)
            for i in range(0, len(segs), 2):
                ax.plot(
                    segs[i : i + 2, ax_idx[0]], segs[i : i + 2, ax_idx[1]],
                    "b-", lw=0.5,
                )
        cov = covisibility_segments(mp)
        for i in range(0, len(cov), 2):
            ax.plot(
                cov[i : i + 2, ax_idx[0]], cov[i : i + 2, ax_idx[1]],
                "g-", lw=0.3, alpha=0.6,
            )
        if current_pose is not None:
            R, t = current_pose
            segs = frustum_segments(R, t, self.frustum_size * 1.5)
            for i in range(0, len(segs), 2):
                ax.plot(
                    segs[i : i + 2, ax_idx[0]], segs[i : i + 2, ax_idx[1]],
                    "r-", lw=1.0,
                )
        ax.set_aspect("equal", adjustable="datalim")
        ax.set_xlabel("x")
        ax.set_ylabel("z" if view == "top" else "y")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return buf

    def save(self, mp, path: str, **kw):
        import imageio.v2 as imageio

        imageio.imwrite(path, self.render(mp, **kw))
