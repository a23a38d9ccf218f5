"""Frame overlay drawing (reference FrameDrawer, src/FrameDrawer.cc).

The reference draws, onto the tracked frame: green squares+dots for
keypoints matched to map points, blue for "visual-odometry" points
(seen <2 keyframes), the initialization match lines, and a status text
bar (state, #KFs, #MPs, #matches).  This is a faithful headless
equivalent in pure numpy — no OpenCV/GUI dependency — producing an
HxWx3 uint8 image.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

GREEN = (0, 220, 0)
BLUE = (80, 120, 255)
RED = (230, 60, 40)
WHITE = (255, 255, 255)
BLACK = (0, 0, 0)

# 5x7 bitmap font for the status bar (digits + the letters we need)
_GLYPHS = {
    "0": "111101101101101101111", "1": "010110010010010010111",
    "2": "111001001111100100111", "3": "111001011001001001111",
    "4": "101101101111001001001", "5": "111100100111001001111",
    "6": "111100100111101101111", "7": "111001001010010010010",
    "8": "111101101111101101111", "9": "111101101111001001111",
    "K": "101101110100110101101", "F": "111100100111100100100",
    "M": "101111111101101101101", "P": "111101101111100100100",
    "S": "111100100111001001111", "L": "100100100100100100111",
    "O": "111101101101101101111", "T": "111010010010010010010",
    "N": "101111111111101101101", "I": "111010010010010010111",
    "A": "010101101111101101101", "C": "111100100100100100111",
    "E": "111100100111100100111", "D": "110101101101101101110",
    "R": "111101101111110101101", ":": "000010000000010000000",
    " ": "000000000000000000000", "=": "000111000111000000000",
    "|": "010010010010010010010",
}


def _draw_text(img: np.ndarray, x: int, y: int, text: str, color=WHITE):
    for ch in text.upper():
        g = _GLYPHS.get(ch)
        if g is not None:
            bits = np.array([int(c) for c in g], bool).reshape(7, 3)
            h = min(7, img.shape[0] - y)
            w = min(3, img.shape[1] - x)
            if h > 0 and w > 0:
                region = img[y : y + h, x : x + w]
                region[bits[:h, :w]] = color
        x += 5
    return img


def _rect(img, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    x0, x1 = max(0, x0), min(w - 1, x1)
    y0, y1 = max(0, y0), min(h - 1, y1)
    if x0 > x1 or y0 > y1:
        return
    img[y0, x0 : x1 + 1] = color
    img[y1, x0 : x1 + 1] = color
    img[y0 : y1 + 1, x0] = color
    img[y0 : y1 + 1, x1] = color


def _dot(img, x, y, color, r=1):
    h, w = img.shape[:2]
    img[max(0, y - r) : min(h, y + r + 1), max(0, x - r) : min(w, x + r + 1)] = color


def _line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.round(np.linspace(x0, x1, n + 1)).astype(int)
    ys = np.round(np.linspace(y0, y1, n + 1)).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = color


class FrameDrawer:
    """Composites the tracking overlay for the most recent frame."""

    def __init__(self):
        self.image: Optional[np.ndarray] = None

    def update(
        self,
        gray: np.ndarray,
        kp_xy: np.ndarray,
        kp_valid: np.ndarray,
        kp_mp: Optional[np.ndarray] = None,
        state: str = "OK",
        n_keyframes: int = 0,
        n_map_points: int = 0,
        init_matches: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> np.ndarray:
        """Reference FrameDrawer::Update + DrawFrame in one step.

        gray: (H,W) uint8; kp_xy: (N,2); kp_valid: (N,) bool;
        kp_mp: (N,) map-point id per keypoint or -1 (green if >=0,
        blue otherwise, matching the tracked/VO color split);
        init_matches: optional [(xy_ref, xy_cur)] pairs drawn as lines
        during initialization (reference's mvIniMatches path).
        """
        img = np.repeat(np.asarray(gray, np.uint8)[:, :, None], 3, axis=2).copy()
        xy = np.asarray(kp_xy)
        valid = np.asarray(kp_valid, bool)
        mp = (
            np.asarray(kp_mp)
            if kp_mp is not None
            else np.full(len(xy), -1, np.int64)
        )
        n_tracked = 0
        for i in np.where(valid)[0]:
            x, y = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
            if mp[i] >= 0:
                _rect(img, x - 4, y - 4, x + 4, y + 4, GREEN)
                _dot(img, x, y, GREEN)
                n_tracked += 1
            else:
                _dot(img, x, y, BLUE)
        if init_matches:
            for a, b in init_matches:
                _line(
                    img, int(round(float(a[0]))), int(round(float(a[1]))),
                    int(round(float(b[0]))), int(round(float(b[1]))), RED,
                )

        # status bar (reference DrawTextInfo appends a strip below)
        bar = np.zeros((12, img.shape[1], 3), np.uint8)
        txt = (
            f"{state} | KFS:{n_keyframes} MPS:{n_map_points} "
            f"MATCHES:{n_tracked}"
        )
        _draw_text(bar, 3, 2, txt)
        self.image = np.concatenate([img, bar], axis=0)
        return self.image

    def save(self, path: str):
        assert self.image is not None, "update() before save()"
        import imageio.v2 as imageio

        imageio.imwrite(path, self.image)
