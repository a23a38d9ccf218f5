"""Shared plumbing of the demo mains (reference: the glog-init + imread
prologue every demo main repeats, e.g.
src/orb_extractor/main_orb_extractor.cpp:8-25).

The default image is a procedural texture made from a seed (a copy of
``tests/port_fixtures.py:procedural_texture``): multi-scale smoothed noise
with sharp discs and rectangles, on which FAST fires at every level of the
pyramid.  ``--image`` reads a ``.npy`` array, or any file a lazily
imported imageio reads.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..config import ORBConfig

# TUM-VI 512 fisheye calibration hard-coded by the reference demos
# (src/matcher/main_matcher.cpp:95-100)
TUM_KB8 = dict(
    fx=190.97847715128717, fy=190.9733070521226,
    cx=254.93170605935475, cy=256.8974428996504,
    k1=0.0034823894022493434, k2=0.0007150348452162257,
    k3=-0.0020532361418706202, k4=0.00020293673591811182,
)
TEXTURE_SIZE = 1024


def _upsample(grid: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsampling of a small square grid to (size, size)."""
    n = grid.shape[0]
    c = np.linspace(0.0, n - 1.0, size)
    i0 = np.minimum(np.floor(c).astype(np.int64), n - 2)
    f = c - i0
    rows = grid[i0] * (1 - f)[:, None] + grid[i0 + 1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]


def procedural_texture(size: int = TEXTURE_SIZE, seed: int = 0) -> np.ndarray:
    """uint8 (size, size) texture: multi-scale smoothed noise plus sharp
    discs and rectangles of random intensity."""
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


def _gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3:   # RGB(A) as imageio reads it
        img = np.round(0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    if img.ndim != 2:
        raise SystemExit(f"expected a grayscale or RGB image, got shape {img.shape}")
    return np.ascontiguousarray(img.astype(np.uint8))


def read_image(path: str) -> np.ndarray:
    """A uint8 grayscale image from a ``.npy`` array or an image file."""
    if path.endswith(".npy"):
        return _gray(np.load(path))
    import imageio.v2 as imageio

    return _gray(imageio.imread(path))


def write_image(path: str, img: np.ndarray):
    if path.endswith(".npy"):
        np.save(path, img)
        return
    import imageio.v2 as imageio

    imageio.imwrite(path, img)


def default_image(shape: Tuple[int, int]) -> np.ndarray:
    """The top-left (H, W) crop of the procedural texture."""
    h, w = shape
    return np.ascontiguousarray(procedural_texture()[:h, :w])


def default_parser(desc: str, image: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    if image:
        p.add_argument("--image", default=None,
                       help="a .npy array or an image file (default: the procedural texture)")
    p.add_argument("--out", default=None, help="write the result image here (.npy or .png)")
    p.add_argument("--features", type=int, default=None,
                   help="override the keypoint budget (small values run faster; used by "
                        "the tests)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p


def demo_device(args) -> torch.device:
    """The card unless ``--device`` names another; raises without a card."""
    return kernels.resolve_device(args.device, "the demo")


def load(args, shape: Tuple[int, int]) -> np.ndarray:
    return read_image(args.image) if getattr(args, "image", None) else default_image(shape)


def orb_config(args, default_features: int) -> ORBConfig:
    """ORBConfig honoring the --features override."""
    n = args.features if getattr(args, "features", None) else default_features
    # the padded per-level candidate capacity shrinks with the budget
    cap = 4096 if n >= 1000 else 1024
    return ORBConfig(n_features=n, max_kps_per_level=cap)


@contextlib.contextmanager
def timer(label: str, device: torch.device):
    """Print the host time of the block, the card's work included."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)


def _sample_bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = tex.shape
    u = np.clip(u, 0.0, w - 1.001)
    v = np.clip(v, 0.0, h - 1.001)
    u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    fu, fv = u - u0, v - v0
    t = tex.astype(np.float64)
    top = t[v0, u0] * (1 - fu) + t[v0, u0 + 1] * fu
    bot = t[v0 + 1, u0] * (1 - fu) + t[v0 + 1, u0 + 1] * fu
    return top * (1 - fv) + bot * fv


# the default pair (``texture_pair``): the texture on the plane Z = 1 m of
# the first camera; the second turned about y and moved (in its own frame)
PAIR_SIZE = 512
PAIR_DEPTH = 1.0
PAIR_T21 = (0.12, 0.02, 0.0)
PAIR_YAW_DEG = 1.5


def texture_pair(K: np.ndarray):
    """Two (PAIR_SIZE, PAIR_SIZE) views of the procedural texture laid on
    the plane Z = PAIR_DEPTH of the first camera: the first sees the
    texture's centre crop; the second is that camera turned by PAIR_YAW_DEG
    about y and moved by PAIR_T21, rendered through the plane's homography
    H21 = K (R21 + t21 n^T / depth) K^-1 with bilinear sampling."""
    size = PAIR_SIZE
    tex = procedural_texture()
    off = (TEXTURE_SIZE - size) // 2
    a = np.deg2rad(PAIR_YAW_DEG)
    R21 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    n_d = np.array([0.0, 0.0, 1.0 / PAIR_DEPTH])
    H21 = K @ (R21 + np.outer(np.asarray(PAIR_T21, np.float64), n_d)) @ np.linalg.inv(K)
    vv, uu = np.mgrid[0:size, 0:size].astype(np.float64)
    p2 = np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)])
    p1 = np.linalg.solve(H21, p2)
    u1, v1 = p1[0] / p1[2], p1[1] / p1[2]
    im1 = tex[off:off + size, off:off + size]
    im2 = _sample_bilinear(tex, u1 + off, v1 + off).reshape(size, size)
    return (np.ascontiguousarray(im1),
            np.clip(np.rint(im2), 0, 255).astype(np.uint8))
