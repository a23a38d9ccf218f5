"""Pinhole camera (port of ``extractorb_tpu/core/camera.py``, pinhole subset).

The JAX package passes a projection closure to its matchers and solver;
here the camera is a small frozen dataclass of Python floats, because the
CUDA kernels need the intrinsics as numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..config import CameraConfig


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Pinhole intrinsics; radial-tangential distortion is handled at
    keypoint-undistortion time (``undistort_points_pinhole``)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_config(c: CameraConfig) -> "Pinhole":
        return Pinhole(float(c.fx), float(c.fy), float(c.cx), float(c.cy))

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    def project(self, p3d: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (...,3) -> pixels (...,2), as
        ``fx * x / z + cx`` (the JAX step's projection closure)."""
        return torch.stack(
            [
                self.fx * p3d[..., 0] / p3d[..., 2] + self.cx,
                self.fy * p3d[..., 1] / p3d[..., 2] + self.cy,
            ],
            -1,
        )

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (...,2) -> unit-depth rays (...,3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], -1)


def _undistort_constants(cam: Pinhole, dist):
    """The float32 constants of the undistortion, in the order K24 takes
    them: fx, fy, cx, cy, 1/fx, 1/fy (rounded reciprocals), k1, k2, k3,
    p1, p2."""
    k1, k2, p1, p2, k3 = (np.float32(v) for v in dist)
    fx, fy, cx, cy = (np.float32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    one = np.float32(1.0)
    return np.array([fx, fy, cx, cy, one / fx, one / fy, k1, k2, k3, p1, p2], np.float32)


def undistort_points_pinhole_plain(uv: torch.Tensor, cam: Pinhole, dist) -> torch.Tensor:
    """Plain version of ``undistort_points_pinhole``.  Every operation is a
    float32 elementwise op on a tensor and a float32 constant, so the
    result is the same on the CPU and on the card (a division by fx is a
    product with the rounded reciprocal, as PyTorch computes a division by
    a scalar on the card)."""
    fx, fy, cx, cy, ifx, ify, k1, k2, k3, p1, p2 = (
        float(v) for v in _undistort_constants(cam, dist))
    tp1, tp2 = 2.0 * p1, 2.0 * p2
    x0 = (uv[..., 0] - cx) * ifx
    y0 = (uv[..., 1] - cy) * ify
    x, y = x0, y0
    for _ in range(8):
        r2 = x * x + y * y
        icdist = torch.reciprocal(1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = tp1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + tp2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([x * fx + cx, y * fy + cy], -1)


def undistort_points_pinhole(uv: torch.Tensor, cam: Pinhole, dist) -> torch.Tensor:
    """Undistort (N,2) float32 pixel coords with radial-tangential
    (k1,k2,p1,p2,k3): 8 fixed compensation iterations (cv::undistortPoints'
    default), then re-projection through K.

    Replaces ``extractorb_tpu/core/camera.py:undistort_points_pinhole``.  On
    a CUDA tensor this launches K24 (``csrc/undistort.cu``, one thread a
    keypoint, bit-equal to the plain version on the card); on the CPU it
    runs ``undistort_points_pinhole_plain``."""
    if not uv.is_cuda:
        return undistort_points_pinhole_plain(uv, cam, dist)
    if uv.dim() != 2 or uv.shape[1] != 2 or uv.dtype != torch.float32:
        raise ValueError(f"undistort: expected (N,2) float32 pixels, got {uv.dtype} "
                         f"{tuple(uv.shape)}")
    uv = uv.contiguous()
    if uv.data_ptr() % 8:
        uv = uv.clone()   # the kernel reads float2
    kernels.require_cuda("undistort", uv)
    prm = _undistort_constants(cam, dist)
    out = torch.empty_like(uv)
    err = kernels.lib().undistort_launch(uv.data_ptr(), uv.shape[0], prm.ctypes.data,
                                         out.data_ptr(), kernels.stream())
    kernels.check(err, "undistort")
    kernels.LAUNCHES["undistort"] += 1
    return out
