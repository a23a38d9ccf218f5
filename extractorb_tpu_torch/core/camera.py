"""Pinhole camera (port of ``extractorb_tpu/core/camera.py``, pinhole subset).

The JAX package passes a projection closure to its matchers and solver;
here the camera is a small frozen dataclass of Python floats, because the
CUDA kernels need the intrinsics as numbers.
"""

from __future__ import annotations

import dataclasses

import torch

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


def undistort_points_pinhole(uv: torch.Tensor, cam: Pinhole, dist) -> torch.Tensor:
    """Undistort pixel coords with radial-tangential (k1,k2,p1,p2,k3):
    8 fixed compensation iterations (cv::undistortPoints' default), then
    re-projection through K."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    x, y = x0, y0
    for _ in range(8):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], -1)
