"""Camera models: Pinhole and Kannala-Brandt 8-parameter fisheye, and the
fisheye rig's two-view triangulation (port of ``extractorb_tpu/core/camera.py``).

The JAX package passes a projection closure to its matchers and solvers;
here the camera is a small frozen dataclass of Python floats, because the
CUDA kernels need the intrinsics as numbers.  ``project`` is the closure's
arithmetic; ``project_jac`` is its Jacobian d(u, v)/d(x, y, z), which the
JAX solvers take by ``jax.jacfwd`` through the closure and the plain
solvers here take in closed form.  K4 and K6 take the camera as a template
parameter (``csrc/camera_t.cuh``).

``triangulate_matches`` is the plain version of the triangulation half of
kernel K26 (``csrc/stereo_fisheye.cu``): on the card the rig's matches are
triangulated inside ``frontend.stereo.compute_stereo_fisheye_matches``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

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

    def project_jac(self, pc: torch.Tensor) -> torch.Tensor:
        """d(u, v)/d(x, y, z) (...,2,3) at camera-frame points (...,3)."""
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        iz = 1.0 / z
        zero = torch.zeros_like(z)
        return torch.stack([torch.stack([self.fx * iz, zero, -self.fx * x * iz * iz], -1),
                            torch.stack([zero, self.fy * iz, -self.fy * y * iz * iz], -1)], -2)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (...,2) -> unit-depth rays (...,3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], -1)

    def kernel_params(self) -> None:
        """The extra camera parameters K4 and K6 take: none (pinhole)."""
        return None


@dataclasses.dataclass(frozen=True)
class KannalaBrandt8:
    """KB8 fisheye: r(theta) = theta + k1 theta^3 + k2 theta^5 + k3 theta^7 +
    k4 theta^9 (reference KannalaBrandt8.cpp:28-56 project, :103-160
    unproject).  Keypoints stay raw (the reference keeps mvKeysUn ==
    mvKeys for a fisheye camera); every residual projects through the
    full model."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    k3: float
    k4: float

    NEWTON_ITERS = 10

    @staticmethod
    def from_config(c: CameraConfig) -> "KannalaBrandt8":
        return KannalaBrandt8(*(float(v) for v in (c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.k3,
                                                   c.k4)))

    @property
    def k(self):
        return (self.k1, self.k2, self.k3, self.k4)

    def K(self, device=None) -> torch.Tensor:
        return Pinhole(self.fx, self.fy, self.cx, self.cy).K(device)

    def _theta_to_r(self, theta: torch.Tensor) -> torch.Tensor:
        t2 = theta * theta
        k1, k2, k3, k4 = self.k
        return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))

    def project(self, p3d: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (...,3) -> pixels (...,2) in the JAX
        function's operation order: theta = atan2(r, z), the polynomial,
        and scale d / r with the ``r < 1e-8`` guard (scale 0 on the axis).
        Points with z <= 0 project too (theta > pi/2): the callers' depth
        gates keep them out."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        d = self._theta_to_r(theta)
        small = r < 1e-8
        scale = torch.where(small, 0.0, d / torch.where(small, 1.0, r))
        return torch.stack([self.fx * scale * x + self.cx, self.fy * scale * y + self.cy], -1)

    def project_jac(self, pc: torch.Tensor) -> torch.Tensor:
        """d(u, v)/d(x, y, z) (...,2,3), in closed form and float64, rounded
        to pc's type.  On the axis (r < 1e-8) it is 0, as ``jax.jacfwd``
        gives it through the JAX function's ``jnp.where`` guard."""
        q = pc.double()
        x, y, z = q[..., 0], q[..., 1], q[..., 2]
        r2 = x * x + y * y
        r = torch.sqrt(r2)
        small = r < 1e-8
        rs = torch.where(small, 1.0, r)
        theta = torch.atan2(r, z)
        t2 = theta * theta
        k1, k2, k3, k4 = self.k
        d = self._theta_to_r(theta)
        dd = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
        den = r2 + z * z
        s = d / rs
        ds_dr = dd * (z / den) / rs - d / (rs * rs)
        ds_dz = -dd * (r / den) / rs
        ds_dx, ds_dy = ds_dr * x / rs, ds_dr * y / rs
        J = torch.stack([
            torch.stack([self.fx * (s + x * ds_dx), self.fx * x * ds_dy, self.fx * x * ds_dz], -1),
            torch.stack([self.fy * y * ds_dx, self.fy * (s + y * ds_dy), self.fy * y * ds_dz], -1),
        ], -2)
        return torch.where(small[..., None, None], 0.0, J).to(pc.dtype)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (...,2) -> unit bearings (...,3): 10 Newton steps on theta
        from r_d (clamped to pi, as the reference), then (sin(theta) x / r,
        sin(theta) y / r, cos(theta)), which holds rays past 90 degrees."""
        f = np.float32
        k1, k2, k3, k4 = (f(v) for v in self.k)
        c3, c5, c7, c9 = (float(f(n) * k) for n, k in ((3, k1), (5, k2), (7, k3), (9, k4)))
        k1, k2, k3, k4 = float(k1), float(k2), float(k3), float(k4)
        wx = (uv[..., 0] - self.cx) / self.fx
        wy = (uv[..., 1] - self.cy) / self.fy
        r_d = torch.clamp(torch.sqrt(wx * wx + wy * wy), max=float(f(np.pi)))
        theta = r_d
        for _ in range(self.NEWTON_ITERS):
            t2 = theta * theta
            t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
            fv = theta * (1.0 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - r_d
            fp = 1.0 + c3 * t2 + c5 * t4 + c7 * t6 + c9 * t8
            theta = theta - fv / torch.where(torch.abs(fp) < 1e-8, 1.0, fp)
        small = r_d < 1e-8
        s = torch.where(small, 1.0, torch.sin(theta) / torch.where(small, 1.0, r_d))
        return torch.stack([wx * s, wy * s, torch.cos(theta)], -1)

    def kernel_params(self) -> np.ndarray:
        """The extra camera parameters K4 and K6 take: k1..k4 in float32."""
        return np.array(self.k, np.float32)


# a camera the projecting searches and the solvers K4 / K6 take
Camera = Union[Pinhole, KannalaBrandt8]


def camera_from_config(c: CameraConfig) -> Camera:
    """The camera of a configuration: ``KannalaBrandt8`` for
    ``model="KannalaBrandt8"``, else ``Pinhole``."""
    if c.model == "KannalaBrandt8":
        return KannalaBrandt8.from_config(c)
    return Pinhole.from_config(c)


def distort_points_pinhole(xy_norm: torch.Tensor, dist) -> torch.Tensor:
    """Apply radial-tangential distortion (k1, k2, p1, p2, k3) to
    normalised coordinates (...,2)."""
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xy_norm[..., 0], xy_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


# the rig's triangulation gates (KannalaBrandt8::TriangulateMatches): the
# rays' parallax (cos < 0.9998, ~1.15 degrees) and the reprojection chi2
MIN_PARALLAX_COS = 0.9998
TRI_CHI2 = 5.991


class TriangulationTerms(NamedTuple):
    """The quantities ``triangulate_matches`` gates on, per match."""
    p3d: torch.Tensor      # (N,3) left-camera point
    cos_par: torch.Tensor  # (N,) cosine of the rays' angle (gate: < min_parallax_cos)
    w: torch.Tensor        # (N,) homogeneous weight (gate: |w| > 1e-12)
    z1: torch.Tensor       # (N,) depth along the left bearing (gate: > 0)
    z2: torch.Tensor       # (N,) depth along the right bearing (gate: > 0)
    e1: torch.Tensor       # (N,) squared reprojection error, left (gate: <= chi2 sigma2_l)
    e2: torch.Tensor       # (N,) right (gate: <= chi2 sigma2_r)


def triangulation_terms(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, uv_l, uv_r, R_rl, t_rl,
                        svd_dtype: torch.dtype = torch.float64) -> TriangulationTerms:
    """The DLT triangulation of ``triangulate_matches`` and its gated
    quantities, in the JAX function's operation order: unit bearings, the
    four DLT rows b x (P p) = 0 against them, the (N,4,4) SVD, the point
    p = h[:3] / w (w guarded at 1e-12), depths along each bearing (fisheye
    rays may pass 90 degrees), reprojection through both cameras.  The SVD
    of the float32 rows runs in float64 and the point is rounded to float32
    (JAX: a float32 SVD): a float32 SVD of these 4x4 systems is good to only
    ~1e-5 of the point, which K26's float64 solve is held to.  ``svd_dtype``
    float32 gives JAX's solve (``chip_smoke.py`` prints K26's distance from
    it)."""
    b1 = cam_l.unproject(uv_l)
    b2 = cam_r.unproject(uv_r)
    cos_par = torch.sum(b1 * (b2 @ R_rl), -1)   # right bearings rotated into the left camera
    P1 = torch.cat([torch.eye(3, dtype=b1.dtype, device=b1.device),
                    torch.zeros(3, 1, dtype=b1.dtype, device=b1.device)], 1)
    P2 = torch.cat([R_rl, t_rl[:, None]], 1)

    def rows(b, P):
        return torch.stack([b[..., 2:3] * P[0] - b[..., 0:1] * P[2],
                            b[..., 2:3] * P[1] - b[..., 1:2] * P[2]], -2)

    A = torch.cat([rows(b1, P1), rows(b2, P2)], -2)   # (N,4,4)
    hp = torch.linalg.svd(A.to(svd_dtype)).Vh[..., 3, :]
    w = hp[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1.0, w)
    p3d = (hp[..., :3] / safe_w[..., None]).to(b1.dtype)
    z1 = torch.sum(p3d * b1, -1)
    p3d_r = p3d @ R_rl.T + t_rl
    z2 = torch.sum(p3d_r * b2, -1)
    e1 = torch.sum((cam_l.project(p3d) - uv_l) ** 2, -1)
    e2 = torch.sum((cam_r.project(p3d_r) - uv_r) ** 2, -1)
    return TriangulationTerms(p3d, cos_par, w, z1, z2, e1, e2)


def triangulation_gate_margin(t: TriangulationTerms, sigma2_l, sigma2_r,
                              min_parallax_cos: float = MIN_PARALLAX_COS, chi2: float = TRI_CHI2
                              ) -> torch.Tensor:
    """(N,) the smallest relative distance of a match's quantities to their
    gates: |cos - c| / c, |z| / |p3d| for the depths, |e - chi2 s2| / (chi2
    s2) for the errors.  A match whose validity two solvers disagree on
    sits on a gate when this is small (1e-4: float32 rounding)."""
    n = torch.linalg.vector_norm(t.p3d, dim=-1).clamp(min=1e-30)
    th_l, th_r = chi2 * sigma2_l, chi2 * sigma2_r
    return torch.stack([(t.cos_par - min_parallax_cos).abs() / min_parallax_cos,
                        t.z1.abs() / n, t.z2.abs() / n, (t.e1 - th_l).abs() / th_l,
                        (t.e2 - th_r).abs() / th_r], -1).amin(-1)


def triangulate_matches(cam_l: KannalaBrandt8, cam_r: KannalaBrandt8, uv_l, uv_r, R_rl, t_rl,
                        sigma2_l, sigma2_r, min_parallax_cos: float = MIN_PARALLAX_COS,
                        chi2: float = TRI_CHI2):
    """Batched two-view triangulation of a fisheye rig's matches with
    parallax, depth and chi2 gates.

    Replaces ``extractorb_tpu/core/camera.py:triangulate_matches``
    (KannalaBrandt8::TriangulateMatches, KannalaBrandt8.cpp:336-438): uv_l,
    uv_r (N,2) raw pixels of the left and right camera, the rig's relative
    pose [R_rl | t_rl] (left-camera coordinates to right-camera ones),
    per-match variances sigma2_l, sigma2_r (N,).  Returns (p3d (N,3) in the
    left camera for every row, depth (N,) = p3d's z where valid else -1,
    valid (N,)).  This is the plain version of K26's triangulation, which
    the card runs inside ``frontend.stereo.compute_stereo_fisheye_matches``."""
    t = triangulation_terms(cam_l, cam_r, uv_l, uv_r, R_rl, t_rl)
    valid = ((t.cos_par < min_parallax_cos) & (t.z1 > 0) & (t.z2 > 0) & (torch.abs(t.w) > 1e-12)
             & (t.e1 <= chi2 * sigma2_l) & (t.e2 <= chi2 * sigma2_r))
    return t.p3d, torch.where(valid, t.p3d[..., 2], -1.0), valid


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
