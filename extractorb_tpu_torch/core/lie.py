"""SO(3)/SE(3) operations on torch tensors (port of ``extractorb_tpu/core/lie.py``).

Only the subset the tracking step needs.  Conventions follow the
reference: rotations are 3x3 matrices, SE(3) is (R, t), the SE(3)
tangent is ordered (rho, phi) = (translation, rotation), and the solver
updates T * Exp(xi).  Every function broadcasts over leading dims and is
Taylor-guarded near theta = 0.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _safe_theta(w: torch.Tensor):
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return theta2, theta, small


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues). (...,3) -> (...,3,3)."""
    theta2, theta, small = _safe_theta(w)
    W = hat(w)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3) (reference RightJacobianSO3)."""
    theta2, theta, small = _safe_theta(w)
    W = hat(w)
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe_t2 * theta))
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l(w) = J_r(-w)."""
    return so3_right_jacobian(-w)


def se3_exp(xi: torch.Tensor):
    """se(3) -> SE(3).  xi = (rho, phi): (...,6) -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """SO(3) re-projection of a near-orthonormal R: two Newton-Schulz
    iterations, R <- R (1.5 I - 0.5 R^T R)."""
    I3 = _eye_like(R)
    for _ in range(2):
        R = R @ (1.5 * I3 - 0.5 * (R.transpose(-1, -2) @ R))
    return R
