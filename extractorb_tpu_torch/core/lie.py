"""SO(3)/SE(3) operations on torch tensors (port of ``extractorb_tpu/core/lie.py``).

Conventions follow the reference: rotations are 3x3 matrices, SE(3) is
(R, t), the SE(3) tangent is ordered (rho, phi) = (translation,
rotation), and the solver updates T * Exp(xi).  Every function broadcasts over leading dims and is
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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


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
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2), theta2))
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


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) (reference InverseRightJacobianSO3)."""
    theta2, theta, small = _safe_theta(w)
    W = hat(w)
    one = torch.ones_like(theta2)
    safe_t2 = torch.where(small, one, theta2)
    safe_sin = torch.where(small, one, theta * torch.sin(theta))
    generic = 1.0 / safe_t2 - (1.0 + torch.cos(theta)) / (2.0 * safe_sin)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, generic)
    return _eye_like(W) + 0.5 * W + c[..., None, None] * (W @ W)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return so3_right_jacobian_inv(-w)


def se3_exp(xi: torch.Tensor):
    """se(3) -> SE(3).  xi = (rho, phi): (...,6) -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3): (...,6) as (rho, phi), rho = J_l(phi)^-1 t."""
    phi = so3_log(R)
    rho = (so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, p):
    """Transform points p (...,3)."""
    return (R @ p[..., None])[..., 0] + t


def se3_matrix(R, t):
    """(R, t) -> 4x4 homogeneous matrix."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0: the
    branch-free Shepperd selection of the most stable component."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], -1)
    k = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], -2)  # (..., 4 pivots, 4 components)
    q = torch.gather(cand, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
    return torch.where(q[..., :1] < 0, -q, q)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """SO(3) re-projection of a near-orthonormal R: two Newton-Schulz
    iterations, R <- R (1.5 I - 0.5 R^T R)."""
    I3 = _eye_like(R)
    for _ in range(2):
        R = R @ (1.5 * I3 - 0.5 * (R.transpose(-1, -2) @ R))
    return R


_EPS = 1e-8


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3), (...,3,3) -> (...,3), through the Shepperd
    quaternion: w = 2 atan2(|v|, qw) v / |v|, with the Taylor branch
    2 / qw (1 - |v|^2 / (3 qw^2)) at |v|^2 < 1e-12.  The square root sits
    inside the branch, so forward-mode derivatives stay finite at v = 0."""
    q = rot_to_quat(R)
    qw, v = q[..., 0], q[..., 1:]
    nv2 = torch.sum(v * v, dim=-1)
    small = nv2 < 1e-12
    safe_nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    theta = 2.0 * torch.atan2(safe_nv, qw)
    safe_qw = torch.clamp(qw, min=_EPS)
    factor = torch.where(small, 2.0 / safe_qw * (1.0 - nv2 / (3.0 * safe_qw * safe_qw)),
                         theta / safe_nv)
    return factor[..., None] * v


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) through its SVD (U diag(1, 1,
    det(U V^T)) V^T)."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    D = torch.cat([torch.ones(R.shape[:-2] + (2,), dtype=R.dtype, device=R.device),
                   det[..., None]], -1)
    return (U * D[..., None, :]) @ Vh


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def sim3_apply(R, t, s, p):
    return s[..., None] * _mv(R, p) + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)   # 1.0 / s of a 0-dim s takes a float64 tangent under jacfwd
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) * (Rb,tb,sb): x -> sa Ra (sb Rb x + tb) + ta."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def _one_minus_cos_over_x2(x):
    x2 = x * x
    small = torch.abs(x) < 1e-4
    return torch.where(small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0,
                       (1.0 - torch.cos(x)) / torch.where(small, torch.ones_like(x2), x2))


def _sim3_V_coeffs(phi, sigma):
    """A, B, C of V = A I + B hat(phi) + C hat(phi)^2 (Sophus' Sim3 exp),
    with the branches of the JAX package at |sigma|, theta < 1e-5."""
    s = torch.exp(sigma)
    th2_raw = torch.sum(phi * phi, dim=-1)
    # theta = |phi| with a derivative-safe square root at phi = 0
    t_small = th2_raw < 1e-10
    theta = torch.where(t_small, torch.zeros_like(th2_raw),
                        torch.sqrt(torch.where(t_small, torch.ones_like(th2_raw), th2_raw)))
    eps = 1e-5
    s_small = torch.abs(sigma) < eps
    one = torch.ones_like(sigma)
    safe_sigma = torch.where(s_small, one, sigma)
    safe_theta = torch.where(t_small, one, theta)
    theta2 = theta * theta
    A = torch.where(s_small, 1.0 + 0.5 * sigma, (s - 1.0) / safe_sigma)
    c, si = torch.cos(theta), torch.sin(theta)
    a_gen, b_gen = s * si, s * c
    denom = sigma * sigma + theta2
    safe_denom = torch.where(s_small & t_small, one, denom)
    B_gen = (a_gen * sigma + (1.0 - b_gen) * theta) / (safe_theta * safe_denom)
    C_gen = (A - (b_gen - 1.0) * sigma / safe_denom - a_gen * theta / safe_denom) / torch.where(
        t_small, one, theta2)
    B_s0 = _one_minus_cos_over_x2(theta)
    C_s0 = torch.where(t_small, one / 6.0,
                       (theta - si) / torch.where(t_small, one, theta2 * safe_theta))
    B_t0 = torch.where(s_small, one * 0.5, ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    C_t0 = torch.where(s_small, one / 6.0,
                       ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0)
                       / (safe_sigma * safe_sigma * safe_sigma))
    B = torch.where(t_small, B_t0, torch.where(s_small, B_s0, B_gen))
    C = torch.where(t_small, C_t0, torch.where(s_small, C_s0, C_gen))
    return A, B, C, s


def sim3_exp(xi: torch.Tensor):
    """sim(3) -> Sim(3): xi = (rho, phi, sigma) (...,7) -> (R, t, s), with
    t = V rho and V from the closed form (Strasdat's thesis)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    A, B, C, s = _sim3_V_coeffs(phi, sigma)
    W = hat(phi)
    V = A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return R, _mv(V, rho), s


def sim3_log(R, t, s):
    """Sim(3) -> sim(3): (...,7) as (rho, phi, sigma), rho = V^-1 t with
    exp's V at (phi, log s)."""
    phi = so3_log(R)
    sigma = torch.log(s)
    A, B, C, _ = _sim3_V_coeffs(phi, sigma)
    W = hat(phi)
    V = A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    rho = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)
