"""Motion-only bundle adjustment (port of ``extractorb_tpu/solver/pose_opt.py``).

The reference's PoseOptimization: one SE3 pose, unary reprojection edges,
Huber(sqrt(5.991)) in rounds 0-2 and none in round 3, 4 rounds x 10 LM
iterations with chi2 re-classification between rounds.  The JAX package
takes its Jacobians with ``jax.jacfwd`` through the projection closure;
here they are analytic: for the right perturbation R Exp(delta), delta =
(rho, phi), a point's camera coordinates move by [R | -R hat(p)] delta,
and the residual r = obs - pi(pc) by -J_pi [R | -R hat(p)], with J_pi
the camera's ``project_jac`` (the pinhole's in float32; the KB8 camera's
in float64, rounded).

``optimize_pose`` takes a batch of B independent problems (the fused
step solves its motion and reference-keyframe branches in one call).
On CUDA tensors it launches kernel K4 (``csrc/pose_lm.cu``, one CTA per
problem), with the stereo residual's third row where ``obs_ur`` is given
(pinhole only) and the KB8 projection for a ``KannalaBrandt8`` camera;
on the CPU it runs ``optimize_pose_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import lie
from ..core.camera import Camera, Pinhole
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # (B,3,3) world->camera
    t: torch.Tensor          # (B,3)
    inliers: torch.Tensor    # (B,N) bool
    n_inliers: torch.Tensor  # (B,) int32


def _residuals(R, t, pts, obs, cam: Camera, obs_ur=None, bf: float = 0.0,
               with_jac: bool = False):
    """Residuals (B,N,k) and, with_jac, Jacobians (B,N,k,6) at delta = 0;
    k = 2 (mono) or 3 (stereo, third row zero where obs_ur < 0)."""
    pc = torch.einsum("bij,bnj->bni", R, pts) + t[:, None]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    uv = cam.project(pc)
    u, v = uv[..., 0], uv[..., 1]
    res = [obs[..., 0] - u, obs[..., 1] - v]
    has_r = None
    if obs_ur is not None:
        has_r = obs_ur >= 0
        res.append(torch.where(has_r, obs_ur - (u - bf / z), 0.0))
    r = torch.stack(res, -1)
    if not with_jac:
        return r, None
    Jpi = cam.project_jac(pc)                        # d(u, v[, u_r]) / d pc (B,N,k,3)
    if obs_ur is not None:
        iz = 1.0 / z
        ju = torch.stack([cam.fx * iz, torch.zeros_like(z), (-cam.fx * x + bf) * iz * iz], -1)
        Jpi = torch.cat([Jpi, torch.where(has_r[..., None], ju, 0.0)[..., None, :]], -2)
    A = Jpi @ R[:, None]                             # J_pi R
    Ap = torch.linalg.cross(A, pts[:, :, None, :].expand_as(A), dim=-1)  # A hat(p) = a x p
    J = torch.cat([-A, Ap], -1)                      # (B,N,k,6)
    return r, J


def optimize_pose_plain(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam: Camera,
                        n_rounds: int = 4, n_iters: int = 10,
                        obs_ur: Optional[torch.Tensor] = None, bf: float = 0.0
                        ) -> PoseOptResult:
    """Plain version of ``optimize_pose`` (same arguments, batched)."""
    B = R0.shape[0]
    dev, dt = R0.device, R0.dtype
    if obs_ur is not None:
        chi2_th = torch.where(obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
        delta_h = torch.where(obs_ur >= 0, DELTA_STEREO, DELTA_MONO)
    else:
        chi2_th, delta_h = CHI2_MONO, DELTA_MONO
    # padded slots may hold zeros; project a safe point there instead
    safe = torch.zeros_like(pts_w)
    safe[..., 2] = 1.0
    pts = torch.where(valid[..., None], pts_w, safe)

    def rho_of(c2, use_huber):
        if not use_huber:
            return c2
        d2 = delta_h * delta_h
        return torch.where(c2 <= d2, c2, 2.0 * delta_h * torch.sqrt(c2) - d2)

    def cost(Rc, tc, active, use_huber):
        rr, _ = _residuals(Rc, tc, pts, obs_uv, cam, obs_ur, bf)
        c2 = torch.sum(rr * rr, -1) * inv_sigma2
        return torch.sum(torch.where(active, rho_of(c2, use_huber), 0.0), -1)

    R, t, active = R0, t0, valid
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for rnd in range(n_rounds):
        use_huber = rnd < 3
        lam = torch.full((B,), 1e-3, dtype=dt, device=dev)
        for _ in range(n_iters):
            r, J = _residuals(R, t, pts, obs_uv, cam, obs_ur, bf, with_jac=True)
            chi2 = torch.sum(r * r, -1) * inv_sigma2
            w = huber_weight(chi2, delta_h) if use_huber else torch.ones_like(chi2)
            w = w * inv_sigma2 * active.to(dt)
            Jw = J * w[..., None, None]
            H = torch.einsum("bnio,bnij->boj", Jw, J)
            b = torch.einsum("bnio,bni->bo", Jw, r)
            Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
            delta = -torch.linalg.solve(Hd + 1e-9 * eye6, b)
            dR, dtr = lie.se3_exp(delta)
            Rn = R @ dR
            tn = (R @ dtr[..., None])[..., 0] + t
            c_old = torch.sum(torch.where(active, rho_of(chi2, use_huber), 0.0), -1)
            c_new = cost(Rn, tn, active, use_huber)
            better = c_new < c_old
            R = torch.where(better[:, None, None], Rn, R)
            t = torch.where(better[:, None], tn, t)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
        rr, _ = _residuals(R, t, pts, obs_uv, cam, obs_ur, bf)
        chi2 = torch.sum(rr * rr, -1) * inv_sigma2
        active = valid & (chi2 <= chi2_th)
    R = lie.orthonormalize(R)
    return PoseOptResult(R, t, active, torch.sum(active.to(torch.int32), -1))


def optimize_pose(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam: Camera,
                  n_rounds: int = 4, n_iters: int = 10,
                  obs_ur: Optional[torch.Tensor] = None, bf: float = 0.0
                  ) -> PoseOptResult:
    """The reference's 4x10 robust pose optimisation, for B problems.

    Replaces ``extractorb_tpu/solver/pose_opt.py:optimize_pose``.
    R0 (B,3,3), t0 (B,3), pts_w (B,N,3) world points, obs_uv (B,N,2)
    pixels, inv_sigma2 (B,N), valid (B,N) bool.  Invalid slots never
    contribute.  obs_ur (B,N), with bf = fx * baseline, makes an
    observation with obs_ur >= 0 a stereo edge (3-row residual, stereo
    Huber delta and chi2; pinhole only).  ``cam`` is a ``Pinhole`` or a
    ``KannalaBrandt8``.  On CUDA tensors this launches K4 once for the
    batch."""
    if obs_ur is not None and not isinstance(cam, Pinhole):
        raise ValueError("optimize_pose: the stereo residual takes a pinhole camera")
    if not R0.is_cuda:
        return optimize_pose_plain(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam,
                                   n_rounds, n_iters, obs_ur, bf)
    B, N = pts_w.shape[0], pts_w.shape[1]
    f32 = lambda a: a.to(torch.float32).contiguous()
    args = [f32(R0), f32(t0), f32(pts_w), f32(obs_uv), f32(inv_sigma2), valid.contiguous()]
    if obs_ur is not None:
        if obs_ur.shape != (B, N):
            raise ValueError(f"pose_lm: obs_ur is {tuple(obs_ur.shape)}, expected {(B, N)}")
        args.append(f32(obs_ur))
    kernels.require_cuda("pose_lm", *args)
    R = torch.empty(B, 3, 3, dtype=torch.float32, device=R0.device)
    t = torch.empty(B, 3, dtype=torch.float32, device=R0.device)
    inl = torch.empty(B, N, dtype=torch.bool, device=R0.device)
    n_inl = torch.empty(B, dtype=torch.int32, device=R0.device)
    p = [a.data_ptr() for a in args]
    ur_ptr = p[6] if obs_ur is not None else None
    kb8 = cam.kernel_params()
    err = kernels.lib().pose_lm_launch(
        p[0], p[1], p[2], p[3], ur_ptr, p[4], p[5], B, N, cam.fx, cam.fy, cam.cx, cam.cy,
        None if kb8 is None else kb8.ctypes.data, float(bf), n_rounds, n_iters, R.data_ptr(),
        t.data_ptr(), inl.data_ptr(), n_inl.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "pose_lm")
    kernels.LAUNCHES["pose_lm"] += 1
    if kb8 is not None:
        kernels.LAUNCHES["pose_lm_kb8"] += 1     # of those, through the KB8 camera
    if obs_ur is not None:
        kernels.LAUNCHES["pose_lm_stereo"] += 1   # of those, with the stereo rows
    return PoseOptResult(R, t, inl, n_inl)
