"""Sim3 estimation between keyframes for loop closing (port of
``extractorb_tpu/geometry/sim3.py``).

Replaces Sim3Solver (reference src/Sim3Solver.cc) and
Optimizer::OptimizeSim3 (src/Optimizer.cc:3888):

- ``horn_sim3``: the closed-form similarity p2 ~= s R p1 + t of Horn
  (1987), the rotation from the largest eigenvector of the 4x4 quaternion
  matrix N;
- ``solve_sim3_ransac``: every hypothesis solves Horn on its 3-point set
  and is scored by reprojection in both images (error^2 < th2, positive
  depth in both cameras); the first hypothesis with the most inliers
  wins; success needs max(20, int(0.4 n_valid)) inliers;
- ``optimize_sim3``: the 7-parameter LM over the bidirectional
  reprojection edges, 5 steps on every edge, the chi2 re-selection, and
  10 more on the inliers when at least 10 remain; Huber sqrt(th2) per
  edge, ``fix_scale`` freezes the scale coordinate.  The Jacobian is
  taken by forward mode (``torch.func.jacfwd``), as the JAX function's
  ``jax.jacfwd``.

The JAX function draws its 3-point sets with ``jax.random`` inside the
program.  Here the draw is split off: ``sample_sim3_sets(seed, valid)``
draws on a CPU ``torch.Generator`` (three distinct indices per hypothesis,
valid ones first), so the card and the CPU see the same hypotheses and a
test can hand both packages JAX's draw.  Horn's eigenproblem runs in
float64 (the centroids and the cross-dispersion in float32, in a fixed
order), the rest in float32.

``solve_sim3_ransac`` and ``optimize_sim3`` launch kernel K12
(``csrc/sim3.cu``) on CUDA tensors and run their plain versions on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie
from ..core.camera import Pinhole

N_HYPOTHESES = 128


class Sim3Result(NamedTuple):
    success: torch.Tensor   # () bool
    R12: torch.Tensor       # (3,3)
    t12: torch.Tensor       # (3,)
    s12: torch.Tensor       # ()
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor  # () int32


class Sim3OptResult(NamedTuple):
    R12: torch.Tensor
    t12: torch.Tensor
    s12: torch.Tensor
    inliers: torch.Tensor   # (N,) bool
    n_in: torch.Tensor      # () int32


def sample_sim3_sets(seed: int, valid, n_hyp: int = N_HYPOTHESES) -> torch.Tensor:
    """(n_hyp, 3) int64 sets of three distinct indices, uniform over the
    valid entries (the invalid ones follow only when fewer than three are
    valid), on a CPU generator seeded with ``seed``, moved to ``valid``'s
    device."""
    valid = torch.as_tensor(valid)
    v = valid.detach().cpu().bool().reshape(-1)
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand((n_hyp, v.numel()), generator=g) + 10.0 * (~v).float()
    return torch.argsort(u, dim=1)[:, :3].to(valid.device)


# ---------------------------------------------------------------- Horn


def _horn_N(x1, x2):
    """Horn's symmetric 4x4 N from centred (..., n, 3) point sets."""
    M = x1.transpose(-1, -2) @ x2
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def horn_sim3(p1, p2, fix_scale: bool = False):
    """Closed-form s, R, t with p2 ~= s R p1 + t for (M,3) point sets."""
    c1, c2 = p1.mean(0), p2.mean(0)
    x1, x2 = p1 - c1, p2 - c2
    q = torch.linalg.eigh(_horn_N(x1, x2).double())[1][..., -1].to(p1.dtype)
    R = lie.quat_to_rot(q)
    if fix_scale:
        s = torch.ones((), dtype=p1.dtype, device=p1.device)
    else:
        s = torch.sqrt(torch.sum(x2 * x2) / torch.clamp(torch.sum(x1 * x1), min=1e-12))
    return R, c2 - s * (R @ c1), s


def _horn3(a, b, fix_scale: bool):
    """Horn for (H,3,3) three-point sets, sums in a fixed order (K12's)."""
    c1 = (a[:, 0] + a[:, 1] + a[:, 2]) / 3.0
    c2 = (b[:, 0] + b[:, 1] + b[:, 2]) / 3.0
    x1, x2 = a - c1[:, None], b - c2[:, None]
    N = torch.zeros(a.shape[0], 4, 4, dtype=torch.float32, device=a.device)
    M = [[x1[:, 0, i] * x2[:, 0, j] + x1[:, 1, i] * x2[:, 1, j] + x1[:, 2, i] * x2[:, 2, j]
          for j in range(3)] for i in range(3)]
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = M
    vals = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    for i in range(4):
        for j in range(4):
            N[:, i, j] = vals[i][j]
    q = torch.linalg.eigh(N.double())[1][..., -1].float()
    R = lie.quat_to_rot(q)
    sq = lambda x: ((x[:, 0, 0] * x[:, 0, 0] + x[:, 0, 1] * x[:, 0, 1] + x[:, 0, 2] * x[:, 0, 2])
                    + (x[:, 1, 0] * x[:, 1, 0] + x[:, 1, 1] * x[:, 1, 1] + x[:, 1, 2] * x[:, 1, 2])
                    + (x[:, 2, 0] * x[:, 2, 0] + x[:, 2, 1] * x[:, 2, 1] + x[:, 2, 2] * x[:, 2, 2]))
    if fix_scale:
        s = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
    else:
        s = torch.sqrt(sq(x2) / torch.clamp(sq(x1), min=1e-12))
    Rc1 = torch.stack([R[:, i, 0] * c1[:, 0] + R[:, i, 1] * c1[:, 1] + R[:, i, 2] * c1[:, 2]
                       for i in range(3)], -1)
    return R, c2 - s[:, None] * Rc1, s


def _sim3_points(R, t, s, p):
    """s R p + t for (H,...) transforms and (N,3) points: (H,N,3), in a
    fixed order."""
    return torch.stack([s[:, None] * (R[:, None, i, 0] * p[:, 0] + R[:, None, i, 1] * p[:, 1]
                                      + R[:, None, i, 2] * p[:, 2]) + t[:, None, i]
                        for i in range(3)], -1)


def _reproj_err2(pc, uv, cam: Pinhole):
    du = cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - uv[:, 0]
    dv = cam.fy * pc[..., 1] / pc[..., 2] + cam.cy - uv[:, 1]
    return du * du + dv * dv


def _score(R, t, s, p1, p2, uv1, uv2, valid, cam: Pinhole, th2: float):
    """Inlier masks (H,N): both reprojections under th2, both depths > 0."""
    p2p = _sim3_points(R, t, s, p1)
    Ri = R.transpose(-1, -2)
    si = 1.0 / s
    ti = -si[:, None] * torch.stack([Ri[:, i, 0] * t[:, 0] + Ri[:, i, 1] * t[:, 1]
                                     + Ri[:, i, 2] * t[:, 2] for i in range(3)], -1)
    p1p = _sim3_points(Ri, ti, si, p2)
    e2 = _reproj_err2(p2p, uv2, cam)
    e1 = _reproj_err2(p1p, uv1, cam)
    return valid & (e1 < th2) & (e2 < th2) & (p2p[..., 2] > 0) & (p1p[..., 2] > 0)


def solve_sim3_ransac_plain(sets, p1, p2, uv1, uv2, valid, cam: Pinhole,
                            fix_scale: bool = False, th2: float = 9.21) -> Sim3Result:
    """Plain version of ``solve_sim3_ransac`` (same arguments)."""
    idx = sets.long()
    R, t, s = _horn3(p1[idx], p2[idx], fix_scale)
    inl = _score(R, t, s, p1, p2, uv1, uv2, valid, cam, th2)
    counts = inl.sum(-1).to(torch.int32)
    best = torch.argmax(counts)
    n_valid = valid.sum().to(torch.int32)
    need = torch.clamp((torch.tensor(0.4, dtype=torch.float32) * n_valid.float()).to(torch.int32),
                       min=20)
    return Sim3Result(counts[best] >= need, R[best], t[best], s[best], inl[best], counts[best])


def solve_sim3_ransac(sets, p1, p2, uv1, uv2, valid, cam: Pinhole, fix_scale: bool = False,
                      th2: float = 9.21) -> Sim3Result:
    """Batched RANSAC Sim3 over the 3-point ``sets`` (H,3)
    (``sample_sim3_sets``): p1/p2 (N,3) float32 points in camera 1 / 2,
    uv1/uv2 (N,2) their pixels, valid (N,).  Returns the winner (p2 = s R
    p1 + t), its inlier mask and count, and success.

    Replaces ``extractorb_tpu/geometry/sim3.py:solve_sim3_ransac``.  On
    CUDA tensors this launches K12's RANSAC entry (hypotheses, scores,
    selection; no host synchronisation); on the CPU it runs
    ``solve_sim3_ransac_plain``."""
    if not p1.is_cuda:
        return solve_sim3_ransac_plain(sets, p1, p2, uv1, uv2, valid, cam, fix_scale, th2)
    N, H = p1.shape[0], sets.shape[0]
    if H == 0 or sets.shape[1:] != (3,) or p2.shape != (N, 3) or uv1.shape != (N, 2) \
            or uv2.shape != (N, 2) or valid.shape != (N,):
        raise ValueError(f"sim3_ransac: sets {tuple(sets.shape)}, p1 {tuple(p1.shape)}, "
                         f"p2 {tuple(p2.shape)}, uv {tuple(uv1.shape)}/{tuple(uv2.shape)}, "
                         f"valid {tuple(valid.shape)}")
    dev = p1.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    args = [f32(p1), f32(p2), f32(uv1), f32(uv2), valid.to(torch.bool).contiguous(),
            sets.to(torch.int32).contiguous()]
    kernels.require_cuda("sim3_ransac", *args)
    hyp = torch.empty(H, 13, dtype=torch.float32, device=dev)    # R, t, s per hypothesis
    counts = torch.empty(H, dtype=torch.int32, device=dev)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    err = kernels.lib().sim3_ransac_launch(
        *[a.data_ptr() for a in args], N, H, int(fix_scale), float(th2), cam.fx, cam.fy,
        cam.cx, cam.cy, hyp.data_ptr(), counts.data_ptr(), out.data_ptr(), inl.data_ptr(),
        n_inl.data_ptr(), ok.data_ptr(), kernels.stream())
    kernels.check(err, "sim3_ransac")
    kernels.LAUNCHES["sim3_ransac"] += 1
    return Sim3Result(ok, out[:9].reshape(3, 3), out[9:12], out[12], inl, n_inl)


# ------------------------------------------------------- OptimizeSim3


def _sim3_residuals(x, R, t, ls, p1, p2, obs1, obs2, cam: Pinhole, fix_scale: bool):
    """The 4N residual vector at the left-multiplied update x = (phi, tau,
    dls): r12 = obs1 - pi(S p2), r21 = obs2 - pi(S^-1 p1)."""
    # batched so3_exp: under jacfwd a 0-dim torch.where promotes the
    # tangent to float64
    Rn = lie.so3_exp(x[None, :3])[0] @ R
    tn = t + x[3:6]
    sn = torch.exp(ls + (torch.zeros_like(x[6]) if fix_scale else x[6]))
    r12 = obs1 - cam.project(sn * (p2 @ Rn.T) + tn)
    Ri, ti, si = lie.sim3_inverse(Rn, tn, sn)
    r21 = obs2 - cam.project(si * (p1 @ Ri.T) + ti)
    return torch.cat([r12.reshape(-1), r21.reshape(-1)])


def _chi2(R, t, ls, p1, p2, obs1, obs2, cam: Pinhole):
    r = _sim3_residuals(torch.zeros(7, dtype=R.dtype, device=R.device), R, t, ls, p1, p2,
                        obs1, obs2, cam, False).reshape(2, -1, 2)
    return torch.sum(r[0] * r[0], -1), torch.sum(r[1] * r[1], -1)


def optimize_sim3_plain(R12, t12, s12, p1, p2, obs1, obs2, valid, cam: Pinhole,
                        fix_scale: bool = False, th2: float = 10.0) -> Sim3OptResult:
    """Plain version of ``optimize_sim3`` (same arguments)."""
    dev = p1.device
    R = R12.to(torch.float32)
    t = t12.to(torch.float32)
    ls = torch.log(torch.clamp(torch.as_tensor(s12, dtype=torch.float32, device=dev), min=1e-12))
    delta = torch.sqrt(torch.tensor(th2, dtype=torch.float32))
    x0 = torch.zeros(7, dtype=torch.float32, device=dev)
    I7 = torch.eye(7, dtype=torch.float32, device=dev)

    def step(R, t, ls, active):
        f = lambda x: _sim3_residuals(x, R, t, ls, p1, p2, obs1, obs2, cam, fix_scale)
        r = f(x0)
        J = torch.func.jacfwd(f)(x0)                     # (4N, 7)
        c12, c21 = _chi2(R, t, ls, p1, p2, obs1, obs2, cam)
        e12 = torch.sqrt(torch.clamp(c12, min=1e-12))
        e21 = torch.sqrt(torch.clamp(c21, min=1e-12))
        w12 = torch.where(e12 <= delta, 1.0, delta / e12) * active
        w21 = torch.where(e21 <= delta, 1.0, delta / e21) * active
        w = torch.cat([w12.repeat_interleave(2), w21.repeat_interleave(2)])
        H = J.T @ (J * w[:, None]) + I7 * 1e-6
        b = J.T @ (r * w)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = b.clone()
            b[6] = 0.0
        dx = -torch.linalg.solve(H, b)
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        return (lie.so3_exp(dx[:3]) @ R, t + dx[3:6], ls + (0.0 if fix_scale else dx[6]))

    active0 = valid.to(torch.float32)
    for _ in range(5):
        R, t, ls = step(R, t, ls, active0)
    c12, c21 = _chi2(R, t, ls, p1, p2, obs1, obs2, cam)
    inl = valid & (c12 <= th2) & (c21 <= th2)
    enough = bool(inl.sum() >= 10)
    if enough:
        active1 = inl.to(torch.float32)
        for _ in range(10):
            R, t, ls = step(R, t, ls, active1)
    c12, c21 = _chi2(R, t, ls, p1, p2, obs1, obs2, cam)
    inl_f = valid & (c12 <= th2) & (c21 <= th2) & enough
    return Sim3OptResult(R, t, torch.exp(ls), inl_f, inl_f.sum().to(torch.int32))


def optimize_sim3(R12, t12, s12, p1, p2, obs1, obs2, valid, cam: Pinhole,
                  fix_scale: bool = False, th2: float = 10.0) -> Sim3OptResult:
    """LM refinement of a relative Sim3 (x1 = s R x2 + t) on bidirectional
    projection edges: p1/p2 (N,3) points in camera 1 / 2, obs1/obs2 (N,2)
    their pixels, valid (N,).

    Replaces ``extractorb_tpu/geometry/sim3.py:optimize_sim3``.  On CUDA
    tensors this launches K12's LM entry (one CTA runs all 15 steps: the
    forward-mode Jacobian of each edge in dual numbers, the 7x7 normal
    equations reduced in the block, the solve by one thread); on the CPU
    it runs ``optimize_sim3_plain``."""
    if not p1.is_cuda:
        return optimize_sim3_plain(R12, t12, s12, p1, p2, obs1, obs2, valid, cam, fix_scale,
                                   th2)
    N = p1.shape[0]
    dev = p1.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    state = torch.cat([f32(R12).reshape(-1), f32(t12).reshape(-1), f32(s12).reshape(1)])
    args = [f32(p1), f32(p2), f32(obs1), f32(obs2), valid.to(torch.bool).contiguous()]
    if any(a.shape[0] != N for a in args):
        raise ValueError("optimize_sim3: p1, p2, obs1, obs2 and valid need one length")
    kernels.require_cuda("sim3_optimize", state, *args)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int32, device=dev)
    err = kernels.lib().sim3_optimize_launch(
        state.data_ptr(), *[a.data_ptr() for a in args], N, int(fix_scale), float(th2),
        cam.fx, cam.fy, cam.cx, cam.cy, out.data_ptr(), inl.data_ptr(), n_in.data_ptr(),
        kernels.stream())
    kernels.check(err, "sim3_optimize")
    kernels.LAUNCHES["sim3_optimize"] += 1
    return Sim3OptResult(out[:9].reshape(3, 3), out[9:12], out[12], inl, n_in)
