"""Batched RANSAC PnP for relocalization (port of
``extractorb_tpu/solver/pnp.py``: ``ransac_pnp`` and ``refine_pnp`` for the
pinhole camera, ``mlpnp_ransac`` and ``mlpnp_refine`` on unit bearings for
the KB8 camera).

The reference draws minimal sets and iterates a PnP solver until enough
inliers (src/Tracking.cc:3184 region, inc/PnPsolver.h:60-92).  Here all
hypotheses are drawn up front, each solved by EPnP (or the 6-point DLT)
on its own, and scored over every correspondence; the first hypothesis
with the most inliers wins (``jnp.argmax``'s tie rule).

The JAX function draws its sets with ``jax.random.categorical`` inside
the program.  Here the draw is split off, as ``two_view.sample_sets``
is: ``sample_pnp_sets(seed, valid)`` draws on a CPU ``torch.Generator``
and ``ransac_pnp(p3d, xy, valid, sets, ...)`` takes the sets, so the card
and the CPU see the same hypotheses (and a test can hand both packages
JAX's draw).

Numerics: the minimal solves run in float64 and round R, t to float32;
the JAX function solves in float32.  The two null vectors (EPnP's and the
DLT's) are the smallest eigenvectors of the 12x12 normal matrix M^T M,
3x3 SVDs come from the eigenvectors of A^T A (``two_view._svd3``), and
the covariance's principal axes get a canonical sign (largest component
positive), so the plain version and kernel K10 (``csrc/pnp_ransac.cu``)
compute the same quantities.  The DLT's branch choice depends on its null
vector's sign, which the JAX function leaves to the SVD; here the vector's
largest entry is made positive (ROADMAP C).  A degenerate sample (repeated or collinear
points) may solve to NaN; NaN scores no inlier, so it never wins over a
finite hypothesis.  Scoring runs in float32 in the JAX function's order.

``ransac_pnp`` launches K10 on CUDA tensors and runs ``ransac_pnp_plain``
on the CPU.

MLPnP (reference inc/MLPnPsolver.h) works on unit bearings, so rays past
90 degrees off the axis, which a fisheye camera sees, are measurements
like any other.  ``mlpnp_ransac`` takes its sets from ``sample_pnp_sets``
as K10 does (the JAX function draws them as ``ransac_pnp`` does); each
hypothesis stacks the nullspace constraints of its 6 bearings into a
(12,12) system, whose null vector (the smallest eigenvector of its normal
matrix, float64) gives [R | t] up to scale and sign: the sign comes from
the bearings' cheirality on the raw estimate, then Procrustes (``_svd3``)
and the mean singular value fix R and the scale.  Hypotheses are scored in
float32 by the bearing angle (0.6 degrees).  ``mlpnp_refine`` runs the 8
covariance-weighted Gauss-Newton steps on the tangent residuals in
float64 with closed-form Jacobians (JAX: float32, ``jax.jacfwd``) and
rounds the orthonormalized result.  Both launch kernel K25
(``csrc/mlpnp.cu``) on CUDA tensors and run their plain versions on the
CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import lie
from ..core.camera import Pinhole
from ..geometry.two_view import _det3, _svd3
from . import pose_opt as spo

MIN_SAMPLE = 6          # DLT minimal set (12 unknowns / 2 equations per point)
N_HYPOTHESES = 256
SOLVERS = ("epnp", "dlt")


class PnPResult(NamedTuple):
    R: torch.Tensor          # (3,3)
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def sample_pnp_sets(seed: int, valid, n_hyp: int = N_HYPOTHESES) -> torch.Tensor:
    """(n_hyp, 6) int64 minimal sets drawn with replacement, uniformly over
    the valid entries (uniformly over all when none is valid, as a
    categorical over equal logits), on a CPU generator seeded with
    ``seed``, moved to ``valid``'s device."""
    valid = torch.as_tensor(valid)
    v = valid.detach().cpu().bool().reshape(-1)
    pool = torch.nonzero(v).flatten()
    if pool.numel() == 0:
        pool = torch.arange(v.numel())
    if pool.numel() == 0:
        return torch.zeros((n_hyp, MIN_SAMPLE), dtype=torch.int64, device=valid.device)
    g = torch.Generator().manual_seed(int(seed))
    r = torch.randint(0, pool.numel(), (n_hyp, MIN_SAMPLE), generator=g)
    return pool[r].to(valid.device)


# ------------------------------------------------------- minimal solvers


def _canonical_columns(V):
    """Flip each column of (...,3,3) so its largest-magnitude entry (the
    first on a tie) is positive."""
    k = torch.argmax(V.abs(), dim=-2, keepdim=True)
    sign = torch.where(torch.gather(V, -2, k) < 0, -1.0, 1.0)
    return V * sign


def _null_vector12(A):
    """Smallest eigenvector of A^T A for (...,r,12) float64."""
    return torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., 0]


def _epnp_pose(p3s, xys):
    """EPnP for (H,6,3)/(H,6,2) float64 samples -> R (H,3,3), t (H,3):
    control points at the centroid and along the principal axes (scaled
    by sqrt(max(eigenvalue, 1e-8))), barycentric alphas from a 4x4 solve,
    the 12x12 system's null vector as the camera-frame control points,
    beta from the control-point distances, the cheirality flip on the
    mean depth, then Horn's rigid alignment."""
    H, S = p3s.shape[0], p3s.shape[1]
    c0 = p3s.mean(1)
    X = p3s - c0[:, None]
    cov = X.transpose(-1, -2) @ X / S
    w, V = torch.linalg.eigh(cov)                       # ascending
    V = _canonical_columns(V)
    s_ax = torch.sqrt(torch.clamp(w, min=1e-8))
    C_w = torch.cat([c0[:, None], c0[:, None] + (V * s_ax[:, None, :]).transpose(-1, -2)], 1)
    ones = lambda n: torch.ones(H, 1, n, dtype=p3s.dtype, device=p3s.device)
    A4 = torch.cat([C_w.transpose(-1, -2), ones(4)], 1)   # (H,4,4)
    rhs = torch.cat([p3s.transpose(-1, -2), ones(S)], 1)
    alpha = torch.linalg.solve(A4, rhs).transpose(-1, -2)   # (H,S,4)
    u, v = xys[..., 0:1], xys[..., 1:2]
    z, o = torch.zeros_like(u), torch.ones_like(u)
    rows_u = alpha[..., :, None] * torch.cat([o, z, -u], -1)[..., None, :]
    rows_v = alpha[..., :, None] * torch.cat([z, o, -v], -1)[..., None, :]
    M = torch.cat([rows_u.reshape(H, S, 12), rows_v.reshape(H, S, 12)], 1)
    Cc = _null_vector12(M).reshape(H, 4, 3)
    ii, jj = torch.triu_indices(4, 4, 1)
    d_c = torch.linalg.norm(Cc[:, ii] - Cc[:, jj], dim=-1)
    d_w = torch.linalg.norm(C_w[:, ii] - C_w[:, jj], dim=-1)
    beta = (d_w * d_c).sum(-1) / torch.clamp((d_c * d_c).sum(-1), min=1e-12)
    pc = alpha @ (Cc * beta[:, None, None])
    pc = torch.where(pc[..., 2].mean(-1)[:, None, None] < 0, -pc, pc)
    # Horn: p_c = R p_w + t, fixed scale
    mu_w, mu_c = p3s.mean(1), pc.mean(1)
    Hm = (p3s - mu_w[:, None]).transpose(-1, -2) @ (pc - mu_c[:, None])
    U, _, Vs = _svd3(Hm)
    d = _det3(Vs @ U.transpose(-1, -2))
    D = torch.ones(H, 3, dtype=p3s.dtype, device=p3s.device)
    D[:, 2] = d
    R = (Vs * D[:, None, :]) @ U.transpose(-1, -2)
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


def _orth(M):
    """Nearest rotation to (H,3,3) M (Procrustes) and the positive scale."""
    U, s, V = _svd3(M)
    d = _det3(U @ V.transpose(-1, -2))
    D = torch.ones_like(s)
    D[:, 2] = d
    R = (U * D[:, None, :]) @ V.transpose(-1, -2)
    return R, torch.clamp(s.mean(-1), min=1e-12)


def _dlt_pose(p3s, xys):
    """6-point DLT for (H,6,3)/(H,6,2) float64 samples: P = [R|t] as the
    12x12 system's null vector, both signs orthogonalised by Procrustes,
    the first (P's own sign) kept when it puts the sample centroid in
    front of the camera, else the second."""
    H, S = p3s.shape[0], p3s.shape[1]
    X = torch.cat([p3s, torch.ones(H, S, 1, dtype=p3s.dtype, device=p3s.device)], -1)
    z = torch.zeros_like(X)
    r1 = torch.cat([X, z, -xys[..., :1] * X], -1)
    r2 = torch.cat([z, X, -xys[..., 1:2] * X], -1)
    p = _null_vector12(torch.cat([r1, r2], 1))
    # the null vector's sign is arbitrary and the branch choice below
    # depends on it (as in the JAX function): fix it, largest entry positive
    k = torch.argmax(p.abs(), dim=-1, keepdim=True)
    P = torch.where(torch.gather(p, -1, k) < 0, -p, p).reshape(H, 3, 4)
    Ra, sa = _orth(P[..., :3])
    Rb, sb = _orth(-P[..., :3])
    ta = P[..., 3] / sa[:, None]
    tb = -P[..., 3] / sb[:, None]
    c = p3s.mean(1)
    za = (Ra[:, 2] * c).sum(-1) + ta[:, 2]
    use_a = za > 0
    return (torch.where(use_a[:, None, None], Ra, Rb), torch.where(use_a[:, None], ta, tb))


def minimal_poses(p3d, xy, sets, solver: str = "epnp"):
    """Each hypothesis' pose from its minimal set: (H,3,3), (H,3) float32.
    A set holding an index outside [0, N) or a non-finite entry solves to
    NaN."""
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r}: expected one of {SOLVERS}")
    N = p3d.shape[0]
    idx = sets.long()
    out = (idx < 0) | (idx >= N)
    idx = torch.where(out, N, idx)
    pad = lambda a, w: torch.cat([a.double(), a.new_zeros((1, w), dtype=torch.float64)], 0)
    p3s, xys = pad(p3d, 3)[idx], pad(xy, 2)[idx]
    bad = out.any(-1) | ~torch.isfinite(p3s).all(-1).all(-1) | ~torch.isfinite(xys).all(-1).all(-1)
    p3s = torch.where(bad[:, None, None], 0.0, p3s)
    xys = torch.where(bad[:, None, None], 0.0, xys)
    R, t = (_epnp_pose if solver == "epnp" else _dlt_pose)(p3s, xys)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=p3d.device)
    R = torch.where(bad[:, None, None], nan, R)
    t = torch.where(bad[:, None], nan, t)
    return R.float(), t.float()


def _score(R, t, p3d, xy, valid, th2):
    """Inlier masks (H,N) of poses (H,3,3)/(H,3) in float32: positive
    depth, reprojection error^2 < th2, valid.  Row sums in a fixed order
    (K10's)."""
    pc = [R[:, None, i, 0] * p3d[:, 0] + R[:, None, i, 1] * p3d[:, 1]
          + R[:, None, i, 2] * p3d[:, 2] + t[:, None, i] for i in range(3)]
    zok = pc[2] > 1e-6
    z = torch.where(zok, pc[2], 1.0)
    dx = pc[0] / z - xy[:, 0]
    dy = pc[1] / z - xy[:, 1]
    err2 = dx * dx + dy * dy
    return valid & zok & (err2 < th2)


# ------------------------------------------------------- plain version


def ransac_pnp_plain(p3d, xy, valid, sets, th: float = 0.01, min_inliers: int = 15,
                     solver: str = "epnp") -> PnPResult:
    """Plain version of ``ransac_pnp`` (same arguments)."""
    p3d = p3d.to(torch.float32)
    xy = xy.to(torch.float32)
    valid = valid.to(torch.bool)
    Rs, ts = minimal_poses(p3d, xy, sets, solver)
    th32 = torch.tensor(th, dtype=torch.float32, device=p3d.device)
    inl = _score(Rs, ts, p3d, xy, valid, th32 * th32)
    counts = inl.sum(-1).to(torch.int32)
    best = torch.argmax(counts)                      # first maximum wins
    n_inl = counts[best]
    ok = (n_inl >= min_inliers) & (valid.sum() >= MIN_SAMPLE)
    return PnPResult(Rs[best], ts[best], inl[best], n_inl, ok)


# ------------------------------------------------------------ kernel K10


def ransac_pnp(p3d, xy, valid, sets, th: float = 0.01, min_inliers: int = 15,
               solver: str = "epnp") -> PnPResult:
    """RANSAC PnP over the minimal sets ``sets`` (H,6) (``sample_pnp_sets``).

    Replaces ``extractorb_tpu/solver/pnp.py:ransac_pnp``.  p3d (N,3) world
    points, xy (N,2) normalized image coordinates, valid (N,) bool; th is
    the inlier threshold in normalized units (pixels / focal length).
    ``ok`` needs ``min_inliers`` inliers and 6 valid entries.  On CUDA
    tensors this launches K10 (hypotheses, scores, selection; no host
    synchronisation); on the CPU it runs ``ransac_pnp_plain``."""
    if not p3d.is_cuda:
        return ransac_pnp_plain(p3d, xy, valid, sets, th, min_inliers, solver)
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r}: expected one of {SOLVERS}")
    N, H = p3d.shape[0], sets.shape[0]
    if H == 0 or sets.shape[1:] != (MIN_SAMPLE,):
        raise ValueError(f"pnp_ransac: sets {tuple(sets.shape)}, expected (H>0, {MIN_SAMPLE})")
    if p3d.shape != (N, 3) or xy.shape != (N, 2) or valid.shape != (N,):
        raise ValueError(f"pnp_ransac: p3d {tuple(p3d.shape)}, xy {tuple(xy.shape)}, "
                         f"valid {tuple(valid.shape)}")
    dev = p3d.device
    args = [p3d.to(torch.float32).contiguous(), xy.to(torch.float32).contiguous(),
            valid.to(torch.bool).contiguous(), sets.to(torch.int32).contiguous()]
    kernels.require_cuda("pnp_ransac", *args)
    # workspace: each hypothesis' pose and inlier count
    Rs = torch.empty(H, 3, 3, dtype=torch.float32, device=dev)
    ts = torch.empty(H, 3, dtype=torch.float32, device=dev)
    counts = torch.empty(H, dtype=torch.int32, device=dev)
    R = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    err = kernels.lib().pnp_ransac_launch(
        *[a.data_ptr() for a in args], N, H, SOLVERS.index(solver), float(th), int(min_inliers),
        Rs.data_ptr(), ts.data_ptr(), counts.data_ptr(), R.data_ptr(), t.data_ptr(),
        inl.data_ptr(), n_inl.data_ptr(), ok.data_ptr(), kernels.stream())
    kernels.check(err, "pnp_ransac")
    kernels.LAUNCHES["pnp_ransac"] += 1
    return PnPResult(R, t, inl, n_inl, ok)


# ---------------------------------------------------------------- MLPnP


MLPNP_ANGLE_DEG = 0.6
MLPNP_REFINE_ITERS = 8


def mlpnp_cos_threshold(ang_th_deg: float = MLPNP_ANGLE_DEG) -> float:
    """cos of the inlier cone in float32, as the JAX function computes it."""
    return float(np.cos(np.deg2rad(np.float32(ang_th_deg))))


def _null_basis(bear):
    """Per-bearing tangent basis (r, s) of (...,3) bearings: r, s unit and
    orthogonal to the bearing, from the cross product with the axis least
    aligned with it (reference MLPnPsolver's nullspace), in bear's type."""
    v = bear / torch.sqrt((bear * bear).sum(-1, keepdim=True))
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    ref = torch.where(torch.abs(v[..., 2:3]) < 0.9, ez, ex)
    r = torch.linalg.cross(v, ref.expand_as(v), dim=-1)
    r = r / torch.clamp(torch.sqrt((r * r).sum(-1, keepdim=True)), min=1e-12)
    return r, torch.linalg.cross(v, r, dim=-1)


def _mlpnp_pose(p3s, bs):
    """MLPnP's closed form for (H,S,3) float64 points and bearings -> R
    (H,3,3), t (H,3): the (2S,12) nullspace system r^T (R p + t) = 0,
    s^T (R p + t) = 0 in [vec(R) row-major, t], its null vector, the sign
    that makes the raw points agree with their bearings, Procrustes."""
    r, s_ = _null_basis(bs)

    def rows(n):
        return torch.cat([n[..., 0:1] * p3s, n[..., 1:2] * p3s, n[..., 2:3] * p3s, n], -1)

    A = torch.cat([rows(r), rows(s_)], -2)                      # (H,2S,12)
    v = _null_vector12(A)
    H = p3s.shape[0]
    M, t_raw = v[:, :9].reshape(H, 3, 3), v[:, 9:]
    pc_raw = p3s @ M.transpose(-1, -2) + t_raw[:, None]
    flip = (pc_raw * bs).sum((-1, -2)) < 0
    M = torch.where(flip[:, None, None], -M, M)
    t_raw = torch.where(flip[:, None], -t_raw, t_raw)
    R, scale = _orth(M)
    return R, t_raw / scale[:, None]


def mlpnp_poses(p3d, bear, sets):
    """Each hypothesis' pose from its 6-point set: (H,3,3), (H,3) float32.
    A set holding an index outside [0, N) or a non-finite entry solves to
    NaN."""
    N = p3d.shape[0]
    idx = sets.long()
    out = (idx < 0) | (idx >= N)
    idx = torch.where(out, N, idx)
    pad = lambda a: torch.cat([a.double(), a.new_zeros((1, 3), dtype=torch.float64)], 0)
    p3s, bs = pad(p3d)[idx], pad(bear)[idx]
    bad = out.any(-1) | ~torch.isfinite(p3s).all(-1).all(-1) | ~torch.isfinite(bs).all(-1).all(-1)
    # a placeholder sample for the bad sets (their result is replaced)
    p3s = torch.where(bad[:, None, None], torch.eye(3, dtype=torch.float64,
                                                    device=p3d.device).repeat(1, 2)
                      .reshape(6, 3) + 1.0, p3s)
    bs = torch.where(bad[:, None, None], p3s, bs)
    R, t = _mlpnp_pose(p3s, bs)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=p3d.device)
    R = torch.where(bad[:, None, None], nan, R)
    t = torch.where(bad[:, None], nan, t)
    return R.float(), t.float()


def _score_bearing(R, t, p3d, bear, valid, cos_th: float):
    """Inlier masks (H,N) in float32: the angle between R p + t and the
    bearing inside the cone (cos > cos_th), valid.  K25's order."""
    pc = [R[:, None, i, 0] * p3d[:, 0] + R[:, None, i, 1] * p3d[:, 1]
          + R[:, None, i, 2] * p3d[:, 2] + t[:, None, i] for i in range(3)]
    n = torch.clamp(torch.sqrt(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]), min=1e-12)
    cosang = (pc[0] * bear[:, 0] + pc[1] * bear[:, 1] + pc[2] * bear[:, 2]) / n
    return valid & (cosang > cos_th)


def mlpnp_ransac_plain(p3d, bear, valid, sets, ang_th_deg: float = MLPNP_ANGLE_DEG,
                       min_inliers: int = 12, counts_out=None) -> PnPResult:
    """Plain version of ``mlpnp_ransac`` (same arguments)."""
    p3d, bear, valid = p3d.to(torch.float32), bear.to(torch.float32), valid.to(torch.bool)
    Rs, ts = mlpnp_poses(p3d, bear, sets)
    inl = _score_bearing(Rs, ts, p3d, bear, valid, mlpnp_cos_threshold(ang_th_deg))
    counts = inl.sum(-1).to(torch.int32)
    if counts_out is not None:
        counts_out.copy_(counts)
    best = torch.argmax(counts)                      # first maximum wins
    n_inl = counts[best]
    return PnPResult(Rs[best], ts[best], inl[best], n_inl, n_inl >= min_inliers)


def mlpnp_ransac(p3d, bear, valid, sets, ang_th_deg: float = MLPNP_ANGLE_DEG,
                 min_inliers: int = 12, counts_out=None) -> PnPResult:
    """RANSAC MLPnP over the 6-point sets ``sets`` (H,6)
    (``sample_pnp_sets``).

    Replaces ``extractorb_tpu/solver/pnp.py:mlpnp_ransac``.  p3d (N,3)
    world points, bear (N,3) unit bearings, valid (N,) bool; an inlier's
    bearing lies within ``ang_th_deg`` of R p + t.  ``ok`` needs
    ``min_inliers`` inliers; ``counts_out`` (H,) int32, where given,
    receives every hypothesis' inlier count.  On CUDA tensors this launches
    K25 (hypotheses, scores, selection; no host synchronisation); on the
    CPU it runs ``mlpnp_ransac_plain``."""
    if not p3d.is_cuda:
        return mlpnp_ransac_plain(p3d, bear, valid, sets, ang_th_deg, min_inliers, counts_out)
    N, H = p3d.shape[0], sets.shape[0]
    if H == 0 or sets.shape[1:] != (MIN_SAMPLE,):
        raise ValueError(f"mlpnp_ransac: sets {tuple(sets.shape)}, expected (H>0, {MIN_SAMPLE})")
    if p3d.shape != (N, 3) or bear.shape != (N, 3) or valid.shape != (N,):
        raise ValueError(f"mlpnp_ransac: p3d {tuple(p3d.shape)}, bear {tuple(bear.shape)}, "
                         f"valid {tuple(valid.shape)}")
    dev = p3d.device
    args = [p3d.to(torch.float32).contiguous(), bear.to(torch.float32).contiguous(),
            valid.to(torch.bool).contiguous(), sets.to(torch.int32).contiguous()]
    kernels.require_cuda("mlpnp_ransac", *args)
    Rs = torch.empty(H, 3, 3, dtype=torch.float32, device=dev)
    ts = torch.empty(H, 3, dtype=torch.float32, device=dev)
    counts = counts_out if counts_out is not None else torch.empty(H, dtype=torch.int32,
                                                                   device=dev)
    if counts.dtype != torch.int32 or counts.shape != (H,):
        raise ValueError(f"mlpnp_ransac: counts_out {counts.dtype} {tuple(counts.shape)}, "
                         f"expected int32 ({H},)")
    kernels.require_cuda("mlpnp_ransac", counts)
    R = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    err = kernels.lib().mlpnp_ransac_launch(
        *[a.data_ptr() for a in args], N, H, mlpnp_cos_threshold(ang_th_deg), int(min_inliers),
        Rs.data_ptr(), ts.data_ptr(), counts.data_ptr(), R.data_ptr(), t.data_ptr(),
        inl.data_ptr(), n_inl.data_ptr(), ok.data_ptr(), kernels.stream())
    kernels.check(err, "mlpnp_ransac")
    kernels.LAUNCHES["mlpnp_ransac"] += 1
    return PnPResult(R, t, inl, n_inl, ok)


def mlpnp_refine_plain(R0, t0, p3d, bear, info, valid,
                       n_iters: int = MLPNP_REFINE_ITERS):
    """Plain version of ``mlpnp_refine`` (same arguments), in float64."""
    f64 = lambda a: a.to(torch.float64)
    p, b = f64(p3d), f64(bear)
    r_b, s_b = _null_basis(b)
    Bm = torch.stack([r_b, s_b], -2)                             # (N,2,3)
    w = f64(info) * valid.to(torch.float64)
    R, t = f64(R0), f64(t0)
    eye3 = torch.eye(3, dtype=torch.float64, device=p.device)
    for _ in range(n_iters):
        pc = p @ R.T + t
        n = torch.clamp(torch.sqrt((pc * pc).sum(-1)), min=1e-12)
        u = pc / n[:, None]
        res = (Bm @ u[..., None])[..., 0]                        # (N,2)
        P = (eye3 - u[:, :, None] * u[:, None, :]) / n[:, None, None]
        A = Bm @ P @ R                                           # d res / d rho
        J = torch.cat([A, -torch.linalg.cross(A, p[:, None].expand_as(A), dim=-1)], -1)
        Jw = J * w[:, None, None]
        H = torch.einsum("nio,nij->oj", Jw, J)
        g = torch.einsum("nio,ni->o", Jw, res)
        d = -torch.linalg.solve(H + 1e-8 * torch.eye(6, dtype=torch.float64, device=p.device), g)
        dR, dt = lie.se3_exp(d)
        R, t = R @ dR, R @ dt + t
    return lie.orthonormalize(R).float(), t.float()


def mlpnp_refine(R0, t0, p3d, bear, info, valid, n_iters: int = MLPNP_REFINE_ITERS):
    """MLPnP's maximum-likelihood refinement: Gauss-Newton on the tangent
    residuals [r^T u; s^T u], u = (R p + t) / |R p + t|, weighted by
    ``info`` (the inverse tangent variance per observation) over ``valid``,
    then the rotation re-orthonormalized.  Returns (R (3,3), t (3,))
    float32.

    Replaces ``extractorb_tpu/solver/pnp.py:mlpnp_refine``.  On CUDA
    tensors this launches K25's refinement (one CTA, fixed-order float64
    sums); on the CPU it runs ``mlpnp_refine_plain``."""
    if not p3d.is_cuda:
        return mlpnp_refine_plain(R0, t0, p3d, bear, info, valid, n_iters)
    N = p3d.shape[0]
    dev = p3d.device
    f32 = lambda a: a.to(torch.float32).contiguous()
    args = [f32(R0), f32(t0), f32(p3d), f32(bear), f32(info), valid.to(torch.bool).contiguous()]
    if args[0].shape != (3, 3) or args[1].shape != (3,) or args[2].shape != (N, 3) \
            or args[3].shape != (N, 3) or args[4].shape != (N,) or args[5].shape != (N,):
        raise ValueError("mlpnp_refine: expected R0 (3,3), t0 (3,), p3d/bear (N,3), "
                         "info/valid (N,)")
    kernels.require_cuda("mlpnp_refine", *args)
    R = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    err = kernels.lib().mlpnp_refine_launch(*[a.data_ptr() for a in args], N, int(n_iters),
                                            R.data_ptr(), t.data_ptr(), kernels.stream())
    kernels.check(err, "mlpnp_refine")
    kernels.LAUNCHES["mlpnp_refine"] += 1
    return R, t


def refine_pnp(result: PnPResult, p3d, xy, cam: Pinhole, inv_sigma2=None) -> spo.PoseOptResult:
    """LM refinement of the RANSAC winner on its inliers through the shared
    robust pose optimiser (K4 on the card).  ``cam`` projects into the
    coordinates of ``xy`` (``Pinhole(1, 1, 0, 0)`` for normalized ones).
    Returns one problem's (R, t, inliers, n_inliers)."""
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(p3d.shape[0], dtype=torch.float32, device=p3d.device)
    res = spo.optimize_pose(result.R[None], result.t[None], p3d[None].to(torch.float32),
                            xy[None].to(torch.float32), inv_sigma2[None], result.inliers[None],
                            cam)
    return spo.PoseOptResult(res.R[0], res.t[0], res.inliers[0], res.n_inliers[0])
