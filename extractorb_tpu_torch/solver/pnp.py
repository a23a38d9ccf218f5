"""Batched RANSAC PnP for relocalization (port of
``extractorb_tpu/solver/pnp.py``, the pinhole part: ``ransac_pnp`` and
``refine_pnp``; MLPnP for the KB8 camera is ROADMAP A.12).

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
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
