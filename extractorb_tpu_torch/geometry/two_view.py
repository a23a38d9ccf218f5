"""Two-view reconstruction: monocular map initialisation
(port of ``extractorb_tpu/geometry/two_view.py``).

RANSAC over homography H and fundamental F in parallel (200 8-point
hypotheses each), model selection by score ratio, an inlier refit of
both models, motion recovery (E decomposition / Faugeras H
decomposition) and DLT triangulation with cheirality and parallax checks
over the 8 motion hypotheses.

The JAX function draws its minimal sets with ``jax.random`` inside the
program.  Here the draw is split off: ``sample_sets(seed, valid)`` draws
on a CPU ``torch.Generator`` and ``reconstruct(sets, ...)`` takes the
sets, so the card and the CPU see the same hypotheses (and a test can
hand both packages the same sets).

Numerics: a model's null vector is the smallest eigenvector of the 9x9
normal matrix A^T A, accumulated and solved in float64 (the JAX function
takes an f32 SVD of A); models are then rounded to float32 and scored in
float32, as in the JAX function.  3x3 SVDs come from the eigenvectors of
A^T A (u = A v / s), so the plain version and kernel K5
(``csrc/two_view.cu``) compute the same quantities in the same order.
SVD signs are arbitrary; every decomposition's set of motion hypotheses
is invariant under them, so results agree as (R, t), not as (U, V).

``reconstruct`` launches K5 on CUDA tensors and runs
``reconstruct_plain`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

N_RANSAC = 200
CHI2_F = 3.841
CHI2_H = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
MAX_PAIRS = 4096          # K5 sorts the parallax cosines in shared memory


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    R21: torch.Tensor              # (3,3) rotation cam1 -> cam2
    t21: torch.Tensor              # (3,) unit-norm translation
    points3d: torch.Tensor         # (N,3) in cam1 frame
    is_triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # () bool


def sample_sets(seed: int, valid, n_sets: int = N_RANSAC) -> torch.Tensor:
    """(n_sets, 8) int64 minimal sets: 8 distinct indices per set, valid
    pairs first (a uniform key per pair, +10 for invalid ones, the 8
    smallest), drawn on a CPU generator seeded with ``seed`` and moved to
    ``valid``'s device."""
    valid = torch.as_tensor(valid)
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand(n_sets, valid.shape[0], generator=g, dtype=torch.float32)
    p = u + (~valid.cpu().bool()).to(torch.float32) * 10.0
    return torch.argsort(p, dim=1)[:, :8].to(valid.device)


# ------------------------------------------------------------- helpers


def _normalize(pts, valid):
    """Reference Normalize: mean + mean absolute deviation.  Returns the
    normalized points and T, T^-1 (float32)."""
    w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], 0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[:, None], 0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    norm = (pts - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]), torch.stack([z, z, o])])
    Tinv = torch.stack([torch.stack([1.0 / s[0], z, mean[0]]),
                        torch.stack([z, 1.0 / s[1], mean[1]]), torch.stack([z, z, o])])
    return norm, T, Tinv


def _rows_h(a, b):
    """The two DLT rows of each pair (..., n, 2) -> (..., 2n, 9), float64."""
    a, b = a.double(), b.double()
    u1, v1, u2, v2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    return torch.cat([r1, r2], -2)


def _rows_f(a, b):
    a, b = a.double(), b.double()
    u1, v1, u2, v2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def _null_vector(A, w=None):
    """Smallest eigenvector of A^T diag(w) A (float64): (..., 9)."""
    Aw = A if w is None else A * w.double()[..., None]
    AtA = Aw.transpose(-1, -2) @ A
    return torch.linalg.eigh(AtA)[1][..., 0]


def _rank2(Fpre):
    """Rank-2 projection Fpre (I - v v^T), v the smallest right singular
    vector (= drop the smallest singular value)."""
    v = torch.linalg.eigh(Fpre.transpose(-1, -2) @ Fpre)[1][..., :, 0]
    return Fpre - (Fpre @ v[..., :, None]) @ v[..., None, :]


def _inv3(M):
    """Adjugate inverse of (...,3,3), float64."""
    M = M.double()
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    c10 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
    c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
    c12 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
    c20 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c21 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
    c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
    adj = torch.stack([torch.stack([c00, c10, c20], -1), torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj / det[..., None, None]


def _h_model(Hn, T1, T2inv):
    return (T2inv.double() @ Hn.reshape(*Hn.shape[:-1], 3, 3) @ T1.double()).float()


def _f_model(Fn, T1, T2):
    Fr = _rank2(Fn.reshape(*Fn.shape[:-1], 3, 3))
    return (T2.double().transpose(-1, -2) @ Fr @ T1.double()).float()


def _score_h(H21, x1, x2, valid):
    """CheckHomography (TwoViewReconstruction.cc:308) for (..., 3, 3)
    models: (score (...,), inliers (..., N))."""
    H12 = _inv3(H21).float()

    def transfer(H, a, b):
        h = lambda i, j: H[..., i, j, None]
        w = h(2, 0) * a[:, 0] + h(2, 1) * a[:, 1] + h(2, 2)
        inv_w = 1.0 / w
        u = (h(0, 0) * a[:, 0] + h(0, 1) * a[:, 1] + h(0, 2)) * inv_w
        v = (h(1, 0) * a[:, 0] + h(1, 1) * a[:, 1] + h(1, 2)) * inv_w
        return (b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2

    chi1 = transfer(H12, x2, x1)
    chi2 = transfer(H21, x1, x2)
    in1, in2 = chi1 <= CHI2_H, chi2 <= CHI2_H
    per = torch.where(valid & in1, CHI2_H - chi1, 0.0) + torch.where(valid & in2, CHI2_H - chi2, 0.0)
    return per.double().sum(-1), valid & in1 & in2


def _score_f(F21, x1, x2, valid):
    """CheckFundamental (TwoViewReconstruction.cc:393)."""
    f = lambda i, j: F21[..., i, j, None]
    l2 = [f(i, 0) * x1[:, 0] + f(i, 1) * x1[:, 1] + f(i, 2) for i in range(3)]
    l1 = [x2[:, 0] * f(0, j) + x2[:, 1] * f(1, j) + f(2, j) for j in range(3)]
    num2 = l2[0] * x2[:, 0] + l2[1] * x2[:, 1] + l2[2]
    num1 = l1[0] * x1[:, 0] + l1[1] * x1[:, 1] + l1[2]
    chi1 = num2 * num2 / (l2[0] * l2[0] + l2[1] * l2[1] + 1e-12)
    chi2 = num1 * num1 / (l1[0] * l1[0] + l1[1] * l1[1] + 1e-12)
    in1, in2 = chi1 <= CHI2_F, chi2 <= CHI2_F
    per = torch.where(valid & in1, CHI2_H - chi1, 0.0) + torch.where(valid & in2, CHI2_H - chi2, 0.0)
    return per.double().sum(-1), valid & in1 & in2


def _solve3x3(M, b):
    """Closed-form batched 3x3 solve via the adjugate (Cramer);
    near-singular systems return huge values the callers' gates reject."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) * inv_det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) * inv_det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], -1)


def triangulate(P1, P2, x1, x2):
    """Batched DLT triangulation (reference Triangulate, :737), solved as
    the inhomogeneous (w = 1) system through its 3x3 normal equations and
    the adjugate, like the JAX function.  P1/P2 (...,3,4), x1/x2 (...,N,2)
    -> (...,N,3).  The sums run in a fixed order (rows 0..3), the order
    of kernels K5 and K7."""
    rows = [x1[..., 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :],
            x1[..., 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :],
            x2[..., 0:1] * P2[..., None, 2, :] - P2[..., None, 0, :],
            x2[..., 1:2] * P2[..., None, 2, :] - P2[..., None, 1, :]]

    def dot4(i, j):
        s = rows[0][..., i] * rows[0][..., j]
        for r in rows[1:]:
            s = s + r[..., i] * r[..., j]
        return s

    M = torch.stack([torch.stack([dot4(i, j) for j in range(3)], -1) for i in range(3)], -2)
    b = -torch.stack([dot4(i, 3) for i in range(3)], -1)
    return _solve3x3(M, b)


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _mat_rt(R, t, X):
    """R X + t for X (...,N,3), R (...,3,3), row sums in a fixed order."""
    return torch.stack([R[..., i, None, 0] * X[..., 0] + R[..., i, None, 1] * X[..., 1]
                        + R[..., i, None, 2] * X[..., 2] + t[..., i, None] for i in range(3)], -1)


def _check_rt(Rs, ts, x1, x2, valid, K):
    """CheckRT (reference :801) for (B,3,3)/(B,3) motions: triangulate
    and count good points.  Returns (n_good (B,), parallax_deg (B,),
    good (B,N), X (B,N,3)).  Positive depth is required unconditionally,
    like the JAX function."""
    B = Rs.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zcol = torch.zeros(3, 1, dtype=K.dtype, device=K.device)
    P1 = torch.cat([K, zcol], 1).expand(B, 3, 4)
    Rt = torch.cat([Rs, ts[..., None]], -1)
    P2 = torch.stack([K[i, 0] * Rt[:, 0] + K[i, 1] * Rt[:, 1] + K[i, 2] * Rt[:, 2]
                      for i in range(3)], 1)
    O2 = -torch.stack([Rs[:, 0, i] * ts[:, 0] + Rs[:, 1, i] * ts[:, 1] + Rs[:, 2, i] * ts[:, 2]
                       for i in range(3)], -1)
    X = triangulate(P1, P2, x1.expand(B, -1, -1), x2.expand(B, -1, -1))
    finite = torch.isfinite(X).all(-1)
    n2 = X - O2[:, None, :]
    d1, d2n = _norm3(X), _norm3(n2)
    cos_par = (X[..., 0] * n2[..., 0] + X[..., 1] * n2[..., 1] + X[..., 2] * n2[..., 2]) \
        / torch.clamp(d1 * d2n, min=1e-12)
    X2 = _mat_rt(Rs, ts, X)
    low_par = cos_par >= 0.99998
    depth_ok = (X[..., 2] > 0) & (X2[..., 2] > 0)
    u1 = fx * X[..., 0] / X[..., 2] + cx
    v1 = fy * X[..., 1] / X[..., 2] + cy
    e1 = (u1 - x1[:, 0]) ** 2 + (v1 - x1[:, 1]) ** 2
    u2 = fx * X2[..., 0] / X2[..., 2] + cx
    v2 = fy * X2[..., 1] / X2[..., 2] + cy
    e2 = (u2 - x2[:, 0]) ** 2 + (v2 - x2[:, 1]) ** 2
    counted = valid & finite & depth_ok & (e1 <= 4.0) & (e2 <= 4.0)
    good = counted & ~low_par
    # parallax: the min(50, n-1)-th smallest cosine over the counted points
    n_good = counted.sum(-1).to(torch.int32)
    k = torch.clamp(n_good - 1, min=0).clamp(max=50)
    cos_sorted = torch.sort(torch.where(counted, cos_par, 1.0), dim=-1).values
    cos_sel = torch.gather(cos_sorted, 1, k[:, None].long())[:, 0]
    parallax = torch.rad2deg(torch.acos(torch.clamp(cos_sel, -1.0, 1.0)))
    return n_good, parallax, good, X


def _svd3(A):
    """SVD of (...,3,3) float64 from the eigenvectors of A^T A: V's
    columns by descending singular value, u_i = A v_i / s_i, and u_2 =
    u_0 x u_1 (sign matched to A v_2) for a rank-deficient A."""
    evals, evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    V = evecs.flip(-1)
    s = torch.sqrt(torch.clamp(evals.flip(-1), min=0.0))
    AV = A @ V
    u0 = AV[..., 0] / s[..., 0, None]
    u1 = AV[..., 1] / s[..., 1, None]
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    u2 = torch.where((u2 * AV[..., 2]).sum(-1, keepdim=True) < 0, -u2, u2)
    return torch.stack([u0, u1, u2], -1), s, V


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _unit(t):
    return t / torch.clamp(torch.sqrt((t * t).sum(-1, keepdim=True)), min=1e-12)


def _decompose_e(E):
    """DecomposeE (reference :912): the 4 motions [R1,R1,R2,R2] x
    [t,-t,t,-t] (float64)."""
    U, _, V = _svd3(E)
    t = _unit(U[..., 2])
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ V.transpose(-1, -2)
    R1 = torch.where(_det3(R1) < 0, -R1, R1)
    R2 = U @ W.T @ V.transpose(-1, -2)
    R2 = torch.where(_det3(R2) < 0, -R2, R2)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H21, K):
    """Faugeras SVD-based homography decomposition (ReconstructH, :576):
    8 motion hypotheses (float64)."""
    K = K.double()
    A = _inv3(K) @ H21.double() @ K
    U, w, V = _svd3(A)
    Vt = V.T
    s = _det3(U) * _det3(V)
    d1, d2, d3 = w[0], w[1], w[2]
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    sg1 = (1.0, 1.0, -1.0, -1.0)
    sg3 = (1.0, -1.0, 1.0, -1.0)
    sgs = (1.0, -1.0, -1.0, 1.0)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    st = root / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sp = root / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for i in range(4):
        Rp = torch.stack([torch.stack([ct, zero, -sgs[i] * st]), torch.stack([zero, one, zero]),
                          torch.stack([sgs[i] * st, zero, ct])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(_unit(U @ torch.stack([sg1[i] * aux1, zero, -sg3[i] * aux3]) * (d1 - d3)))
    for i in range(4):
        Rp = torch.stack([torch.stack([cp, zero, sgs[i] * sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sgs[i] * sp, zero, -cp])])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(_unit(U @ torch.stack([sg1[i] * aux1, zero, sg3[i] * aux3]) * (d1 + d3)))
    return torch.stack(Rs), torch.stack(ts)


# ------------------------------------------------------- plain version


def reconstruct_plain(sets, x1, x2, valid, K) -> TwoViewResult:
    """Plain version of ``reconstruct`` (same arguments)."""
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    K = K.to(torch.float32)
    xn1, T1, _ = _normalize(x1, valid)
    xn2, T2, T2inv = _normalize(x2, valid)
    idx = sets.long()

    # the 200 minimal-set hypotheses of both models
    a, b = xn1[idx], xn2[idx]                                  # (S,8,2)
    H_all = _h_model(_null_vector(_rows_h(a, b)), T1, T2inv)   # (S,3,3)
    F_all = _f_model(_null_vector(_rows_f(a, b)), T1, T2)
    SH_all, _ = _score_h(H_all, x1, x2, valid)
    SF_all, _ = _score_f(F_all, x1, x2, valid)
    bh, bf = torch.argmax(SH_all), torch.argmax(SF_all)        # first max wins
    H21, SH = H_all[bh], SH_all[bh]
    F21, SF = F_all[bf], SF_all[bf]
    use_h = (SH / torch.clamp(SH + SF, min=1e-9)).float() > 0.40

    # inlier refit of both models, kept where it scores higher
    _, inl_h = _score_h(H21, x1, x2, valid)
    _, inl_f = _score_f(F21, x1, x2, valid)
    H_re = _h_model(_null_vector(_rows_h(xn1, xn2), torch.cat([inl_h, inl_h]).double()),
                    T1, T2inv)
    sh2, inl_h2 = _score_h(H_re, x1, x2, valid)
    F_re = _f_model(_null_vector(_rows_f(xn1, xn2), inl_f.double()), T1, T2)
    sf2, inl_f2 = _score_f(F_re, x1, x2, valid)
    H21 = torch.where(sh2 > SH, H_re, H21)
    inl_h = torch.where(sh2 > SH, inl_h2, inl_h)
    F21 = torch.where(sf2 > SF, F_re, F21)
    inl_f = torch.where(sf2 > SF, inl_f2, inl_f)

    # motion hypotheses: 4 from E (padded to 8, invalid) or 8 from H
    E21 = K.double().T @ F21.double() @ K.double()
    Rs_f, ts_f = _decompose_e(E21)
    Rs_h, ts_h = _decompose_h(H21, K)
    Rs = torch.where(use_h, Rs_h, torch.cat([Rs_f, Rs_f])).float()
    ts = torch.where(use_h, ts_h, torch.cat([ts_f, ts_f])).float()
    hyp_valid = use_h | (torch.arange(8, device=x1.device) < 4)
    inliers = torch.where(use_h, inl_h, inl_f)

    n_good, parallax, good, Xs = _check_rt(Rs, ts, x1, x2, inliers, K)
    n_good = torch.where(hyp_valid, n_good, -1)
    best = torch.argmax(n_good)
    max_good = n_good[best]
    n_inl = inliers.sum().to(torch.int32)
    n_min_good = torch.clamp((0.9 * n_inl.float()).to(torch.int32), min=MIN_TRIANGULATED)
    n_similar = (n_good > (0.7 * max_good.float()).to(torch.int32)).sum()
    ok = (max_good >= n_min_good) & (n_similar == 1) & (parallax[best] > MIN_PARALLAX_DEG)
    return TwoViewResult(success=ok, R21=Rs[best], t21=ts[best], points3d=Xs[best],
                         is_triangulated=good[best], used_homography=use_h)


# ------------------------------------------------------------ kernel K5


def reconstruct(sets, x1, x2, valid, K) -> TwoViewResult:
    """Full two-view initialisation on matched (padded) keypoint pairs.

    Replaces ``extractorb_tpu/geometry/two_view.py:reconstruct``.  sets
    (S,8) minimal sets (``sample_sets``), x1/x2 (N,2) float32 pixel
    coordinates, valid (N,) bool, K (3,3).  On CUDA tensors this launches
    K5 (the whole chain, no host synchronisation); on the CPU it runs
    ``reconstruct_plain``."""
    if not x1.is_cuda:
        return reconstruct_plain(sets, x1, x2, valid, K)
    N, S = x1.shape[0], sets.shape[0]
    if N > MAX_PAIRS or N == 0:
        raise ValueError(f"two_view: {N} pairs, the kernel takes 1..{MAX_PAIRS}")
    dev = x1.device
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    xn1, T1, _ = _normalize(x1, valid)
    xn2, T2, T2inv = _normalize(x2, valid)
    Kf = K.to(torch.float32).cpu()
    mats = torch.stack([T1, T2, T2inv]).to(torch.float32).contiguous()
    sets_i = sets.to(torch.int32).contiguous()
    args = [xn1.contiguous(), xn2.contiguous(), x1, x2, valid, sets_i, mats]
    kernels.require_cuda("two_view", *args)
    lib = kernels.lib()
    ws = torch.empty(int(lib.two_view_workspace_bytes(S, N)), dtype=torch.uint8, device=dev)
    success = torch.empty((), dtype=torch.bool, device=dev)
    used_h = torch.empty((), dtype=torch.bool, device=dev)
    R21 = torch.empty(3, 3, dtype=torch.float32, device=dev)
    t21 = torch.empty(3, dtype=torch.float32, device=dev)
    pts = torch.empty(N, 3, dtype=torch.float32, device=dev)
    tri = torch.empty(N, dtype=torch.bool, device=dev)
    err = lib.two_view_launch(
        *[a.data_ptr() for a in args], S, N, float(Kf[0, 0]), float(Kf[1, 1]),
        float(Kf[0, 2]), float(Kf[1, 2]), ws.data_ptr(), success.data_ptr(),
        R21.data_ptr(), t21.data_ptr(), pts.data_ptr(), tri.data_ptr(), used_h.data_ptr(),
        kernels.stream())
    kernels.check(err, "two_view")
    kernels.LAUNCHES["two_view"] += 1
    return TwoViewResult(success, R21, t21, pts, tri, used_h)
