"""Matcher of the PyTorch port (plain path) against the JAX package.

Random descriptors and geometry from a numpy seed go through each of the
searches of both packages on the CPU (the tracking step's four, the loop
closer's word-gated ``search_by_bow`` and Sim3 ``search_by_projection_sim3``,
and ``fuse_by_projection``, ``search_by_projection_reloc`` and the mutual
``search_by_sim3``); the match index arrays must be identical.  Edge cases of the best/second-best primitive (ties, rows
without a candidate) and of the rotation histogram (tied bins) are held
to the JAX semantics as well.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extractorb_tpu.frontend import matcher as jfm
from extractorb_tpu.slam.track_device import pinhole_project as j_pinhole
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.frontend import matcher as fm
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

W, H = 320, 240
FX, CX, CY = 250.0, 160.0, 120.0
SCALES = tuple(float(s) for s in np.cumprod([1.0] + [np.float32(1.2)] * 7).astype(np.float32))
CAM = Pinhole(FX, FX, CX, CY)


def _flip_bits(rng, desc, n_flip):
    out = desc.copy()
    for row in out:
        for b in rng.choice(256, n_flip, replace=False):
            row[b // 8] ^= np.uint8(1 << (b % 8))
    return out


def _scene(seed, M=400, N=300):
    """N keypoints and M map points; the first 200 map points are noisy
    copies of keypoints (descriptor bit flips, 1-3 px reprojection)."""
    rng = np.random.default_rng(seed)
    kp_xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1).astype(np.float32)
    kp_oct = rng.integers(0, 8, N).astype(np.int32)
    kp_ang = rng.uniform(0, 360, N).astype(np.float32)
    kp_desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kp_desc[1::7] = kp_desc[0::7][: len(kp_desc[1::7])]  # duplicate descriptors: ties
    kp_valid = rng.random(N) < 0.9
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.02, -0.01, 0.05], np.float32)
    src = rng.choice(N, 200, replace=False)
    z = rng.uniform(2, 8, M)
    uv = np.stack([rng.uniform(0, W, M), rng.uniform(0, H, M)], -1)
    uv[:200] = kp_xy[src] + rng.normal(0, 2.0, (200, 2))
    pc = np.stack([(uv[:, 0] - CX) / FX * z, (uv[:, 1] - CY) / FX * z, z], -1)
    mp_pos = ((pc - t) @ R).astype(np.float32)  # world points, R^T (pc - t)
    mp_desc = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    mp_desc[:200] = _flip_bits(rng, kp_desc[src], 12)
    mp_oct = rng.integers(0, 8, M).astype(np.int32)
    mp_oct[:200] = np.clip(kp_oct[src] + rng.integers(-1, 2, 200), 0, 7)
    mp_ang = rng.uniform(0, 360, M).astype(np.float32)
    mp_ang[:200] = (kp_ang[src] + rng.normal(0, 3, 200)) % 360
    mp_valid = rng.random(M) < 0.95
    # local-map geometry: normal towards the camera, max distance so that
    # the predicted level is near the keypoint's
    ctr = -R.T @ t
    view = mp_pos - ctr
    dist = np.linalg.norm(view, axis=1)
    normal = (view / dist[:, None] + rng.normal(0, 0.02, (M, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    maxd = (dist * 1.2 ** mp_oct * rng.uniform(0.9, 1.1, M)).astype(np.float32)
    return dict(kp_xy=kp_xy, kp_oct=kp_oct, kp_ang=kp_ang, kp_desc=kp_desc, kp_valid=kp_valid,
                R=R, t=t, mp_pos=mp_pos, mp_desc=mp_desc, mp_oct=mp_oct, mp_ang=mp_ang,
                mp_valid=mp_valid, normal=normal, maxd=maxd)


T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th", [15.0, 30.0])
def test_search_by_projection_last_frame(seed, th):
    s = _scene(seed)
    args = [s[k] for k in ("mp_pos", "mp_desc", "mp_valid", "mp_oct", "mp_ang", "R", "t",
                           "kp_xy", "kp_desc", "kp_oct", "kp_ang", "kp_valid")]
    j = np.asarray(jfm.search_by_projection_last_frame(
        *map(J, args), j_pinhole(FX, FX, CX, CY), SCALES, (float(W), float(H)), th))
    p = fm.search_by_projection_last_frame(*map(T, args), CAM, SCALES, (float(W), float(H)), th)
    assert (j >= 0).sum() > 20
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_by_projection_local_map(seed):
    s = _scene(seed)
    args = [s[k] for k in ("mp_pos", "mp_desc", "mp_valid", "normal", "maxd", "R", "t",
                           "kp_xy", "kp_desc", "kp_oct", "kp_valid")]
    j = np.asarray(jfm.search_by_projection_local_map(
        *map(J, args), None, j_pinhole(FX, FX, CX, CY), SCALES, (float(W), float(H))))
    p = fm.search_by_projection_local_map(*map(T, args), CAM, SCALES, (float(W), float(H)))
    assert (j >= 0).sum() > 10
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_best_match(seed):
    s = _scene(seed)
    args = (s["kp_desc"], s["kp_valid"], s["mp_desc"], s["mp_valid"])
    jm, jd = (np.asarray(a) for a in jfm.mutual_best_match(*map(J, args)))
    pm, pd = fm.mutual_best_match(*map(T, args))
    assert (jm >= 0).sum() > 20
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(pd.numpy(), jd)


def _words(rng, s, n_words=12):
    """Word ids of both sets (-1 for none), the noisy copies sharing their
    source keypoint's word most of the time."""
    w_kp = rng.integers(-1, n_words, len(s["kp_desc"])).astype(np.int32)
    w_mp = rng.integers(-1, n_words, len(s["mp_desc"])).astype(np.int32)
    src = np.array([np.argmin(np.unpackbits(s["kp_desc"] ^ d, axis=1).sum(1))
                    for d in s["mp_desc"][:200]])
    keep = rng.random(200) < 0.8
    w_mp[:200][keep] = w_kp[src[keep]]
    return w_kp, w_mp


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nn_ratio,rotation", [(0.7, True), (0.9, True), (0.9, False)])
def test_search_by_bow(seed, nn_ratio, rotation):
    s = _scene(seed)
    w_kp, w_mp = _words(np.random.default_rng(seed + 10), s)
    args = (s["mp_desc"], w_mp, s["mp_ang"], s["mp_valid"],
            s["kp_desc"], w_kp, s["kp_ang"], s["kp_valid"])
    j = np.asarray(jfm.search_by_bow(*map(J, args), nn_ratio, rotation))
    p = fm.search_by_bow(*map(T, args), nn_ratio, rotation)
    assert (j >= 0).sum() > 20
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale,th", [(1.0, 7.5), (0.8, 5.0)])
def test_search_by_projection_sim3(seed, scale, th):
    """The Sim3 projection search: the scene's points shrunk by 1/s and
    projected through s R p + t, the same pixels as at s = 1."""
    s = _scene(seed)
    free = s["kp_valid"] & (np.random.default_rng(seed).random(len(s["kp_valid"])) < 0.9)
    args = [s["mp_pos"] / np.float32(scale), s["mp_desc"], s["mp_valid"], s["normal"],
            s["maxd"] / np.float32(scale), np.float32(scale), s["R"], s["t"], s["kp_xy"],
            s["kp_desc"], s["kp_oct"], free]
    j = np.asarray(jfm.search_by_projection_sim3(
        *map(J, args), j_pinhole(FX, FX, CX, CY), SCALES, (float(W), float(H)), th))
    p = fm.search_by_projection_sim3(*map(T, args), CAM, SCALES, (float(W), float(H)), th)
    assert (j >= 0).sum() > 10
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th", [3.0, 6.0])
def test_fuse_by_projection(seed, th):
    """Fuse: no claims, so a keypoint may take several map points."""
    s = _scene(seed)
    args = [s[k] for k in ("mp_pos", "mp_desc", "mp_valid", "normal", "maxd", "R", "t",
                           "kp_xy", "kp_desc", "kp_oct", "kp_valid")]
    j = np.asarray(jfm.fuse_by_projection(
        *map(J, args), j_pinhole(FX, FX, CX, CY), SCALES, (float(W), float(H)), th))
    p = fm.fuse_by_projection(*map(T, args), CAM, SCALES, (float(W), float(H)), th)
    assert (j >= 0).sum() > 10
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th,orb_dist", [(10.0, 100), (20.0, 50)])
def test_search_by_projection_reloc(seed, th, orb_dist):
    s = _scene(seed)
    free = s["kp_valid"] & (np.random.default_rng(seed).random(len(s["kp_valid"])) < 0.9)
    args = [s[k] for k in ("mp_pos", "mp_desc", "mp_valid", "mp_oct", "mp_ang", "maxd", "R",
                           "t", "kp_xy", "kp_desc", "kp_oct", "kp_ang")] + [free]
    j = np.asarray(jfm.search_by_projection_reloc(
        *map(J, args), j_pinhole(FX, FX, CX, CY), SCALES, (float(W), float(H)), th, orb_dist))
    p = fm.search_by_projection_reloc(*map(T, args), CAM, SCALES, (float(W), float(H)), th,
                                      orb_dist)
    assert (j >= 0).sum() > 20
    np.testing.assert_array_equal(p.numpy(), j)


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _sim3_sets(seed, s12, N1=300, N2=260, n_common=180):
    """Two keyframes' map points in their own camera frames, the first
    n_common the same points (p1 = s12 R12 p2 + t12, 1 cm of noise) with
    their descriptors 10 bits apart, and each set's keypoints (pixels 1 px
    off the projections, levels, scale-invariance distances)."""
    rng = np.random.default_rng(seed)

    def unproject(n):
        z = rng.uniform(2, 8, n)
        uv = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
        return np.stack([(uv[:, 0] - CX) / FX * z, (uv[:, 1] - CY) / FX * z, z], -1)

    def project(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX, FX * p[:, 1] / p[:, 2] + CY], -1)

    R12 = _rodrigues(np.array([0.02, -0.03, 0.01]))
    t12 = np.array([0.05, -0.02, 0.03])
    pos1 = unproject(N1)
    pos2 = unproject(N2)
    pos2[:n_common] = (pos1[:n_common] - t12) @ R12 / s12 + rng.normal(0, 0.01, (n_common, 3))
    desc1 = rng.integers(0, 256, (N1, 32)).astype(np.uint8)
    desc2 = rng.integers(0, 256, (N2, 32)).astype(np.uint8)
    desc2[:n_common] = _flip_bits(rng, desc1[:n_common], 10)
    oct1 = rng.integers(0, 8, N1).astype(np.int32)
    oct2 = rng.integers(0, 8, N2).astype(np.int32)
    oct2[:n_common] = np.clip(oct1[:n_common] + rng.integers(-1, 2, n_common), 0, 7)
    f32 = lambda a: np.asarray(a, np.float32)
    out = dict(pos1=f32(pos1), desc1=desc1, valid1=rng.random(N1) < 0.95, pos2=f32(pos2),
               desc2=desc2, valid2=rng.random(N2) < 0.95, s12=np.float32(s12), R12=f32(R12),
               t12=f32(t12), already=rng.random(N1) < 0.1)
    kw = dict(kp_xy1=f32(project(pos1) + rng.normal(0, 1, (N1, 2))),
              kp_xy2=f32(project(pos2) + rng.normal(0, 1, (N2, 2))), kp_octave1=oct1,
              kp_octave2=oct2,
              max_dist1=f32(np.linalg.norm(pos1, axis=1) * 1.2 ** oct1 * rng.uniform(0.9, 1.1, N1)),
              max_dist2=f32(np.linalg.norm(pos2, axis=1) * 1.2 ** oct2 * rng.uniform(0.9, 1.1, N2)))
    return out, kw


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s12", [1.0, 1.25])
def test_search_by_sim3(seed, s12):
    sets, kw = _sim3_sets(seed, s12)
    wh = (float(W), float(H))
    j = np.asarray(jfm.search_by_sim3(*map(J, sets.values()), j_pinhole(FX, FX, CX, CY), SCALES,
                                      **{k: J(v) for k, v in kw.items()}, img_wh=wh))
    p = fm.search_by_sim3(*map(T, sets.values()), CAM, SCALES,
                          **{k: T(v) for k, v in kw.items()}, img_wh=wh)
    assert (j >= 0).sum() > 20
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_initialization(seed):
    s = _scene(seed)
    rng = np.random.default_rng(seed + 10)
    n = len(s["kp_xy"])
    xy2 = (s["kp_xy"] + rng.normal(0, 20, (n, 2))).astype(np.float32)
    desc2 = _flip_bits(rng, s["kp_desc"], 10)
    oct1 = np.where(rng.random(n) < 0.7, 0, s["kp_oct"]).astype(np.int32)
    oct2 = np.where(rng.random(n) < 0.7, 0, s["kp_oct"]).astype(np.int32)
    ang2 = ((s["kp_ang"] + np.where(rng.random(n) < 0.8, 5.0, rng.uniform(0, 360, n))) % 360
            ).astype(np.float32)
    args = (s["kp_desc"], s["kp_xy"], s["kp_ang"], oct1, s["kp_valid"],
            desc2, xy2, ang2, oct2, rng.random(n) < 0.9)
    j = np.asarray(jfm.search_for_initialization(*map(J, args), 100))
    p = fm.search_for_initialization(*map(T, args), window=100)
    assert (j >= 0).sum() > 20
    np.testing.assert_array_equal(p.numpy(), j)


def _best2_reference(dist, mask):
    """The JAX semantics, in numpy: masked pairs are 1<<20, argmin takes
    the first minimum, second = min with the best column set to 1<<20."""
    d = np.where(mask, dist, fm.INF)
    bi = np.argmin(d, 1)
    d2 = d.copy()
    d2[np.arange(len(d)), bi] = fm.INF
    return d.min(1), d2.min(1), bi, np.argmin(d2, 1)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_best2_edge_cases(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    M, N = 40, 64
    q = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    c = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    c[10] = c[3]
    c[20] = c[3]          # three equal columns: ties in best and second
    q[0] = c[3]           # exact match at the tied columns
    q[1] = c[5]
    c[40] = c[5]          # best tie at 5 and 40
    row_ok = np.ones(M, bool)
    row_ok[2] = False     # a row without candidates
    col_ok = rng.random(N) < 0.9
    col_ok[[3, 5, 10, 20, 40]] = True
    u, v = rng.uniform(0, 100, M).astype(np.float32), rng.uniform(0, 100, M).astype(np.float32)
    r = rng.uniform(5, 60, M).astype(np.float32)
    lo, hi = np.full(M, 1, np.int32), np.full(M, 3, np.int32)
    x, y = rng.uniform(0, 100, N).astype(np.float32), rng.uniform(0, 100, N).astype(np.float32)
    octv = rng.integers(0, 5, N).astype(np.int32)
    r[:2], lo[:2], hi[:2] = np.inf, -1, 9      # rows 0, 1: every finite column
    r[7] = 0.0                                 # an empty window
    # K3's grid edges: columns that never pass (a NaN or infinite x or y),
    # one far outside every finite window; row 8 at (50, 50) with r = 10
    # against a column on each edge of its window and one an ulp inside
    # each; a row with a NaN centre, one with a NaN and one with a
    # negative half-width
    x[[50, 51]], y[[52, 53]] = np.nan, [np.inf, -np.inf]
    x[54], y[54] = 1e4, -1e4
    u[8], v[8], r[8] = 50.0, 50.0, 10.0
    edge = np.float32(60.0)
    x[55:59] = [edge, np.nextafter(edge, np.float32(0)), np.float32(40.0),
                np.nextafter(np.float32(40.0), np.float32(100))]
    y[55:59] = 50.0
    x[59], y[59] = 50.0, np.nextafter(edge, np.float32(0))
    octv[54:60] = 2
    col_ok[50:60] = True
    u[9], r[10], r[11] = np.nan, np.nan, -5.0
    gate = fm.Gate(*(torch.from_numpy(a) for a in (u, v, r, lo, hi, x, y, octv)))
    D = lambda a: T(a).to(device)
    got = fm.hamming_best2(D(q), D(row_ok), D(c), D(col_ok),
                           fm.Gate(*(g.to(device) for g in gate)))
    got = fm.Best2(*(g.cpu() for g in got))
    dist = np.unpackbits(q[:, None, :] ^ c[None, :, :], axis=-1).sum(-1)
    mask = fm._gate_mask(gate, T(row_ok), T(col_ok)).numpy()
    want = _best2_reference(dist, mask)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.best[0] == 0 and got.best_idx[0] == 3 and got.second_idx[0] == 10
    assert got.best_idx[1] == 5 and got.second_idx[1] == 40
    for row in (2, 7, 9, 10, 11):
        assert got.best[row] == fm.INF and got.best_idx[row] == 0 and got.second_idx[row] == 0
    assert not mask[:, 50:54].any() and mask[:2, 54].all()
    assert list(np.flatnonzero(mask[8, 55:60]) + 55) == [56, 58, 59]


def _grid_case(case: str, rng):
    """(q, row_ok, c, col_ok, gate) of K3's box route at its grid's edges:
    every column on one point, one column, all descriptors equal (each
    row's best and second are its two lowest admitted columns), columns
    spread so wide that the grid's width overflows float32."""
    M, N = 48, {"one_column": 1}.get(case, 200)
    q = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    c = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    x, y = rng.uniform(0, 640, N).astype(np.float32), rng.uniform(0, 480, N).astype(np.float32)
    u, v = rng.uniform(0, 640, M).astype(np.float32), rng.uniform(0, 480, M).astype(np.float32)
    r = rng.uniform(5, 120, M).astype(np.float32)
    if case == "one_cell":
        x[:], y[:] = 300.0, 200.0
        u[: M // 2], v[: M // 2] = 300.0 + rng.uniform(-20, 20, M // 2), 200.0
    elif case == "one_column":
        u[: M // 2], v[: M // 2] = x[0], y[0]
    elif case == "ties":
        c[:] = c[0]
        q[::2] = c[0]
    elif case == "overflow":
        x[::3], y[1::3] = -3e38, 3e38
        r[::4] = np.inf
    octv = rng.integers(0, 8, N).astype(np.int32)
    lo = rng.integers(-1, 7, M).astype(np.int32)
    gate = fm.Gate(*(T(a) for a in (u, v, r, lo, lo + 2, x, y, octv)))
    return T(q), T(rng.random(M) < 0.9), T(c), T(rng.random(N) < 0.9), gate


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("case", ["one_cell", "one_column", "ties", "overflow"])
def test_best2_grid_cases(case, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, row_ok, c, col_ok, gate = _grid_case(case, np.random.default_rng(4))
    D = lambda a: a.to(device)
    got = fm.hamming_best2(D(q), D(row_ok), D(c), D(col_ok), fm.Gate(*(D(g) for g in gate)))
    dist = np.unpackbits(q.numpy()[:, None, :] ^ c.numpy()[None, :, :], axis=-1).sum(-1)
    mask = fm._gate_mask(gate, row_ok, col_ok).numpy()
    want = _best2_reference(dist, mask)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w, err_msg=name)
    assert mask.any()


def _adversarial_gate(rng, spread: str, M: int = 300, N: int = 400):
    """Box-gate inputs at the float32 edges of K3's grid: windows whose
    edges lie on a column or an ulp either side of one, NaN and infinite
    centres, half-widths and coordinates, columns outside every window,
    r = 0 and r = inf; with ``spread`` "far" some columns a million pixels
    out, with "overflow" some at +-3e38 (the grid's width overflows)."""
    f = np.float32
    x, y = rng.uniform(0, 640, N).astype(f), rng.uniform(0, 480, N).astype(f)
    if spread == "far":
        x[:20], y[20:40] = rng.uniform(-1e6, 1e6, 20), rng.uniform(-1e6, 1e6, 20)
    elif spread == "overflow":
        x[:20], y[20:40] = rng.choice([-3e38, 3e38], 20), rng.choice([-3e38, 3e38], 20)
    x[40:43], y[43:46] = [np.nan, np.inf, -np.inf], [np.nan, np.inf, -np.inf]
    u, v = rng.uniform(0, 640, M).astype(f), rng.uniform(0, 480, M).astype(f)
    r = rng.uniform(0.5, 60, M).astype(f)
    # rows whose window edge is a column's coordinate, or an ulp either side
    j = rng.integers(50, N, M)
    side = rng.choice([-1.0, 1.0], M).astype(f)
    nudge = rng.integers(-1, 2, M)
    for i in range(0, M, 2):
        ex = np.float32(u[i] + side[i] * r[i])
        ex = ex if nudge[i] == 0 else np.nextafter(ex, f(np.inf) if nudge[i] > 0 else f(-np.inf))
        x[j[i]], y[j[i]] = ex, v[i]
    u[[1, 3]], v[5], r[[7, 9, 11, 13]] = np.nan, np.inf, [np.nan, 0.0, np.inf, -1.0]
    octv = rng.integers(0, 8, N).astype(np.int32)
    gate = fm.Gate(*(T(a) for a in (u, v, r, np.full(M, -1, np.int32), np.full(M, 9, np.int32),
                                      x, y, octv)))
    return gate, T(rng.random(M) < 0.95), T(rng.random(N) < 0.95)


def test_bucket_grid_constants_match_the_kernel():
    """The plain grid mirror sizes its cells with the kernel's own
    constants (kColsPerCell, kMaxCells in hamming_best2.cu)."""
    import re
    from extractorb_tpu_torch import kernels
    src = (kernels.CSRC / "hamming_best2.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kColsPerCell") == fm.BOX_COLS_PER_CELL
    assert const("kMaxCells") == fm.BOX_MAX_CELLS


@pytest.mark.parametrize("spread", ["image", "far", "overflow"])
def test_bucket_grid_visits_every_admitted_pair(spread):
    """K3's box route visits only the cells a row's window overlaps
    (widened by one a side): on adversarial inputs every pair the gate
    admits has its column in a visited cell, also without the widening
    (the cell function is monotone), and the columns left out of the grid
    are those that can pass no gate."""
    gate, row_ok, col_ok = _adversarial_gate(np.random.default_rng(5), spread)
    grid = fm.bucket_grid(gate.x, gate.y, col_ok)
    admitted = fm._gate_mask(gate, row_ok, col_ok)
    rows, cols = torch.nonzero(admitted, as_tuple=True)
    assert rows.numel() > 100
    cell = grid.cells[cols]
    assert (cell >= 0).all()
    cx, cy = cell % grid.gx, cell // grid.gx
    cx0, cx1, cy0, cy1 = (a[rows] for a in fm.row_cells(grid, gate.u, gate.v, gate.r))
    assert ((cx >= cx0) & (cx <= cx1) & (cy >= cy0) & (cy <= cy1)).all()
    u, v, r = gate.u[rows], gate.v[rows], gate.r[rows]
    g = fm.grid_cell
    assert ((cx >= g(u - r, grid.x0, grid.sx, grid.gx)) & (cx <= g(u + r, grid.x0, grid.sx, grid.gx))
            & (cy >= g(v - r, grid.y0, grid.sy, grid.gy))
            & (cy <= g(v + r, grid.y0, grid.sy, grid.gy))).all()
    out = grid.cells < 0
    assert torch.equal(out, ~(col_ok & torch.isfinite(gate.x) & torch.isfinite(gate.y)))
    assert 1 <= grid.gx * grid.gy <= fm.BOX_MAX_CELLS
    assert int(grid.cells.max()) < grid.gx * grid.gy
    if spread == "image":  # a real grid: the windows walk a small part of it
        assert grid.gx * grid.gy > 100
        assert float(((cx1 - cx0 + 1) * (cy1 - cy0 + 1)).float().median()) < 0.2 * (
            grid.gx * grid.gy)


@pytest.mark.parametrize("counts", [
    [5, 3, 3, 3, 0, 0],      # third place tied between three bins: lowest bins win
    [4, 4, 4, 4, 1, 0],      # four-way tie for first
    [10, 1, 1, 0, 0, 0],     # bins 2 and 3 dropped below 0.1x the largest
])
def test_rotation_histogram_ties(counts):
    rng = np.random.default_rng(7)
    rot = np.concatenate([np.full(c, 30.0 * b) + rng.uniform(-5, 5, c)
                          for b, c in enumerate(counts)]).astype(np.float32)
    a2 = rng.uniform(0, 360, len(rot)).astype(np.float32)
    a1 = ((a2 + rot) % 360).astype(np.float32)
    valid = np.ones(len(rot), bool)
    valid[-1] = False
    j = np.asarray(jfm.rotation_consistency_mask(J(a1), J(a2), J(valid)))
    p = fm.rotation_consistency_mask(T(a1), T(a2), T(valid))
    np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.gpu
def test_hamming_best2_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    M, N = 4096, 1128
    q = torch.from_numpy(rng.integers(0, 256, (M, 32)).astype(np.uint8)).to(cuda_device)
    c = torch.from_numpy(rng.integers(0, 256, (N, 32)).astype(np.uint8)).to(cuda_device)
    c[: N // 2] = q[: N // 2]
    f = lambda a: torch.from_numpy(a).to(cuda_device)
    gate = fm.Gate(f(rng.uniform(0, 640, M).astype(np.float32)),
                   f(rng.uniform(0, 480, M).astype(np.float32)),
                   f(rng.uniform(2, 40, M).astype(np.float32)),
                   f(np.zeros(M, np.int32)), f(np.full(M, 4, np.int32)),
                   f(rng.uniform(0, 640, N).astype(np.float32)),
                   f(rng.uniform(0, 480, N).astype(np.float32)),
                   f(rng.integers(0, 8, N).astype(np.int32)))
    row_ok = f(rng.random(M) < 0.9)
    col_ok = f(rng.random(N) < 0.9)
    got = fm.hamming_best2(q, row_ok, c, col_ok, gate)
    want = fm.hamming_best2_plain(q, row_ok, c, col_ok, gate)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_hamming_best2_word_gate_kernel_matches_plain(cuda_device):
    """K3's word gate against the plain version: two 1128-slot keyframes
    whose words come from 40 ids."""
    rng = np.random.default_rng(1)
    N = 1128
    f = lambda a: torch.from_numpy(a).to(cuda_device)
    q = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    c = q.copy()
    c[N // 2:] = rng.integers(0, 256, (N - N // 2, 32))
    wq = rng.integers(-1, 40, N).astype(np.int32)
    wc = np.where(rng.random(N) < 0.7, wq, rng.integers(-1, 40, N)).astype(np.int32)
    args = (f(q), f(rng.random(N) < 0.9), f(c), f(rng.random(N) < 0.9))
    got = fm.hamming_best2(*args, words=(f(wq), f(wc)))
    want = fm.hamming_best2_plain(*args, words=(f(wq), f(wc)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _site_inputs(site: str, rng, dev):
    """K3's inputs at the shapes of the tracking step's five calls on a
    640x480 / 1000-feature frame (1128 keypoints, 4096 local-map points):
    the last-frame search at th 15 and 30 (windows th x scale of the map
    point's level, levels lo - 1 .. lo + 1), the open gate of the mutual
    match, the local-map search (2.5 or 4 x scale, levels pred - 1 ..
    pred); and the box gate at the grid's shared-memory limit (N = 4266)
    and above it (every pair tested)."""
    M, N = {"local_map": (4096, 1128), "box_limit": (96, 4266), "dense_limit": (96, 4267),
            "dense_box": (96, 13000)}.get(site, (1128, 1128))
    f = lambda a, dt=None: torch.from_numpy(np.asarray(a, dt)).to(dev)
    q = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    c = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    src = rng.integers(0, N, M)
    near = rng.random(M) < 0.6
    q[near] = _flip_bits(rng, c[src[near]], 20)
    x, y = rng.uniform(0, 640, N).astype(np.float32), rng.uniform(0, 480, N).astype(np.float32)
    octv = rng.integers(0, 8, N).astype(np.int32)
    u = np.where(near, x[src] + rng.normal(0, 3, M), rng.uniform(0, 640, M)).astype(np.float32)
    v = np.where(near, y[src] + rng.normal(0, 3, M), rng.uniform(0, 480, M)).astype(np.float32)
    lvl = np.clip(np.where(near, octv[src], rng.integers(0, 8, M)), 0, 7).astype(np.int32)
    scale = np.asarray(SCALES, np.float32)[lvl]
    if site.startswith("last_frame"):
        th = float(site.rsplit("_", 1)[1])
        r, lo, hi = np.float32(th) * scale, lvl - 1, lvl + 1
    else:
        r, lo, hi = np.where(rng.random(M) < 0.3, 2.5, 4.0).astype(np.float32) * scale, lvl - 1, lvl
    gate = None if site == "mutual" else fm.Gate(
        f(u), f(v), f(r, np.float32), f(lo, np.int32), f(hi, np.int32), f(x), f(y), f(octv))
    return f(q), f(rng.random(M) < 0.9), f(c), f(rng.random(N) < 0.95), gate


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["last_frame_15", "last_frame_30", "mutual", "local_map",
                                  "box_limit", "dense_limit", "dense_box"])
def test_hamming_best2_sites_match_plain(site, cuda_device):
    """K3 bit-equal to the plain version at each call site's shape, and
    one launch a call."""
    from extractorb_tpu_torch import kernels
    args = _site_inputs(site, np.random.default_rng(11), cuda_device)
    before = kernels.LAUNCHES["hamming_best2"]
    got = fm.hamming_best2(*args)
    assert kernels.LAUNCHES["hamming_best2"] == before + 1
    want = fm.hamming_best2_plain(*args)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    assert int((want.best < fm.INF).sum()) > args[0].shape[0] // 4
