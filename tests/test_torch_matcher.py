"""Matcher of the PyTorch port (plain path) against the JAX package.

Random descriptors and geometry from a numpy seed go through each of the
searches of both packages on the CPU (the tracking step's four, and the
loop closer's word-gated ``search_by_bow`` and Sim3
``search_by_projection_sim3``); the match index arrays must be identical.  Edge cases of the best/second-best primitive (ties, rows
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
    gate = fm.Gate(*(torch.from_numpy(a) for a in (
        rng.uniform(0, 100, M).astype(np.float32), rng.uniform(0, 100, M).astype(np.float32),
        rng.uniform(5, 60, M).astype(np.float32), np.full(M, 1, np.int32),
        np.full(M, 3, np.int32), rng.uniform(0, 100, N).astype(np.float32),
        rng.uniform(0, 100, N).astype(np.float32), rng.integers(0, 5, N).astype(np.int32))))
    gate = gate._replace(r=torch.where(torch.arange(M) < 2, float("inf"), gate.r),
                         lo=torch.where(torch.arange(M) < 2, -1, gate.lo),
                         hi=torch.where(torch.arange(M) < 2, 9, gate.hi))
    gate = gate._replace(r=torch.where(torch.arange(M) == 7, 0.0, gate.r))  # empty window
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
    for row in (2, 7):
        assert got.best[row] == fm.INF and got.best_idx[row] == 0 and got.second_idx[row] == 0


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
