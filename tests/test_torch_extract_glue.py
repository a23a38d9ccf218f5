"""The extraction and match glue of the PyTorch port against the JAX
package, on the inputs its kernels find hardest.

CPU cases (the port's plain versions; integer outputs bit-equal):
``collect_keypoints`` (K16's plain version) with kept pixels far above
capacity, all scores equal, nothing kept and fewer kept than capacity;
``distribute_device`` (K17) at depth 7 and depth 0, with equal responses
in one cell and invalid slots interleaved; ``_compact`` and ``_truncate``
with ties and all-invalid levels; ``rotation_consistency_mask`` and the
claims (K18) at bins of exactly 0.1x the largest, rotations just under 360
and exact bin halves, several map points on one keypoint and equal
distances; the extractor on a noise frame and a black one.

Card cases (``-m gpu``): K15-K18 against their plain versions on the same
CUDA inputs, and the extractor and a ``TrackStep`` step on the card with
every plain glue function made to raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.frontend import extractor as jext
from extractorb_tpu.frontend import fast as jfast
from extractorb_tpu.frontend import matcher as jfm
from extractorb_tpu.frontend import octree as joctree
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.frontend import extractor as fext
from extractorb_tpu_torch.frontend import fast, matcher, octree, pyramid
from extractorb_tpu_torch.frontend.extractor import Features, ORBExtractor
from extractorb_tpu_torch.slam.track_device import TrackStep
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

T = torch.from_numpy
FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _np(a):
    return np.asarray(a)


# ------------------------------------------------------------ K16: collect


def _plane(case: str, rng, H: int = 64, W: int = 96):
    score = rng.integers(7, 255, (H, W))
    if case == "far_above_capacity":
        keep = rng.random((H, W)) < 0.5
    elif case == "all_scores_equal":
        keep, score = np.ones((H, W), bool), np.full((H, W), 20)
    elif case == "none_kept":
        keep = np.zeros((H, W), bool)
    else:  # capacity above the kept count
        keep = rng.random((H, W)) < 0.01
    return keep, score.astype(np.int16)


@pytest.mark.parametrize("case", ["far_above_capacity", "all_scores_equal", "none_kept",
                                  "capacity_above_kept"])
def test_collect_keypoints_bit_equal(case):
    keep, score = _plane(case, np.random.default_rng(1))
    want = [_np(a) for a in jfast.collect_keypoints(jnp.asarray(keep), jnp.asarray(score), 512)]
    got = fast.collect_keypoints(T(keep), T(score), 512)
    for name, g, w in zip(("xy", "resp", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ---------------------------------------------------------- K17: quadtree


LEVEL_W, LEVEL_H = 179, 134   # level 7 of the 640x480 pyramid, inner size
MIN_B = fast.MIN_BORDER


def _candidates(case: str, rng, K: int = 512):
    x = rng.integers(MIN_B, LEVEL_W - MIN_B, K)
    y = rng.integers(MIN_B, LEVEL_H - MIN_B, K)
    resp = rng.integers(7, 255, K)
    valid = rng.random(K) < 0.9
    budget = 60
    if case == "depth_7":
        budget = 10 ** 6
    elif case == "depth_0":
        budget = 1
    elif case == "equal_resp_one_cell":
        x[:40], y[:40] = 60 + rng.integers(0, 3, 40), 50 + rng.integers(0, 3, 40)
        resp[:40] = 50
        valid[:40] = True
    else:  # invalid slots interleaved
        valid = np.arange(K) % 2 == 0
        valid[rng.random(K) < 0.2] = False
    xy = np.stack([x, y], -1).astype(np.int32)
    return xy, resp.astype(np.int32), valid, budget


@pytest.mark.parametrize("case", ["depth_7", "depth_0", "equal_resp_one_cell",
                                  "invalid_interleaved"])
def test_distribute_device_bit_equal(case):
    xy, resp, valid, budget = _candidates(case, np.random.default_rng(2))
    w, h = LEVEL_W - 2 * MIN_B, LEVEL_H - 2 * MIN_B
    jkeep, jdepth = joctree.distribute_device(jnp.asarray(xy), jnp.asarray(resp),
                                              jnp.asarray(valid), budget, w, h, MIN_B, MIN_B)
    plan = octree.OctreePlan(w, h, MIN_B, MIN_B, "cpu")
    keep, depth = octree.distribute_device(T(xy), T(resp), T(valid), budget, plan)
    np.testing.assert_array_equal(keep.numpy(), _np(jkeep))
    assert int(depth) == int(jdepth)
    if case == "depth_7":
        assert int(depth) == 7
    if case == "depth_0":
        assert int(depth) == 0


@pytest.mark.parametrize("case", ["ties", "all_masked_out"])
def test_compact_bit_equal(case):
    rng = np.random.default_rng(3)
    n = 512
    xy = rng.integers(0, 300, (n, 2)).astype(np.int32)
    resp = rng.choice([10, 20, 30], n).astype(np.int32)
    mask = rng.random(n) < 0.6 if case == "ties" else np.zeros(n, bool)
    want = [_np(a) for a in jext._compact(jnp.asarray(xy), jnp.asarray(resp),
                                          jnp.asarray(mask), 128)]
    got = fext._compact(T(xy), T(resp), T(mask), 128)
    for name, g, w in zip(("xy", "resp", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("capacity", [300, 180])
def test_truncate_bit_equal(capacity):
    """Three levels of 100 slots, the middle one all invalid, the others
    with invalid slots between valid ones; packed into all slots or cut."""
    rng = np.random.default_rng(4)
    n = 300
    valid = rng.random(n) < 0.7
    valid[100:200] = False
    arrays = dict(xy=rng.uniform(0, 640, (n, 2)).astype(np.float32),
                  response=rng.integers(7, 255, n).astype(np.float32),
                  angle=rng.uniform(0, 360, n).astype(np.float32),
                  octave=np.repeat(np.arange(3), 100).astype(np.int32),
                  size=np.full(n, 31.0, np.float32),
                  desc=rng.integers(0, 256, (n, 32)).astype(np.uint8), valid=valid)
    want = jext._truncate(jext.Features(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                          capacity)
    got = fext._truncate(Features(**{k: T(v) for k, v in arrays.items()}), capacity)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), _np(getattr(want, k)), err_msg=k)


# ------------------------------------------------ K18: rotation and claims


def _rotation_case(case: str, rng, N: int = 64):
    """Angles (angle1 (M,), angle2 (N,)), best_idx (M,) and accept (M,)
    whose rotations fill chosen histogram bins."""
    if case.startswith("tenth_"):
        c0 = int(case[6:])
        # bin 0 holds c0 rotations, bin 4 exactly 0.1 x c0, bin 8 one fewer
        rots = [0.0] * c0 + [120.0] * (c0 // 10) + [240.0] * (c0 // 10 - 1) + [300.0] * 2
    elif case == "under_360":
        rots = [359.99997, 359.9999, 359.99, 0.00001, 350.0] * 6
    else:  # exact bin halves: rint(k + 0.5) rounds to even
        rots = [15.0, 45.0, 75.0, 105.0, 135.0, 345.0] * 5
    M = len(rots)
    best_idx = rng.integers(0, N, M).astype(np.int32)
    angle2 = rng.uniform(0, 360, N).astype(np.float32)
    angle2[best_idx] = 0.0
    angle1 = np.asarray(rots, np.float32)
    accept = rng.random(M) < 0.95
    if case.startswith("tenth_"):
        accept[:] = True
    return angle1, angle2, best_idx, accept


ROT_CASES = ["tenth_10", "tenth_20", "tenth_30", "tenth_70", "under_360", "halves"]


@pytest.mark.parametrize("case", ROT_CASES)
def test_rotation_consistency_mask_bit_equal(case):
    a1, a2, bidx, accept = _rotation_case(case, np.random.default_rng(5))
    want = _np(jfm.rotation_consistency_mask(jnp.asarray(a1), jnp.asarray(a2[bidx]),
                                             jnp.asarray(accept)))
    got = matcher.rotation_consistency_mask(T(a1), T(a2[bidx]), T(accept))
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("tenth_"):
        n0 = int(case[6:])
        assert got.numpy()[n0:n0 + n0 // 10].all(), "a bin of exactly 0.1x the largest is kept"


@pytest.mark.parametrize("case", ROT_CASES[::2] + ["many_on_one"])
def test_first_claim_and_epilogue_bit_equal(case):
    """_first_claim with several map points per keypoint, and K18's plain
    version (claim + rotation filter) against the JAX composition."""
    rng = np.random.default_rng(6)
    N = 64
    if case == "many_on_one":
        M = 300
        bidx = rng.integers(0, 12, M).astype(np.int32)
        accept = rng.random(M) < 0.6
        a1, a2 = rng.uniform(0, 360, M).astype(np.float32), rng.uniform(0, 360, N).astype(
            np.float32)
    else:
        a1, a2, bidx, accept = _rotation_case(case, rng, N)
        M = len(a1)
    jclaim = jfm._first_claim(jnp.asarray(bidx), jnp.asarray(accept), N)
    np.testing.assert_array_equal(matcher._first_claim(T(bidx), T(accept), N).numpy(),
                                  _np(jclaim))
    jrot = jfm.rotation_consistency_mask(jnp.asarray(a1), jnp.asarray(a2[bidx]),
                                         jnp.asarray(accept))
    want = np.where(_np(jclaim) & _np(jrot), bidx, -1)
    best = rng.integers(0, 60, M).astype(np.int32)
    got = matcher.match_epilogue(T(best), T(bidx), T(accept), N, False, T(a1), T(a2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flips", [0, 3])
def test_init_claim_equal_distances(flips):
    """search_for_initialization where many rows have the same best
    distance to one column: the earlier row wins (dist-major claim)."""
    rng = np.random.default_rng(7)
    N1, N2 = 96, 64
    desc2 = rng.integers(0, 256, (N2, 32)).astype(np.uint8)
    src = rng.integers(0, 8, N1)    # eight columns, each wanted by ~12 rows
    desc1 = desc2[src].copy()
    for i in range(N1):   # the same number of flipped bits in every row
        for b in rng.choice(256, flips, replace=False):
            desc1[i, b // 8] ^= np.uint8(1 << (b % 8))
    xy1 = rng.uniform(100, 200, (N1, 2)).astype(np.float32)
    xy2 = rng.uniform(100, 200, (N2, 2)).astype(np.float32)
    ang1 = rng.uniform(0, 360, N1).astype(np.float32)
    ang2 = rng.uniform(0, 360, N2).astype(np.float32)
    args = (desc1, xy1, ang1, np.zeros(N1, np.int32), np.ones(N1, bool),
            desc2, xy2, ang2, np.zeros(N2, np.int32), np.ones(N2, bool))
    want = _np(jfm.search_for_initialization(*map(jnp.asarray, args), 100))
    got = matcher.search_for_initialization(*map(T, args), window=100).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() >= 1


# ------------------------------------------------------ the whole extractor


@pytest.mark.parametrize("frame", ["noise", "black"])
def test_extractor_edge_frames_bit_equal(frame):
    """A noise frame keeps far more pixels than k on every level; a black
    one keeps none (every level at depth 7, no valid slot)."""
    W, H = 320, 240
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8) if frame == "noise" else \
        np.zeros((H, W), np.uint8)
    jf = jext.ORBExtractor(JORBConfig(n_features=500))(jnp.asarray(img))
    got = interop.to_numpy(ORBExtractor(ORBConfig(n_features=500), (H, W), "cpu")(T(img)))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], _np(getattr(jf, k)), err_msg=k)
    assert (got["valid"].sum() > 400) == (frame == "noise")


# --------------------------------------------------------------- on a card


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(240, 320), (480, 640)])
def test_glue_kernels_match_plain(shape, cuda_device):
    """K15, K16 and K17 bit-equal to their plain versions on a rendered,
    a noise and a black frame; K18 on both claim rules."""
    H, W = shape
    rng = np.random.default_rng(9)
    imgs, _, _ = pf.render_sequence(pf.procedural_texture(), 1, width=W, height=H)
    ex = ORBExtractor(ORBConfig(n_features=1000), shape, cuda_device)
    for im in (imgs[0], rng.integers(0, 256, shape).astype(np.uint8), np.zeros(shape, np.uint8)):
        img = T(im).to(cuda_device)
        pk = pyramid.compute_pyramid(img, ex.pyr_plan)
        assert torch.equal(pk.flat, pyramid.compute_pyramid_plain(img, ex.pyr_plan).flat)
        keeps, scores = fast.fast_detect(pk, ex.fast_plan)
        cand = fast.collect_levels(keeps, scores, ex.collect_plan)
        for a, b in zip(cand, fast.collect_levels_plain(keeps, scores, ex.collect_plan)):
            assert torch.equal(a, b)
        for a, b in zip(fext.select_keypoints(*cand, ex), fext.select_keypoints_plain(*cand, ex)):
            assert torch.equal(a, b)
    M, N = 1128, 1128
    d = lambda a: T(np.asarray(a)).to(cuda_device)
    best, bidx = d(rng.integers(0, 60, M).astype(np.int32)), d(rng.integers(0, 300, M).astype(
        np.int32))
    accept = d(rng.random(M) < 0.7)
    a1, a2 = d(rng.uniform(0, 360, M).astype(np.float32)), d(rng.uniform(0, 360, N).astype(
        np.float32))
    for by_distance in (False, True):
        for rot in ((), (a1, a2)):
            args = (best, bidx, accept, N, by_distance, *rot)
            assert torch.equal(matcher.match_epilogue(*args), matcher.match_epilogue_plain(*args))


def _raise(name):
    def f(*a, **k):
        raise AssertionError(f"{name} ran on the card's main path")
    return f


@pytest.mark.gpu
def test_card_path_runs_no_plain_glue(cuda_device, monkeypatch):
    """The extractor and TrackStep steps on the card with every plain glue
    function made to raise: the pyramid's torch path, the collection, the
    quadtree, the compaction, the pack, the rotation filter and the claims."""
    for mod, names in ((pyramid, ("compute_pyramid_plain", "resize_u8")),
                       (fast, ("collect_keypoints", "collect_levels_plain")),
                       (octree, ("distribute_device",)),
                       (fext, ("distribute_device", "_compact", "_truncate", "_pack_order",
                               "select_keypoints_plain")),
                       (matcher, ("rotation_consistency_mask", "_first_claim",
                                  "_distance_claim", "match_epilogue_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, _raise(n))
    W, H = 320, 240
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), 3, width=W, height=H)
    feats = ORBExtractor(ORBConfig(n_features=500), (H, W), cuda_device)(
        T(frames[0]).to(cuda_device))
    assert int(feats.valid.sum()) > 400
    step = TrackStep(chip_smoke.camera_config(W, H), ORBConfig(n_features=500), (H, W), 4096,
                     1024, cuda_device)
    out = chip_smoke.track_sequence(step, frames, depths, poses, pf.true_pose(-1), cuda_device)
    assert all(int(o["n_inl_final"]) >= pf.MIN_INLIERS for o in out)
