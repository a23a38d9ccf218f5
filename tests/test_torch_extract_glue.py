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


@pytest.mark.parametrize("shape,n_features", [((480, 640), 1000), ((512, 512), 1500)])
@pytest.mark.parametrize("G", [8, 16])
def test_collect_plan_bands_cover_each_plane(shape, n_features, G):
    """K16's host plan: the G bands of every level, in rank order, cover
    its plane's flat pixels exactly once in row-major order, their inner
    bounds on 16-pixel segments; the launch table carries them."""
    plan = ORBExtractor(ORBConfig(n_features=n_features), shape, "cpu").collect_plan
    assert len(plan.k_levels) == 8
    bands = plan.bands(G)
    table = plan.table(G)
    assert list(table[:4]) == [8, G, plan.list_n, plan.flat_total]
    assert plan.list_n % 4 == 0 and plan.list_n >= max(plan.k_levels)
    rows = table[4:].reshape(8, 6 + G)
    for l, ((H, W), off) in enumerate(zip(plan.inner, plan.plane_offsets)):
        b = bands[l]
        pixels = np.concatenate([np.arange(b[r], b[r + 1]) for r in range(G)])
        np.testing.assert_array_equal(pixels, np.arange(off, off + H * W))
        assert all(x % fast.COLLECT_SEGMENT == 0 for x in b[1:-1])
        np.testing.assert_array_equal(rows[l], np.concatenate(
            [[off, W, H, plan.k_levels[l], plan.slot_offsets[l]], b]))
        # no band is more than a segment a rank above an even share
        assert np.diff(b).max() <= -(-H * W // G) + fast.COLLECT_SEGMENT


@pytest.mark.parametrize("shape,n_features", [((480, 640), 1000), ((512, 512), 1500),
                                              ((240, 960), 1000)])
def test_select_plan_tables(shape, n_features):
    """K17's host plan: per level the launch table's row, and the per-axis
    path-code tables, whose px[x] | py[y] is the quadtree path code of
    every pixel of the level's box (coordinates outside it clamped, as the
    kernel clamps them); the cell tables of the levels with more depth-7
    cells than the shared table holds get disjoint workspace ranges."""
    ex = ORBExtractor(ORBConfig(n_features=n_features), shape, "cpu")
    plan = ex.select_plan
    L = len(ex.levels)
    table = plan.table
    assert list(table[:2]) == [L, plan.n_out]
    rows = table[4:].reshape(L, 14)
    assert table[2] == 512 * max(r[11] for r in rows) and table[3] >= max(k for k, _, _ in
                                                                           ex.levels)
    ws_end = 0
    for lvl, ((k, cap, tree), row) in enumerate(zip(ex.levels, rows)):
        assert list(row[:9]) == [k, sum(x[0] for x in ex.levels[:lvl]), cap,
                                 sum(x[1] for x in ex.levels[:lvl]), ex.budgets[lvl],
                                 fast.MIN_BORDER, fast.MIN_BORDER, tree.width, tree.height]
        assert row[11] == tree.n_cx[0]
        assert np.float32(ex.scales[lvl]).view(np.int32) == row[13]
        big = tree.n_cx[0] * 4 ** octree.D_MAX > fext.SELECT_TAB_CAP
        assert (row[12] >= 0) == big
        if big:
            assert row[12] == ws_end
            ws_end += tree.n_cx[0] * 4 ** octree.D_MAX
        px = plan.tables[row[9]:row[9] + tree.width]
        py = plan.tables[row[10]:row[10] + tree.height]
        xs = torch.arange(-3, tree.width + 3, dtype=torch.int32)
        ys = torch.arange(-3, tree.height + 3, dtype=torch.int32)
        gx, gy = torch.meshgrid(xs, ys, indexing="ij")
        want = octree.path_code(gx.reshape(-1), gy.reshape(-1), tree)
        got = px[gx.reshape(-1).clamp(0, tree.width - 1).long()] | \
            py[gy.reshape(-1).clamp(0, tree.height - 1).long()]
        assert torch.equal(got, want)
        assert int(want.max()) < tree.n_cx[0] * 4 ** octree.D_MAX
    assert plan.ws_ints == ws_end
    assert (ws_end > 0) == (shape == (240, 960))


def _select_case(case: str, dev):
    """(extractor, candidates) for K17 at its edges: budgets of 1 (depth 0
    on every level) or 10^6 (depth 7), forty candidates of every level on
    a 3-pixel square with one response, no valid candidate, a noise
    frame's candidates (every level's far above its capacity) at 640x480
    and at 512x512 / 1500, and a 240x960 frame at depth 7, whose level 0
    keeps its cell table in the workspace."""
    rng = np.random.default_rng(12)
    shape, n_features = {"noise_512": ((512, 512), 1500), "wide_depth_7": ((240, 960), 1000)
                         }.get(case, ((480, 640), 1000))
    ex = ORBExtractor(ORBConfig(n_features=n_features), shape, dev)
    budgets = {"depth_0": 1, "depth_7": 10 ** 6, "wide_depth_7": 10 ** 6}.get(case)
    if budgets is not None:
        ex.budgets = [budgets] * len(ex.levels)
        ex.select_plan = fext.SelectPlan(ex.levels, ex.budgets, ex.scales, ex.capacity,
                                         fast.MIN_BORDER, dev)
    if case.startswith("noise"):
        img = T(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
        pk = pyramid.compute_pyramid(img, ex.pyr_plan)
        return ex, fast.collect_levels(*fast.fast_detect(pk, ex.fast_plan), ex.collect_plan)
    xys, resps, valids = [], [], []
    for k, _, tree in ex.levels:
        x = rng.integers(MIN_B, MIN_B + tree.width, k)
        y = rng.integers(MIN_B, MIN_B + tree.height, k)
        resp = rng.integers(7, 255, k)
        valid = rng.random(k) < 0.9
        if case == "equal_resp_one_cell":
            x[:40], y[:40] = MIN_B + 30 + rng.integers(0, 3, 40), MIN_B + 20 + rng.integers(0, 3, 40)
            resp[:40], valid[:40] = 50, True
        elif case == "no_valid":
            valid[:] = False
        xys.append(np.stack([x, y], -1))
        resps.append(resp)
        valids.append(valid)
    cat = lambda a, dt: T(np.concatenate(a).astype(dt)).to(dev)
    return ex, (cat(xys, np.int32), cat(resps, np.int32), cat(valids, bool))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["depth_0", "depth_7", "equal_resp_one_cell", "no_valid",
                                  "noise_640", "noise_512", "wide_depth_7"])
def test_select_kernel_cases(case, cuda_device):
    """K17 bit-equal to its plain version (held to JAX by the CPU cases
    above) at its edges, in one launch."""
    from extractorb_tpu_torch import kernels
    ex, cand = _select_case(case, cuda_device)
    before = kernels.LAUNCHES["octree_select"]
    got = fext.select_keypoints(*cand, ex)
    assert kernels.LAUNCHES["octree_select"] == before + 1
    want = fext.select_keypoints_plain(*cand, ex)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    depth = want.depth.cpu().numpy()
    if case in ("depth_0", "depth_7", "wide_depth_7"):
        assert (depth == {"depth_0": 0}.get(case, 7)).all()
    if case == "no_valid":
        assert not bool(want.valid.any())
    if case.startswith("noise"):
        assert int(want.valid.sum()) > 0.9 * ex.cfg.n_features


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_features", [((240, 320), 1000), ((480, 640), 1000),
                                              ((512, 512), 1500)])
def test_glue_kernels_match_plain(shape, n_features, cuda_device):
    """K15, K16 and K17 bit-equal to their plain versions on a rendered,
    a noise and a black frame; K18 on both claim rules."""
    H, W = shape
    rng = np.random.default_rng(9)
    imgs, _, _ = pf.render_sequence(pf.procedural_texture(), 1, width=W, height=H)
    ex = ORBExtractor(ORBConfig(n_features=n_features), shape, cuda_device)
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
