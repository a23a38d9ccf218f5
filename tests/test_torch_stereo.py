"""The PyTorch port's stereo match (K9's plain version) against the JAX
``compute_stereo_matches``, and the pyramid the extractor hands it.

Rendered pairs of the two-plane scene (right camera 0.1 m along the left
camera's x axis) at 320x240 and 640x480 with 1000 features, and seeded
synthetic cases for the edges: rows with no candidate, no match at all
(n_ok = 0), tied Hamming distances and tied SADs, and a disparity at
zero (clamped to 0.01 px).  ``valid`` must be bit-equal, and so must
``u_right`` and ``depth`` on the valid slots.  The card-only tests hold
K9 bit-equal to the plain version on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import port_fixtures as pf
from extractorb_tpu.frontend import stereo as jstereo
from extractorb_tpu.frontend.pyramid import compute_pyramid as j_compute_pyramid
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.frontend import stereo
from extractorb_tpu_torch.frontend.extractor import ORBExtractor, scale_factors
from extractorb_tpu_torch.frontend.pyramid import PyramidPlan, compute_pyramid
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

BASELINE = 0.1
SIZES = [(320, 240), (640, 480)]


def _rig(W):
    f = float(pf.camera_matrix(W, 1)[0, 0])
    return f * BASELINE, BASELINE   # bf, b


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def pair(request):
    """Left/right features and pyramids of frame 0 of a rendered rig."""
    W, H = request.param
    left, right, depths, _ = pf.render_stereo_sequence(pf.procedural_texture(), 1, 0.04, W, H)
    ext = ORBExtractor(ORBConfig(n_features=1000), (H, W), "cpu")
    fl, pl = ext.extract_with_pyramid(torch.from_numpy(left[0]))
    fr, pr = ext.extract_with_pyramid(torch.from_numpy(right[0]))
    return dict(ext=ext, fl=fl, fr=fr, pl=pl, pr=pr, left=left[0], depth=depths[0],
                rig=_rig(W), size=(W, H))


def _args(fl, fr, pl, pr):
    return (fl.xy, fl.octave, fl.desc, fl.valid, fr.xy, fr.octave, fr.desc, fr.valid, pl, pr)


def _jax(xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r, pl, pr, sf, bf, b):
    J = lambda t: jnp.asarray(t.numpy())
    r = jstereo.compute_stereo_matches(J(xy_l), J(oct_l), J(desc_l), J(valid_l), J(xy_r),
                                       J(oct_r), J(desc_r), J(valid_r),
                                       tuple(J(v) for v in pl.levels),
                                       tuple(J(v) for v in pr.levels), tuple(sf), bf, b)
    return np.asarray(r.u_right), np.asarray(r.depth), np.asarray(r.valid)


def _assert_equal(got, want_ur, want_depth, want_valid):
    np.testing.assert_array_equal(got.valid.cpu().numpy(), want_valid)
    v = want_valid
    np.testing.assert_array_equal(got.u_right.cpu().numpy()[v], want_ur[v])
    np.testing.assert_array_equal(got.depth.cpu().numpy()[v], want_depth[v])
    assert (got.u_right.cpu().numpy()[~v] == -1).all() and (got.depth.cpu().numpy()[~v] == -1).all()


def test_extractor_pyramid_bit_equal_to_jax(pair):
    """The bordered levels the extractor exposes are the JAX pyramid's, and
    the features are ``__call__``'s."""
    ext, pl = pair["ext"], pair["pl"]
    want = j_compute_pyramid(jnp.asarray(pair["left"]), 8, 1.2)
    assert len(pl.levels) == len(want) == 8
    for lvl, (got, w) in enumerate(zip(pl.levels, want)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=f"level {lvl}")
        off, (hb, wb) = ext.pyr_plan.offsets[lvl], ext.pyr_plan.shapes[lvl]
        np.testing.assert_array_equal(pl.flat[off:off + hb * wb].view(hb, wb).numpy(),
                                      np.asarray(w))
    again = ext(torch.from_numpy(pair["left"]))
    for name in ("xy", "octave", "desc", "valid", "angle"):
        assert torch.equal(getattr(again, name), getattr(pair["fl"], name)), name


def test_stereo_matches_bit_equal_to_jax(pair):
    bf, b = pair["rig"]
    sf = pair["ext"].scales
    args = _args(pair["fl"], pair["fr"], pair["pl"], pair["pr"])
    got = stereo.compute_stereo_matches(*args, pair["ext"].pyr_plan, sf, bf, b)
    _assert_equal(got, *_jax(*args, sf, bf, b))
    # most left keypoints find their match, at the renderer's depth
    valid = got.valid.numpy()
    assert valid.sum() > 0.5 * pair["fl"].valid.sum()
    W, H = pair["size"]
    xy = pair["fl"].xy.numpy()[valid]
    truth = pair["depth"][np.clip(np.rint(xy[:, 1]).astype(int), 0, H - 1),
                          np.clip(np.rint(xy[:, 0]).astype(int), 0, W - 1)]
    assert np.median(np.abs(got.depth.numpy()[valid] - truth) / truth) < 0.05


# ----------------------------------------------------------- edge cases

W_E, H_E = 160, 120
SCALES = tuple(float(s) for s in scale_factors(ORBConfig(n_levels=4)))
EDGES = ["no-candidate", "no-match", "hamming-ties", "sad-ties", "zero-disparity"]


def _edge_case(name: str, seed: int):
    """Seeded synthetic inputs for one edge case: the 10 stereo arguments,
    the plan, bf and b.

    no-candidate: half the rows see no right keypoint in their band.
    no-match: every distance is 256, so n_ok = 0.
    hamming-ties: the zero-disparity set with each right keypoint repeated
    6 px to the left at the same distance; the first index must win.
    sad-ties: flat images, every SAD ties at 0 (the first shift wins).
    zero-disparity: right = left up to a symmetric bump, octave-0 keypoints
    on the symmetry axes of a triangle wave, so the parabola is centred:
    disparity exactly 0, clamped to 0.01 px."""
    rng = np.random.default_rng(seed)
    plan = PyramidPlan(W_E, H_E, 4, 1.2, "cpu")
    n = 96
    desc_l = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    flips = (rng.integers(0, 2, (n, 32)) << rng.integers(0, 8, (n, 32))).astype(np.uint8)
    desc_r = desc_l ^ np.where(rng.random((n, 32)) < 0.5, flips, 0).astype(np.uint8)
    valid_l, valid_r = rng.random(n) < 0.95, rng.random(n) < 0.95
    if name in ("hamming-ties", "zero-disparity"):
        rows = rng.integers(0, 256, (H_E, 1))
        tri = np.abs(np.arange(W_E) % 8 - 4)[None, :]
        img_l = np.clip(rows // 2 + 20 * tri, 0, 255).astype(np.uint8)
        # a bump symmetric about the same axes keeps the SADs off zero (a
        # zero median would cut every match)
        img_r = img_l + 3 * np.isin(np.arange(W_E) % 8, (3, 5)).astype(np.uint8)[None, :]
        oct_l = np.zeros(n, np.int32)
        u = (8 * rng.integers(3, 16, n) + 4).astype(np.float32)
        shift = 0
    else:
        img_l = rng.integers(0, 256, (H_E, W_E)).astype(np.uint8)
        shift = 3
        img_r = np.roll(img_l, -shift, axis=1)     # right u = left u - shift
        if name == "sad-ties":
            img_l = np.full((H_E, W_E), 90, np.uint8)
            img_r = img_l.copy()
        oct_l = rng.integers(0, 4, n).astype(np.int32)
        u = rng.integers(24, 60, n).astype(np.float32)
    s = np.asarray(SCALES, np.float32)[oct_l]
    v = rng.integers(22, 42, n).astype(np.float32)
    # integer coordinates on each keypoint's level, >= 19 px inside it
    xy_l = np.stack([u * s, v * s], -1).astype(np.float32)
    xy_r = xy_l - np.array([shift, 0], np.float32)
    oct_r = oct_l.copy()
    if name == "no-candidate":
        xy_r[: n // 2, 1] += 40.0
    if name == "no-match":
        desc_r = 255 - desc_l
    if name == "hamming-ties":
        xy_r = np.concatenate([xy_r, xy_r - np.array([6, 0], np.float32)])
        desc_r, oct_r, valid_r = (np.concatenate([a, a]) for a in (desc_r, oct_r, valid_r))
    t = torch.from_numpy
    args = (t(xy_l), t(oct_l), t(desc_l), t(valid_l), t(xy_r), t(oct_r), t(desc_r), t(valid_r),
            compute_pyramid(t(img_l), plan), compute_pyramid(t(img_r), plan))
    return args, plan, 50.0, 0.1


@pytest.mark.parametrize("name", EDGES)
@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_edge_cases_bit_equal_to_jax(name, seed):
    args, plan, bf, b = _edge_case(name, seed)
    got = stereo.compute_stereo_matches(*args, plan, SCALES, bf, b)
    _assert_equal(got, *_jax(*args, SCALES, bf, b))
    valid = got.valid.numpy()
    if name in ("no-match", "sad-ties"):
        assert not valid.any()
    elif name == "no-candidate":
        assert not valid[: len(valid) // 2].any() and valid[len(valid) // 2:].any()
    elif name == "zero-disparity":
        assert valid.sum() > len(valid) // 2
        assert (got.depth.numpy()[valid] == np.float32(bf) / np.float32(0.01)).all()
        assert (got.u_right.numpy()[valid] == args[0].numpy()[valid, 0] - np.float32(0.01)).all()
    elif name == "hamming-ties":
        # the repeated keypoints 6 px left would fail the SAD search: the
        # first index won every tie
        ref = stereo.compute_stereo_matches(*_edge_case("zero-disparity", seed)[0], plan,
                                            SCALES, bf, b)
        for a, c in zip(got, ref):
            assert torch.equal(a, c)


# ------------------------------------------------------------ card only


@pytest.mark.gpu
@pytest.mark.parametrize("name", EDGES + ["rendered"])
def test_stereo_match_kernel_matches_plain(name, cuda_device):
    if name == "rendered":
        W, H = 640, 480
        left, right, _, _ = pf.render_stereo_sequence(pf.procedural_texture(), 1, 0.04, W, H)
        ext = ORBExtractor(ORBConfig(n_features=1000), (H, W), cuda_device)
        fl, pl = ext.extract_with_pyramid(torch.from_numpy(left[0]))
        fr, pr = ext.extract_with_pyramid(torch.from_numpy(right[0]))
        args, plan, sf, (bf, b) = _args(fl, fr, pl, pr), ext.pyr_plan, ext.scales, _rig(W)
    else:
        args, plan, bf, b = _edge_case(name, 0)
        args = tuple(a.to(cuda_device) for a in args[:8]) + tuple(
            p._replace(flat=p.flat.to(cuda_device)) for p in args[8:])
        sf = SCALES
    before = kernels.LAUNCHES["stereo_match"]
    got = stereo.compute_stereo_matches(*args, plan, sf, bf, b)
    assert kernels.LAUNCHES["stereo_match"] == before + 1
    want = stereo.compute_stereo_matches_plain(*args, plan, sf, bf, b)
    torch.cuda.synchronize()
    _assert_equal(got, want.u_right.cpu().numpy(), want.depth.cpu().numpy(),
                  want.valid.cpu().numpy())
