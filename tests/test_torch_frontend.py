"""ORB extraction of the PyTorch port (plain path) against the JAX package.

Both run on the CPU on one rendered 320x240 frame of the procedural
two-plane scene, 500 features, 8 levels, scale 1.2.  Every integer output
must be bit-equal: pyramid pixels, FAST keep and score, collected
keypoints, quadtree keep, BRIEF bytes and the merged Features; angles
agree within 1e-4 degrees.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import port_fixtures as pf
from extractorb_tpu.config import ORBConfig
from extractorb_tpu.frontend import blur as jblur
from extractorb_tpu.frontend import brief as jbrief
from extractorb_tpu.frontend import extractor as jext
from extractorb_tpu.frontend import fast as jfast
from extractorb_tpu.frontend import octree as joctree
from extractorb_tpu.frontend import orientation as jorient
from extractorb_tpu.frontend.pyramid import compute_pyramid as j_compute_pyramid
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.frontend import blur, brief, fast, octree, orientation
from extractorb_tpu_torch.frontend.extractor import ORBExtractor, _compact
from extractorb_tpu_torch.frontend.pyramid import compute_pyramid
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

W, H = 320, 240
CFG = ORBConfig(n_features=500)
LEVELS = list(range(CFG.n_levels))


def _jax_stages(img):
    """The JAX device-octree extraction chain with its per-level
    intermediates, in one jit."""
    ex = jext.ORBExtractor(CFG, octree="device")

    def run(img):
        pyr = j_compute_pyramid(img, CFG.n_levels, CFG.scale_factor)
        out = []
        for lvl, bordered in enumerate(pyr):
            keep, score = jfast.detect_keypoints(bordered, CFG.ini_th_fast, CFG.min_th_fast)
            h, w = bordered.shape
            Hi, Wi = h - 38, w - 38
            k_lvl = min(CFG.max_kps_per_level, max(512, -(-(Hi * Wi) // 75 // 512) * 512))
            xy_all, resp_all, valid_all = jfast.collect_keypoints(keep, score, k_lvl)
            min_b = jfast.MIN_BORDER
            sel, _ = joctree.distribute_device(xy_all, resp_all, valid_all, ex.budgets[lvl],
                                               Wi - 2 * min_b, Hi - 2 * min_b, min_b, min_b)
            cap = min(CFG.max_kps_per_level, ex.budgets[lvl] + 16, k_lvl)
            xy, resp, valid = jext._compact(xy_all, resp_all, valid_all & sel, cap)
            ang = jorient.ic_angle(bordered, xy, valid)
            desc = jbrief.pack_bits_u8(
                jbrief.compute_descriptors(jblur.blur_level(bordered), xy, ang, valid))
            out.append(dict(pyr=bordered, keep=keep, score=score, xy_all=xy_all,
                            resp_all=resp_all, valid_all=valid_all, sel=sel, xy=xy,
                            resp=resp, valid=valid, angle=ang, desc=desc))
        return out, ex._extract(img, CFG.n_features + CFG.n_levels * 16)

    stages, feats = jax.jit(run)(jnp.asarray(img))
    stages = jax.tree_util.tree_map(np.array, stages)  # writable copies
    feats = {k: np.asarray(getattr(feats, k)) for k in
             ("xy", "response", "angle", "octave", "size", "desc", "valid")}
    return stages, feats


@pytest.fixture(scope="module")
def frame():
    imgs, _, _ = pf.render_sequence(pf.procedural_texture(), 1, width=W, height=H)
    return imgs[0]


@pytest.fixture(scope="module")
def jax_out(frame):
    return _jax_stages(frame)


@pytest.fixture(scope="module")
def port():
    return ORBExtractor(CFG, (H, W), "cpu")


@pytest.fixture(scope="module")
def port_pyr(frame, port):
    return compute_pyramid(torch.from_numpy(frame), port.pyr_plan)


@pytest.mark.parametrize("lvl", LEVELS)
def test_pyramid_and_fast_bit_equal(jax_out, port_pyr, port, lvl):
    stages, _ = jax_out
    j = stages[lvl]
    np.testing.assert_array_equal(port_pyr.levels[lvl].numpy(), j["pyr"])
    keep, score = fast.detect_keypoints(port_pyr.levels[lvl], CFG.ini_th_fast, CFG.min_th_fast)
    np.testing.assert_array_equal(score.numpy(), j["score"])
    np.testing.assert_array_equal(keep.numpy(), j["keep"])
    assert keep.sum() > 0, "FAST fires on every level of the procedural scene"


@pytest.mark.parametrize("lvl", LEVELS)
def test_collect_octree_compact_bit_equal(jax_out, port, lvl):
    j = jax_out[0][lvl]
    k_lvl, cap, plan = port.levels[lvl]
    xy_all, resp_all, valid_all = fast.collect_keypoints(
        torch.from_numpy(j["keep"]), torch.from_numpy(j["score"]), k_lvl)
    np.testing.assert_array_equal(xy_all.numpy(), j["xy_all"])
    np.testing.assert_array_equal(resp_all.numpy(), j["resp_all"])
    np.testing.assert_array_equal(valid_all.numpy(), j["valid_all"])
    sel, _ = octree.distribute_device(xy_all, resp_all, valid_all, port.budgets[lvl], plan)
    np.testing.assert_array_equal(sel.numpy(), j["sel"])
    xy, resp, valid = _compact(xy_all, resp_all, valid_all & sel, cap)
    np.testing.assert_array_equal(xy.numpy(), j["xy"])
    np.testing.assert_array_equal(resp.numpy(), j["resp"])
    np.testing.assert_array_equal(valid.numpy(), j["valid"])


@pytest.mark.parametrize("lvl", LEVELS)
def test_angle_blur_brief(jax_out, port_pyr, lvl):
    j = jax_out[0][lvl]
    bordered = port_pyr.levels[lvl]
    xy, valid = torch.from_numpy(j["xy"]), torch.from_numpy(j["valid"])
    ang = orientation.ic_angle(bordered, xy, valid)
    v = j["valid"]
    np.testing.assert_allclose(ang.numpy()[v], j["angle"][v], rtol=0, atol=1e-4)
    blurred = blur.blur_level(bordered)
    np.testing.assert_array_equal(blurred.numpy()[19:-19, 19:-19],
                                  np.asarray(jblur.blur_level(jnp.asarray(j["pyr"])))[19:-19, 19:-19])
    desc = brief.pack_bits_u8(brief.compute_descriptors(blurred, xy, ang, valid))
    np.testing.assert_array_equal(desc.numpy()[v], j["desc"][v])


def test_merged_features_bit_equal(jax_out, frame, port):
    _, jf = jax_out
    pf_ = interop.to_numpy(port(torch.from_numpy(frame)))
    for k in ("xy", "octave", "valid", "desc", "response", "size"):
        np.testing.assert_array_equal(pf_[k], jf[k], err_msg=k)
    np.testing.assert_allclose(pf_["angle"], jf["angle"], rtol=0, atol=1e-4)
    assert pf_["valid"].sum() >= 0.9 * CFG.n_features


def test_merged_features_bit_equal_full_size():
    """640x480, 1000 features: the TUM-style monocular setting."""
    cfg = ORBConfig(n_features=1000)
    imgs, _, _ = pf.render_sequence(pf.procedural_texture(), 1, width=640, height=480)
    jf = jext.ORBExtractor(cfg)(jnp.asarray(imgs[0]))
    got = interop.to_numpy(ORBExtractor(cfg, (480, 640), "cpu")(torch.from_numpy(imgs[0])))
    for k in ("xy", "octave", "valid", "desc", "response", "size", "angle"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jf, k)), err_msg=k)
    assert got["valid"].sum() >= 0.95 * cfg.n_features


def test_init_extractor_5x_bit_equal():
    """The tracker's init extractor: 640x480 at 5x the features (5000,
    capacity 5128, slam/tracking.py:178 of the JAX package)."""
    cfg = ORBConfig(n_features=5000)
    imgs, _, _ = pf.render_sequence(pf.procedural_texture(), 1, width=640, height=480)
    jf = jext.ORBExtractor(cfg)(jnp.asarray(imgs[0]))
    ex = ORBExtractor(cfg, (480, 640), "cpu")
    got = interop.to_numpy(ex(torch.from_numpy(imgs[0])))
    assert ex.capacity == 5128 and got["valid"].shape == (5128,)
    for k in ("xy", "octave", "valid", "desc", "response", "size", "angle"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jf, k)), err_msg=k)
    assert got["valid"].sum() >= 0.9 * cfg.n_features


@pytest.mark.gpu
def test_fast_and_describe_kernels_match_plain(frame, cuda_device):
    ex = ORBExtractor(CFG, (H, W), cuda_device)
    pyr = compute_pyramid(torch.from_numpy(frame).to(cuda_device), ex.pyr_plan)
    keep_k, score_k = fast.fast_detect(pyr, ex.fast_plan)
    keep_p, score_p = fast.fast_detect_plain(pyr, ex.fast_plan)
    for a, b in zip(keep_k + score_k, keep_p + score_p):
        assert torch.equal(a, b)
    xy = torch.cat([fast.collect_keypoints(k, s, 256)[0] for k, s in zip(keep_k, score_k)])
    valid = torch.cat([fast.collect_keypoints(k, s, 256)[2] for k, s in zip(keep_k, score_k)])
    level = torch.arange(CFG.n_levels, device=cuda_device, dtype=torch.int32).repeat_interleave(256)
    ang_k, desc_k = brief.orb_describe(pyr, ex.desc_plan, xy, level, valid)
    ang_p, desc_p = brief.orb_describe_plain(pyr, ex.desc_plan, xy, level, valid)
    assert torch.equal(desc_k, desc_p)
    assert float((ang_k - ang_p).abs().max()) <= 1e-4
    cpu = interop.to_numpy(ORBExtractor(CFG, (H, W), "cpu")(torch.from_numpy(frame)))
    gpu = interop.to_numpy(ex(torch.from_numpy(frame)))
    for k in ("xy", "octave", "valid", "desc"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
