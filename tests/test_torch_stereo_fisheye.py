"""The fisheye rig's stereo match and triangulation: the port's plain
``lapping_mask``, ``triangulate_matches`` and
``compute_stereo_fisheye_matches`` against the JAX functions, and (``-m
gpu``) kernel K26 against the plain version.

Inputs: ``tests/test_stereo_fisheye.py``'s synthetic rig (TUM-VI's 512x512
KB8 camera on both sides, a 0.101 m baseline, points 1-3.5 m away), the same
scene with the right camera turned 0.8 degrees about y (R_rl != I), and the
match scene of ``test_compute_stereo_fisheye_matches`` (random descriptors,
the right ones permuted), also with a lapping band of [100, 400] on both
sides and with duplicated right descriptors (two equal best distances).

Held: the lapping masks, the best column before the gates and the
candidate mask (TH_ORB and the ratio test) bit-equal; ``valid`` equal
except on rows within 1e-4 (relative) of a gate, at most 1% of the rows;
p3d and depth within 1e-4 relative on the rows valid in both.  On the card
K26's integer outputs are bit-equal to the plain version's, p3d within
1e-5 relative on the rows valid in both, and the rows whose validity
differs sit within 1e-4 of a gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
import test_stereo_fisheye as tsf
from extractorb_tpu.core import camera as jcam
from extractorb_tpu.frontend import matcher as jmatcher
from extractorb_tpu.frontend import stereo as jstereo
from extractorb_tpu_torch.core import camera as pcam
from extractorb_tpu_torch.frontend import stereo as pstereo
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

GATE_EDGE = 1e-4
T = lambda a: torch.from_numpy(np.array(a))


def port_camera():
    c = tsf.TUMVI
    return pcam.KannalaBrandt8(c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.k3, c.k4)


def rig(rng, n, rotated: bool):
    """``test_stereo_fisheye._rig``'s scene; ``rotated`` turns the right
    camera 0.8 degrees about y."""
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = tsf._rig(rng, n)
    if rotated:
        R_rl = pf.so3_exp_np([0.0, np.deg2rad(0.8), 0.0]).astype(np.float32)
        uv_r = np.asarray(cam_r.project(jnp.asarray(pts @ R_rl.T + t_rl)))
    return cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r


def assert_valid_and_points(vp, vj, pp, pj, dp, dj, margin, rtol=1e-4):
    """valid equal but on gate-edge rows (at most 1%); p3d and depth within
    ``rtol`` relative on the rows valid in both."""
    differ = vp != vj
    assert (margin[differ] < GATE_EDGE).all(), margin[differ]
    assert differ.mean() <= 0.01, differ.sum()
    both = vp & vj
    scale = np.linalg.norm(pj[both], axis=1)
    assert (np.abs(pp[both] - pj[both]).max(1) <= rtol * scale).all()
    assert (np.abs(dp[both] - dj[both]) <= rtol * scale).all()


def test_lapping_mask_matches_jax(rng):
    xy = np.concatenate([[[10.0, 0.0], [100.0, 0.0], [300.0, 0.0], [400.0, 5.0]],
                         rng.uniform(0, 512, (60, 2))]).astype(np.float32)
    valid = np.ones(len(xy), bool)
    valid[2] = False
    for lo, hi in ((50.0, 400.0), (0.0, 512.0), (100.0, 400.0)):
        j = np.asarray(jstereo.lapping_mask(jnp.asarray(xy), lo, hi, jnp.asarray(valid)))
        p = pstereo.lapping_mask(T(xy), lo, hi, T(valid)).numpy()
        np.testing.assert_array_equal(p, j)
    assert pstereo.lapping_mask(T(xy[:3]), 50.0, 400.0, T(valid[:3])).tolist() == \
        [False, True, False]


@pytest.mark.parametrize("case", ["rig", "rotated", "shuffled", "zero-parallax"])
def test_triangulate_matches_matches_jax(rng, case):
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = rig(rng, 300, case == "rotated")
    if case == "shuffled":
        uv_r = uv_r[rng.permutation(len(uv_r))]
    if case == "zero-parallax":
        uv_r, t_rl = uv_l, np.zeros(3, np.float32)
    s2 = np.full(len(pts), 1.44, np.float32)
    pj, dj, vj = (np.asarray(a) for a in jcam.triangulate_matches(
        cam_l, cam_r, jnp.asarray(uv_l), jnp.asarray(uv_r), jnp.asarray(R_rl),
        jnp.asarray(t_rl), s2, s2))
    cam = port_camera()
    args = (cam, cam, T(uv_l), T(uv_r), T(R_rl), T(t_rl))
    pp, dp, vp = (a.numpy() for a in pcam.triangulate_matches(*args, T(s2), T(s2)))
    margin = pcam.triangulation_gate_margin(pcam.triangulation_terms(*args), T(s2),
                                            T(s2)).numpy()
    assert_valid_and_points(vp, vj, pp, pj, dp, dj, margin)
    if case in ("rig", "rotated"):
        assert vp.mean() > 0.9
        np.testing.assert_allclose(pp[vp], pts[vp], rtol=2e-2, atol=2e-2)
    else:
        assert vp.mean() < 0.05


def match_scene(rng, case):
    """``test_compute_stereo_fisheye_matches``'s inputs: the rig's 128
    points, random descriptors, the right side permuted; per case a rotated
    rig, a lapping band of [100, 400], or duplicated right descriptors."""
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = rig(rng, 128, case == "rotated")
    n = len(pts)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    perm = rng.permutation(n)
    desc_r, uv_r = desc[perm].copy(), uv_r[perm]
    octv = rng.integers(0, 3, n).astype(np.int32)
    if case == "ties":
        desc_r[1::7] = desc_r[0::7][:len(desc_r[1::7])]   # equal best distances
        desc_r[2::5, :3] ^= 0x5a                          # near matches
    lap_band = (100.0, 400.0) if case == "band" else (0.0, 512.0)
    valid = np.ones(n, bool)
    lap_l = np.asarray(jstereo.lapping_mask(jnp.asarray(uv_l), *lap_band, jnp.asarray(valid)))
    lap_r = np.asarray(jstereo.lapping_mask(jnp.asarray(uv_r), *lap_band, jnp.asarray(valid)))
    sigma2 = np.array([1.2 ** (2 * k) for k in range(8)], np.float32)
    return (cam_l, cam_r, uv_l, octv, desc, lap_l, uv_r, octv[perm].copy(), desc_r, lap_r,
            R_rl, t_rl, sigma2, pts, perm)


def jax_best_and_candidates(desc_l, lap_l, desc_r, lap_r, ratio=0.7):
    """The JAX function's best column and candidate mask (its intermediate
    values, ``frontend/stereo.py:211-223``)."""
    d = jnp.where(jnp.asarray(lap_l)[:, None] & jnp.asarray(lap_r)[None, :],
                  jmatcher.hamming_matrix(jnp.asarray(desc_l), jnp.asarray(desc_r)), 1 << 20)
    best, best_idx = jnp.min(d, axis=1), jnp.argmin(d, axis=1)
    second = jnp.min(jnp.where(jnp.arange(d.shape[1])[None, :] == best_idx[:, None], 1 << 20, d),
                     axis=1)
    cand = (best < jstereo.TH_ORB) & (best.astype(jnp.float32) < ratio *
                                      second.astype(jnp.float32))
    return np.asarray(best_idx), np.asarray(cand)


def port_inputs(scene, dev="cpu"):
    (_, _, uv_l, oct_l, desc, lap_l, uv_r, oct_r, desc_r, lap_r, R_rl, t_rl, sigma2, _, _) = scene
    cam = port_camera()
    t = lambda a: T(a).to(dev)
    return (cam, cam, t(uv_l), t(oct_l), t(desc), t(lap_l), t(uv_r), t(oct_r), t(desc_r),
            t(lap_r), R_rl, t_rl, sigma2)


@pytest.mark.parametrize("case", ["rig", "rotated", "band", "ties"])
def test_compute_stereo_fisheye_matches_matches_jax(rng, case):
    scene = match_scene(rng, case)
    (cam_l, cam_r, uv_l, oct_l, desc, lap_l, uv_r, oct_r, desc_r, lap_r, R_rl, t_rl, sigma2,
     pts, perm) = scene
    jres = jstereo.compute_stereo_fisheye_matches(
        cam_l, cam_r, jnp.asarray(uv_l), jnp.asarray(oct_l), jnp.asarray(desc),
        jnp.asarray(lap_l), jnp.asarray(uv_r), jnp.asarray(oct_r), jnp.asarray(desc_r),
        jnp.asarray(lap_r), jnp.asarray(R_rl), jnp.asarray(t_rl), sigma2)
    pres = pstereo.compute_stereo_fisheye_matches(*port_inputs(scene))
    jbest, jcand = jax_best_and_candidates(desc, lap_l, desc_r, lap_r)
    np.testing.assert_array_equal(pres.best_idx.numpy(), jbest)
    np.testing.assert_array_equal(pres.candidate.numpy(), jcand)
    vp, vj = pres.valid.numpy(), np.asarray(jres.valid)
    cam = port_camera()
    bi = pres.best_idx.long()
    s2 = T(sigma2)
    terms = pcam.triangulation_terms(cam, cam, T(uv_l), T(uv_r)[bi], T(R_rl), T(t_rl))
    margin = pcam.triangulation_gate_margin(terms, s2[T(oct_l).long()],
                                            s2[T(oct_r).long()[bi]]).numpy()
    assert_valid_and_points(vp, vj, pres.p3d.numpy(), np.asarray(jres.p3d),
                            pres.depth.numpy(), np.asarray(jres.depth), margin)
    same = vp == vj
    np.testing.assert_array_equal(pres.right_idx.numpy()[same], np.asarray(jres.right_idx)[same])
    if case == "ties":
        # left rows with two equal best columns (both exact copies)
        dup = (desc[:, None, :] == desc_r[None, :, :]).all(-1).sum(1) >= 2
        assert dup.sum() >= 10
        assert not jcand[dup].any() and not pres.candidate.numpy()[dup].any()
    else:
        assert vp.mean() > (0.5 if case == "band" else 0.85)
        assert (perm[pres.right_idx.numpy()[vp]] == np.arange(len(perm))[vp]).all()
    if case == "band":
        assert not vp[~lap_l].any() and vp.sum() < lap_l.sum() + 1


@pytest.mark.gpu
def test_k26_matches_plain(cuda_device, rng):
    """K26 against its plain version on the card, on the scenes above and
    at the tracker's shape (1628 slots a side)."""
    dev = cuda_device
    scenes = [match_scene(rng, c) for c in ("rig", "rotated", "band", "ties")]
    for scene in scenes:
        args = port_inputs(scene, dev)
        k = pstereo.compute_stereo_fisheye_matches(*args)
        p = pstereo.compute_stereo_fisheye_matches_plain(*args)
        for a, b in ((k.best_idx, p.best_idx), (k.candidate, p.candidate)):
            assert torch.equal(a.cpu(), b.to(a.dtype).cpu())
        vk, vp = k.valid.cpu().numpy(), p.valid.cpu().numpy()
        both = vk & vp
        pk, pp = k.p3d.cpu().numpy(), p.p3d.cpu().numpy()
        scale = np.linalg.norm(pp[both], axis=1)
        assert (np.abs(pk[both] - pp[both]).max(1) <= 1e-5 * scale).all()
        assert (vk != vp).sum() <= max(1, 0.01 * len(vk))
        np.testing.assert_array_equal(k.right_idx.cpu().numpy()[vk == vp],
                                      p.right_idx.cpu().numpy()[vk == vp])
