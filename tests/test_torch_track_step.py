"""The PyTorch port's monocular TrackStep (plain path) against the JAX step.

A 320x240 rendering of the two-plane scene, 500 features; the map is
seeded from frame 0's keypoints with the true depth.  At every frame both
steps get byte-identical numpy state (the port's previous output) and
must agree: pose within 1e-3 (m and rad) and >= 98% of the per-keypoint
map-point ids.  chip_smoke.track_sequence then tracks the full-size 640x480,
1000-feature sequence on the CPU and must meet the thresholds that
``chip_smoke.py`` holds the card to.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.slam import track_device as jtd
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.frontend.extractor import ORBExtractor
from extractorb_tpu_torch.slam.track_device import TrackStep, get_track_step
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

W, H = 320, 240
N_FRAMES = 4
MAP_CAP, LOCAL_CAP = 4096, 1024
FEATURE_FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _jax_out(out):
    out = jax.tree_util.tree_map(np.asarray, out)
    d = {f"feats.{k}": getattr(out.feats, k) for k in FEATURE_FIELDS}
    d.update({k: getattr(out, k) for k in ("R", "t", "kp_mp", "n_inl_final", "used_ref",
                                           "n_match_motion", "n_pre", "lm_searched")})
    return d


@pytest.fixture(scope="module")
def scene():
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES,
                                               width=W, height=H)
    cam = chip_smoke.camera_config(W, H)
    port = TrackStep(cam, ORBConfig(n_features=500), (H, W), MAP_CAP, LOCAL_CAP, "cpu")
    jcam = JCameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W, height=H)
    jstep = jtd.get_track_step(jcam, JORBConfig(n_features=500), (H, W), MAP_CAP, LOCAL_CAP,
                               depth_mode="none")
    f0 = interop.to_numpy(port.extractor(torch.from_numpy(frames[0])))
    kp_mp, map_pos, map_valid, local, ref = pf.seed_map(
        f0["xy"], f0["octave"], f0["valid"], f0["desc"], depths[0], poses[0],
        pf.camera_matrix(W, H), port.scale_factors, MAP_CAP, LOCAL_CAP)
    state = dict(last=dict(xy_un=f0["xy"], desc=f0["desc"], octave=f0["octave"],
                           angle=f0["angle"]),
                 kp_mp=kp_mp, map_pos=map_pos, map_valid=map_valid, local=local, ref=ref)
    return dict(frames=frames, poses=poses, port=port, jstep=jstep, f0=f0, state=state)


def _inputs(img, st, pose_last, pose_prev):
    return interop.step_inputs_from_numpy(img, st["last"], st["kp_mp"], st["map_pos"],
                                          st["map_valid"], st["local"], st["ref"],
                                          *pose_last, *pose_prev, "cpu")


def _both(sc, args):
    port = interop.to_numpy(sc["port"](*args))
    jax_ = _jax_out(sc["jstep"](*[jnp.asarray(a.numpy()) for a in args]))
    return port, jax_


@pytest.fixture(scope="module")
def chain(scene):
    """Frames 1..3, each step fed the port's previous output (numpy) on
    both sides."""
    st = dict(scene["state"])
    pose_prev, pose_last = pf.true_pose(-1), scene["poses"][0]
    out = []
    for k in range(1, N_FRAMES):
        p, j = _both(scene, _inputs(scene["frames"][k], st, pose_last, pose_prev))
        out.append((p, j))
        st["last"] = dict(xy_un=p["xy_un"], desc=p["feats.desc"], octave=p["feats.octave"],
                          angle=p["feats.angle"])
        st["kp_mp"] = p["kp_mp"]
        pose_prev, pose_last = pose_last, (p["R"], p["t"])
    return out


def _assert_agree(p, j):
    np.testing.assert_allclose(p["R"], j["R"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(p["t"], j["t"], atol=1e-3, rtol=0)
    assert (p["kp_mp"] == j["kp_mp"]).mean() >= 0.98
    for k in FEATURE_FIELDS:
        np.testing.assert_array_equal(p[f"feats.{k}"], j[f"feats.{k}"], err_msg=k)


def test_frame0_features_identical(scene):
    # the JAX step's extraction of frame 0 (its other outputs are unused)
    st = scene["state"]
    args = _inputs(scene["frames"][0], st, scene["poses"][0], scene["poses"][0])
    j = _jax_out(scene["jstep"](*[jnp.asarray(a.numpy()) for a in args]))
    for k in FEATURE_FIELDS:
        np.testing.assert_array_equal(scene["f0"][k], j[f"feats.{k}"], err_msg=k)
    # interop round trip of the same features
    back = interop.to_numpy(interop.features_from_numpy(scene["f0"], "cpu"))
    for k in FEATURE_FIELDS:
        np.testing.assert_array_equal(back[k], scene["f0"][k], err_msg=k)


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_step_matches_jax(chain, scene, frame):
    p, j = chain[frame - 1]
    _assert_agree(p, j)
    assert not p["used_ref"] and not j["used_ref"]
    assert pf.camera_centre_error(p["R"], p["t"], scene["poses"][frame]) < pf.MAX_CENTER_ERR


def test_reference_keyframe_fallback_matches_jax(scene):
    """No association carried from the last frame: the motion-model
    search finds nothing and both steps take the reference-KF branch."""
    st = dict(scene["state"])
    st["kp_mp"] = np.full_like(st["kp_mp"], -1)
    p, j = _both(scene, _inputs(scene["frames"][1], st, scene["poses"][0],
                                pf.true_pose(-1)))
    assert p["used_ref"] and j["used_ref"]
    assert int(p["n_pre"]) == int(j["n_pre"]) > 50
    _assert_agree(p, j)


def test_step_chained_from_init_capacity_frame():
    """The first fused step after initialisation chains from the init
    extractor's frame: 5x the features, 5128 slots at 640x480
    (slam/tracking.py:461-466 of the JAX package).  The step runs 1000
    features (1128 slots); the reference block holds the tracker's 1128
    rows."""
    w, h = 640, 480
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), 2, width=w, height=h)
    cfg = ORBConfig(n_features=1000)
    init_ex = ORBExtractor(dataclasses.replace(cfg, n_features=5000), (h, w), "cpu")
    f0 = interop.to_numpy(init_ex(torch.from_numpy(frames[0])))
    assert f0["valid"].shape == (5128,)
    kp_mp, map_pos, map_valid, local, _ = pf.seed_map(
        f0["xy"], f0["octave"], f0["valid"], f0["desc"], depths[0], poses[0],
        pf.camera_matrix(w, h), init_ex.scales, MAP_CAP, 2 * LOCAL_CAP)
    idx = np.where(f0["valid"] & (kp_mp >= 0))[0][:1128]
    ref = dict(desc=np.zeros((1128, 32), np.uint8), valid=np.zeros(1128, bool),
               kp_mp=np.full(1128, -1, np.int32))
    ref["desc"][:len(idx)], ref["valid"][:len(idx)] = f0["desc"][idx], True
    ref["kp_mp"][:len(idx)] = kp_mp[idx]
    st = dict(last=dict(xy_un=f0["xy"], desc=f0["desc"], octave=f0["octave"], angle=f0["angle"]),
              kp_mp=kp_mp, map_pos=map_pos, map_valid=map_valid, local=local, ref=ref)
    cam = chip_smoke.camera_config(w, h)
    port = TrackStep(cam, cfg, (h, w), MAP_CAP, 2 * LOCAL_CAP, "cpu")
    jcam = JCameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=w, height=h)
    jstep = jtd.get_track_step(jcam, JORBConfig(n_features=1000), (h, w), MAP_CAP,
                               2 * LOCAL_CAP, depth_mode="none")
    args = _inputs(frames[1], st, poses[0], pf.true_pose(-1))
    p = interop.to_numpy(port(*args))
    j = _jax_out(jstep(*[jnp.asarray(a.numpy()) for a in args]))
    _assert_agree(p, j)
    assert p["feats.valid"].shape == (1128,) and not p["used_ref"]
    assert pf.camera_centre_error(p["R"], p["t"], poses[1]) < pf.MAX_CENTER_ERR


def test_get_track_step_caches_per_configuration():
    cam, orb = chip_smoke.camera_config(W, H), ORBConfig(n_features=500)
    step = get_track_step(cam, orb, (H, W), MAP_CAP, LOCAL_CAP, "cpu")
    assert get_track_step(cam, orb, [H, W], MAP_CAP, LOCAL_CAP, torch.device("cpu")) is step
    other = get_track_step(cam, orb, (H, W), MAP_CAP, 2 * LOCAL_CAP, "cpu")
    assert other is not step and other.local_cap == 2 * LOCAL_CAP
    assert step.capacity == 500 + 8 * 16


def test_full_size_sequence_meets_chip_thresholds():
    """chip_smoke.track_sequence on the CPU: 640x480, 1000 features, 12 steps."""
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), chip_smoke.N_FRAMES,
                                               chip_smoke.SPEED, 640, 480)
    step = TrackStep(chip_smoke.camera_config(640, 480), ORBConfig(n_features=1000),
                     (480, 640), chip_smoke.MAP_CAP, chip_smoke.LOCAL_CAP, "cpu")
    results = chip_smoke.track_sequence(step, frames, depths, poses,
                                        pf.true_pose(-1, chip_smoke.SPEED), "cpu")
    chip_smoke.check_sequence(results, poses)


@pytest.mark.gpu
def test_step_on_card_matches_cpu(scene, cuda_device):
    st = scene["state"]
    args = _inputs(scene["frames"][1], st, scene["poses"][0], pf.true_pose(-1))
    cpu = interop.to_numpy(scene["port"](*args))
    card = TrackStep(scene["port"].cam_cfg, scene["port"].orb_cfg, (H, W), MAP_CAP, LOCAL_CAP,
                     cuda_device)
    gpu = interop.to_numpy(card(*(a.to(cuda_device) for a in args)))
    _assert_agree(gpu, cpu)
