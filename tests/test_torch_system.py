"""The port's ``System.track_monocular`` (plain path, CPU) against the JAX
``System`` on one rendered sequence.

320x240, 500 features, ``TrackingConfig(max_frames=6)``, 20 frames of
the two-plane scene at speed 0.04, from a cold map.  The port's two-view
sets are drawn with the JAX package's generator from the same integer
(``two_view.sample_sets`` patched), so both initialise from the same
hypotheses.  Both must initialise on the same frame pair, keep every
later frame OK, insert the same number of keyframes, and the port's ATE
after Sim3 alignment must stay within 1.05 x the JAX run's + 1 mm
(ROADMAP A.7).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.core import lie as jlie
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch.config import CameraConfig, IMUConfig, ORBConfig, TrackingConfig
from extractorb_tpu_torch.core import lie
from extractorb_tpu_torch.geometry import two_view
from extractorb_tpu_torch.slam.system import System
from extractorb_tpu_torch.slam.tracking import TrackState
from test_torch_two_view import jax_sets
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES, SPEED = 320, 240, 500, 20, 0.04


def first_ok(states):
    return next(k for k, s in enumerate(states) if s.name == "OK")


@pytest.fixture(scope="module")
def runs():
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H)
    cfg = chip_smoke.system_config(W, H, NF)
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                       camera=JCameraConfig(fx=cfg.camera.fx, fy=cfg.camera.fy,
                                            cx=cfg.camera.cx, cy=cfg.camera.cy, width=W, height=H),
                       tracking=JTrackingConfig(max_frames=6))
    jsys = JSystem(jcfg)
    jstates = [jsys.track_monocular(img, k / 30.0) for k, img in enumerate(frames)]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(two_view, "sample_sets",
                  lambda seed, valid, n_sets=200: torch.from_numpy(jax_sets(seed, valid, n_sets)
                                                                   .copy()))
        psys, pstates = chip_smoke.run_system(frames, torch.device("cpu"), cfg=cfg)
    return dict(poses=poses, jsys=jsys, jstates=jstates, psys=psys, pstates=pstates)


def test_same_init_pair_keyframes_and_states(runs):
    js, ps = runs["jstates"], runs["pstates"]
    k0 = first_ok(js)
    assert first_ok(ps) == k0 <= 2
    assert all(s == TrackState.OK for s in ps[k0:])
    assert all(s.name == "OK" for s in js[k0:])
    jt, pt = runs["jsys"].tracker.trajectory, runs["psys"].tracker.trajectory
    assert [ts for ts, _, _ in pt[:2]] == [ts for ts, _, _ in jt[:2]]
    assert len(pt) == len(jt) == N_FRAMES - k0 + 1
    assert runs["psys"].n_keyframes() == runs["jsys"].n_keyframes() >= 4
    assert abs(runs["psys"].n_map_points() - runs["jsys"].n_map_points()) \
        <= 0.05 * runs["jsys"].n_map_points()


def test_ate_within_jax_bound(runs):
    ate_p, scale = pf.trajectory_ate(runs["psys"].tracker.trajectory, runs["poses"])
    ate_j, _ = pf.trajectory_ate(runs["jsys"].tracker.trajectory, runs["poses"])
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)
    assert ate_p <= 0.05 * max(scale, 1.0)
    # the kernels the card counts ran here as their plain versions
    stats = runs["psys"].tracker.stats
    assert stats["two_view"] == 1 and stats["ba"] >= 3 and stats["tri_groups"] >= 3


def test_saved_trajectories(runs, tmp_path):
    sys_ = runs["psys"]
    final = sys_.tracker.final_trajectory()
    assert len(final) == len(sys_.tracker.trajectory)
    for name, fields in (("tum", 8), ("euroc", 8), ("kitti", 12)):
        path = tmp_path / f"{name}.txt"
        getattr(sys_, f"save_trajectory_{name}")(str(path))
        lines = path.read_text().strip().splitlines()
        assert len(lines) == len(final) and all(len(ln.split()) == fields for ln in lines)
    ts, R, t = final[-1]
    x = np.array(path.read_text().strip().splitlines()[-1].split(), np.float64).reshape(3, 4)
    np.testing.assert_allclose(x[:, :3], R.T, atol=1e-6)
    np.testing.assert_allclose(x[:, 3], -R.T @ t, atol=1e-6)
    tum = (tmp_path / "tum.txt").read_text().strip().splitlines()[-1].split()
    assert float(tum[0]) == pytest.approx(ts)
    q = np.array([float(v) for v in tum[4:]])          # qx qy qz qw
    qj = np.asarray(jlie.rot_to_quat(jnp.asarray(R.T)))  # w x y z
    np.testing.assert_allclose(q, np.r_[qj[1:], qj[0]], atol=1e-6)
    R_cur, t_cur = sys_.current_pose()
    np.testing.assert_array_equal(R_cur, sys_.tracker.last_frame.R)


def test_rot_to_quat_matches_jax():
    rng = np.random.default_rng(0)
    Rs = np.stack([pf.so3_exp_np(rng.normal(0, 1.5, 3)) for _ in range(64)]).astype(np.float32)
    Rs[0] = np.diag([1.0, -1.0, -1.0])   # a half-turn: the x pivot
    got = lie.rot_to_quat(torch.from_numpy(Rs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.rot_to_quat(jnp.asarray(Rs))), atol=1e-6)


@pytest.mark.parametrize("change,item", [
    (dict(sensor="stereo", camera2=CameraConfig(model="KannalaBrandt8")), "A.12"),
    (dict(imu=IMUConfig()), "A.11"),
    (dict(camera=CameraConfig(model="KannalaBrandt8")), "A.12"),
    (dict(orb=ORBConfig(octree="host")), "Not to be ported"),
    (dict(tracking=TrackingConfig(pipeline_depth=2)), "A.7"),
], ids=["stereo", "imu", "kb8", "host-octree", "pipelined"])
def test_unported_configurations_raise(change, item):
    cfg = dataclasses.replace(chip_smoke.system_config(W, H, NF), **change)
    with pytest.raises(NotImplementedError, match=item):
        System(cfg, device="cpu")


def test_system_without_device_needs_a_card(monkeypatch):
    """With no device the System runs on the card: without one it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(chip_smoke.system_config(W, H, NF))
    assert System(chip_smoke.system_config(W, H, NF), device="cpu").tracker.device.type == "cpu"


def test_vocabulary_raises(tmp_path):
    """A vocabulary turns on the loop closer and its keyframe database
    (tests/test_torch_system_loop.py); ``vocab_path`` reads the ORBvoc text
    format or the npz of ``Vocabulary.save``, and raises on a missing
    file.  The database's mesh-sharded scoring is not ported (B.26)."""
    from extractorb_tpu_torch.place.vocab import Vocabulary, save_orbvoc_text

    cfg = chip_smoke.system_config(W, H, NF)
    rng = np.random.default_rng(0)
    voc = Vocabulary.train(rng.integers(0, 256, (300, 32), dtype=np.uint8), k=4, L=2)
    save_orbvoc_text(voc, str(tmp_path / "voc.txt"))
    voc.save(str(tmp_path / "voc.npz"))
    for path in ("voc.txt", "voc.npz"):
        db = System(cfg, vocab_path=str(tmp_path / path), device="cpu").tracker.loop_closer.db
        assert db is not None and db.vocab.n_words == voc.n_words
    with pytest.raises(FileNotFoundError):
        System(cfg, vocab_path=str(tmp_path / "missing.txt"), device="cpu")
    with pytest.raises(NotImplementedError, match="B.26"):
        System(cfg, vocab=voc, device="cpu").tracker.loop_closer.db.enable_device_backend(None)
