"""The port's inertial TrackStep with the frame's IMU window inside it.

The monocular-inertial step takes the frame's raw window in one host
record (``track_device.imu_record``) and integrates it itself (K19 on a
card, its plain version here), where the JAX tracker integrates the
window (``slam/imu_frontend._integrate_jit``) before its step.  On the
CPU: one frame of [vi]'s trajectory at 320x240 / 500 features, the map
seeded from frame 0's keypoints with the true depth in a gravity-aligned
world, through the step with the window inside, bit-equal to the port's
integrate-then-step route and within 1e-4 (pose) and 1e-5 (v, bg, ba; H15
relative to its largest entry) of the JAX integration and step.  On a
card (``-m gpu``): the inertial step's CUDA graph against its eager
launches over [vi]'s sequence, pinhole and KB8, at depth 0 and 3, and a
capture that a host read breaks.
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
from extractorb_tpu.slam import imu_frontend as jimu
from extractorb_tpu.slam import track_device as jtd
from extractorb_tpu_torch import interop, kernels
from extractorb_tpu_torch.frontend.extractor import ORBExtractor
from extractorb_tpu_torch.imu.calib import ImuCalib
from extractorb_tpu_torch.slam import imu_frontend
from extractorb_tpu_torch.slam import track_device as td
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

W, H = 320, 240
NF = 500
MAP_CAP, LOCAL_CAP = 4096, 1024
# the world turned so that the trajectory's gravity (-y) is the step's -z
R_ALIGN = pf.so3_exp_np([np.pi / 2, 0.0, 0.0])
STATE = ("v", "bg", "ba")


def _aligned_pose(k: int):
    R, t = pf.vi_pose(k / pf.VI_FPS)
    return (R @ R_ALIGN.T).astype(np.float64), t


@pytest.fixture(scope="module")
def frame():
    """Frame 1 of [vi]'s trajectory with frame 0's state: the step's
    positional inputs, the raw window (0, 0.1 s], a seeded bias, prior and
    previous velocity, and the calibration."""
    tex = pf.procedural_texture()
    cfg = chip_smoke.vi_config(W, H, NF)
    calib = ImuCalib.from_config(cfg.imu)
    pose0, pose1 = _aligned_pose(0), _aligned_pose(1)
    img0, depth0 = pf.render_two_plane(tex, pf.vi_pose(0.0), W, H)
    img1 = pf.render_two_plane(tex, pf.vi_pose(1 / pf.VI_FPS), W, H)[0]
    ex = ORBExtractor(cfg.orb, (H, W), "cpu")
    f0 = interop.to_numpy(ex(torch.from_numpy(img0)))
    kp_mp, map_pos, map_valid, local, ref = pf.seed_map(
        f0["xy"], f0["octave"], f0["valid"], f0["desc"], depth0, pose0,
        pf.camera_matrix(W, H), ex.scales, MAP_CAP, LOCAL_CAP)
    last = dict(xy_un=f0["xy"], desc=f0["desc"], octave=f0["octave"], angle=f0["angle"])
    args = interop.step_inputs_from_numpy(img1, last, kp_mp, map_pos, map_valid, local, ref,
                                          *pose0, *pose0, "cpu")
    q = imu_frontend.ImuQueue(calib, "cpu")
    q.extend(pf.imu_window(0.0, 1 / pf.VI_FPS))
    win = q.raw_window(0.0, 1 / pf.VI_FPS)
    rng = np.random.default_rng(22)
    bias = (rng.standard_normal(6) * np.array([1e-3] * 3 + [1e-2] * 3)).astype(np.float32)
    # the body velocity at t = 0, in the aligned world
    v0 = (R_ALIGN @ (np.array([0.70, 0.25, 0.12]) * np.array([1.9, 1.4, 1.1])
                     * np.cos([0.0, 1.0, 0.5]))).astype(np.float32)
    A = rng.standard_normal((15, 15))
    prior = (A @ A.T + 15 * np.eye(15)).astype(np.float32) * 100.0
    return dict(cfg=cfg, calib=calib, args=args, win=win, bias=bias, v=v0, bg=bias[:3],
                ba=bias[3:], prior=prior, pose1=pose1)


def _step(fr, device="cpu", graph=None):
    cfg, c = fr["cfg"], fr["calib"]
    return td.TrackStep(cfg.camera, cfg.orb, (H, W), MAP_CAP, LOCAL_CAP, device, inertial=True,
                        graph=graph, imu_noise=(c.noise_gyro, c.noise_acc, c.walk_gyro,
                                                c.walk_acc))


def _record(fr):
    c = fr["calib"]
    return td.imu_record(fr["win"], fr["bias"], fr["v"], fr["bg"], fr["ba"], c.Rcb, c.tcb)


@pytest.fixture(scope="module")
def outputs(frame):
    """The step with the window inside, the port's integrate-then-step
    route and the JAX integration and step, as numpy dicts."""
    fr, c = frame, frame["calib"]
    step = _step(fr)
    prior = torch.from_numpy(fr["prior"])
    inside = interop.to_numpy(step(*fr["args"], imu=td.StepImu(_record(fr), prior)))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    preint = imu_frontend.integrate_raw(fr["win"], fr["bias"], c, "cpu")
    outside = interop.to_numpy(step._track(*fr["args"], imu=(
        preint, t(fr["v"]), t(fr["bg"]), t(fr["ba"]), prior, t(c.Rcb), t(c.tcb))))
    cam = fr["cfg"].camera
    jcam = JCameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W, height=H)
    jstep = jtd.get_track_step(jcam, JORBConfig(n_features=NF), (H, W), MAP_CAP, LOCAL_CAP,
                               depth_mode="none", inertial=True)
    jp = jimu.integrate_raw(fr["win"], fr["bias"], c)
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))
    jout = jstep(*[jnp.asarray(a.numpy()) for a in fr["args"]], imu=(
        jp, j(fr["v"]), j(fr["bg"]), j(fr["ba"]), j(fr["prior"]), j(c.Rcb), j(c.tcb)))
    jax_ = {k: np.asarray(getattr(jout, k)) for k in ("R", "t", "kp_mp", "v", "bg", "ba", "H15")}
    return inside, outside, jax_


def test_window_inside_the_step_is_bit_equal_to_integrate_then_step(outputs):
    inside, outside, _ = outputs
    assert inside.keys() == outside.keys() and {"v", "bg", "ba", "H15"} <= inside.keys()
    for k in inside:
        np.testing.assert_array_equal(inside[k], outside[k], err_msg=k)


def test_window_inside_the_step_matches_jax(outputs, frame):
    inside, _, j = outputs
    for k in ("R", "t"):
        np.testing.assert_allclose(inside[k], j[k], atol=1e-4, rtol=0, err_msg=k)
    for k in STATE:
        np.testing.assert_allclose(inside[k], j[k], atol=1e-5, rtol=0, err_msg=k)
    h = np.abs(inside["H15"] - j["H15"]).max() / np.abs(j["H15"]).max()
    assert h <= 1e-5, h
    assert (inside["kp_mp"] == j["kp_mp"]).mean() >= 0.98
    assert int(inside["n_inl_final"]) >= 50
    assert pf.camera_centre_error(inside["R"], inside["t"], frame["pose1"]) < pf.MAX_CENTER_ERR


def test_record_views_round_trip(frame):
    """The record's views give the window padded to its bucket, the bias,
    the state and the extrinsics back; valid marks the window's samples."""
    rec = _record(frame)
    gyro, acc, dt, valid, bias, v, bg, ba, Rcb, tcb = td.imu_record_views(rec)
    g, a, d = frame["win"]
    n = len(d)
    assert gyro.shape == (32, 3) and valid.dtype == torch.bool and int(valid.sum()) == n
    assert bool(valid[:n].all())
    np.testing.assert_array_equal(gyro[:n].numpy(), g)
    np.testing.assert_array_equal(acc[:n].numpy(), a)
    np.testing.assert_array_equal(dt[:n].numpy(), d)
    assert not gyro[n:].any() and not acc[n:].any() and not dt[n:].any()
    for got, want in ((bias, frame["bias"]), (v, frame["v"]), (bg, frame["bg"]),
                      (ba, frame["ba"]), (Rcb, frame["calib"].Rcb), (tcb, frame["calib"].tcb)):
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ card


def _run_vi(kb8: bool, depth: int, graph, device):
    """[vi]'s (or [vi-kb8]'s) sequence at 320x240 (KB8 320x320) / 500
    features through the System, every step's outputs kept (clones)."""
    if kb8:
        frames = pf.render_vi_kb8_sequence(pf.procedural_texture(), 32, 320, 320)[0]
        cfg = chip_smoke.vi_kb8_config(320, 320, NF)
    else:
        frames = pf.render_vi_sequence(pf.procedural_texture(), 40, W, H)[0]
        cfg = chip_smoke.vi_config(W, H, NF)
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                 pipeline_depth=depth))
    kernels.GRAPH_LAUNCHES.clear()
    with chip_smoke._StepOutputs() as rec:
        sys_, states, _, _ = chip_smoke.run_pipelined(frames, device, cfg, graph=graph, imu=True)
    return sys_, states, rec.calls, kernels.GRAPH_LAUNCHES["track_step_inertial"]


@pytest.mark.gpu
@pytest.mark.parametrize("kb8", [False, True], ids=["pinhole", "kb8"])
@pytest.mark.parametrize("depth", [0, 3])
def test_inertial_graph_matches_eager_steps(cuda_device, kb8, depth):  # noqa: F811
    """Every fused inertial step's outputs (v, bg, ba and H15 with them)
    bit-equal between the graph and the eager launches, the same
    trajectory; every fused frame but each key's first two is a replay."""
    sg, states, calls_g, replays = _run_vi(kb8, depth, None, cuda_device)
    se, _, calls_e, replays_e = _run_vi(kb8, depth, False, cuda_device)
    inertial = [c for c in calls_g if c["inertial"]]
    assert inertial and len(calls_g) == len(calls_e) and replays_e == 0
    # a key captured by an earlier test (a mirror at the same address) replays from the first
    assert len(inertial) - 2 <= replays <= len(inertial)
    assert states[-1] == TrackState.OK
    for k, (g, e) in enumerate(zip(calls_g, calls_e)):
        assert not chip_smoke._differing(g, e), k
    assert len(sg.tracker.trajectory) == len(se.tracker.trajectory)
    for (_, Rg, tg), (_, Re, te) in zip(sg.tracker.trajectory, se.tracker.trajectory):
        assert np.array_equal(Rg, Re) and np.array_equal(tg, te)


@pytest.mark.gpu
def test_inertial_capture_broken_by_a_host_read_raises(cuda_device, frame):  # noqa: F811
    """A key's first call runs eagerly, its second captures and replays; a
    host read inside the inertial step breaks the capture, which raises and
    falls back to nothing."""
    fr = frame
    prior = torch.from_numpy(fr["prior"]).to(cuda_device)
    args = tuple(a.to(cuda_device) for a in fr["args"])
    step = _step(fr, cuda_device)
    outs = [step(*args, imu=td.StepImu(_record(fr), prior)) for _ in range(3)]
    assert (step.graph.n_warm, step.graph.n_captures, step.graph.n_replays) == (1, 1, 2)
    for o in outs[1:]:
        for a, b in zip(interop.to_numpy(outs[0]).values(), interop.to_numpy(o).values()):
            assert np.array_equal(a, b)
    broken = _step(fr, cuda_device)
    orig = td.pre.integrate_batch

    def host_read(*a, **kw):
        out = orig(*a, **kw)
        float(out.dT.sum())   # a host synchronisation: not capturable
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(td.pre, "integrate_batch", host_read)
        broken(*args, imu=td.StepImu(_record(fr), prior))
        with pytest.raises(RuntimeError):
            broken(*args, imu=td.StepImu(_record(fr), prior))
    assert broken.graph.n_captures == 0 and broken.graph.n_replays == 0
    torch.cuda.synchronize()
