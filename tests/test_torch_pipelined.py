"""Pipelined monocular tracking (``tracking.pipeline_depth = 3``): the
port's ``System`` against the JAX ``System`` on the CPU, and on the card
the step's CUDA graph against the eager step.

At depth K consecutive fused frames chain device to device, the host
confirms them in batches with one packed fetch (the 2 newest stay in
flight), and a keyframe's triangulation and fuse results ride the next
confirmation.  The scene is the two-plane sequence seen through TUM fr1's
distorted pinhole (``pf.FR1_DIST``, rendered by inverting the distortion
per pixel with Newton's method), so every step undistorts its keypoints:
320x240, 500 features, ``max_frames`` 4, 12 frames from a cold map.  The
port draws its two-view sets as JAX does (``patch_jax_draws``).

Held: (a) after ``flush()`` the two packages' states frame by frame and
keyframe ids are equal, poses within 1e-3, the port's ATE within 1.05x the
JAX run's + 1 mm; (b) black frames in mid-batch (JAX
``tests/test_pipelined.py:62``) replay through the legacy path in both
packages with equal states; (d) the port at depth 0 and depth 3 both under
the JAX test's accuracy bound (``tests/test_pipelined.py:43-60``); and (e)
on the card the graph and the eager step give bit-equal poses and
associations over the sequence.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.config import CameraConfig, TrackingConfig
from extractorb_tpu_torch.frontend.extractor import Features
from extractorb_tpu_torch.slam import local_mapping
from extractorb_tpu_torch.slam import track_device as td
from extractorb_tpu_torch.slam.system import System
from extractorb_tpu_torch.slam.tracking import TrackState
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

W, H, NF, N_FRAMES, SPEED, MAX_FRAMES, DEPTH = 320, 240, 500, 12, 0.04, 4, 3
BLACK_AT = 7          # two black frames inserted before frame 7 (tests/test_pipelined.py:70)
MAX_ATE = 0.15        # the JAX test's bound (tests/test_pipelined.py:60)


def configs(depth: int):
    """The port's and the JAX package's configuration: FR1's distorted
    pinhole at W x H, ``max_frames`` 4, the given pipeline depth."""
    K, d = pf.fr1_camera_matrix(W, H), pf.FR1_DIST
    cam = dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
               k1=d[0], k2=d[1], p1=d[2], p2=d[3], k3=d[4], width=W, height=H)
    cfg = dataclasses.replace(chip_smoke.system_config(W, H, NF), camera=CameraConfig(**cam),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES, pipeline_depth=depth))
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF), camera=JCameraConfig(**cam),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES, pipeline_depth=depth))
    return cfg, jcfg


def run_jax(frames, depth: int = DEPTH):
    jsys = JSystem(configs(depth)[1])
    states = [jsys.track_monocular(img, k / 30.0) for k, img in enumerate(frames)]
    jsys.flush()
    return jsys, states


def run_port(frames, depth: int = DEPTH, device="cpu", graph=None):
    sys_ = System(configs(depth)[0], device=device)
    sys_.tracker.step_graph = graph
    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        states = [sys_.track_monocular(img, k / 30.0) for k, img in enumerate(frames)]
        sys_.flush()
    return sys_, states


def keyframe_ids(sys_):
    return sorted(kf.frame_id for kf in sys_.tracker.atlas.current.keyframes.values())


@pytest.fixture(scope="module")
def scene():
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), N_FRAMES, SPEED, W, H,
                                          pf.fr1_camera_matrix(W, H), pf.FR1_DIST)
    return frames, poses


@pytest.fixture(scope="module")
def runs(scene):
    frames, poses = scene
    jsys, jstates = run_jax(frames)
    psys, pstates = run_port(frames)
    sync, sync_states = run_port(frames, depth=0)
    return dict(poses=poses, jsys=jsys, jstates=jstates, psys=psys, pstates=pstates,
                sync=sync, sync_states=sync_states)


@pytest.fixture(scope="module")
def black_runs(scene):
    frames, _ = scene
    black = np.zeros_like(frames[0])
    seq = frames[:BLACK_AT] + [black, black] + frames[BLACK_AT:]
    jsys, jstates = run_jax(seq)
    psys, pstates = run_port(seq)
    return dict(jsys=jsys, jstates=jstates, psys=psys, pstates=pstates)


def test_states_and_keyframes_equal_jax(runs):
    assert [s.name for s in runs["pstates"]] == [s.name for s in runs["jstates"]]
    assert runs["pstates"][0] == TrackState.NOT_INITIALIZED
    assert all(s == TrackState.OK for s in runs["pstates"][1:])
    assert keyframe_ids(runs["psys"]) == keyframe_ids(runs["jsys"])
    assert len(keyframe_ids(runs["psys"])) >= 3
    # flush() settled every frame: one trajectory row each
    assert len(runs["psys"].tracker.trajectory) == len(runs["jsys"].tracker.trajectory) == N_FRAMES
    assert runs["psys"].tracker.n_fused_frames >= N_FRAMES - 4


def test_poses_within_1e3_of_jax(runs):
    for (ts, Rp, tp), (tj, Rj, tjj) in zip(runs["psys"].tracker.trajectory,
                                           runs["jsys"].tracker.trajectory):
        assert ts == tj
        d = max(float(np.abs(Rp - np.asarray(Rj)).max()), float(np.abs(tp - np.asarray(tjj)).max()))
        assert d < 1e-3, (ts, d)


def test_ate_within_jax_bound(runs):
    ate_p, _ = pf.trajectory_ate(runs["psys"].tracker.trajectory, runs["poses"])
    ate_j, _ = pf.trajectory_ate(runs["jsys"].tracker.trajectory, runs["poses"])
    assert ate_p <= 1.05 * ate_j + 1e-3, (ate_p, ate_j)


def test_depth0_and_depth3_under_the_bound(runs):
    """Both modes track the scene (the JAX test's bound); on this sequence
    they also insert the same keyframes.  Depth 3's ATE is not within
    1.05x depth 0's, in either package: its deferred triangulation lands a
    confirmation later."""
    for key in ("psys", "sync"):
        ate, _ = pf.trajectory_ate(runs[key].tracker.trajectory, runs["poses"])
        assert ate < MAX_ATE, (key, ate)
    assert all(s == TrackState.OK for s in runs["sync_states"][1:])
    assert keyframe_ids(runs["sync"]) == keyframe_ids(runs["psys"])
    assert len(runs["sync"].tracker.trajectory) == N_FRAMES


def test_deferred_mapping_settled(runs):
    """The pipelined run deferred its keyframes' triangulation and fuse;
    flush() applied the last one, and the map grew from them as the
    synchronous run's did."""
    tr = runs["psys"].tracker
    assert not tr.local_mapper.has_pending_tf()
    assert tr.stats["tri_groups"] >= 2 and tr.stats["ba"] >= 2
    n_p, n_s = runs["psys"].n_map_points(), runs["sync"].n_map_points()
    n_j = runs["jsys"].n_map_points()
    assert abs(n_p - n_s) <= 0.1 * n_s, (n_p, n_s)
    assert abs(n_p - n_j) <= 0.01 * n_j, (n_p, n_j)


def test_black_frames_replay_through_legacy(black_runs):
    """Black frames fail the fused gates in mid-batch: the in-flight frames
    replay through the legacy state machine (LOST, then relocalization),
    and tracking resumes, as in the JAX package.  The states ``track``
    returned are the optimistic ones of in-flight frames: the same in both
    packages.  The black frames leave no trajectory row."""
    ps, js = black_runs["pstates"], black_runs["jstates"]
    assert [s.name for s in ps] == [s.name for s in js]
    tr = black_runs["psys"].tracker
    assert tr.state == TrackState.OK and black_runs["jsys"].tracker.state.name == "OK"
    assert tr.stats["reloc"] >= 1 and tr.stats["reloc_ok"] == 1
    assert black_runs["psys"].n_keyframes() == black_runs["jsys"].n_keyframes() >= 2
    assert len(tr.trajectory) == len(black_runs["jsys"].tracker.trajectory) == N_FRAMES


def test_discard_drops_the_deferred_results_and_notifies():
    fired = []
    lm = local_mapping.LocalMapper(None, (1.0,), (1.0,), np.eye(3, dtype=np.float32), "cpu")
    lm.on_tf_applied = lambda: fired.append(1)
    lm._pending_tf = (0, 1, [], [])
    assert lm.has_pending_tf() and lm.pending_tf_handles() == [[], []]
    lm.discard_ba()
    assert not lm.has_pending_tf() and lm.pending_tf_handles() == [] and fired == [1]


def _fused_out(rng, kind: str) -> td.FusedOut:
    N, M = 37, 53
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    xy = t(rng.uniform(0, 320, (N, 2)).astype(np.float32))
    feats = Features(xy=xy, response=t(rng.random(N, np.float32)),
                     angle=t(rng.random(N, np.float32) * 360), octave=t(rng.integers(0, 8, N,
                                                                                    np.int32)),
                     size=t(rng.random(N, np.float32)),
                     desc=t(rng.integers(0, 256, (N, 32), np.uint8)), valid=t(rng.random(N) > .3))
    R = t(rng.random((3, 3), np.float32))
    n = torch.tensor([5, 7], dtype=torch.int32)
    out = td.FusedOut(feats=feats, xy_un=xy, R=R, t=t(rng.random(3, np.float32)),
                      kp_mp=t(rng.integers(-1, 99, N, np.int32)), n_match_motion=torch.tensor(41),
                      n_inl_motion=n[0], n_inl_final=torch.tensor(33), lm_searched=t(
                          rng.random(M) > 0.5), used_ref=torch.tensor(True), n_pre=n[1])
    if kind == "stereo":
        out = out._replace(ur=t(rng.random(N, np.float32)), depth=t(rng.random(N, np.float32)),
                           n_close_tracked=torch.tensor(3, dtype=torch.int32),
                           n_close_untracked=torch.tensor(4, dtype=torch.int32))
    if kind == "inertial":   # the joint solve's outputs: views of one buffer, as K22 gives them
        sol = t(rng.random(21 + 225, np.float32))
        out = out._replace(v=sol[12:15], bg=sol[15:18], ba=sol[18:21],
                           H15=sol[21:].reshape(15, 15))
    return out


@pytest.mark.parametrize("kind", ["mono", "stereo", "inertial"])
def test_graph_output_snapshot_layout(kind):
    """The graph packs a step's outputs into one buffer that a replay's
    snapshot copies: unpacking gives every field back, with its type and
    shape, a tensor that was two fields (xy_un = feats.xy without
    distortion) as one, and None where the step has no such output."""
    out = _fused_out(np.random.default_rng(("mono", "stereo", "inertial").index(kind)), kind)
    g = td.StepGraph(None)
    back = g._unpack(g._pack(out).clone())
    assert back.xy_un is back.feats.xy
    for name in td.FusedOut._fields:
        a, b = getattr(out, name), getattr(back, name)
        if name == "feats":
            for f in ("xy", "response", "angle", "octave", "size", "desc", "valid"):
                assert getattr(a, f).dtype == getattr(b, f).dtype
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        elif a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    assert all(o % 16 == 0 for o, _, _, _ in g.pieces)
    assert (back.H15 is None) == (kind != "inertial")


def _imu_step(graph=None):
    cfg = chip_smoke.vi_config(W, H, NF)
    return td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, "cpu", inertial=True,
                        graph=graph, imu_noise=(1e-3, 1e-2, 1e-6, 1e-5))


def _window(n: int, rng):
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32), np.full(n, 0.01, np.float32))


@pytest.mark.parametrize("kind", ["mono", "inertial"])
def test_graph_key_and_static_inputs(kind):
    """The graph's key and its static-input order.  The 21 step arguments
    come first (the mirror's addresses in the key); an inertial step adds
    the IMU record and the prior, which round-trip through the list: a
    window of 10 or 32 samples is one key (the bucket of 32), one of 33 a
    new one, as is another mirror."""
    rng = np.random.default_rng(7)
    step = _imu_step() if kind == "inertial" else td.TrackStep(
        configs(DEPTH)[0].camera, configs(DEPTH)[0].orb, (H, W), 32768, 4096, "cpu")
    g = td.StepGraph(step)
    assert g.name == ("track_step_inertial" if kind == "inertial" else "track_step")
    args = [torch.zeros(i + 1) for i in range(21)]
    prior = torch.eye(15)

    def inputs(n, mirror=None):
        a = list(args)
        if mirror is not None:
            a[6] = mirror
        if kind == "mono":
            return g.inputs(a)
        rec = td.imu_record(_window(n, rng), np.zeros(6), np.zeros(3), np.zeros(3),
                            np.zeros(3), np.eye(3), np.zeros(3))
        return g.inputs(a, imu=td.StepImu(rec, prior))

    k10, k32, k33 = (g.key_of(inputs(n)) for n in (10, 32, 33))
    assert k10 == k32 and g.key_of(inputs(10, torch.zeros(7))) != k10
    assert (k33 != k32) == (kind == "inertial")
    lst = inputs(12)
    a, img_r, imu = g.split(lst)
    assert img_r is None and len(a) == 21 and all(x is y for x, y in zip(a, args))
    if kind == "mono":
        assert imu is None and len(lst) == 21
    else:
        assert len(lst) == 23 and imu[0] is lst[21] and imu[1] is prior
        assert lst[21].shape == (td.REC_HEAD + 8 * 32,) and lst[21].dtype == torch.float32


@pytest.mark.parametrize("kind", ["visual", "inertial"])
def test_graph_is_for_a_visual_step_on_a_card(kind):
    """The step's CUDA graph is the default on a card only: on the CPU a
    step has none, and asking for one raises (visual and inertial)."""
    if kind == "inertial":
        assert _imu_step().graph is None
        with pytest.raises(ValueError, match="CUDA graph"):
            _imu_step(graph=True)
        with pytest.raises(ValueError, match="imu_noise"):
            cfg = chip_smoke.vi_config(W, H, NF)
            td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, "cpu", inertial=True)
        return
    cfg = configs(DEPTH)[0]
    step = td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, "cpu")
    assert step.graph is None
    with pytest.raises(ValueError, match="CUDA graph"):
        td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, "cpu", graph=True)


@pytest.mark.gpu
def test_graph_matches_the_eager_step_on_the_card(cuda_device, scene):  # noqa: F811
    """Depth 3 on the card with the step's CUDA graph and with the eager
    step: every step's outputs bit-equal, and the same trajectory; the
    graph replays once per ordinary frame."""
    frames, _ = scene
    calls, traj, replays = {}, {}, {}
    for graph in (None, False):
        kernels.GRAPH_LAUNCHES.clear()
        with chip_smoke._StepOutputs() as rec:
            sys_, _ = run_port(frames, device=cuda_device, graph=graph)
        calls[graph], traj[graph] = rec.calls, sys_.tracker.trajectory
        replays[graph] = kernels.GRAPH_LAUNCHES["track_step"]
    traj_g, traj_e = traj[None], traj[False]
    assert len(calls[None]) == len(calls[False]) >= N_FRAMES - 3
    # every fused frame but a step key's first (eager) call is one replay
    assert len(calls[None]) - 3 <= replays[None] < len(calls[None]) and replays[False] == 0
    assert any(c["graph"] for c in calls[None]) and not any(c["graph"] for c in calls[False])
    for k, (g, e) in enumerate(zip(calls[None], calls[False])):
        assert not chip_smoke._differing(g, e), k
    assert len(traj_g) == len(traj_e) == N_FRAMES
    for (_, Rg, tg), (_, Re, te) in zip(traj_g, traj_e):
        assert np.array_equal(Rg, Re) and np.array_equal(tg, te)


@pytest.mark.gpu
def test_graph_recaptures_for_a_new_mirror_and_a_failed_capture_raises(cuda_device):
    """A step key's first call runs eagerly, its second captures and
    replays, later ones replay; a new map mirror (new tensors, as after its
    capacity grows) is a new key and recaptures.  A capture that a wrapper
    breaks (a host read inside the step) raises; nothing falls back."""
    frames, depths, poses = pf.render_sequence(pf.procedural_texture(), 4, SPEED, W, H)
    cfg = chip_smoke.system_config(W, H, NF)
    step = td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, cuda_device)
    for n in (1, 2):   # each track_sequence seeds a map of its own: a new mirror
        chip_smoke.track_sequence(step, frames, depths, poses, pf.true_pose(-1, SPEED),
                                  cuda_device)
        assert (step.graph.n_captures, step.graph.n_warm, step.graph.n_replays) == (n, n, 2 * n)
    broken = td.TrackStep(cfg.camera, cfg.orb, (H, W), 32768, 4096, cuda_device)
    orig = td.fm.search_by_projection_local_map

    def host_read(*args, **kw):
        out = orig(*args, **kw)
        int(out.sum())   # a host synchronisation: not capturable
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(td.fm, "search_by_projection_local_map", host_read)
        with pytest.raises(RuntimeError):
            chip_smoke.track_sequence(broken, frames, depths, poses, pf.true_pose(-1, SPEED),
                                      cuda_device)
    assert broken.graph.n_captures == 0 and broken.graph.n_replays == 0
    torch.cuda.synchronize()
