"""Local mapping of the PyTorch port (plain path) against the JAX package,
on one map carried across from a JAX run.

The JAX ``System`` tracks a rendered 320x240 sequence (500 features,
max_frames 6); the map state right before its first keyframe event after
initialisation is captured as numpy (``interop.map_to_numpy``), then
rebuilt in both packages (``interop.map_from_numpy`` for the port).
Tolerances: the triangulation program's matches bit-equal, its gates
equal and its points within 1e-4; the fuse program bit-equal; one
``process_keyframe`` creates the same new points within 1e-4; the map
mirror bit-equal; ``pack_fetch`` an exact round trip.  Beside the
parity: the window BA's poll/force semantics and the mirror's capacity
ladder.
"""

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
from extractorb_tpu.frontend import matcher as jfm
from extractorb_tpu.frontend.extractor import Features as JFeatures
from extractorb_tpu.slam import local_mapping as jlm
from extractorb_tpu.slam import map as jmap
from extractorb_tpu.slam import track_device as jtd
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu.utils.packed_fetch import pack_fetch as j_pack_fetch
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.frontend import matcher
from extractorb_tpu_torch.slam import local_mapping as lm
from extractorb_tpu_torch.slam import track_device as td
from extractorb_tpu_torch.utils import packed_fetch
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

W, H, NF, N_FRAMES = 320, 240, 500, 9


@pytest.fixture(scope="module")
def captured():
    """The JAX map state right before the first keyframe event after
    initialisation, and the JAX mapper's configuration."""
    frames, _, _ = pf.render_sequence(pf.procedural_texture(), N_FRAMES, 0.04, W, H)
    cam = chip_smoke.camera_config(W, H)
    cfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                      camera=JCameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W,
                                           height=H),
                      tracking=JTrackingConfig(max_frames=6))
    cap = {}
    orig = jlm.LocalMapper.process_keyframe

    def spy(self, mp, kf_id, defer_fetch=False):
        if not cap:
            cap.update(pre=interop.map_to_numpy(mp), kf=kf_id, project=self.project,
                       sf=self.scale_factors, isig=self.inv_sigma2, K=self.K)
        return orig(self, mp, kf_id, defer_fetch)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jlm.LocalMapper, "process_keyframe", spy)
        sys_ = JSystem(cfg)
        for k, img in enumerate(frames):
            sys_.track_monocular(img, k / 30.0)
    assert cap, "the JAX run reached no keyframe event"
    cap["cam"] = Pinhole(cam.fx, cam.fy, cam.cx, cam.cy)
    return cap


def jax_map(d) -> jmap.SLAMMap:
    """A JAX SLAMMap from ``interop.map_to_numpy`` state."""
    mp = jmap.SLAMMap(capacity=len(d["mp_valid"]), scale_factor=d["scale_factor"])
    for k in interop._MAP_ARRAYS:
        setattr(mp, k, np.array(d[k]))
    for k in interop._MAP_SCALARS:
        setattr(mp, k, d[k])
    mp.obs = {m: dict(o) for m, o in d["obs"].items()}
    mp.dead_kfs = {k: (p, np.array(R), np.array(t)) for k, (p, R, t) in d["dead_kfs"].items()}
    for k, kd in d["keyframes"].items():
        kf = jmap.KeyFrame(feats=JFeatures(**{f: jnp.asarray(v) for f, v in kd["feats"].items()}),
                           **{a: np.array(kd[a]) for a in interop._KF_ARRAYS},
                           **{a: kd[a] for a in interop._KF_SCALARS})
        kf.loop_edges = list(kd["loop_edges"])
        mp.keyframes[k] = kf
    return mp


def mappers(cap):
    j = jlm.LocalMapper(cap["project"], cap["sf"], cap["isig"], cap["K"])
    p = lm.LocalMapper(cap["cam"], cap["sf"], cap["isig"], cap["K"], "cpu")
    return j, p


def assert_state_equal(a, b, path="map"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_state_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


def test_map_state_round_trip(captured):
    pre = captured["pre"]
    assert len(pre["keyframes"]) == 3 and captured["kf"] == 2
    port = interop.map_from_numpy(pre, "cpu")
    assert isinstance(port.keyframes[2].feats.desc, torch.Tensor)
    assert_state_equal(interop.map_to_numpy(port), pre)
    assert_state_equal(interop.map_to_numpy(jax_map(pre)), pre)
    # the carried map answers the map queries like the JAX one
    j = jax_map(pre)
    assert port.covisible_keyframes(2, 1) == j.covisible_keyframes(2, 1)
    np.testing.assert_array_equal(port.points_seen_by([0, 2]), j.points_seen_by([0, 2]))


def test_triangulation_program_matches_jax(captured):
    pre, kf = captured["pre"], captured["kf"]
    jm, pm = mappers(captured)
    jt = jm._create_new_points_dispatch(jax_map(pre), kf)
    pt = pm._create_new_points_dispatch(interop.map_from_numpy(pre, "cpu"), kf)
    assert len(jt) == len(pt) >= 1
    n_ok = 0
    for (jg, jres), (pg, pres) in zip(jt, pt):
        assert [k.kid for k in jg] == [k.kid for k in pg]
        # the JAX program pads the group with no-match dummies
        jm12, jX, jok = (np.asarray(a)[: len(jg)] for a in jres)
        pm12, pX, pok = (a.numpy() for a in pres)
        assert not np.asarray(jres[2])[len(jg):].any()
        np.testing.assert_array_equal(pm12, jm12)
        np.testing.assert_array_equal(pok, jok)
        np.testing.assert_allclose(pX[pok], jX[jok], atol=1e-4, rtol=0)
        n_ok += int(pok.sum())
    assert n_ok > 50


def test_search_for_triangulation_matches_jax(captured):
    """The matcher's single-pair search (K7 without the geometry) on the
    newest keyframe against the first one."""
    pre = captured["pre"]
    k1, k2 = (pre["keyframes"][k] for k in (captured["kf"], 0))
    F12 = lm.fundamental_matrix(captured["K"], k1["R"], k1["t"], k2["R"], k2["t"])
    sigma2 = np.asarray([1.0 / s for s in captured["isig"]], np.float32)
    args = [k1["desc"], k1["xy_un"], k1["octave"], k1["valid"] & (k1["kp_mp"] < 0),
            k2["desc"], k2["xy_un"], k2["octave"], k2["valid"] & (k2["kp_mp"] < 0),
            F12.astype(np.float32), sigma2]
    j = np.asarray(jfm.search_for_triangulation(*(jnp.asarray(a) for a in args)))
    p = matcher.search_for_triangulation(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_array_equal(p.numpy(), j)
    assert (j >= 0).sum() > 50


def test_fuse_program_matches_jax(captured):
    pre, kf = captured["pre"], captured["kf"]
    jm, pm = mappers(captured)
    jf = jm._fuse_dispatch(jax_map(pre), kf)
    pfz = pm._fuse_dispatch(interop.map_from_numpy(pre, "cpu"), kf)
    assert len(jf) == len(pfz) >= 1
    n_match = 0
    for (jjobs, jmatch), (pjobs, pmatch) in zip(jf, pfz):
        assert [t for t, _ in jjobs] == [t for t, _ in pjobs]
        for (_, a), (_, b) in zip(jjobs, pjobs):
            np.testing.assert_array_equal(a, b)
        got = pmatch.numpy()
        np.testing.assert_array_equal(got, np.asarray(jmatch)[: len(pjobs)])
        n_match += int((got >= 0).sum())
    assert n_match > 0


def test_process_keyframe_matches_jax(captured):
    pre, kf = captured["pre"], captured["kf"]
    jm, pm = mappers(captured)
    jmp, pmp = jax_map(pre), interop.map_from_numpy(pre, "cpu")
    jm.process_keyframe(jmp, kf)
    pm.process_keyframe(pmp, kf)
    n0 = pre["_next_mp"]
    assert pmp._next_mp == jmp._next_mp > n0 + 50
    assert sorted(pmp.keyframes) == sorted(jmp.keyframes)
    np.testing.assert_array_equal(pmp.mp_valid, jmp.mp_valid)
    new = np.arange(n0, jmp._next_mp)
    np.testing.assert_allclose(pmp.mp_pos[new], jmp.mp_pos[new], atol=1e-4, rtol=0)
    assert pmp.obs == jmp.obs
    for k in jmp.keyframes:
        np.testing.assert_array_equal(pmp.keyframes[k].kp_mp, jmp.keyframes[k].kp_mp)
    # the window BA is in flight on both sides, over the same window
    assert pm._pending_ba is not None and jm._pending_ba is not None
    assert pm._pending_ba.kf_ids == jm._pending_ba.kf_ids
    np.testing.assert_array_equal(pm._pending_ba.pt_ids, jm._pending_ba.pt_ids)
    assert pm.stats["tri_groups"] >= 1 and pm.stats["ba"] == 1


def test_window_ba_is_polled_not_forced(captured):
    """A keyframe event polls the in-flight window BA (a CUDA event's
    query() on the card) and leaves a running solve in flight; flush
    forces it (ROADMAP "Recent": the mbAbortBA semantics)."""

    class Running:
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

    pre, kf = captured["pre"], captured["kf"]
    _, pm = mappers(captured)
    pmp = interop.map_from_numpy(pre, "cpu")
    pm.process_keyframe(pmp, kf)
    pending = pm._pending_ba
    pending.event = Running()
    version = pmp.version
    pm.flush_ba(pmp, force=False)
    assert pm._pending_ba is pending and pmp.version == version
    pending.event.done = True
    pm.flush_ba(pmp, force=False)
    assert pm._pending_ba is None and pmp.version == version + 1
    pm._pending_ba = pending
    pending.event.done = False
    pm.flush_ba(pmp)          # force: waits for the result and applies it
    assert pm._pending_ba is None and pmp.version == version + 2


def test_mirror_moves_up_its_ladder():
    """A map past 32768 points takes the mirror to the next rung, and the
    tracker asks get_track_step for a step of that capacity."""
    mp = interop.map_from_numpy(dict(
        mp_pos=np.zeros((40000, 3), np.float32), mp_desc=np.zeros((40000, 32), np.uint8),
        mp_normal=np.zeros((40000, 3), np.float32), mp_max_dist=np.zeros(40000, np.float32),
        mp_valid=np.ones(40000, bool), mp_first_kf=np.zeros(40000, np.int32),
        mp_visible=np.zeros(40000, np.int32), mp_found=np.zeros(40000, np.int32), mid=0,
        scale_factor=1.2, _next_kf=0, _next_mp=40000, version=1, obs={}, dead_kfs={},
        keyframes={}), "cpu")
    mir = td.MapMirror("cpu")
    mir.sync(mp)
    assert mir.cap == 65536 and mir.pos.shape == (65536, 3) and int(mir.valid.sum()) == 40000
    cam = chip_smoke.camera_config(W, H)
    small = td.get_track_step(cam, td.ORBConfig(n_features=NF), (H, W), 32768, 1024, "cpu")
    big = td.get_track_step(cam, td.ORBConfig(n_features=NF), (H, W), mir.cap, 1024, "cpu")
    assert big is not small and big.map_cap == 65536


def test_map_mirror_sync_matches_jax(captured):
    pre = captured["pre"]
    jmp, pmp = jax_map(pre), interop.map_from_numpy(pre, "cpu")
    jmir, pmir = jtd.MapMirror(), td.MapMirror("cpu")
    rng = np.random.default_rng(5)
    for step in range(3):
        jmir.sync(jmp)
        pmir.sync(pmp)
        np.testing.assert_array_equal(pmir.pos.numpy(), np.asarray(jmir.pos))
        np.testing.assert_array_equal(pmir.valid.numpy(), np.asarray(jmir.valid))
        assert pmir.cap == jmir.cap
        # the same edit on both maps: moved, removed and added points
        n = jmp._next_mp
        rows = rng.choice(n, 40 * (step + 1), replace=False)
        delta = rng.normal(0, 0.01, (len(rows), 3)).astype(np.float32)
        for mp in (jmp, pmp):
            mp.mp_pos[rows] += delta
            mp.mp_valid[rows[:5]] = False
            mp.add_point(np.ones(3, np.float32), np.zeros(32, np.uint8), np.zeros(3, np.float32),
                         1.0, 0)
    assert pmir.n_scatter == 2


def test_pack_fetch_round_trip():
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=(3, 3)).astype(np.float32), rng.integers(-9, 9, 50).astype(np.int32),
              rng.random(17) < 0.5, rng.integers(0, 256, (5, 32)).astype(np.uint8),
              rng.integers(-100, 100, 7).astype(np.int8), np.float32(2.5)]
    tree = [[torch.from_numpy(np.asarray(a)) for a in leaves[:3]], [],
            (torch.from_numpy(leaves[3]), [torch.from_numpy(leaves[4])]),
            torch.tensor(leaves[5]), torch.tensor(41, dtype=torch.int64), None, "tag"]
    got = packed_fetch.pack_fetch(tree)
    flat = got[0] + [got[2][0], got[2][1][0], got[3]]
    for a, b in zip(leaves, flat):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.asarray(a).dtype and b.shape == np.asarray(a).shape
    assert int(got[4]) == 41 and got[4].dtype == np.int64
    assert got[1] == [] and got[5] is None and got[6] == "tag"
    # the same bits as the JAX package's packed fetch
    jgot = j_pack_fetch([[jnp.asarray(a) for a in leaves[:3]], jnp.asarray(leaves[3])])
    for a, b in zip(jgot[0] + [jgot[1]], flat[:4]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_empty_pack_fetch_is_identity():
    assert packed_fetch.pack_fetch([]) == []
    assert packed_fetch.pack_fetch(None) is None


@pytest.mark.gpu
def test_tri_search_kernel_matches_plain(cuda_device):
    frames, _, poses = pf.render_sequence(pf.procedural_texture(), 9, 0.04, W, H)
    args, geom = chip_smoke.tri_inputs(frames, poses, cuda_device, n_features=NF)
    mk, Xk, okk = matcher.tri_search(*args, geom)
    mp_, Xp, okp = matcher.tri_search_plain(*args, geom)
    assert torch.equal(mk, mp_) and torch.equal(okk, okp) and int(okk.sum()) > 0
    rel = (Xk - Xp).norm(dim=-1) / Xp.norm(dim=-1).clamp(min=1e-9)
    assert float(rel[okp].max()) <= 1e-5


@pytest.mark.gpu
def test_map_io_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(1)
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=cuda_device).to(dt)
    pos, val = t(rng.normal(size=(1000, 3)), torch.float32), t(rng.random(1000) < 0.5, torch.bool)
    rows = t(np.r_[rng.choice(1000, 200, replace=False), [1000] * 56], torch.int32)
    new_pos, new_val = t(rng.normal(size=(256, 3)), torch.float32), t(rng.random(256) < 0.5,
                                                                      torch.bool)
    a, b = (pos.clone(), val.clone()), (pos.clone(), val.clone())
    td.mirror_scatter(*a, rows, new_pos, new_val)
    td.mirror_scatter_plain(*b, rows, new_pos, new_val)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    leaves = [pos, val, t(rng.integers(0, 256, (9, 32)), torch.uint8), t(3, torch.int64)]
    assert torch.equal(packed_fetch.pack_i32(leaves), packed_fetch.pack_i32_plain(leaves))
