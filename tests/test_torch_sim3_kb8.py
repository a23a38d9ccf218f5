"""Loop closing's Sim3 estimation, Sim3 search and global BA of the port
through TUM-VI's 512x512 KB8 fisheye, against the JAX package's functions
given the KB8 projection closure (``extractorb_tpu/slam/track_device.py
:kb8_project``).

The same seeded numpy inputs go through both: the RANSAC with JAX's
draws patched in (the same count and mask, the Sim3 within 1e-4; with
and without a fixed scale), OptimizeSim3 (the same inliers, the Sim3
within 1e-4), ``search_by_projection_sim3`` (the same indices) and the
one-shard Schur GBA against ``optimize_schur_sharded`` on a one-device
mesh (within 1e-3, cost within 1e-3 relative).  The scenes spread to
about 55 degrees off the axis, where the KB8 model parts from the
pinhole by tens of pixels.  On a card, K12 and K14 take their ``CamKB8``
instantiations and hold to their plain versions; K14<KB8> gives one
result over 20 calls on one input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu.frontend import matcher as jfm
from extractorb_tpu.geometry import sim3 as jsim3
from extractorb_tpu.slam.track_device import kb8_project as j_kb8
from extractorb_tpu.solver import ba as jba
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.core.camera import KannalaBrandt8
from extractorb_tpu_torch.dist import sharded_ba
from extractorb_tpu_torch.frontend import matcher as fm
from extractorb_tpu_torch.geometry import sim3
from test_torch_sim3 import jax_sim3_sets, t
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

KB8 = pf.kb8_camera()
CAM = KannalaBrandt8(*KB8)
JPROJ = j_kb8(*KB8)
CPU = torch.device("cpu")
SCALES = tuple(float(s) for s in np.cumprod([1.0] + [np.float32(1.2)] * 7).astype(np.float32))


def kb8_sim3_scene(seed: int, N: int, out_frac: float, fix_scale: bool = False):
    """``chip_smoke.sim3_scene`` through KB8; with ``fix_scale`` the second
    camera's points are the first's moved rigidly (the true scale 1)."""
    p1, p2, uv1, uv2, val, (R, tt, s) = chip_smoke.sim3_scene(np.random.default_rng(seed), N,
                                                              out_frac, kb8=KB8)
    if fix_scale:
        p2 = ((p2 - p2.mean(0)) / 1.3 + p2.mean(0)).astype(np.float32)
        uv2 = pf.kb8_project_np(p2, KB8).astype(np.float32)
    return p1, p2, uv1, uv2, val, (R, tt, s)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_kb8_with_jax_draws(fix_scale):
    p1, p2, uv1, uv2, val, _ = kb8_sim3_scene(3, 512, 0.3, fix_scale)
    # the scene is off the pinhole: its reprojections miss by tens of px
    pin = np.stack([KB8[0] * p1[:, 0] / p1[:, 2] + KB8[2], KB8[1] * p1[:, 1] / p1[:, 2] + KB8[3]],
                   -1)
    assert np.median(np.linalg.norm(pin - uv1, axis=1)) > 10.0
    seed = 11
    j = jsim3.solve_sim3_ransac(jax.random.PRNGKey(seed),
                                *map(jnp.asarray, (p1, p2, uv1, uv2, val)), JPROJ, fix_scale)
    r = sim3.solve_sim3_ransac(t(jax_sim3_sets(seed, val).astype(np.int64)),
                               *map(t, (p1, p2, uv1, uv2, val)), CAM, fix_scale)
    assert bool(r.success) == bool(j.success)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))
    assert int(r.n_inliers) == int(np.asarray(j.inliers).sum()) > 100
    np.testing.assert_allclose(r.R12.numpy(), np.asarray(j.R12), atol=1e-4)
    np.testing.assert_allclose(r.t12.numpy(), np.asarray(j.t12), atol=1e-4)
    assert float(r.s12) == pytest.approx(float(j.s12), abs=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_kb8(fix_scale):
    p1, p2, uv1, uv2, val, (R, tt, s) = kb8_sim3_scene(4, 300, 0.1, fix_scale)
    if fix_scale:
        s = 1.0
    Ri, ti, si = R.T, -(R.T @ tt) / s, 1.0 / s
    R0 = (pf.so3_exp_np([0.02, 0.0, -0.01]) @ Ri).astype(np.float32)
    t0 = (ti + np.array([0.05, 0.0, -0.03])).astype(np.float32)
    s0 = np.float32(si * (1.0 if fix_scale else 1.03))
    j = jsim3.optimize_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0),
                            *map(jnp.asarray, (p1, p2, uv1, uv2, val)), JPROJ, fix_scale)
    r = sim3.optimize_sim3(t(R0), t(t0), torch.tensor(s0), *map(t, (p1, p2, uv1, uv2, val)), CAM,
                           fix_scale)
    assert int(r.n_in) == int(j.n_in) > 150
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_allclose(r.R12.numpy(), np.asarray(j.R12), atol=1e-4)
    np.testing.assert_allclose(r.t12.numpy(), np.asarray(j.t12), atol=1e-4)
    assert float(r.s12) == pytest.approx(float(j.s12), abs=1e-4)


def kb8_search_scene(seed: int, M: int = 400, N: int = 300):
    """N keypoints within 75 degrees of the KB8 camera's axis and M map
    points; the first 200 are noisy copies of keypoints (12 descriptor bits
    flipped, 1-3 px), the points on their keypoints' rays 2-8 m away."""
    rng = np.random.default_rng(seed)
    fx, _, cx, cy = KB8[:4]
    ang = rng.uniform(0, 2 * np.pi, 4 * N)
    rad = np.sqrt(rng.uniform(0, 1, 4 * N)) * 75.0 / 180.0 * np.pi * fx
    kp_xy = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)[:N].astype(np.float32)
    kp_oct = rng.integers(0, 8, N).astype(np.int32)
    kp_desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kp_valid = rng.random(N) < 0.9
    src = rng.choice(N, 200, replace=False)
    uv = np.stack([rng.uniform(0, 512, M), rng.uniform(0, 512, M)], -1)
    uv[:200] = kp_xy[src] + rng.normal(0, 2.0, (200, 2))
    rays = pf.kb8_rays(uv[:, 0], uv[:, 1], KB8).T
    R = pf.so3_exp_np([0.01, -0.02, 0.005]).astype(np.float32)
    tt = np.array([0.02, -0.01, 0.05], np.float32)
    pc = rays * rng.uniform(2, 8, M)[:, None]
    mp_pos = ((pc - tt) @ R).astype(np.float32)
    mp_desc = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    for i, k in enumerate(src):
        row = kp_desc[k].copy()
        for b in rng.choice(256, 12, replace=False):
            row[b // 8] ^= np.uint8(1 << (b % 8))
        mp_desc[i] = row
    mp_oct = np.clip(kp_oct[np.resize(src, M)] + rng.integers(-1, 2, M), 0, 7)
    ctr = -R.T @ tt
    view = mp_pos - ctr
    dist = np.linalg.norm(view, axis=1)
    normal = (view / dist[:, None] + rng.normal(0, 0.02, (M, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    maxd = (dist * 1.2 ** mp_oct * rng.uniform(0.9, 1.1, M)).astype(np.float32)
    return dict(kp_xy=kp_xy, kp_oct=kp_oct, kp_desc=kp_desc, kp_valid=kp_valid, R=R, t=tt,
                mp_pos=mp_pos, mp_desc=mp_desc, mp_valid=rng.random(M) < 0.95, normal=normal,
                maxd=maxd)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale,th", [(1.0, 7.5), (0.8, 5.0)])
def test_search_by_projection_sim3_kb8(seed, scale, th):
    s = kb8_search_scene(seed)
    free = s["kp_valid"] & (np.random.default_rng(seed).random(len(s["kp_valid"])) < 0.9)
    args = [s["mp_pos"] / np.float32(scale), s["mp_desc"], s["mp_valid"], s["normal"],
            s["maxd"] / np.float32(scale), np.float32(scale), s["R"], s["t"], s["kp_xy"],
            s["kp_desc"], s["kp_oct"], free]
    j = np.asarray(jfm.search_by_projection_sim3(*map(jnp.asarray, args), JPROJ,
                                                 SCALES, (512.0, 512.0), th))
    p = fm.search_by_projection_sim3(*[torch.from_numpy(np.array(a)) for a in args], CAM,
                                     SCALES, (512.0, 512.0), th)
    assert (j >= 0).sum() > 50
    np.testing.assert_array_equal(p.numpy(), j)


def kb8_gba_problem(dev=CPU):
    """A window-BA-shaped problem through KB8 (chip_smoke.ba_problem: two
    fixed keyframes, 5% gross outliers) as one shard."""
    return chip_smoke.ba_problem(np.random.default_rng(6), dev, n_kf=6, n_pts=300, Kp=8,
                                 Pp=384, Op=2048, kb8=KB8)


def test_schur_gba_kb8_matches_one_device_mesh():
    p = kb8_gba_problem()
    r = sharded_ba.optimize_schur(p, CAM)
    jp = jba.BAProblem(*[jnp.asarray(a.numpy()) for a in p[:10]])
    j = jsba.optimize_schur_sharded(jmesh.make_mesh(1), jp, JPROJ)
    np.testing.assert_allclose(r.R.numpy(), np.asarray(j.R), atol=1e-3)
    np.testing.assert_allclose(r.t.numpy(), np.asarray(j.t), atol=1e-3)
    np.testing.assert_allclose(r.points.numpy(), np.asarray(j.points), atol=1e-3)
    assert float(r.cost) == pytest.approx(float(j.cost), rel=1e-3)
    assert float(r.cost) < 0.9 * float(sharded_ba.optimize_schur(p, CAM, n_iters=0).cost)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(j.inliers))


# ------------------------------------------------------ card (K12, K14<KB8>)


@pytest.mark.gpu
def test_sim3_kb8_kernels_match_plain(cuda_device):
    p1, p2, uv1, uv2, val, _ = kb8_sim3_scene(7, 512, 0.3)
    args = [t(a).to(cuda_device) for a in (p1, p2, uv1, uv2, val)]
    sets = sim3.sample_sim3_sets(2, torch.from_numpy(val)).to(cuda_device)
    kernels.LAUNCHES.clear()
    for fix in (False, True):
        rk = sim3.solve_sim3_ransac(sets, *args, CAM, fix)
        rp = sim3.solve_sim3_ransac_plain(sets, *args, CAM, fix)
        assert torch.equal(rk.inliers, rp.inliers) and int(rk.n_inliers) == int(rp.n_inliers)
        assert float((rk.R12 - rp.R12).abs().max()) <= 1e-4
        ok, op = (f(rp.R12, rp.t12, rp.s12, *args, CAM, fix)
                  for f in (sim3.optimize_sim3, sim3.optimize_sim3_plain))
        assert int(ok.n_in) == int(op.n_in) > 100
        assert float((ok.R12 - op.R12).abs().max()) <= 1e-4
        assert float((ok.t12 - op.t12).abs().max()) <= 1e-4
    assert kernels.LAUNCHES["sim3_ransac_kb8"] == kernels.LAUNCHES["sim3_ransac"] == 2
    assert kernels.LAUNCHES["sim3_optimize_kb8"] == kernels.LAUNCHES["sim3_optimize"] == 2


@pytest.mark.gpu
def test_schur_kb8_kernel_matches_plain(cuda_device):
    gb = kb8_gba_problem(cuda_device)
    kernels.LAUNCHES.clear()
    bk, bp = sharded_ba.optimize_schur(gb, CAM), sharded_ba.optimize_schur_plain(gb, CAM)
    assert kernels.LAUNCHES["ba_schur_kb8"] == kernels.LAUNCHES["ba_schur"] == 1
    assert float((bk.points - bp.points).abs().max()) <= 1e-3
    assert float((bk.t - bp.t).abs().max()) <= 1e-3
    assert float(bk.cost) == pytest.approx(float(bp.cost), rel=1e-3)
    assert torch.equal(bk.inliers, bp.inliers)


@pytest.mark.gpu
def test_schur_kb8_kernel_deterministic(cuda_device):
    """K14<KB8> with fixed-order sums: 20 calls on one problem, one result."""
    gb = kb8_gba_problem(cuda_device)
    first = sharded_ba.optimize_schur(gb, CAM)
    for _ in range(19):
        r = sharded_ba.optimize_schur(gb, CAM)
        assert all(torch.equal(getattr(r, f), getattr(first, f)) for f in r._fields)
