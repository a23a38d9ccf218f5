"""The inertial post-loop GBA over a device mesh: the port's ``LoopCloser``
with an IMU calibration on 8 CPU shards against the JAX package's on its
virtual 8-device CPU mesh.

Both packages build the inertial looped map of ``port_fixtures``
(``build_looped_map(inertial=True)``) and close the loop keyframe by
keyframe, as ``tests/test_torch_inertial_loop.py`` does on one device.
Under ``use_devices([cpu] * 8)`` the port's closer runs FullInertialBA over
8 landmark shards (``full_inertial_ba(mesh=...)`` ->
``relayout_point_sharded`` -> ``optimize_vi_sharded``), as JAX's closer
does over its 8 devices; the one-shard port run takes the one-device solve.

- The route: one ``optimize_vi_sharded`` call on 8 shards, no one-device
  VI BA, the layout's lengths multiples of the mesh.
- The loop: the same closing keyframe in the 8-shard run, the one-shard run
  and JAX's, within half its drift.
- The problem: the port's ``full_inertial_ba`` on JAX's map taken just
  before JAX's GBA passes ``optimize_vi_sharded`` JAX's arrays, bit for
  bit.
- The solve: that call's float32 PCG breaks down on the map's
  single-observation points in both packages (ROADMAP C), so it is held in
  float64 on both sides: the port's plain 8-shard solve against JAX's
  ``optimize_vi_sharded`` on 8 devices under ``jax.enable_x64``, every
  state and point within 1e-6 after all 7 iterations, inliers equal.
"""

import contextlib
import copy

import jax
import numpy as np
import pytest
import torch

import port_fixtures as pf
from depth_system import patch_jax_draws
from extractorb_tpu.dist import mesh as jmesh
from extractorb_tpu.dist import sharded_ba as jsba
from extractorb_tpu.slam import imu_frontend as jfront
from extractorb_tpu.solver import inertial as jsin
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.dist import mesh as dmesh
from extractorb_tpu_torch.dist import sharded_ba
from extractorb_tpu_torch.slam import imu_frontend as front
from extractorb_tpu_torch.solver import inertial as sin
from test_torch_imu_frontend import port_map
from test_torch_inertial_loop import CALIB, KIND, SHIFT, centre, closer, integrator, jax_viba, spy
from test_torch_loop_closing import CX, CY, FX, jproject
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

CPU8 = [torch.device("cpu")] * 8
CAM = Pinhole(FX, FX, CX, CY)


def run(pkg, devices=None):
    """``pkg``'s closer over the inertial looped map until a loop closes
    (the port's over ``devices``, None: one shard).  Returns the map, the
    closer, the closing keyframe, the drift and the solver calls."""
    log = {"sharded": [], "viba": [], "gba": []}
    with pytest.MonkeyPatch.context() as m, \
            (dmesh.use_devices(devices) if devices else contextlib.nullcontext()):
        patch_jax_draws(m)
        spy(m, jsba if pkg == "jax" else sharded_ba, "optimize_vi_sharded", log["sharded"])
        spy(m, jsin if pkg == "jax" else sin, "optimize_vi_ba", log["viba"])
        if pkg == "jax":
            spy(m, jfront, "full_inertial_ba", log["gba"], before=lambda a: copy.deepcopy(a[0]))
        SM, KF, feats = KIND[pkg]
        mp, _, desc, centres = pf.build_looped_map(0, SM, KF, feats, return_shift=SHIFT,
                                                   inertial=True, preintegrate=integrator(pkg))
        drift = {k: float(np.linalg.norm(centre(kf) - centres[k]))
                 for k, kf in mp.keyframes.items()}
        cl = closer(pkg, desc)
        closed = next((kid for kid in sorted(mp.keyframes) if cl.process_keyframe(mp, kid)), None)
    return dict(mp=mp, closer=cl, closed=closed, centres=centres, drift=drift, log=log)


@pytest.fixture(scope="module")
def runs():
    return {"jax": run("jax"), "mesh": run("port", CPU8), "one": run("port")}


@pytest.fixture(scope="module")
def on_jax_map(runs):
    """The port's full_inertial_ba (7 iterations, as the closer) over 8 CPU
    shards on JAX's map taken just before JAX's GBA; its
    ``optimize_vi_sharded`` call."""
    (_, _, before), = runs["jax"]["log"]["gba"]
    got = []
    with pytest.MonkeyPatch.context() as m, dmesh.use_devices(CPU8):
        spy(m, sharded_ba, "optimize_vi_sharded", got)
        front.full_inertial_ba(port_map(before), CALIB, CAM, n_iters=7, device="cpu",
                               mesh=dmesh.make_mesh())
    return got


def test_gba_takes_the_8_shard_route(runs):
    for name in ("mesh", "jax"):
        log = runs[name]["log"]
        assert len(log["sharded"]) == 1 and not log["viba"], name
        (args, _, _), = log["sharded"]
        mesh, prob = args[0], args[1]
        assert dict(mesh.shape) == {"shard": 8}, name
        assert prob.points.shape[0] % 8 == 0 and prob.obs_kf.shape[0] % (8 * 128) == 0, name
    one = runs["one"]["log"]
    assert not one["sharded"] and len(one["viba"]) == 1
    (args, _, _), = runs["mesh"]["log"]["sharded"]
    assert all(d == torch.device("cpu") for d in args[0].devices)


def test_same_loop_as_jax_and_one_shard(runs):
    j, a, b = runs["jax"], runs["mesh"], runs["one"]
    assert j["closed"] is not None and a["closed"] == b["closed"] == j["closed"]
    for r in (j, a, b):
        assert r["closer"].n_loops == 1
        k = r["closed"]
        err = float(np.linalg.norm(centre(r["mp"].keyframes[k]) - r["centres"][k]))
        assert err < 0.5 * r["drift"][k]
        assert all(np.isfinite(kf.t).all() and np.isfinite(kf.v).all()
                   for kf in r["mp"].keyframes.values())


def test_sharded_problem_bit_equal_to_jax(runs, on_jax_map):
    """On the same map, the port's 8-shard problem is JAX's: the padding of
    the points to the mesh, the observations regrouped by point shard, the
    states and the chain, bit for bit."""
    (jargs, _, _), = runs["jax"]["log"]["sharded"]
    (pargs, _, _), = on_jax_map
    jprob, prob = jargs[1], pargs[1]
    assert pargs[0].size == jargs[0].shape["shard"] == 8
    for f in prob._fields:
        a, b = getattr(prob, f), getattr(jprob, f)
        if f == "chain":
            for g in a._fields:
                x, y = getattr(a, g).numpy(), np.asarray(getattr(b, g))
                assert x.dtype == y.dtype and np.array_equal(x, y), f"chain.{g}"
        elif f in ("prior_g", "prior_a"):
            assert a == b
        else:
            x, y = a.numpy(), np.asarray(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_sharded_solve_float64_matches_jax(runs):
    """The closer's own 8-shard call, in float64 on both sides: the port's
    plain 8-shard solve against JAX's ``optimize_vi_sharded`` on its 8
    devices, within 1e-6 after all 7 iterations.  It also witnesses the
    float32 breakdown: the float32 first candidate is not finite, the
    float64 one is, and the float64 solve descends."""
    (args, res, _), = runs["mesh"]["log"]["sharded"]
    mesh, prob = args[0], args[1]
    assert not np.isfinite(float(res.cost))   # the float32 solve's last candidate
    p64 = sin._cast(prob, torch.float64)
    r64 = sharded_ba.optimize_vi_sharded(mesh, p64, CAM, n_iters=7, cg_iters=40)
    with jax.enable_x64(True):
        j64 = jsba.optimize_vi_sharded(jmesh.make_mesh(8), jax_viba(p64), jproject, n_iters=7,
                                       cg_iters=40)
        for f in ("Rwb", "twb", "v", "bg", "ba", "points"):
            assert np.asarray(getattr(j64, f)).dtype == np.float64
            np.testing.assert_allclose(getattr(r64, f).numpy(), np.asarray(getattr(j64, f)),
                                       atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(r64.inliers.numpy(), np.asarray(j64.inliers))
    first = lambda q: float(sharded_ba.optimize_vi_sharded(mesh, q, CAM, n_iters=1,
                                                           cg_iters=40).cost)
    first64, first32 = first(p64), first(prob)
    assert np.isfinite(first64) and not np.isfinite(first32)
    assert float(r64.cost) < first64
