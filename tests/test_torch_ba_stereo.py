"""The window BA's stereo rows and its dense-Schur solver in the PyTorch
port (plain path) against the JAX package.

The problems are ``chip_smoke.ba_problem`` at a small size (5 keyframes,
the first two fixed, 300 points, padded to 8 / 384 / 2048), with every
other observation given a right-image u (``stereo_bf``), through the
pinhole or TUM-VI's KB8 camera, and each also with five observed points
fixed.  Held: R, t and points within 1e-4, cost rtol 1e-4, inliers equal.

``solver="cg"`` through the pinhole is held in float32, as both packages
run it.  The ``schur_dense`` cases are held in float64 on both sides: in
float32 the two packages' dense LU solves (XLA's and LAPACK's) round
differently, and the LM accept decisions between costs a few ulps apart
then part the two runs (up to 3e-4 on points here, costs within 5e-5); in
float64 they agree to 1e-12.  So is the KB8 case: in float32 three far
points seen at wide angles, weakly constrained in depth, part by up to
3e-3 between the two PCG solves (JAX's jacfwd Jacobian against the port's
closed form), as in ``tests/test_torch_kb8.py``.  JAX's ``schur_dense``
also eliminates fixed points into the reduced system (``ba.py:218``: W has
no free mask), so a fixed point still shapes the pose step; the port
matches it (ROADMAP C.2), pinned by the fixed-point cases.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.slam.track_device import kb8_project as j_kb8
from extractorb_tpu.slam.track_device import pinhole_project as j_pinhole
from extractorb_tpu.solver import ba as jba
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.core.camera import KannalaBrandt8, Pinhole
from extractorb_tpu_torch.solver import ba
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

K = pf.camera_matrix(chip_smoke.WIDTH, chip_smoke.HEIGHT)
PIN = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
KB8 = pf.KB8_TUMVI
BF = {"pinhole": PIN[0] * chip_smoke.STEREO_BASELINE, "kb8": KB8[0] * chip_smoke.KB8_BASELINE}
N_ITERS, CG_ITERS = 8, 30


def cams(camera: str):
    """The port's camera and the JAX projection closure."""
    if camera == "kb8":
        return KannalaBrandt8(*KB8), j_kb8(*KB8)
    return Pinhole(*PIN), j_pinhole(*PIN)


@functools.lru_cache(maxsize=None)
def problem(stereo: bool, camera: str, fixed_point: bool) -> ba.BAProblem:
    p = chip_smoke.ba_problem(np.random.default_rng(3), torch.device("cpu"), n_kf=5, n_pts=300,
                              Kp=8, Pp=384, Op=2048, kb8=KB8 if camera == "kb8" else None,
                              stereo_bf=BF[camera] if stereo else None)
    if fixed_point:
        fixed = p.fixed_mp.clone()
        fixed[:5] = True
        p = p._replace(fixed_mp=fixed)
    return p


def to_jax(p: ba.BAProblem, dtype):
    cast = lambda a: jnp.asarray(a.numpy().astype(dtype) if a.is_floating_point() else a.numpy())
    return jba.BAProblem(*[None if a is None else cast(a) for a in p])


def to_f64(p: ba.BAProblem) -> ba.BAProblem:
    return ba.BAProblem(*[None if a is None else (a.double() if a.is_floating_point() else a)
                          for a in p])


CASES = [("cg", True, "pinhole"), ("schur_dense", False, "pinhole"),
         ("schur_dense", True, "pinhole"), ("cg", True, "kb8")]


@pytest.mark.parametrize("fixed_point", [False, True], ids=["free", "fixed-point"])
@pytest.mark.parametrize("solver,stereo,camera", CASES,
                         ids=["cg-stereo", "dense-mono", "dense-stereo", "cg-stereo-kb8"])
def test_ba_matches_jax(solver, stereo, camera, fixed_point):
    p = problem(stereo, camera, fixed_point)
    bf = BF[camera] if stereo else 0.0
    cam, jproject = cams(camera)
    f64 = solver == "schur_dense" or camera == "kb8"
    kw = dict(n_iters=N_ITERS, cg_iters=CG_ITERS, bf=bf, solver=solver)
    with jax.enable_x64(f64):
        want = jba.optimize(to_jax(p, np.float64 if f64 else np.float32), jproject, **kw)
        want = jax.tree_util.tree_map(np.asarray, want)
    got = ba.optimize(to_f64(p) if f64 else p, cam, **kw)
    for f in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f), atol=1e-4, rtol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(got.inliers.numpy(), want.inliers)
    assert float(got.cost) == pytest.approx(float(want.cost), rel=1e-4)
    # the solve moved the free keyframes, kept the fixed ones and points,
    # and rejected the gross outliers
    start = ba.optimize(p, cam, n_iters=0, bf=bf, solver=solver)
    assert float(got.cost) < 0.5 * float(start.cost)
    np.testing.assert_array_equal(got.t.numpy()[:2], p.t.numpy()[:2])
    fixed = p.fixed_mp.numpy()
    np.testing.assert_array_equal(got.points.numpy()[fixed], p.points.numpy()[fixed])
    n_valid = int(p.obs_valid.sum())
    assert int(got.inliers.sum()) <= n_valid - int(0.03 * n_valid)


def test_stereo_rows_change_the_solve():
    """The stereo rows take part: the same problem without them gives
    another cost, and a third row of a mono observation (ur < 0) is zero."""
    p = problem(True, "pinhole", False)
    cam, _ = cams("pinhole")
    st = ba.optimize(p, cam, n_iters=2, cg_iters=CG_ITERS, bf=BF["pinhole"])
    mono = ba.optimize(p._replace(obs_ur=None), cam, n_iters=2, cg_iters=CG_ITERS)
    assert float(st.cost) > float(mono.cost)
    r, Jp, Jl = ba._residual_jac(p.R, p.t, p.points, p, cam, BF["pinhole"])
    m = p.obs_ur < 0
    assert r.shape[1] == 3 and bool((r[m, 2] == 0).all()) and bool((Jp[m, 2] == 0).all())
    assert bool((Jl[m, 2] == 0).all()) and bool((Jp[~m & p.obs_valid, 2] != 0).any())


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="solver"):
        ba.optimize(problem(False, "pinhole", False), cams("pinhole")[0], solver="lu")


# ------------------------------------------------------------------ card


# the card's problem sizes: (keyframes, points, Kp, Pp, Op); Kp 32 is the
# window BA's padding, Kp 64 its largest, K 256 the most K35 takes (its
# tiles then outgrow the cluster's shared memory and live in L2)
SIZES = {"Kp32": (6, 1000, 32, 2048, 8192), "Kp64": (12, 1000, 64, 2048, 16384),
         "K256": (24, 500, 256, 512, 12288)}


@pytest.mark.gpu
@pytest.mark.parametrize("solver,stereo,camera,size,fixed_point",
                         [c + ("Kp32", f) for c in CASES + [("schur_dense", True, "kb8")]
                          for f in (False, True)]
                         + [("schur_dense", True, "pinhole", "Kp64", False),
                            ("schur_dense", True, "pinhole", "K256", False)])
def test_kernels_match_plain(cuda_device, solver, stereo, camera, size, fixed_point):
    """K6 <stereo> and K35 against their plain versions on the card, at
    the window BA's padding (Kp 32, Pp 2048, Op 8192), each also with five
    observed points fixed (which K35 still eliminates into S), and K35 on
    one problem at Kp 64 and one at K 256: poses within 1e-4, the same
    inliers, cost rtol 1e-4, and 20 calls one result.  Not at Kp 64 and K
    256 with fixed points: there S's condition is ~1e8 and the LM stops
    after its first step, so the two float32 solves keep their own ~1e-3
    of the step apart (ROADMAP C.10)."""
    cam, _ = cams(camera)
    n_kf, n_pts, Kp, Pp, Op = SIZES[size]
    p = chip_smoke.ba_problem(np.random.default_rng(1), cuda_device, n_kf=n_kf, n_pts=n_pts,
                              Kp=Kp, Pp=Pp, Op=Op, kb8=KB8 if camera == "kb8" else None,
                              stereo_bf=BF[camera] if stereo else None)
    if fixed_point:
        fixed = p.fixed_mp.clone()
        fixed[:5] = True
        p = p._replace(fixed_mp=fixed)
    bf = BF[camera] if stereo else 0.0
    n0 = dict(kernels.LAUNCHES)
    first = ba.optimize(p, cam, bf=bf, solver=solver)
    torch.cuda.synchronize()
    for name, on in (("ba_pcg", True), ("ba_pcg_stereo", stereo),
                     ("ba_schur_dense", solver == "schur_dense"), ("ba_pcg_kb8", camera == "kb8"),
                     ("ba_pcg_stereo_kb8", stereo and camera == "kb8")):
        assert kernels.LAUNCHES[name] == n0.get(name, 0) + int(on), name
    want = ba.optimize_plain(p, cam, bf=bf, solver=solver)
    assert float((first.R - want.R).abs().max()) <= 1e-4
    assert float((first.t - want.t).abs().max()) <= 1e-4
    assert torch.equal(first.inliers, want.inliers)
    assert float(first.cost) == pytest.approx(float(want.cost), rel=1e-4)
    for _ in range(19):
        r = ba.optimize(p, cam, bf=bf, solver=solver)
        assert all(torch.equal(getattr(r, f), getattr(first, f)) for f in ba.BAResult._fields)
