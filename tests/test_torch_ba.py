"""Bundle adjustment of the PyTorch port (plain path) against the JAX
package, on problems padded the way ``run_ba`` pads them (Kp 32, Pp 2048,
Op 8192: padded keyframes and points fixed, padded observations invalid).

The scenes are ``tests/test_solver.py:make_ba_scene`` with 20 gross
outliers.  Two keyframes are fixed, so the problem has no gauge freedom
left: with one fixed keyframe the scale is free, and the two solvers'
rounding walks along it (their costs still agree).  Tolerances: R, t and
points within 1e-3, chi2 inliers agree on >= 99.5% of the observations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extractorb_tpu.core import lie as jlie
from extractorb_tpu.solver import ba as jba
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.solver import ba
from test_solver import CX, CY, FX, FY, make_ba_scene, project
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

CAM = Pinhole(FX, FY, CX, CY)
KP, PP, OP = 32, 2048, 8192


def padded_problem(seed: int, n_kf: int):
    rng = np.random.default_rng(seed)
    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=n_kf, n_mp=150)
    K, P, O = len(Rs), len(pts), len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    obs_uv[rng.choice(O, 20, replace=False)] += 40.0
    Rs_n, ts_n = Rs.copy(), ts.copy()
    for k in range(2, K):
        dR, dt = jlie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    R_p = np.tile(np.eye(3, dtype=np.float32), (KP, 1, 1))
    R_p[:K] = Rs_n
    pts_p = pad(pts_n, PP)
    pts_p[P:, 2] = 1.0
    fixed_kf = np.ones(KP, bool)
    fixed_kf[2:K] = False
    isig = np.ones(OP, np.float32)
    isig[:O] = 1.2 ** (-2.0 * rng.integers(0, 3, O))
    return dict(R=R_p, t=pad(ts_n.astype(np.float32), KP), points=pts_p,
                obs_kf=pad(obs_kf, OP), obs_mp=pad(obs_mp, OP), obs_uv=pad(obs_uv, OP),
                inv_sigma2=isig, obs_valid=pad(np.ones(O, bool), OP),
                fixed_kf=fixed_kf, fixed_mp=np.arange(PP) >= P)


@pytest.mark.parametrize("seed,n_kf,n_iters,cg_iters", [(0, 4, 12, 40), (1, 8, 5, 25)],
                         ids=["init-budget", "window-budget"])
def test_optimize_matches_jax(seed, n_kf, n_iters, cg_iters):
    arrs = padded_problem(seed, n_kf)
    j = jba.optimize(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}), project,
                     n_iters=n_iters, cg_iters=cg_iters)
    j = jax.tree_util.tree_map(np.asarray, j)
    p = ba.optimize(ba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrs.items()}), CAM,
                    n_iters=n_iters, cg_iters=cg_iters)
    np.testing.assert_allclose(p.R.numpy(), j.R, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p.t.numpy(), j.t, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p.points.numpy(), j.points, atol=1e-3, rtol=0)
    assert (p.inliers.numpy() == j.inliers).mean() >= 0.995
    # fixed and padded blocks stay where they were (up to the final
    # re-orthonormalization of every rotation); outliers are found
    np.testing.assert_allclose(p.R.numpy()[:2], arrs["R"][:2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(p.t.numpy()[:2], arrs["t"][:2])
    np.testing.assert_array_equal(p.points.numpy()[arrs["fixed_mp"]],
                                  arrs["points"][arrs["fixed_mp"]])
    assert int(p.inliers.sum()) <= int(arrs["obs_valid"].sum()) - 15
    np.testing.assert_allclose(float(p.cost), float(j.cost), rtol=1e-4)


def test_unported_options_raise():
    """The options the port once refused now run and hold to JAX: the
    stereo rows (every valid observation's ur at bf 40, cg) and
    ``schur_dense`` (mono), on the init-budget problem.  ``schur_dense``
    runs in float64 on both sides: in float32 XLA's and LAPACK's dense LU
    round differently.  (Their cases with KB8 and fixed points are in
    tests/test_torch_ba_stereo.py.)"""
    arrs = padded_problem(0, 4)
    z = np.einsum("oij,oj->oi", arrs["R"][arrs["obs_kf"]], arrs["points"][arrs["obs_mp"]])[:, 2] \
        + arrs["t"][arrs["obs_kf"]][:, 2]
    ur = np.where(arrs["obs_valid"], arrs["obs_uv"][:, 0] - 40.0 / z, -1.0).astype(np.float32)
    f64 = lambda a: {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in a.items()}
    for a, kw in (({**arrs, "obs_ur": ur}, dict(bf=40.0)), (f64(arrs), dict(solver="schur_dense"))):
        with jax.enable_x64(a["R"].dtype == np.float64):
            j = jba.optimize(jba.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()}), project,
                             n_iters=12, cg_iters=40, **kw)
            j = jax.tree_util.tree_map(np.asarray, j)
        p = ba.optimize(ba.BAProblem(**{k: torch.from_numpy(v) for k, v in a.items()}), CAM,
                        n_iters=12, cg_iters=40, **kw)
        for f in ("R", "t", "points"):
            np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                       atol=1e-3, rtol=0, err_msg=f)
        assert (p.inliers.numpy() == np.asarray(j.inliers)).mean() >= 0.995
        np.testing.assert_allclose(float(p.cost), float(j.cost), rtol=1e-4)


# K6's cases on the card: (problem, camera name, n_iters, cg_iters, stereo).
# The engine's calls: the init BA (run_ba's init shape, 12 x 40), the weld
# (run_ba's defaults, 10 x 40), the window BA (5 x 25), run_ba's largest
# bucket (Pp 8192, Op 32768); KB8 and the stereo rows at Kp 32.  Through
# KB8 the poses are held to 1e-4 and the points are not, as in
# [parity-kb8] and tests/test_torch_kb8.py: the problem's far points at
# wide angles, weak in depth, part by up to ~4e-4 between the kernel's
# closed-form KB8 Jacobian and the plain version's (the same before the
# solve became one launch).
KERNEL_CASES = {
    "scene-12x40": (None, "pinhole", 12, 40, False),
    "init-12x40": (dict(seed=1), "pinhole", 12, 40, False),
    "weld-10x40": (dict(seed=4, n_kf=8), "pinhole", 10, 40, False),
    "window-5x25": (dict(seed=5, n_kf=10, Op=16384), "pinhole", 5, 25, False),
    "Pp8192-Op32768": (dict(seed=6, n_kf=10, n_pts=3000, Pp=8192, Op=32768), "pinhole", 10, 40,
                       False),
    "kb8-Kp32": (dict(seed=1), "kb8", 12, 40, False),
    "stereo-Kp32": (dict(seed=3), "pinhole", 10, 40, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_optimize_kernel_matches_plain(case, cuda_device):
    """K6 (one cluster launch a call) within 1e-4 of the plain version with
    the inliers equal, 20 calls one result, and (mono) bit-equal to K6's
    passes launched one by one (K33's route on one shard)."""
    import chip_smoke
    import port_fixtures as pf
    from extractorb_tpu_torch import kernels
    from extractorb_tpu_torch.core.camera import KannalaBrandt8
    from extractorb_tpu_torch.dist import mesh as dmesh
    from extractorb_tpu_torch.dist import sharded_ba

    spec, camera, n_iters, cg_iters, stereo = KERNEL_CASES[case]
    Kc = pf.camera_matrix(chip_smoke.WIDTH, chip_smoke.HEIGHT)
    bf = float(Kc[0, 0]) * chip_smoke.STEREO_BASELINE if stereo else 0.0
    if spec is None:
        arrs = padded_problem(0, 6)
        prob = ba.BAProblem(**{k: torch.from_numpy(v).to(cuda_device) for k, v in arrs.items()})
        cam = CAM
    else:
        spec = dict(spec)
        kb8 = pf.KB8_TUMVI if camera == "kb8" else None
        prob = chip_smoke.ba_problem(np.random.default_rng(spec.pop("seed")), cuda_device,
                                     kb8=kb8, stereo_bf=bf if stereo else None, **spec)
        cam = (KannalaBrandt8(*kb8) if kb8 is not None
               else Pinhole(float(Kc[0, 0]), float(Kc[1, 1]), float(Kc[0, 2]), float(Kc[1, 2])))
    before = kernels.LAUNCHES["ba_pcg"]
    k = ba.optimize(prob, cam, n_iters=n_iters, cg_iters=cg_iters, bf=bf)
    assert kernels.LAUNCHES["ba_pcg"] == before + 1
    p = ba.optimize_plain(prob, cam, n_iters=n_iters, cg_iters=cg_iters, bf=bf)
    held = ((k.R, p.R), (k.t, p.t)) + (((k.points, p.points),) if camera != "kb8" else ())
    for a, b in held:
        assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(k.inliers, p.inliers)
    for _ in range(20):
        again = ba.optimize(prob, cam, n_iters=n_iters, cg_iters=cg_iters, bf=bf)
        assert all(torch.equal(getattr(again, f), getattr(k, f)) for f in ba.BAResult._fields)
    if not stereo:
        m = sharded_ba.optimize_sharded(dmesh.Mesh([cuda_device]), prob, cam, n_iters, cg_iters)
        for f in ("R", "t", "points", "inliers"):
            assert torch.equal(getattr(m, f), getattr(k, f)), f
