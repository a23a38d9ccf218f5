"""The pose optimisation above K4's staging limit, against the JAX package.

K4 stages a problem of up to ``pose_opt.pose_lm_max_n`` observations in a
CTA's shared memory (8886 mono, 7701 with the stereo u on an H100) and
takes its global route above that.  JAX's ``optimize_pose`` takes any N.
Here the port's plain version, which the global route is held to on the
card, meets JAX's at 9000 observations, mono and stereo: R and t within
1e-4, the inlier sets equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import port_fixtures as pf
from extractorb_tpu.slam.track_device import pinhole_project as j_pinhole
from extractorb_tpu.solver import pose_opt as jpo
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.solver import pose_opt
from torch_card import one_torch_thread  # noqa: F401  (autouse fixture)

FX, CX, CY = 500.0, 320.0, 240.0
N_LARGE = 9000


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_above_the_staging_limit_matches_jax(stereo):
    R0, t0, pts, obs, isig, valid, (R_true, _) = pf.synthetic_pose_problems(
        np.random.default_rng(11), 1, N_LARGE, FX, FX, CX, CY)
    kw, jkw = {}, {}
    if stereo:
        bf = 40.0
        rng = np.random.default_rng(12)
        pc = np.einsum("bij,bnj->bni", R0, pts) + t0[:, None]
        ur = (obs[..., 0] - bf / pc[..., 2]
              + rng.uniform(-0.5, 0.5, obs.shape[:2])).astype(np.float32)
        ur[rng.random(ur.shape) < 0.4] = -1.0
        kw = dict(obs_ur=torch.from_numpy(ur), bf=bf)
        jkw = dict(obs_ur=jnp.asarray(ur[0]), bf=bf)
    got = pose_opt.optimize_pose(*(torch.from_numpy(a) for a in (R0, t0, pts, obs, isig, valid)),
                                 Pinhole(FX, FX, CX, CY), **kw)
    want = jpo.optimize_pose(*(jnp.asarray(a[0]) for a in (R0, t0, pts, obs, isig, valid)),
                             j_pinhole(FX, FX, CX, CY), **jkw)
    np.testing.assert_allclose(got.R[0].numpy(), np.asarray(want.R), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.t[0].numpy(), np.asarray(want.t), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers[0]) == int(want.n_inliers)
    np.testing.assert_allclose(got.R[0].numpy(), R_true[0], atol=2e-3)
