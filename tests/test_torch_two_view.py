"""Two-view reconstruction of the PyTorch port (plain path) against the
JAX package.

Both get the same matched pairs of ``tests/test_two_view.py:make_scene``
(padded to the tracker's 1024 rows) and the same 200 minimal sets: the
JAX function draws them from its key inside the program, and
``jax_sets`` repeats that draw outside it for the port.  Tolerances:
``success`` and ``used_homography`` equal, R21/t21 within 1e-3, the
triangulated masks agree on >= 99% of the pairs; ``triangulate`` itself
within 1e-5 relative (the same f32 normal equations; XLA:CPU contracts
some products into FMAs, so the last bits differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from extractorb_tpu.geometry import two_view as jtv
from extractorb_tpu_torch.geometry import two_view as tv
from test_two_view import make_scene
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

N = 1024
SEED = 7


def jax_sets(seed: int, valid, n_sets: int = tv.N_RANSAC) -> np.ndarray:
    """The minimal sets jtv.reconstruct draws from PRNGKey(seed)."""
    valid = jnp.asarray(valid)

    def sample(k):
        p = jax.random.uniform(k, (valid.shape[0],)) + (~valid) * 10.0
        return jnp.argsort(p)[:8]

    return np.asarray(jax.vmap(sample)(jax.random.split(jax.random.PRNGKey(seed), n_sets)))


def padded_scene(planar: bool):
    K, R, t, x1, x2, pts, inliers = make_scene(np.random.default_rng(0), planar=planar)
    X1, X2, V = np.zeros((N, 2), np.float32), np.zeros((N, 2), np.float32), np.zeros(N, bool)
    X1[: len(x1)], X2[: len(x2)], V[: len(x1)] = x1, x2, True
    return K, R, t, X1, X2, V


@pytest.fixture(scope="module", params=[False, True], ids=["general", "planar"])
def both(request):
    K, R, t, x1, x2, valid = padded_scene(request.param)
    j = jtv.reconstruct(jax.random.PRNGKey(SEED), jnp.asarray(x1), jnp.asarray(x2),
                        jnp.asarray(valid), jnp.asarray(K))
    j = jax.tree_util.tree_map(np.asarray, j)
    sets = torch.from_numpy(jax_sets(SEED, valid))
    p = tv.reconstruct(sets, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid),
                       torch.from_numpy(K))
    p = {k: v.numpy() for k, v in p._asdict().items()}
    return request.param, (K, R, t), j, p


def test_reconstruct_matches_jax(both):
    planar, (_, R, t), j, p = both
    assert bool(p["success"]) and bool(j.success)
    assert bool(p["used_homography"]) == bool(j.used_homography) == planar
    np.testing.assert_allclose(p["R21"], j.R21, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p["t21"], j.t21, atol=1e-3, rtol=0)
    assert (p["is_triangulated"] == j.is_triangulated).mean() >= 0.99
    # and both recover the scene's motion
    np.testing.assert_allclose(p["R21"], R, atol=0.02, rtol=0)
    assert abs(abs(float(p["t21"] @ (t / np.linalg.norm(t)))) - 1.0) < 0.01


def test_degenerate_rotation_rejected():
    """Pure rotation has no parallax: neither package succeeds."""
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200), rng.uniform(3, 8, 200)],
                   -1)
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    proj = lambda P: (P @ K.T)[:, :2] / (P @ K.T)[:, 2:]
    x1, x2 = proj(pts).astype(np.float32), proj(pts @ R.T).astype(np.float32)
    valid = np.ones(200, bool)
    j = jtv.reconstruct(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2),
                        jnp.asarray(valid), jnp.asarray(K))
    p = tv.reconstruct(torch.from_numpy(jax_sets(0, valid)), torch.from_numpy(x1),
                       torch.from_numpy(x2), torch.from_numpy(valid), torch.from_numpy(K))
    assert not bool(j.success) and not bool(p.success)


def test_triangulate_matches_jax():
    rng = np.random.default_rng(3)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    P1 = np.concatenate([K, np.zeros((3, 1), np.float32)], 1)
    w = np.array([0.01, -0.02, 0.015])
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = (np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W).astype(np.float32)
    # a 1 m baseline at 3-8 m: the f32 Cramer solve of B^T B squares the
    # condition number (ROADMAP C.2); here both packages' own float32
    # error stays below the 1e-5 tolerance
    t = np.array([1.0, 0.05, -0.02], np.float32)
    P2 = (K @ np.concatenate([R, t[:, None]], 1)).astype(np.float32)
    pts = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500),
                    rng.uniform(3, 8, 500)], -1)
    x1 = (pts @ K.T)[:, :2] / (pts @ K.T)[:, 2:] + rng.normal(0, 0.3, (500, 2))
    pc2 = pts @ R.T + t
    x2 = (pc2 @ K.T)[:, :2] / (pc2 @ K.T)[:, 2:] + rng.normal(0, 0.3, (500, 2))
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    j = np.asarray(jtv.triangulate(*(jnp.asarray(a) for a in (P1, P2, x1, x2))))
    p = tv.triangulate(*(torch.from_numpy(a) for a in (P1, P2, x1, x2))).numpy()
    rel = np.linalg.norm(p - j, axis=1) / np.linalg.norm(j, axis=1)
    assert rel.max() <= 1e-5, rel.max()
    assert np.abs(p - pts).max() < 0.5


def test_sample_sets_draw_distinct_valid_first():
    valid = np.zeros(1024, bool)
    valid[:300] = True
    a = tv.sample_sets(11, valid)
    assert a.shape == (200, 8) and a.dtype == torch.int64
    assert bool((a < 300).all())
    assert all(len(set(row.tolist())) == 8 for row in a)
    assert torch.equal(a, tv.sample_sets(11, torch.from_numpy(valid)))
    assert not torch.equal(a, tv.sample_sets(12, valid))


@pytest.mark.gpu
@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
def test_reconstruct_kernel_matches_plain(planar, cuda_device):
    _, _, _, x1, x2, valid = padded_scene(planar)
    sets = tv.sample_sets(SEED, valid).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x1, x2, valid)]
    K = torch.from_numpy(make_scene(np.random.default_rng(0))[0])
    k = tv.reconstruct(sets, *args, K)
    p = tv.reconstruct_plain(sets, *args, K.to(cuda_device))
    assert bool(k.success) == bool(p.success) == True  # noqa: E712
    assert bool(k.used_homography) == bool(p.used_homography) == planar
    assert float((k.R21 - p.R21).abs().max()) <= 1e-4
    assert float((k.t21 - p.t21).abs().max()) <= 1e-4
    assert torch.equal(k.is_triangulated, p.is_triangulated)
