"""The marginalisation toolbox of the PyTorch port (``solver/marginal.py``,
plain path) against the JAX package's, and K36 against the plain version
on a card.

Information matrices H = A A^T + 0.1 I from a numpy seed at n = 9 (the
JAX test's, ``tests/test_solver.py:221``), 30 and 45, blocks up to 15 wide
(the inertial states), and one block holding a state with no information
(a zero row and column: the pseudo-inverse's 1e-6 cutoff drops its zero
singular value on both sides).  ``condition`` is bit-equal; ``marginalize``
and ``sparsify`` agree within JAX's own 2e-4 (rtol and atol, the JAX
test's tolerance against the analytic Schur complement).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extractorb_tpu.solver import marginal as jmg
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.solver import marginal as mg
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

# (n, marginalised block, sparsify's second block, a state with no information)
CASES = [(9, (3, 5), (6, 8), None), (9, (0, 2), (6, 8), None), (30, (0, 14), (15, 29), None),
         (30, (15, 29), (0, 14), 20), (45, (15, 29), (30, 44), None), (45, (0, 8), (36, 44), 3)]
IDS = [f"n{n}-{b[0]}-{b[1]}" + ("-void" if v is not None else "") for n, b, _, v in CASES]


def information(n: int, void=None) -> np.ndarray:
    rng = np.random.default_rng(n + (void or 0))
    A = rng.normal(size=(n, n + 3)).astype(np.float32)
    H = A @ A.T + 0.1 * np.eye(n, dtype=np.float32)
    if void is not None:
        H[void, :] = 0.0
        H[:, void] = 0.0
    return H.astype(np.float32)


@pytest.mark.parametrize("n,blk,blk2,void", CASES, ids=IDS)
def test_marginal_ops_match_jax(n, blk, blk2, void):
    H = information(n, void)
    (s, e), (s2, e2) = blk, blk2
    got = mg.marginalize(torch.from_numpy(H), s, e).numpy()
    want = np.asarray(jmg.marginalize(jnp.asarray(H), s, e))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.all(got[s:e + 1, :] == 0) and np.all(got[:, s:e + 1] == 0)
    np.testing.assert_array_equal(mg.condition(torch.from_numpy(H), s, e).numpy(),
                                  np.asarray(jmg.condition(jnp.asarray(H), s, e)))
    got = mg.sparsify(torch.from_numpy(H), s, e, s2, e2).numpy()
    want = np.asarray(jmg.sparsify(jnp.asarray(H), s, e, s2, e2))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_marginalize_is_the_schur_complement():
    """On a block with full rank the pseudo-inverse is the inverse: the
    analytic Schur complement (float64) within 2e-4."""
    H = information(30)
    keep = np.r_[0:10, 20:30]
    Hd = H.astype(np.float64)
    schur = Hd[np.ix_(keep, keep)] - Hd[np.ix_(keep, range(10, 20))] @ np.linalg.inv(
        Hd[10:20, 10:20]) @ Hd[np.ix_(range(10, 20), keep)]
    got = mg.marginalize(torch.from_numpy(H), 10, 19).numpy()
    np.testing.assert_allclose(got[np.ix_(keep, keep)], schur, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ card


@pytest.mark.gpu
@pytest.mark.parametrize("n,blk,blk2,void", CASES, ids=IDS)
def test_kernel_matches_plain(cuda_device, n, blk, blk2, void):
    """K36 against the plain version on the card: condition bit-equal,
    marginalize and sparsify within 1e-5 of max|H|, one launch a call and
    20 calls one result."""
    H = torch.from_numpy(information(n, void)).to(cuda_device)
    (s, e), (s2, e2) = blk, blk2
    tol = 1e-5 * float(H.abs().max())
    n0 = kernels.LAUNCHES["marginal"]
    got = [mg.condition(H, s, e), mg.marginalize(H, s, e), mg.sparsify(H, s, e, s2, e2)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["marginal"] == n0 + 3
    assert torch.equal(got[0], mg.condition_plain(H, s, e))
    assert float((got[1] - mg.marginalize_plain(H, s, e)).abs().max()) <= tol
    assert float((got[2] - mg.sparsify_plain(H, s, e, s2, e2)).abs().max()) <= tol
    for _ in range(19):
        assert torch.equal(mg.sparsify(H, s, e, s2, e2), got[2])
        assert torch.equal(mg.marginalize(H, s, e), got[1])


@pytest.mark.gpu
def test_kernel_refuses_wide_blocks_and_float64(cuda_device):
    H = torch.from_numpy(information(45)).to(cuda_device)
    with pytest.raises(ValueError, match="wider"):
        mg.marginalize(H, 0, 15)
    with pytest.raises(ValueError, match="float32"):
        mg.condition(H.double(), 0, 3)
