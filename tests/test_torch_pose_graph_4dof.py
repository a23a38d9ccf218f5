"""The 4-DoF essential graph of inertial maps (``solver/pose_graph.py``)
and the SE3 maps it needs (``core/lie.py``) against the JAX package's.

The same seeded numpy inputs go through both: ``se3_log``,
``se3_inverse`` and ``se3_compose`` within 1e-6 (the theta -> 0 branch
included), the plain 4-DoF LM on the circle graph of
tests/test_sim3_posegraph.py and on a seeded graph of cameras with their
own roll and pitch (poses within 1e-4), roll and pitch left where they were
(1e-5), and the JAX problem carried over by ``interop``.  On a card, K23
holds to its plain version within 1e-4 and gives one result over 20 calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.core import lie as jlie
from extractorb_tpu.solver import pose_graph as jpg
from extractorb_tpu_torch import interop, kernels
from extractorb_tpu_torch.core import lie
from extractorb_tpu_torch.solver import pose_graph
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def se3_inputs(rng, n: int = 64):
    """Rotations of angles from 1e-6 to 3 rad (the first quarter below
    the Taylor guards) and translations of a few metres."""
    ang = np.concatenate([10.0 ** rng.uniform(-6, -4.5, n // 4),
                          rng.uniform(1e-3, 3.0, n - n // 4)])
    axis = rng.normal(size=(n, 3))
    w = axis / np.linalg.norm(axis, axis=1, keepdims=True) * ang[:, None]
    R = np.stack([pf.so3_exp_np(x) for x in w]).astype(np.float32)
    return R, rng.normal(0, 2.0, (n, 3)).astype(np.float32)


def test_se3_maps_match_jax():
    rng = np.random.default_rng(0)
    R, tt = se3_inputs(rng)
    R2, t2 = se3_inputs(rng)
    np.testing.assert_allclose(lie.se3_log(t(R), t(tt)).numpy(),
                               np.asarray(jlie.se3_log(jnp.asarray(R), jnp.asarray(tt))),
                               atol=1e-6)
    for got, want in zip(lie.se3_inverse(t(R), t(tt)),
                         jlie.se3_inverse(jnp.asarray(R), jnp.asarray(tt))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for got, want in zip(lie.se3_compose(t(R), t(tt), t(R2), t(t2)),
                         jlie.se3_compose(jnp.asarray(R), jnp.asarray(tt), jnp.asarray(R2),
                                          jnp.asarray(t2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the inverse left Jacobian's Taylor branch is taken at theta^2 < 1e-8
    phi = np.array([[1e-5, -2e-5, 3e-6], [0.0, 0.0, 0.0]], np.float32)
    np.testing.assert_allclose(lie.so3_left_jacobian_inv(t(phi)).numpy(),
                               np.asarray(jlie.so3_left_jacobian_inv(jnp.asarray(phi))),
                               atol=1e-7)


@pytest.fixture
def jax_x64():
    """JAX in float64 for one test (restored after it)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def problems(fields, dtype=np.float32):
    """The port's problem (CPU) and JAX's from the same numpy fields."""
    fields = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in fields.items()}
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return (interop.pose_graph_4dof_from_numpy(fields, torch.device("cpu"), tdt),
            jpg.PoseGraph4DoFProblem(**{k: jnp.asarray(v) for k, v in fields.items()}))


GRAPHS = {"circle": lambda: pf.pose_graph_4dof_circle()[0],
          "random": lambda: pf.pose_graph_4dof_random(np.random.default_rng(3))}


def solve_both(fields, n_iters, cg, dtype=np.float32):
    p, jp = problems(fields, dtype)
    R, tt, c = pose_graph.optimize_pose_graph_4dof_plain(p, n_iters, cg)
    jR, jt, jc = jpg.optimize_pose_graph_4dof(jp, n_iters, cg)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert float(c) == pytest.approx(float(jc), rel=1e-5)
    return p, R, tt


def test_plain_solve_matches_jax_on_the_circle_in_float64(jax_x64):
    """The JAX test's circle (25 LM x 40 PCG) in float64 on both sides.  Its
    optimum is flat along the translations the chain's roll and pitch drift
    leaves free: near it the float32 cost changes by less than its own
    rounding, so float32 runs accept different late steps (the float32
    solves of either package end up to 2e-4 from the float64 one, in the
    flat direction, at the same cost within 1e-5 relative)."""
    fields = GRAPHS["circle"]()
    p, R, _ = solve_both(fields, 25, 40, np.float64)
    assert R.dtype == torch.float64
    assert np.abs(pf.gravity_in_cameras(R.numpy()) - pf.gravity_in_cameras(fields["R"])).max() \
        < 1e-5


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_solve_matches_jax_and_keeps_roll_and_pitch(name):
    fields = GRAPHS[name]()
    if name == "circle":   # float32: the same cost (see the float64 case), roll and pitch
        p, jp = problems(fields)
        R, tt, c = pose_graph.optimize_pose_graph_4dof_plain(p, 25, 40)
        assert float(c) == pytest.approx(float(jpg.optimize_pose_graph_4dof(jp, 25, 40)[2]),
                                         rel=1e-5)
    else:
        p, R, tt = solve_both(fields, 15, 50)
    g0, g1 = pf.gravity_in_cameras(fields["R"]), pf.gravity_in_cameras(R.numpy())
    assert np.abs(g1 - g0).max() < 1e-5
    # the solve moved the free keyframes, not the fixed one's translation
    assert float((tt - p.t).abs().max()) > 1e-3
    assert torch.equal(tt[0], p.t[0])


def test_circle_graph_closes_the_loop():
    """The JAX test's bound on the circle: the trajectory error falls to
    under 0.35 of the drifted start's."""
    fields, centres = pf.pose_graph_4dof_circle()
    p, _ = problems(fields)
    R, tt, _ = pose_graph.optimize_pose_graph_4dof(p, n_iters=25, cg_iters=40)
    err = lambda R_, t_: np.sqrt(np.mean(np.sum(
        (-np.einsum("kji,kj->ki", R_, t_) - centres) ** 2, -1)))
    assert err(R.numpy(), tt.numpy()) < 0.35 * err(fields["R"], fields["t"])


def test_interop_converts_the_jax_problem():
    fields = GRAPHS["random"]()
    _, jp = problems(fields)
    p = interop.pose_graph_4dof_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                           torch.device("cpu"))
    assert p._fields == jp._fields
    for name, a in zip(p._fields, p):
        b = np.asarray(getattr(jp, name))
        assert a.shape == b.shape and np.array_equal(a.numpy(), b), name
    assert p.edge_i.dtype == torch.int32 and p.fixed.dtype == torch.bool


@pytest.mark.gpu
def test_kernel_matches_plain_and_is_deterministic(cuda_device):
    fields = GRAPHS["random"]()
    p = interop.pose_graph_4dof_from_numpy(fields, cuda_device)
    before = kernels.LAUNCHES["pose_graph_4dof"]
    Rk, tk, ck = pose_graph.optimize_pose_graph_4dof(p)
    assert kernels.LAUNCHES["pose_graph_4dof"] == before + 1
    with kernels.ordered_plain(True):
        Rp, tp, cp = pose_graph.optimize_pose_graph_4dof_plain(p)
    assert float((Rk - Rp).abs().max()) <= 1e-4 and float((tk - tp).abs().max()) <= 1e-4
    assert float(ck) == pytest.approx(float(cp), rel=1e-3, abs=1e-9)
    for _ in range(19):
        R2, t2, c2 = pose_graph.optimize_pose_graph_4dof(p)
        assert torch.equal(R2, Rk) and torch.equal(t2, tk) and torch.equal(c2, ck)
    g0, g1 = pf.gravity_in_cameras(fields["R"]), pf.gravity_in_cameras(Rk.cpu().numpy())
    assert np.abs(g1 - g0).max() < 1e-5


@pytest.mark.gpu
def test_kernel_takes_float32_only(cuda_device):
    """K23 computes in float32; a float64 problem on the card is refused
    (the plain version takes it on the CPU)."""
    fields = GRAPHS["random"]()
    p = interop.pose_graph_4dof_from_numpy(fields, cuda_device, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        pose_graph.optimize_pose_graph_4dof(p)
