"""The port's small utilities against the JAX package: ``core/padding.py``
(bit-equal), the ``lie`` and ``camera`` helpers the demos' slice adds
(within 1e-6), ``utils/verbose.py``, ``utils/timing.StageTimer`` (its
stages as ranges of a torch.profiler trace) and ``System.shutdown``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.core import camera as jcamera
from extractorb_tpu.core import lie as jlie
from extractorb_tpu.core import padding as jpad
from extractorb_tpu_torch.core import camera, lie, padding
from extractorb_tpu_torch.utils import timing, verbose
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,fill,axis", [(7, 0, 0), (3, 0, 0), (5, 0, 0), (9, -1, 1), (2, 7, 1)])
def test_pad_to_matches_jax(n, fill, axis):
    x = np.arange(15, dtype=np.int32).reshape(5, 3)
    if axis == 1:
        x = x.T.copy()
    want = np.asarray(jpad.pad_to(jnp.asarray(x), n, fill, axis))
    got = padding.pad_to(t(x), n, fill, axis).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_masked_top_k_matches_jax(k):
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 5, 10).astype(np.float32)   # ties
    mask = rng.random(10) > 0.4
    want = [np.asarray(a) for a in jpad.masked_top_k(jnp.asarray(scores), jnp.asarray(mask), k)]
    got = [a.numpy() for a in padding.masked_top_k(t(scores), t(mask), k)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("capacity", [3, 8, 20])
def test_compact_mask_matches_jax(capacity):
    mask = np.random.default_rng(capacity).random(12) > 0.5
    want = [np.asarray(a) for a in jpad.compact_mask(jnp.asarray(mask), capacity)]
    got = [a.numpy() for a in padding.compact_mask(t(mask), capacity)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert padding.INVALID == int(jpad.INVALID)


@pytest.mark.parametrize("fill", [0, -3])
def test_gather_rows_matches_jax(fill):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    idx = np.array([2, -1, 7, 0, -1], np.int32)
    for a in (x, x[:, 0].copy()):
        want = np.asarray(jpad.gather_rows(jnp.asarray(a), jnp.asarray(idx), fill))
        got = padding.gather_rows(t(a), t(idx), fill).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_lie_helpers_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    R = np.stack([pf.so3_exp_np(v) for v in w]).astype(np.float32)
    tt = rng.normal(size=(5, 3)).astype(np.float32)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    W = np.asarray(jlie.hat(jnp.asarray(w)))
    np.testing.assert_allclose(lie.vee(t(W)).numpy(), np.asarray(jlie.vee(jnp.asarray(W))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(lie.vee(lie.hat(t(w))).numpy(), w, rtol=0, atol=0)
    np.testing.assert_allclose(
        lie.se3_apply(t(R), t(tt), t(p)).numpy(),
        np.asarray(jlie.se3_apply(jnp.asarray(R), jnp.asarray(tt), jnp.asarray(p))),
        rtol=0, atol=1e-6)
    T = lie.se3_matrix(t(R), t(tt))
    np.testing.assert_allclose(T.numpy(),
                               np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(tt))),
                               rtol=0, atol=1e-6)
    R2, t2 = lie.se3_from_matrix(T)
    jR2, jt2 = jlie.se3_from_matrix(jnp.asarray(T.numpy()))
    np.testing.assert_array_equal(R2.numpy(), np.asarray(jR2))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
    np.testing.assert_array_equal(R2.numpy(), R)


def test_distort_points_pinhole_matches_jax():
    xy = np.random.default_rng(1).uniform(-0.6, 0.6, (200, 2)).astype(np.float32)
    for dist in (pf.FR1_DIST, np.asarray(pf.FR1_DIST, np.float32)):
        want = np.asarray(jcamera.distort_points_pinhole(jnp.asarray(xy), dist))
        got = camera.distort_points_pinhole(t(xy), dist).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the renderer's undistortion inverts it
    d = camera.distort_points_pinhole(t(xy).double(), pf.FR1_DIST).numpy()
    xu, yu = pf.undistort_normalized(d[:, 0], d[:, 1], pf.FR1_DIST)
    np.testing.assert_allclose(np.stack([xu, yu], -1), xy, rtol=0, atol=1e-6)


def test_verbose_levels(capsys):
    old = verbose._level
    try:
        verbose.set_verbosity(verbose.Verbosity.VERBOSE)
        verbose.print_mess("shown", verbose.Verbosity.NORMAL)
        verbose.print_mess("also shown", verbose.Verbosity.VERBOSE)
        verbose.print_mess("hidden", verbose.Verbosity.DEBUG)
        verbose.set_verbosity(verbose.Verbosity.QUIET)
        verbose.print_mess("hidden too")
    finally:
        verbose.set_verbosity(old)
    err = capsys.readouterr().err
    assert err.splitlines() == ["shown", "also shown"]
    assert [int(v) for v in verbose.Verbosity] == [0, 1, 2, 3, 4]


def test_stage_timer(tmp_path):
    """tests/test_utils.py:23's checks, and the stage as a range of a CPU
    torch.profiler trace."""
    tm = timing.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tm.stage("extract"):
            torch.ones(64).sum()
        with tm.stage("extract"):
            sum(range(1000))
    with tm.stage("pose-opt"):
        pass
    s = tm.summary()
    assert s["extract"]["count"] == 2 and s["pose-opt"]["count"] == 1
    assert s["extract"]["p95_ms"] >= s["extract"]["p50_ms"] >= 0.0
    assert "extract" in {e.name for e in prof.events()}
    p = tmp_path / "times.csv"
    tm.write_csv(str(p))
    lines = p.read_text().splitlines()
    assert lines[0] == "stage,count,mean_ms,p50_ms,p95_ms,total_s"
    assert [ln.split(",")[:2] for ln in lines[1:]] == [["extract", "2"], ["pose-opt", "1"]]
    tm.enabled = False
    with tm.stage("gba"):
        pass
    assert "gba" not in tm.summary()
    assert isinstance(timing.GLOBAL_TIMER, timing.StageTimer)


def test_system_shutdown():
    import chip_smoke
    from extractorb_tpu_torch.slam.system import System

    s = System(chip_smoke.system_config(320, 240, 300), device="cpu")
    assert s.shutdown() is None
