"""The port's preintegration (``imu/preintegration.py``, kernel K19's plain
version) and IMU queue (``slam/imu_frontend.py``) against the JAX package.

Seeded numpy windows go through JAX ``integrate`` and the port's
``integrate_batch_plain``: padded and unpadded windows, zero-length
intervals, a bias.  dR, dV, dP and the five bias Jacobians within 1e-5
relative (of each field's largest entry: float32 scans of up to 64 steps
whose XLA:CPU contractions differ from PyTorch's in the last bits), the
covariance within 1e-4 relative (products of three 9x9 matrices per step).
``ImuQueue.raw_window``'s boundary clipping is exact (the same numpy
code), ``predict_state`` within 1e-5.  The ``-m gpu`` case holds K19 to
the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extractorb_tpu.imu import preintegration as jpre
from extractorb_tpu.slam import imu_frontend as jfront
from extractorb_tpu_torch.config import IMUConfig
from extractorb_tpu_torch.imu import preintegration as pre
from extractorb_tpu_torch.imu.calib import ImuCalib
from extractorb_tpu_torch.slam import imu_frontend as front
from test_imu_tracking import fill_queue, make_calib, truth
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

NOISE = (1.7e-4 * np.sqrt(200.0), 2e-3 * np.sqrt(200.0), 1.9e-5 / np.sqrt(200.0),
         3e-3 / np.sqrt(200.0))
FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dT")


def window(rng, T, n_valid, zero_dt=(), dt=0.005):
    gyro = (rng.normal(0, 0.3, (T, 3))).astype(np.float32)
    acc = (rng.normal(0, 1.0, (T, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    dts = np.full(T, dt, np.float32)
    dts[list(zero_dt)] = 0.0
    valid = np.arange(T) < n_valid
    return gyro, acc, dts, valid


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_close(p, j):
    for f in FIELDS:
        assert rel_err(getattr(p, f), getattr(j, f)) < 1e-5, f
    assert rel_err(p.C, j.C) < 1e-4


@pytest.mark.parametrize("T,n_valid,zero_dt,bias", [
    (32, 32, (), False),
    (64, 23, (), False),
    (32, 17, (0, 5, 6), False),
    (64, 64, (10,), True),
])
def test_integrate_matches_jax(T, n_valid, zero_dt, bias):
    rng = np.random.default_rng(T + n_valid)
    gyro, acc, dts, valid = window(rng, T, n_valid, zero_dt)
    b = (rng.normal(0, 0.01, 6).astype(np.float32) if bias else np.zeros(6, np.float32))
    j = jpre.integrate(jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
                       jnp.asarray(valid), jnp.asarray(b), *NOISE)
    p = pre.integrate_batch_plain(torch.from_numpy(gyro)[None], torch.from_numpy(acc)[None],
                                  torch.from_numpy(dts)[None], torch.from_numpy(valid)[None],
                                  torch.from_numpy(b)[None], *NOISE)
    check_close(pre.index(p, 0), j)


def test_batched_windows_equal_single():
    rng = np.random.default_rng(5)
    wins = [window(rng, 32, n) for n in (32, 9, 20)]
    bias = torch.from_numpy(rng.normal(0, 0.01, (3, 6)).astype(np.float32))
    stack = [torch.from_numpy(np.stack([w[i] for w in wins])) for i in range(4)]
    pb = pre.integrate_batch_plain(*stack, bias, *NOISE)
    for k in range(3):
        ps = pre.integrate_batch_plain(*[s[k:k + 1] for s in stack], bias[k:k + 1], *NOISE)
        for f in pre.Preintegrated._fields:
            assert torch.equal(getattr(pb, f)[k], getattr(ps, f)[0]), f


def test_deltas_and_residual_match_jax():
    rng = np.random.default_rng(7)
    gyro, acc, dts, valid = window(rng, 32, 30)
    b0 = np.zeros(6, np.float32)
    j = jpre.integrate(*map(jnp.asarray, (gyro, acc, dts, valid, b0)), *NOISE)
    p = pre.integrate(*map(torch.from_numpy, (gyro, acc, dts, valid, b0)), *NOISE)
    nb = rng.normal(0, 0.02, 6).astype(np.float32)
    for fj, fp in ((jpre.delta_rotation, pre.delta_rotation),
                   (jpre.delta_velocity, pre.delta_velocity),
                   (jpre.delta_position, pre.delta_position)):
        assert rel_err(fp(p, torch.from_numpy(nb)), fj(j, jnp.asarray(nb))) < 1e-5
    st = [rng.normal(0, 1, 3).astype(np.float32) for _ in range(4)]
    R1 = np.asarray(jnp.eye(3)) @ np.eye(3, dtype=np.float32)
    R2 = np.asarray(jpre.lie.so3_exp(jnp.asarray(st[0] * 0.1)))
    args = (R1, st[1], st[2], R2, st[3], st[2] * 0.9, nb)
    rj = jpre.inertial_residual(j, *map(jnp.asarray, args))
    rp = pre.inertial_residual(p, *[torch.from_numpy(np.array(a, np.float32)) for a in args])
    assert rel_err(rp, rj) < 1e-4


def test_raw_window_clipping_exact():
    calib_j = make_calib()
    calib_p = ImuCalib.from_config(IMUConfig(
        noise_gyro=1e-4 / np.sqrt(200.0), noise_acc=1e-3 / np.sqrt(200.0),
        gyro_walk=1e-6 * np.sqrt(200.0), acc_walk=1e-5 * np.sqrt(200.0), frequency=200.0))
    qj, qp = jfront.ImuQueue(calib_j), front.ImuQueue(calib_p, device="cpu")
    fill_queue(qj, 1.0)
    fill_queue(qp, 1.0)
    for t0, t1 in ((0.0, 0.1), (0.0123, 0.4567), (0.9, 1.2), (0.5, 0.5), (2.0, 3.0)):
        wj, wp = qj.raw_window(t0, t1), qp.raw_window(t0, t1)
        assert (wj is None) == (wp is None)
        if wj is not None:
            for a, b in zip(wj, wp):
                assert np.array_equal(a, b)
    qj.drop_before(0.3)
    qp.drop_before(0.3)
    assert qj.t == qp.t


def test_queue_preintegrate_and_predict_state():
    calib_j = make_calib()
    calib_p = ImuCalib(**{f: getattr(calib_j, f) for f in ImuCalib.__dataclass_fields__})
    qj, qp = jfront.ImuQueue(calib_j), front.ImuQueue(calib_p, device="cpu")
    fill_queue(qj, 0.6)
    fill_queue(qp, 0.6)
    bias = np.array([0.001, -0.002, 0.0005, 0.01, 0.0, -0.02], np.float32)
    pj = qj.preintegrate(0.1, 0.35, bias, host=True)
    pp = qp.preintegrate(0.1, 0.35, bias, host=True)
    check_close(pp, pj)
    R, p, v, _, _ = truth(0.1)
    Rj = jfront.predict_state(R.astype(np.float32), p.astype(np.float32),
                              v.astype(np.float32), bias, pj)
    Rp = front.predict_state(R.astype(np.float32), p.astype(np.float32),
                             v.astype(np.float32), bias, pp)
    for a, b in zip(Rp, Rj):
        assert rel_err(a, b) < 1e-5


@pytest.mark.gpu
def test_preint_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    wins = [window(rng, 64, n, zero_dt=(3,)) for n in (64, 40, 11, 1)]
    bias = torch.from_numpy(rng.normal(0, 0.01, (4, 6)).astype(np.float32))
    stack = [torch.from_numpy(np.stack([w[i] for w in wins])) for i in range(4)]
    plain = pre.integrate_batch_plain(*[s.to(cuda_device) for s in stack],
                                      bias.to(cuda_device), *NOISE)
    kern = pre.integrate_batch(*[s.to(cuda_device) for s in stack], bias.to(cuda_device), *NOISE)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert rel_err(getattr(kern, f).cpu(), getattr(plain, f).cpu()) < 1e-5, f
    assert rel_err(kern.C.cpu(), plain.C.cpu()) < 1e-4
