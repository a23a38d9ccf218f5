"""On-manifold IMU preintegration (port of
``extractorb_tpu/imu/preintegration.py``).

Replaces IMU::Preintegrated (reference: src/ImuTypes.cc:255-311
IntegrateNewMeasurement, :225 Initialize, :357-428 the bias-corrected
getters).  The state is (dR, dV, dP), the 15x15 covariance C (order: rot,
vel, pos, gyro bias, acc bias), the bias Jacobians JRg, JVg, JVa, JPg, JPa
and the total time dT.  The update order follows the reference: position
first with the rotation not yet updated, rotation last.

``integrate_batch`` integrates B padded windows.  On CUDA tensors it
launches kernel K19 (``csrc/preint.cu``, one thread per window walking its
samples in order); on the CPU it runs ``integrate_batch_plain``, the JAX
scan written as a loop over the samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..core import lie


class Preintegrated(NamedTuple):
    dR: torch.Tensor      # (...,3,3)
    dV: torch.Tensor      # (...,3)
    dP: torch.Tensor      # (...,3)
    C: torch.Tensor       # (...,15,15) covariance
    JRg: torch.Tensor     # (...,3,3) d dR / d gyro bias
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dT: torch.Tensor      # (...) total time
    bias: torch.Tensor    # (...,6) (bg, ba) used at integration time


def init_preintegrated(bias=None, dtype=torch.float32, device="cpu") -> Preintegrated:
    """Reference Preintegrated::Initialize (ImuTypes.cc:225)."""
    z3 = torch.zeros(3, 3, dtype=dtype, device=device)
    return Preintegrated(
        dR=torch.eye(3, dtype=dtype, device=device),
        dV=torch.zeros(3, dtype=dtype, device=device),
        dP=torch.zeros(3, dtype=dtype, device=device),
        C=torch.zeros(15, 15, dtype=dtype, device=device),
        JRg=z3, JVg=z3.clone(), JVa=z3.clone(), JPg=z3.clone(), JPa=z3.clone(),
        dT=torch.zeros((), dtype=dtype, device=device),
        bias=torch.zeros(6, dtype=dtype, device=device) if bias is None else bias,
    )


def index(p: Preintegrated, i) -> Preintegrated:
    """Window ``i`` of a batched Preintegrated."""
    return Preintegrated(*(f[i] for f in p))


def integrate_batch_plain(gyro, acc, dts, valid, bias, noise_gyro: float, noise_acc: float,
                          walk_gyro: float, walk_acc: float) -> Preintegrated:
    """Plain version of ``integrate_batch`` (same arguments)."""
    dtype, dev = acc.dtype, acc.device
    B = acc.shape[0]
    Nga = torch.diag(torch.tensor([noise_gyro ** 2] * 3 + [noise_acc ** 2] * 3, dtype=dtype,
                                  device=dev))
    NgaWalk = torch.diag(torch.tensor([walk_gyro ** 2] * 3 + [walk_acc ** 2] * 3, dtype=dtype,
                                      device=dev))
    bg, ba = bias[:, None, :3], bias[:, None, 3:]
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    s = init_preintegrated(None, dtype, dev)
    dR, dV, dP = s.dR.expand(B, 3, 3), s.dV.expand(B, 3), s.dP.expand(B, 3)
    C = s.C.expand(B, 15, 15)
    JRg = JVg = JVa = JPg = JPa = s.JRg.expand(B, 3, 3)
    dT = s.dT.expand(B)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    a_c_all, w_c_all = acc - ba, gyro - bg
    for k in range(acc.shape[1]):
        a_c, w_c, dt, ok = a_c_all[:, k], w_c_all[:, k], dts[:, k], valid[:, k]
        dt1, dt2 = dt[:, None], dt[:, None, None]
        nP = dP + dV * dt1 + mv(0.5 * dR, a_c) * dt1 * dt1
        nV = dV + mv(dR, a_c) * dt1
        Wacc = lie.hat(a_c)
        dRdt = dR * dt2
        nJPa = JPa + JVa * dt2 - 0.5 * dRdt * dt2
        nJPg = JPg + JVg * dt2 - (0.5 * dRdt * dt2) @ Wacc @ JRg
        nJVa = JVa - dRdt
        nJVg = JVg - dRdt @ Wacc @ JRg
        dRi = lie.so3_exp(w_c * dt1)
        rightJ = lie.so3_right_jacobian(w_c * dt1)
        nR = lie.normalize_rotation(dR @ dRi)
        A = torch.eye(9, dtype=dtype, device=dev).repeat(B, 1, 1)
        A[:, 0:3, 0:3] = dRi.transpose(-1, -2)
        A[:, 3:6, 0:3] = -dRdt @ Wacc
        A[:, 6:9, 0:3] = (-0.5 * dRdt * dt2) @ Wacc
        A[:, 6:9, 3:6] = eye3 * dt2
        Bm = torch.zeros(B, 9, 6, dtype=dtype, device=dev)
        Bm[:, 0:3, 0:3] = rightJ * dt2
        Bm[:, 3:6, 3:6] = dRdt
        Bm[:, 6:9, 3:6] = 0.5 * dRdt * dt2
        nC = C.clone()
        nC[:, :9, :9] = A @ C[:, :9, :9] @ A.transpose(-1, -2) + Bm @ Nga @ Bm.transpose(-1, -2)
        nC[:, 9:, 9:] = C[:, 9:, 9:] + NgaWalk
        nJRg = dRi.transpose(-1, -2) @ JRg - rightJ * dt2
        # masked (padding) steps keep the old state
        o1, o2 = ok[:, None], ok[:, None, None]
        dP, dV = torch.where(o1, nP, dP), torch.where(o1, nV, dV)
        JPa, JPg = torch.where(o2, nJPa, JPa), torch.where(o2, nJPg, JPg)
        JVa, JVg = torch.where(o2, nJVa, JVa), torch.where(o2, nJVg, JVg)
        dR, JRg = torch.where(o2, nR, dR), torch.where(o2, nJRg, JRg)
        C = torch.where(o2, nC, C)
        dT = torch.where(ok, dT + dt, dT)
    return Preintegrated(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                         JPa=JPa, dT=dT, bias=bias)


# the packed per-window output of K19: field name and its number of floats
_LAYOUT = (("dR", 9), ("dV", 3), ("dP", 3), ("C", 225), ("JRg", 9), ("JVg", 9), ("JVa", 9),
           ("JPg", 9), ("JPa", 9), ("dT", 1))
_WIDTH = sum(n for _, n in _LAYOUT)
_SHAPES = {"dR": (3, 3), "dV": (3,), "dP": (3,), "C": (15, 15), "dT": ()}


def integrate_batch(gyro, acc, dts, valid, bias, noise_gyro: float, noise_acc: float,
                    walk_gyro: float, walk_acc: float) -> Preintegrated:
    """IntegrateNewMeasurement over B padded windows: gyro, acc (B,T,3),
    dts (B,T), valid (B,T) bool (padding mask), bias (B,6) (bg, ba).
    Returns a Preintegrated with a leading batch dimension B.

    Replaces ``extractorb_tpu/imu/preintegration.py:integrate`` (the
    ``lax.scan`` that ``slam/imu_frontend.py:_integrate_jit`` runs).  On
    CUDA tensors this launches K19 once for the batch."""
    if not acc.is_cuda:
        return integrate_batch_plain(gyro, acc, dts, valid, bias, noise_gyro, noise_acc,
                                     walk_gyro, walk_acc)
    B, T = acc.shape[0], acc.shape[1]
    f32 = lambda a: a.to(torch.float32).contiguous()
    args = [f32(gyro), f32(acc), f32(dts), valid.to(torch.bool).contiguous(), f32(bias)]
    kernels.require_cuda("preint", *args)
    out = torch.empty(B, _WIDTH, dtype=torch.float32, device=acc.device)
    err = kernels.lib().preint_launch(
        *[a.data_ptr() for a in args], B, T, noise_gyro ** 2, noise_acc ** 2, walk_gyro ** 2,
        walk_acc ** 2, out.data_ptr(), kernels.stream())
    kernels.check(err, "preint")
    kernels.LAUNCHES["preint"] += 1
    fields, o = {}, 0
    for name, n in _LAYOUT:
        fields[name] = out[:, o:o + n].reshape((B,) + _SHAPES.get(name, (3, 3)))
        o += n
    return Preintegrated(bias=args[4], **fields)


def integrate(gyro, acc, dts, valid, bias, noise_gyro: float, noise_acc: float,
              walk_gyro: float, walk_acc: float) -> Preintegrated:
    """One window: gyro, acc (T,3), dts (T,), valid (T,), bias (6,)."""
    p = integrate_batch(gyro[None], acc[None], dts[None], valid[None], bias[None],
                        noise_gyro, noise_acc, walk_gyro, walk_acc)
    return index(p, 0)


def delta_rotation(p: Preintegrated, new_bias: torch.Tensor):
    """GetDeltaRotation(b') = dR Exp(JRg (bg' - bg)) (ImuTypes.cc:357);
    no SVD re-normalisation (dR is normalised at integration time)."""
    dbg = new_bias[..., :3] - p.bias[..., :3]
    return p.dR @ lie.so3_exp((p.JRg @ dbg[..., None])[..., 0])


def delta_velocity(p: Preintegrated, new_bias: torch.Tensor):
    dbg = new_bias[..., :3] - p.bias[..., :3]
    dba = new_bias[..., 3:] - p.bias[..., 3:]
    return p.dV + (p.JVg @ dbg[..., None])[..., 0] + (p.JVa @ dba[..., None])[..., 0]


def delta_position(p: Preintegrated, new_bias: torch.Tensor):
    dbg = new_bias[..., :3] - p.bias[..., :3]
    dba = new_bias[..., 3:] - p.bias[..., 3:]
    return p.dP + (p.JPg @ dbg[..., None])[..., 0] + (p.JPa @ dba[..., None])[..., 0]


def inertial_residual(p: Preintegrated, R1, t1, v1, R2, t2, v2, bias_new,
                      gravity: Optional[torch.Tensor] = None):
    """The 9-dim preintegration residual (reference G2oTypes.cc
    EdgeInertial::computeError); poses are body-in-world (Rwb, twb)."""
    g = (torch.tensor([0.0, 0.0, -9.81], dtype=R1.dtype, device=R1.device)
         if gravity is None else gravity)
    dT = p.dT
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    R1T = R1.transpose(-1, -2)
    eR = lie.so3_log(delta_rotation(p, bias_new).transpose(-1, -2) @ (R1T @ R2))
    eV = mv(R1T, v2 - v1 - g * dT) - delta_velocity(p, bias_new)
    eP = mv(R1T, t2 - t1 - v1 * dT - 0.5 * g * dT * dT) - delta_position(p, bias_new)
    return torch.cat([eR, eV, eP], -1)
