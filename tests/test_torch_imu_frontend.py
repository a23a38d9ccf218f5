"""The port's inertial frontend (``slam/imu_frontend.py``, the inertial
hooks of ``slam/local_mapping.py``) against the JAX package on JAX
``tests/test_imu_tracking.py``'s constructed map: keyframes and points in a
visual frame that is a rotated, 1/s-scaled copy of the metric gravity
frame, IMU from the analytic trajectory (``_build_scaled_map``,
``fill_queue``, ``truth``).  Both packages get the same map (copied into the
port's ``SLAMMap``).

- ``initialize_imu`` (K21's and K20's plain versions) recovers the same
  scale within 1e-4 relative and the same gravity rotation within 1e-4,
  and the initialised maps agree within 1e-3 (25 LM iterations of the full
  visual-inertial BA follow the init solve);
- a culled keyframe's successor inherits its predecessor and the merged
  window, re-integrated to JAX's preintegration (1e-5 relative);
- ``local_inertial_ba`` pulls the perturbed window back as the JAX test
  asks, and the port's map equals JAX's within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extractorb_tpu.core import lie as jlie
from extractorb_tpu.slam import imu_frontend as jfront
from extractorb_tpu.slam.local_mapping import LocalMapper as JLocalMapper
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.core.camera import Pinhole
from extractorb_tpu_torch.imu.calib import ImuCalib
from extractorb_tpu_torch.slam import imu_frontend as front
from extractorb_tpu_torch.slam.local_mapping import LocalMapper
from extractorb_tpu_torch.slam.map import KeyFrame, SLAMMap
from test_imu_tracking import CAM, _build_scaled_map, make_calib, project, truth
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

PCAM = Pinhole(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"])


def port_calib(jcalib) -> ImuCalib:
    return ImuCalib(**{f: getattr(jcalib, f) for f in ImuCalib.__dataclass_fields__})


def port_map(jmp) -> SLAMMap:
    """The port's copy of a JAX map whose keyframes carry no features."""
    mp = SLAMMap(capacity=len(jmp.mp_valid), scale_factor=jmp.scale_factor)
    for k in interop._MAP_ARRAYS:
        setattr(mp, k, np.array(getattr(jmp, k)))
    for k in interop._MAP_SCALARS:
        setattr(mp, k, getattr(jmp, k))
    mp.obs = {m: dict(o) for m, o in jmp.obs.items()}
    for k, kf in jmp.keyframes.items():
        mp.keyframes[k] = KeyFrame(
            feats=None, **{a: np.array(getattr(kf, a)) for a in interop._KF_ARRAYS},
            **{a: getattr(kf, a) for a in interop._KF_SCALARS},
            **{a: None if getattr(kf, a) is None else np.array(getattr(kf, a))
               for a in interop._KF_OPTIONAL},
            preint=None if kf.preint is None else interop.preint_from_numpy(
                interop.preint_to_numpy(kf.preint)),
            imu_meas=None if kf.imu_meas is None else tuple(np.array(a) for a in kf.imu_meas))
    return mp


def max_diff(jmp, mp, fields=("R", "t", "v", "bg", "ba")) -> float:
    d = float(np.abs(np.asarray(jmp.mp_pos) - mp.mp_pos).max())
    for k, kf in mp.keyframes.items():
        for f in fields:
            a, b = getattr(kf, f), getattr(jmp.keyframes[k], f)
            if a is not None or b is not None:
                d = max(d, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    return d


def test_initialize_imu_matches_jax():
    jcalib = make_calib()
    jmp, _ = _build_scaled_map(jcalib, s_true=2.0)
    mp = port_map(jmp)
    jres = jfront.initialize_imu(jmp, jcalib, project, prior_g=1e2, prior_a=1e10)
    pres = front.initialize_imu(mp, port_calib(jcalib), PCAM, prior_g=1e2, prior_a=1e10,
                                device="cpu")
    assert jres and pres and mp.imu_initialized
    (jR, js), (pR, ps) = jres, pres
    assert abs(ps - js) < 1e-4 * js, (ps, js)
    assert np.abs(pR - np.asarray(jR)).max() < 1e-4
    assert max_diff(jmp, mp) < 1e-3
    # metric: keyframe spacing matches the truth (the JAX test's check)
    kids = sorted(mp.keyframes)
    C = np.stack([mp.keyframes[k].center() for k in kids])
    C_gt = np.stack([truth(k * 0.25)[1] for k in range(len(kids))])
    ratio = np.linalg.norm(C[1:] - C[:-1], axis=1) / np.linalg.norm(C_gt[1:] - C_gt[:-1], axis=1)
    assert np.abs(ratio - 1.0).max() < 0.05, ratio


def test_chain_repair_on_keyframe_cull():
    jcalib = make_calib()
    jmp, _ = _build_scaled_map(jcalib, n_kf=6)
    mp = port_map(jmp)
    jlm = JLocalMapper(project, (1.0,), (1.0,), np.eye(3, dtype=np.float32), imu_calib=jcalib)
    lm = LocalMapper(PCAM, (1.0,), (1.0,), np.eye(3, dtype=np.float32), torch.device("cpu"))
    lm.imu_calib = port_calib(jcalib)
    kids = sorted(mp.keyframes)
    jlm._remove_keyframe(jmp, kids[2])
    lm._remove_keyframe(mp, kids[2])
    kf, jkf = mp.keyframes[kids[3]], jmp.keyframes[kids[3]]
    assert kf.prev_kf == jkf.prev_kf == kids[1] and kids[2] not in mp.keyframes
    for a, b in zip(kf.imu_meas, jkf.imu_meas):
        np.testing.assert_array_equal(a, b)
    for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dT"):
        a, b = np.asarray(getattr(kf.preint, f)), np.asarray(getattr(jkf.preint, f))
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), f


@pytest.mark.parametrize("n_window", [6, 10])
def test_local_inertial_ba_matches_jax(n_window):
    jcalib = make_calib()
    jmp, _ = _build_scaled_map(jcalib, n_kf=12, s_true=1.0, rot_vw=(0.0, 0.0, 0.0))
    jmp.imu_initialized = True
    kids = sorted(jmp.keyframes)
    for i, k in enumerate(kids):
        kf = jmp.keyframes[k]
        kf.v = truth(i * 0.25)[2].astype(np.float32)
        kf.bg = np.zeros(3, np.float32)
        kf.ba = np.zeros(3, np.float32)
    rng = np.random.default_rng(3)
    perturbed = kids[-5:]
    for k in perturbed:
        kf = jmp.keyframes[k]
        dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.01)))
        kf.R = (kf.R @ dR).astype(np.float32)
        kf.t = (kf.t + rng.normal(size=3) * 0.03).astype(np.float32)
        kf.v = (kf.v + rng.normal(size=3) * 0.3).astype(np.float32)
    mp = port_map(jmp)

    def errors(m):
        ep, ev = [], []
        for i, k in enumerate(kids):
            if k in perturbed:
                _, pwb, vwb, _, _ = truth(i * 0.25)
                ep.append(np.linalg.norm(m.keyframes[k].center() - pwb))
                ev.append(np.linalg.norm(m.keyframes[k].v - vwb))
        return np.mean(ep), np.mean(ev)

    ep0, ev0 = errors(mp)
    assert jfront.local_inertial_ba(jmp, jcalib, project, kids[-1], n_window=n_window)
    assert front.local_inertial_ba(mp, port_calib(jcalib), PCAM, kids[-1], n_window=n_window,
                                   device="cpu")
    ep1, ev1 = errors(mp)
    assert ep1 < 0.5 * ep0 and ev1 < 0.5 * ev0, (ep0, ep1, ev0, ev1)
    assert max_diff(jmp, mp) < 1e-4
    assert mp.version == jmp.version
