"""IMU calibration: extrinsics and noise (port of
``extractorb_tpu/imu/calib.py``; reference IMU::Calib, inc/ImuTypes.h:108-139,
parsed by Tracking::ParseIMUParamFile, src/Tracking.cc:786).

The calib keeps Tbc (body-from-camera), the discrete noise and random-walk
sigmas, and Tcb, the direction the inertial solvers use: their states are
body-in-world and the camera sees a point through pc = Rcb pb + tcb.
Plain numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import IMUConfig


@dataclasses.dataclass(frozen=True)
class ImuCalib:
    Rbc: np.ndarray          # (3,3) body-from-camera rotation
    tbc: np.ndarray          # (3,)
    Rcb: np.ndarray          # (3,3) camera-from-body
    tcb: np.ndarray          # (3,)
    noise_gyro: float        # continuous noise * sqrt(freq) (discrete)
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    frequency: float

    @staticmethod
    def from_config(cfg: IMUConfig) -> "ImuCalib":
        """The YAML noise densities are continuous; preintegration uses
        the discrete sigmas Ng sqrt(freq) and walk / sqrt(freq)."""
        T = np.asarray(cfg.T_bc, np.float32).reshape(4, 4)
        Rbc, tbc = T[:3, :3], T[:3, 3]
        Rcb = Rbc.T
        tcb = -Rbc.T @ tbc
        sf = float(np.sqrt(cfg.frequency))
        return ImuCalib(
            Rbc=Rbc.astype(np.float32), tbc=tbc.astype(np.float32),
            Rcb=Rcb.astype(np.float32), tcb=tcb.astype(np.float32),
            noise_gyro=float(cfg.noise_gyro) * sf,
            noise_acc=float(cfg.noise_acc) * sf,
            walk_gyro=float(cfg.gyro_walk) / sf,
            walk_acc=float(cfg.acc_walk) / sf,
            frequency=float(cfg.frequency),
        )

    def body_from_cam(self, Rcw: np.ndarray, tcw: np.ndarray):
        """Tcw (world->camera) -> (Rwb, twb) body-in-world."""
        Rwb = Rcw.T @ self.Rcb
        twb = Rcw.T @ (self.tcb - tcw)
        return Rwb.astype(np.float32), twb.astype(np.float32)

    def cam_from_body(self, Rwb: np.ndarray, twb: np.ndarray):
        """(Rwb, twb) body-in-world -> Tcw (world->camera)."""
        Rcw = self.Rcb @ Rwb.T
        tcw = self.tcb - Rcw @ twb
        return Rcw.astype(np.float32), tcw.astype(np.float32)
