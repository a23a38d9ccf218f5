"""System facade: the user-facing API (port of
``extractorb_tpu/slam/system.py``: monocular, monocular-inertial, stereo,
stereo-inertial and RGB-D).

Replaces System (reference: src/System.cc:41 ctor, :222 TrackStereo, :288
TrackRGBD, :346 TrackMonocular, :480/:573/:748
SaveTrajectoryTUM/EuRoC/KITTI).  The tracker runs on the card (``device``
None: cuda:0, and no card is an error); ``device="cpu"`` runs the plain
PyTorch path.  Local mapping and loop closing run
synchronously after keyframe insertion, driven by the tracker.  With a
vocabulary (``vocab``, or ``vocab_path``: ORBvoc text through
``load_orbvoc_text``, else ``Vocabulary.load``'s npz) the loop closer
detects and corrects loops and welds Atlas maps; without one it has
nothing to do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SLAMConfig, load_yaml
from ..core import lie
from .tracking import Tracker, TrackState


class System:
    def __init__(self, cfg: Optional[SLAMConfig] = None, settings_yaml: Optional[str] = None,
                 vocab=None, vocab_path: Optional[str] = None, device=None):
        if cfg is None:
            cfg = load_yaml(settings_yaml) if settings_yaml else SLAMConfig()
        if vocab is None and vocab_path:
            from ..place.vocab import Vocabulary, load_orbvoc_text

            vocab = (load_orbvoc_text(vocab_path) if vocab_path.endswith(".txt")
                     else Vocabulary.load(vocab_path))
        self.cfg = cfg
        self.tracker = Tracker(cfg, vocab=vocab, device=device)

    @staticmethod
    def _to_gray(img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:
            # cvtColor equivalent: BGR -> gray (reference Tracking.cc:1042)
            img = np.round(0.114 * img[..., 0] + 0.587 * img[..., 1]
                           + 0.299 * img[..., 2]).astype(np.uint8)
        return img

    def track_monocular(self, img: np.ndarray, timestamp: float, imu=None) -> TrackState:
        """Reference System::TrackMonocular (src/System.cc:346).  ``imu``:
        the (t, acc(3,), gyro(3,)) measurements since the previous frame,
        for ``sensor="imu-monocular"``."""
        self._check_imu(imu, "imu-monocular")
        return self.tracker.track(self._to_gray(img), timestamp, imu=imu)

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray, timestamp: float,
                     imu=None) -> TrackState:
        """Reference System::TrackStereo (src/System.cc:222).  The pair
        must be rectified; Camera.bf must be set in the config.  ``imu``:
        the (t, acc(3,), gyro(3,)) measurements since the previous frame,
        for ``sensor="imu-stereo"``."""
        self._check_imu(imu, "imu-stereo")
        return self.tracker.track_stereo(self._to_gray(img_left), self._to_gray(img_right),
                                         timestamp, imu=imu)

    def _check_imu(self, imu, sensor: str):
        if imu is not None and not self.tracker.inertial:
            raise ValueError(f"IMU measurements with sensor {self.cfg.sensor!r}: "
                             f"pass sensor={sensor!r} and an IMUConfig")

    def track_rgbd(self, img: np.ndarray, depthmap: np.ndarray, timestamp: float) -> TrackState:
        """Reference System::TrackRGBD (src/System.cc:288).  depthmap is
        metric depth (float, 0 or negative where unknown)."""
        return self.tracker.track_rgbd(self._to_gray(img), depthmap, timestamp)

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def flush(self):
        """Settle the dispatched frames and the in-flight window, global
        and welding BAs."""
        self.tracker.flush()

    def current_pose(self):
        self.tracker.flush()
        f = self.tracker.last_frame
        if f is None or f.R is None:
            return None
        return f.R, f.t

    def n_map_points(self) -> int:
        mp = self.tracker.atlas.current
        return int(mp.mp_valid[: mp._next_mp].sum())

    def n_keyframes(self) -> int:
        return len(self.tracker.atlas.current.keyframes)

    def _camera_to_world(self):
        for ts, R, t in self.tracker.final_trajectory():
            Rwc = R.T
            twc = -R.T @ t
            q = lie.rot_to_quat(torch.from_numpy(np.ascontiguousarray(Rwc))).numpy()  # (w,x,y,z)
            yield ts, Rwc, twc, q

    def save_trajectory_tum(self, path: str):
        """SaveTrajectoryTUM (reference src/System.cc:480): one line per
        frame 'ts tx ty tz qx qy qz qw' with the camera-to-world pose."""
        with open(path, "w") as f:
            for ts, _, twc, q in self._camera_to_world():
                f.write(f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_euroc(self, path: str):
        """SaveTrajectoryEuRoC (reference src/System.cc:573): nanosecond
        timestamps, 'ts tx ty tz qx qy qz qw'."""
        with open(path, "w") as f:
            for ts, _, twc, q in self._camera_to_world():
                f.write(f"{ts * 1e9:.0f} {twc[0]:.9f} {twc[1]:.9f} {twc[2]:.9f} "
                        f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")

    def save_trajectory_kitti(self, path: str):
        """SaveTrajectoryKITTI (reference src/System.cc:748): one 3x4
        row-major camera-to-world matrix per line."""
        with open(path, "w") as f:
            for _, Rwc, twc, _ in self._camera_to_world():
                vals = [Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                        Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                        Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2]]
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    def shutdown(self):
        """System::Shutdown: a no-op, as in the JAX package (nothing runs on
        a thread of its own)."""
