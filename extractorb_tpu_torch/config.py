"""Configuration dataclasses.

Key names mirror the reference's OpenCV-YAML settings files so existing
ORB-SLAM3 configs can be loaded unchanged (reference:
src/Tracking.cc:169 ParseCamParamFile, :702 ParseORBParamFile,
:786 ParseIMUParamFile).  All quantities that shape jitted computations
(pyramid levels, keypoint budgets, grid sizes) are static Python ints so
they become compile-time constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extractor configuration (reference: ORBextractor.* YAML keys).

    Defaults follow the reference demos: 1000-1500 features, 8 levels,
    scale 1.2, FAST thresholds 20/7 (src/orb_extractor/main_orb_extractor.cpp:34-43).
    """

    n_features: int = 1000          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST
    min_th_fast: int = 7            # ORBextractor.minThFAST

    # Static geometry constants (reference: inc/ORBExtractor.h:18-20).
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    cell_size: int = 35             # FAST cell window (reference W=35, ORBextractor.cc:795)

    # Padded per-level keypoint capacity (static shape for jit).  The
    # reference's per-level budget is a geometric series over n_features;
    # raw FAST can return far more before octree distribution.
    max_kps_per_level: int = 4096

    # Keypoint distribution path: "device" (one-program XLA octree) or
    # "host" (bit-exact DistributeOctTree, reference
    # ORBextractor.cc:544-771); both produce the same spatial policy.
    octree: str = "device"

    @property
    def scale_factors(self) -> Tuple[float, ...]:
        """Per-level scale factors (reference ORBextractor ctor :408-430)."""
        out = [1.0]
        for _ in range(1, self.n_levels):
            out.append(out[-1] * self.scale_factor)
        return tuple(out)

    @property
    def features_per_level(self) -> Tuple[int, ...]:
        """Geometric-series keypoint budget per level (reference :439-452)."""
        factor = 1.0 / self.scale_factor
        n_desired = (
            self.n_features * (1.0 - factor)
            / (1.0 - factor ** self.n_levels)
        )
        out = []
        total = 0
        for _ in range(self.n_levels - 1):
            k = int(round(n_desired))
            out.append(k)
            total += k
            n_desired *= factor
        out.append(max(self.n_features - total, 0))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera model configuration (reference: Camera.* YAML keys)."""

    model: str = "PinHole"          # "PinHole" | "KannalaBrandt8"
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    # Pinhole distortion (k1 k2 p1 p2 k3) or KB8 (k1..k4 in k[:4]).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    width: int = 640
    height: int = 480
    bf: float = 0.0                 # stereo baseline * fx (Camera.bf)
    fps: float = 30.0
    th_depth: float = 35.0          # ThDepth close/far split
    # thFarPoints (reference System.cc:183 / Tracking mThFarPoints):
    # stereo/RGBD observations deeper than this are never turned into
    # map points (noisy disparity tail); 0 disables the gate
    th_far_points: float = 0.0
    # Stereo-fisheye overlap region in x (Camera.lappingBegin/End,
    # reference: src/Tracking.cc ParseCamParamFile KB8 branch); -1 = unset.
    lapping_begin: float = -1.0
    lapping_end: float = -1.0


@dataclasses.dataclass(frozen=True)
class IMUConfig:
    """IMU configuration (reference: ParseIMUParamFile, src/Tracking.cc:786)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    frequency: float = 200.0
    # Body-from-camera extrinsics as a flat row-major 4x4.
    T_bc: Tuple[float, ...] = tuple(
        1.0 if i % 5 == 0 else 0.0 for i in range(16)
    )


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking / mapping pipeline constants.

    Values mirror the reference's hard-coded thresholds
    (src/ORBmatcher.cc:36-38, src/Tracking.cc, src/LocalMapping.cc).
    """

    th_low: int = 50                # Hamming accept (TH_LOW)
    th_high: int = 100              # Hamming accept loose (TH_HIGH)
    histo_length: int = 30          # rotation histogram bins
    nn_ratio: float = 0.9           # default mNNratio for initialization
    grid_cols: int = 64             # FRAME_GRID_COLS (inc/Frame.h:39)
    grid_rows: int = 48             # FRAME_GRID_ROWS (inc/Frame.h:40)
    max_frame_kps: int = 2048       # padded per-frame keypoint capacity
    # Fused-path software pipelining: number of frames tracked ahead of
    # confirmation.  0 = synchronous (each track_* call settles before
    # returning).  K>0 = the tracker dispatches up to K+1 chained device
    # programs before paying one host round trip for all of them;
    # states/poses for in-flight frames are reported optimistically and
    # corrected at the next confirmation (Tracker.flush drains).  The
    # analog of the reference's decoupled tracking/mapping threads.
    pipeline_depth: int = 0
    # False routes every frame through the legacy (multi-dispatch)
    # tracking stack — the reference-exact control flow — instead of the
    # fused one-program step.  Useful for apples-to-apples comparisons
    # of non-tracking components and as an escape hatch.
    use_fused: bool = True
    # Map capacities (ring-buffer style, static shapes).
    max_keyframes: int = 512
    max_map_points: int = 32768
    max_obs_per_frame: int = 2048
    # Local BA window.
    local_window: int = 10
    # Keyframe insertion: min frames between KFs etc.
    min_frames: int = 0
    max_frames: int = 30
    # RECENTLY_LOST grace period in seconds before declaring LOST
    # (reference Tracking.cc: time_recently_lost, set to 5 s in the
    # constructor; visual-only runs use a shorter 3 s window at
    # Tracking.cc:1576-1605).
    time_recently_lost: float = 5.0


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    imu: Optional[IMUConfig] = None
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    sensor: str = "monocular"       # monocular|stereo|rgbd|imu-monocular|...
    # Stereo-fisheye second camera (Camera2.* keys) and the left-to-right
    # extrinsic Tlr as a flat row-major 4x4 (p_left = R_lr p_right + t_lr,
    # i.e. the pose of the right camera expressed in the left frame).
    camera2: Optional[CameraConfig] = None
    T_lr: Optional[Tuple[float, ...]] = None


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    return v if v is not None else default


def load_yaml(path: str) -> SLAMConfig:
    """Load an ORB-SLAM3-style YAML settings file.

    Accepts the reference's key names (Camera.fx, ORBextractor.nFeatures,
    ...).  OpenCV YAML files start with a ``%YAML:1.0`` directive that
    pyyaml rejects; it is stripped.
    """
    import yaml  # optional dependency, only needed to read settings files

    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    d = yaml.safe_load("\n".join(lines)) or {}

    cam = CameraConfig(
        model=_get(d, "Camera.type", "PinHole"),
        fx=float(_get(d, "Camera.fx", 500.0)),
        fy=float(_get(d, "Camera.fy", 500.0)),
        cx=float(_get(d, "Camera.cx", 320.0)),
        cy=float(_get(d, "Camera.cy", 240.0)),
        k1=float(_get(d, "Camera.k1", 0.0)),
        k2=float(_get(d, "Camera.k2", 0.0)),
        p1=float(_get(d, "Camera.p1", 0.0)),
        p2=float(_get(d, "Camera.p2", 0.0)),
        k3=float(_get(d, "Camera.k3", 0.0)),
        k4=float(_get(d, "Camera.k4", 0.0)),
        width=int(_get(d, "Camera.width", 640)),
        height=int(_get(d, "Camera.height", 480)),
        bf=float(_get(d, "Camera.bf", 0.0)),
        fps=float(_get(d, "Camera.fps", 30.0)),
        th_depth=float(_get(d, "ThDepth", 35.0)),
        th_far_points=float(_get(d, "thFarPoints", 0.0)),
        lapping_begin=float(_get(d, "Camera.lappingBegin", -1.0)),
        lapping_end=float(_get(d, "Camera.lappingEnd", -1.0)),
    )

    cam2 = None
    T_lr = None
    if "Camera2.fx" in d:
        cam2 = CameraConfig(
            model=_get(d, "Camera.type", "KannalaBrandt8"),
            fx=float(_get(d, "Camera2.fx", 500.0)),
            fy=float(_get(d, "Camera2.fy", 500.0)),
            cx=float(_get(d, "Camera2.cx", 320.0)),
            cy=float(_get(d, "Camera2.cy", 240.0)),
            k1=float(_get(d, "Camera2.k1", 0.0)),
            k2=float(_get(d, "Camera2.k2", 0.0)),
            k3=float(_get(d, "Camera2.k3", 0.0)),
            k4=float(_get(d, "Camera2.k4", 0.0)),
            width=cam.width,
            height=cam.height,
            lapping_begin=float(_get(d, "Camera2.lappingBegin", -1.0)),
            lapping_end=float(_get(d, "Camera2.lappingEnd", -1.0)),
        )
        tlr = d.get("Tlr") or d.get("Camera.Tlr")
        if isinstance(tlr, dict) and "data" in tlr:  # OpenCV matrix node
            flat = [float(v) for v in tlr["data"]]
            if len(flat) == 12:
                flat = flat + [0.0, 0.0, 0.0, 1.0]
            T_lr = tuple(flat)
        elif isinstance(tlr, (list, tuple)):
            T_lr = tuple(float(v) for v in tlr)

    orb = ORBConfig(
        n_features=int(_get(d, "ORBextractor.nFeatures", 1000)),
        scale_factor=float(_get(d, "ORBextractor.scaleFactor", 1.2)),
        n_levels=int(_get(d, "ORBextractor.nLevels", 8)),
        ini_th_fast=int(_get(d, "ORBextractor.iniThFAST", 20)),
        min_th_fast=int(_get(d, "ORBextractor.minThFAST", 7)),
    )
    return SLAMConfig(orb=orb, camera=cam, camera2=cam2, T_lr=T_lr)
