"""Typed configuration for the SLAM engine.

Replaces the reference's imperative OpenCV-YAML parsing
(``src/Tracking.cc:538,1083,1169`` ParseCamParamFile / ParseORBParamFile /
ParseIMUParamFile) with one frozen dataclass tree.  All capacities that shape
device arrays (max features, max keyframes, max landmarks, …) live here so
that every jitted step has static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class SensorType:
    """Sensor configurations (reference ``include/System.h:84-90``)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4

    @staticmethod
    def is_inertial(sensor: int) -> bool:
        return sensor in (SensorType.IMU_MONOCULAR, SensorType.IMU_STEREO)

    @staticmethod
    def is_stereo(sensor: int) -> bool:
        return sensor in (SensorType.STEREO, SensorType.IMU_STEREO)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics + stereo geometry.

    Mirrors the reference YAML keys ``Camera.fx/fy/cx/cy/k1..``, ``Camera.bf``
    (``Examples/Stereo-Inertial/EuRoC.yaml:1-40``) but as typed fields.
    ``model`` selects 'pinhole' or 'kannala_brandt8' (fisheye,
    reference ``src/CameraModels/KannalaBrandt8.cpp``).
    """

    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    # pinhole: (k1, k2, p1, p2[, k3]); KB8: (k0, k1, k2, k3) equidistant poly
    dist: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    model: str = "pinhole"
    # stereo baseline * fx (reference Camera.bf); 0 for mono
    bf: float = 47.90639384423901
    # stereo-fisheye (dual KannalaBrandt8, reference ``Frame.cc:1021`` /
    # TUM_512.yaml Camera2.* + Tlr): right-camera intrinsics
    # (fx, fy, cx, cy, k1..k4) and the right→left extrinsic Tlr
    # (row-major 3x4 or 4x4). None = rectified/virtual stereo.
    right_intrinsics: Optional[Tuple[float, ...]] = None
    tlr: Optional[Tuple[float, ...]] = None
    fps: float = 20.0
    # depth threshold multiple of baseline for "close" points
    # (reference ThDepth, EuRoC.yaml:44)
    th_depth: float = 35.0
    # discard map points farther than this many metres from the camera in
    # per-frame association and mapping-time triangulation; 0 = disabled
    # (reference ``thFarPoints``, ``System.cc:113-116`` /
    # ``Tracking.cc:3524`` / ``LocalMapping.cc:923``; present only in some
    # YAMLs, e.g. TUM_512_outdoors.yaml:79)
    th_far_points: float = 0.0


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extractor parameters (reference ``EuRoC.yaml:105-117``)."""

    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # grid-cell size in px used for spatially-uniform selection; the
    # reference uses 35-px cells + a quadtree (ORBextractor.cc:537,765);
    # we use per-cell top-score selection which has the same intent.
    cell_size: int = 32
    patch_size: int = 31
    edge_threshold: int = 19


@dataclasses.dataclass(frozen=True)
class IMUConfig:
    """IMU noise model (reference ``EuRoC.yaml:51-60``, ``ImuTypes.h:87-139``)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    frequency: float = 200.0
    # body-from-camera transform Tbc as a flat 4x4 row-major tuple
    tbc: Tuple[float, ...] = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
        0.0, 0.0, 0.0, 1.0,
    )
    # inserted keyframes needed before IMU init stages fire (see
    # LocalMapping.cc:218-295 schedule)
    gravity_mag: float = 9.81


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference ``Tracking.cc``)."""

    # min matches for motion-model / reference-KF tracking to succeed
    # (Tracking.cc:2868-2877, 2733)
    min_matches_track: int = 20
    min_inliers_track: int = 10
    # TrackLocalMap acceptance (Tracking.cc:3036-3074)
    min_inliers_local_map: int = 30
    # keyframe decision (Tracking.cc:3078-3273)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 20
    kf_ref_ratio: float = 0.75  # thRefRatio for stereo (Tracking.cc:3214)
    # seconds without tracking before RECENTLY_LOST -> LOST
    # (time_recently_lost, Tracking.cc:1904-1917)
    time_recently_lost: float = 5.0
    # matcher search radii (Tracking.cc:2845: th=7 stereo, 15 mono)
    search_radius_motion: float = 15.0
    search_radius_local: float = 3.0
    # RANSAC / init
    min_parallax_deg: float = 1.0
    # IMU-predicted pose prior in per-frame tracking once the IMU is
    # initialized (PoseInertialOptimizationLastKeyFrame analog,
    # Optimizer.cc:6697): 1σ trust region of the dead-reckoned prediction
    imu_prior_sigma_rot: float = 0.02    # rad over one inter-KF window
    imu_prior_sigma_trans: float = 0.02  # m over one inter-KF window
    # full per-frame VI state optimization with a marginalized prior chain
    # (PoseInertialOptimizationLastKeyFrame/LastFrame + ConstraintPoseImu,
    # Optimizer.cc:6697,7092) refining the fused tracker's pose each frame;
    # off falls back to the pose-prior-only fusion above
    use_frame_vio: bool = True
    # frames whose decision scalars (inlier counts) are fetched from the
    # device with ONE batched readback; decisions lag by up to 2×batch
    # frames. 1 = synchronous per-frame decisions (lowest recovery latency,
    # slowest through a remote device tunnel).
    decision_batch: int = 4


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static array capacities for jitted state. Everything is masked."""

    max_kps_per_level: int = 512      # post-selection budget per pyramid level
    max_features: int = 1536          # per image after concat over levels
    max_landmarks: int = 32768        # per map
    max_keyframes: int = 512          # per map
    max_local_kfs: int = 32           # local BA window
    max_local_landmarks: int = 4096   # landmarks in local window
    max_obs_per_landmark: int = 32
    max_imu_per_frame: int = 64       # IMU samples between frames
    max_maps: int = 8                 # Atlas capacity
    vocab_branching: int = 10
    vocab_depth: int = 4              # 10^4 = 10k words


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    sensor: int = SensorType.STEREO
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    camera2: Optional[CameraConfig] = None   # right camera for fisheye stereo
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    imu: IMUConfig = dataclasses.field(default_factory=IMUConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)

    @property
    def is_inertial(self) -> bool:
        return SensorType.is_inertial(self.sensor)

    @property
    def is_stereo(self) -> bool:
        return SensorType.is_stereo(self.sensor)


def euroc_stereo_config(**overrides) -> SLAMConfig:
    """EuRoC stereo defaults mirroring ``Examples/Stereo-Inertial/EuRoC.yaml``."""
    return SLAMConfig(sensor=SensorType.STEREO, **overrides)
