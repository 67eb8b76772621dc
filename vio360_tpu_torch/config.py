"""Configuration of the port: frozen dataclasses + the YAML loader.

The port's own copy of ``vio360_tpu/config.py`` (which is free of JAX,
but the port imports nothing of the JAX package), trimmed to what the
port reads. Every field it keeps has the reference's name and default,
so a configuration carries over field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 960
    height: int = 480
    polar_exclusion_ratio: float = 0.15
    boundary_margin: float = 20.0


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    max_features: int = 1000
    quality_level: float = 0.01
    min_distance: float = 30.0
    grid_cols: int = 20
    grid_rows: int = 10
    max_features_per_grid: int = 10
    capacity: int = 1024  # padded slot count


@dataclasses.dataclass(frozen=True)
class OpticalFlowConfig:
    window_size: int = 21
    max_level: int = 3
    max_iterations: int = 30
    epsilon: float = 0.01
    # "matmul": the matmul-gather LK (ops/lk_matmul.py, kernel K5);
    # "auto" / "pallas" / "xla": the per-feature LK (kernel K4).
    backend: str = "auto"
    use_rotation_guess: bool = True
    # with a gyro-propagated guess, drop the top pyramid level
    guess_skips_top_level: bool = True
    photometric_compensation: bool = True


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    max_iterations: int = 1000
    threshold_degrees: float = 2.0


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    min_parallax_for_keyframe: float = 10.0
    kf_min_inlier_ratio: float = 0.5


@dataclasses.dataclass(frozen=True)
class InitializationConfig:
    window_size: int = 10
    min_parallax: float = 10.0
    min_features: int = 100
    min_observations: int = 10
    grid_cols: int = 8
    grid_rows: int = 4
    max_per_cell: int = 5
    ransac_threshold: float = 0.1
    ransac_iterations: int = 200
    max_reprojection_error: float = 5.0


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    max_keyframes: int = 10
    max_landmarks: int = 2048
    huber_delta: float = 1.0
    chi2_threshold: float = 5.991
    pnp_rounds: int = 4
    pnp_min_inliers: int = 10
    max_lm_iterations: int = 50
    viba_max_iterations: int = 20
    viba_inertial_weight: float = 1.0
    viba_bg_prior_weight: float = 50.0
    viba_ba_prior_weight: float = 50.0
    max_scale_refines: int = 12


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Keyframe pose graph over evicted-window constraints
    (solver/pose_graph.py). Edge weights are diagonal sqrt-information;
    with ``cov_weighted`` they are derived per edge (solver/marginals.py),
    else the ``*_weight_*`` constants below are used."""
    enabled: bool = True
    cov_weighted: bool = True
    # covariance floors (m, rad): keep derived weights finite
    min_sigma_t: float = 1e-3
    min_sigma_r: float = 5e-4
    # velocity-estimate uncertainty entering IMU edges through v0 dt (m/s)
    imu_vel_sigma: float = 0.05
    # fallback sqrt-info for (translation m, rotation rad) components
    vis_weight_t: float = 20.0
    vis_weight_r: float = 100.0
    skip_weight_t: float = 10.0
    skip_weight_r: float = 50.0
    imu_weight_t: float = 4.0
    imu_weight_r: float = 40.0
    max_iterations: int = 50
    # Sim(3) mode (monocular VO graphs with loop edges): per-edge sigma of
    # the scale residual; loop edges leave scale nearly free
    sim3_odom_scale_sigma: float = 0.05
    sim3_loop_scale_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Appearance-based loop closure + relocalization (loop/closure.py)."""
    enabled: bool = True
    db_capacity: int = 256  # keyframe place database (ring buffer)
    # ring descriptor: latitude bands x longitude bins, dividing H and W
    desc_bands: int = 16
    desc_bins: int = 64
    patch_size: int = 8  # NCC patch side (pixels, at the coarse level)
    patch_pyr_levels: int = 2  # pyramid levels before patch extraction
    # retrieval gates on the verified candidate's correlation score
    min_score: float = 0.20
    reloc_min_score: float = 0.15
    verify_top_k: int = 4  # candidates patch-matched + PnP-verified
    # candidates younger than this many keyframes are not loops
    exclude_recent_kf: int = 30
    match_min_ncc: float = 0.60
    match_min_margin: float = 0.02
    min_matches: int = 20
    min_inliers: int = 25
    # a "loop" implying a larger jump is a mismatch
    max_rot_correction_deg: float = 30.0
    max_trans_correction: float = 5.0
    # live rigid corrections only above these floors, strongly verified
    # and rate-limited
    min_trans_correction: float = 0.15
    min_rot_correction_deg: float = 5.0
    apply_inlier_factor: float = 2.0  # x min_inliers to apply
    correction_cooldown_kf: int = 10
    # loop-edge sqrt-information
    edge_weight_t: float = 400.0
    edge_weight_r: float = 1500.0
    # relocalization: consecutive tracking_lost frames before querying
    reloc_after: int = 5


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    mesh: str = ""
    fused_keyframe: bool = True
    image_transport: str = "u8"  # "u8" | "u16" | "f32" wire dtype of the frame upload
    frames_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    frequency: float = 200.0
    gyro_noise: float = 0.001
    accel_noise: float = 0.01
    gyro_bias_noise: float = 0.0001
    accel_bias_noise: float = 0.001
    gravity_magnitude: float = 9.81
    min_dt: float = 0.0005
    max_dt: float = 0.02
    max_samples_per_frame: int = 64
    max_samples_per_keyframe: int = 512
    # IMU-init quality gates: stage-1 cost per keyframe pair, and the
    # split-half gravity agreement
    init_max_cost_per_pair: float = 1e-4
    init_max_gravity_split_deg: float = 10.0


@dataclasses.dataclass(frozen=True)
class VisualizationConfig:
    # read by the tracker: clustered-cell removal
    highlight_clustered_grid: bool = True
    clustered_std_ratio: float = 0.25


@dataclasses.dataclass(frozen=True)
class VioConfig:
    camera: CameraConfig = CameraConfig()
    features: FeatureConfig = FeatureConfig()
    optical_flow: OpticalFlowConfig = OpticalFlowConfig()
    ransac: RansacConfig = RansacConfig()
    tracking: TrackingConfig = TrackingConfig()
    init: InitializationConfig = InitializationConfig()
    window: WindowConfig = WindowConfig()
    solver: SolverConfig = SolverConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    loop: LoopConfig = LoopConfig()
    imu: ImuConfig = ImuConfig()
    viz: VisualizationConfig = VisualizationConfig()
    # T_BC camera-to-body extrinsics, 4x4 row-major
    t_bc: tuple = (
        (1.0, 0.0, 0.0, 0.0),
        (0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, 1.0, 0.0),
        (0.0, 0.0, 0.0, 1.0),
    )

    def t_bc_array(self) -> np.ndarray:
        return np.asarray(self.t_bc, dtype=np.float32)


def _get(d: dict, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def load_yaml(path: str) -> VioConfig:
    """Ingest a reference-format YAML config (OpenCV ``%YAML:1.0`` header
    allowed). Absent values keep the defaults; as in the reference, the
    ``optical_flow`` / ``ransac`` sections are not read."""
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    data: dict[str, Any] = yaml.safe_load("\n".join(lines)) or {}

    cam = CameraConfig(
        width=_get(data, "camera", "width", default=960),
        height=_get(data, "camera", "height", default=480),
        polar_exclusion_ratio=_get(data, "camera", "polar_exclusion_ratio", default=0.15),
        boundary_margin=_get(data, "camera", "boundary_margin", default=20.0),
    )
    max_features = _get(data, "feature_detection", "max_features", default=1000)
    feats = FeatureConfig(
        max_features=max_features,
        quality_level=_get(data, "feature_detection", "quality_level", default=0.01),
        min_distance=_get(data, "feature_detection", "min_distance", default=30.0),
        grid_cols=_get(data, "feature_detection", "grid_cols", default=20),
        grid_rows=_get(data, "feature_detection", "grid_rows", default=10),
        max_features_per_grid=_get(data, "feature_detection", "max_features_per_grid", default=10),
        capacity=-(-max_features // 128) * 128,
    )
    tracking = TrackingConfig(
        min_parallax_for_keyframe=_get(data, "tracking", "min_parallax_for_keyframe", default=10.0),
    )
    init = InitializationConfig(
        window_size=_get(data, "initialization", "window_size", default=10),
        min_parallax=_get(data, "initialization", "min_parallax", default=10.0),
        min_features=_get(data, "initialization", "min_features", default=100),
        min_observations=_get(data, "initialization", "min_observations", default=10),
        ransac_threshold=_get(data, "initialization", "ransac_threshold", default=0.1),
        ransac_iterations=_get(data, "initialization", "ransac_iterations", default=200),
        max_reprojection_error=_get(data, "initialization", "max_reprojection_error", default=5.0),
    )
    imu = ImuConfig(
        frequency=_get(data, "imu", "frequency", default=200.0),
        gyro_noise=_get(data, "imu", "gyro_noise", default=0.001),
        accel_noise=_get(data, "imu", "accel_noise", default=0.01),
        gyro_bias_noise=_get(data, "imu", "gyro_bias_noise", default=0.0001),
        accel_bias_noise=_get(data, "imu", "accel_bias_noise", default=0.001),
    )
    viz = VisualizationConfig(
        highlight_clustered_grid=bool(_get(data, "visualization", "highlight_clustered_grid", default=1)),
        clustered_std_ratio=_get(data, "visualization", "clustered_std_ratio", default=0.25),
    )
    t_bc_raw = _get(data, "extrinsics", "T_BC")
    t_bc = (tuple(tuple(float(x) for x in row) for row in t_bc_raw) if t_bc_raw is not None
            else VioConfig.t_bc)
    return VioConfig(camera=cam, features=feats, tracking=tracking, init=init, imu=imu, viz=viz,
                     t_bc=t_bc, loop=fit_loop_config(LoopConfig(), cam))


def fit_loop_config(loop: LoopConfig, cam: CameraConfig) -> LoopConfig:
    """Snap the ring-descriptor grid to divisors of the image size (the
    pooled reshape in loop/descriptor.py needs exact tiling)."""

    def best_divisor(n: int, target: int) -> int:
        for d in range(target, 0, -1):
            if n % d == 0:
                return d
        return 1

    bands = best_divisor(cam.height, loop.desc_bands)
    bins = best_divisor(cam.width, loop.desc_bins)
    if bands == loop.desc_bands and bins == loop.desc_bins:
        return loop
    return dataclasses.replace(loop, desc_bands=bands, desc_bins=bins)
