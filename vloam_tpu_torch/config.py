"""Configuration of the ported paths: the fields of vloam_tpu/config.py that
the port reads (the LiDAR sections, the visual odometry section, the sensor
profiles and the pipeline's flags), with the same names and defaults (the
port's own copy, so that the port and its smoke run import nothing of the
JAX package).

Algorithm parameters follow the reference launch file
(src/lidar_odometry_mapping/launch/loam_velodyne_HDL_64_kitti.launch:3-16)
and the constants hard-coded in the reference sources; the caps give every
ragged structure a static padded shape. Any object with these attribute
names works as a config: the tests pass the JAX package's dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LidarProfile:
    """Sensor geometry (reference scan_registration.cpp:195-226)."""

    name: str = "HDL-64"
    n_scans: int = 64
    minimum_range: float = 5.0  # loam_velodyne_HDL_64_kitti.launch:14
    # static caps: points per ring after padding, total input cap
    max_points: int = 131072
    ring_capacity: int = 2560


# the reference's launch variants loam_velodyne_{HDL_64,HDL_32,VLP_16}
HDL64_KITTI = LidarProfile()
HDL32 = LidarProfile(name="HDL-32", n_scans=32, minimum_range=0.1)
VLP16 = LidarProfile(name="VLP-16", n_scans=16, minimum_range=0.3)


@dataclass(frozen=True)
class ScanRegistrationConfig:
    """Feature extraction (reference scan_registration.cpp:288-440)."""

    n_sectors: int = 6
    curvature_threshold: float = 0.1  # sharp/flat split (":332,:385")
    max_sharp_per_sector: int = 2
    max_less_sharp_per_sector: int = 20
    max_flat_per_sector: int = 4
    neighbor_suppress_gap_sq: float = 0.05  # ":358"
    less_flat_leaf: float = 0.2  # VoxelGrid leaf (":436")
    # True: the reference's sequential sector order (kernel K1). False (the
    # simultaneous-sector variant of the JAX package) is not ported yet.
    strict_sector_order: bool = True
    # sharp/flat caps are exact upper bounds (n_scans * n_sectors * picks);
    # less_sharp's per-ring slice (8192/64 = 128) is 4 short of the 132
    # theoretical maximum, a rare-frame tail truncation
    sharp_cap: int = 768
    less_sharp_cap: int = 8192
    flat_cap: int = 1536
    less_flat_cap: int = 32768


@dataclass(frozen=True)
class LaserOdometryConfig:
    """Frame-to-frame scan matching (reference laser_odometry.cpp)."""

    outer_rounds: int = 2  # ":211"
    gn_iterations: int = 4  # ceres max_num_iterations (":460")
    distance_sq_threshold: float = 25.0  # laser_odometry.h:94
    nearby_scan: float = 2.5  # laser_odometry.h:95
    huber_delta: float = 0.1  # ":217"
    distortion: bool = False  # laser_odometry.h:90 (KITTI clouds pre-deskewed)
    mapping_skip_frame: int = 1  # launch:6
    # warn when corner + surf correspondences fall below this after the
    # final round (reference "less correspondence!", laser_odometry.cpp:452)
    min_correspondences: int = 10


@dataclass(frozen=True)
class LaserMappingConfig:
    """Scan-to-map refinement (reference laser_mapping.cpp)."""

    cube_size: float = 50.0  # laser_mapping.h:110-114
    cube_width: int = 21
    cube_height: int = 21
    cube_depth: int = 11
    line_resolution: float = 0.4  # launch:15
    plane_resolution: float = 0.8  # launch:16
    outer_rounds: int = 2  # ":458"
    gn_iterations: int = 4  # ":612"
    huber_delta: float = 0.1
    neighbor_radius_sq: float = 1.0  # 5-NN gate (":479,:547")
    eigen_ratio: float = 3.0  # line test lambda2 > 3 lambda1 (":506")
    plane_fit_tolerance: float = 0.2  # ":568"
    edge_half_length: float = 0.1  # synthetic edge points (":510-511")
    min_corner_map_points: int = 10  # ":448"
    min_surf_map_points: int = 50
    # caps of the per-frame voxel-downsampled stacks (:432-440)
    corner_stack_cap: int = 2048
    surf_stack_cap: int = 6144
    knn: int = 5
    # publish the accumulated map every N frames (reference map_pub_number,
    # laser_mapping.cpp:778-793), read by the engines' map_callback
    map_pub_number: int = 20
    # hashed cell-slab map (gridmap.py): cells are integer multiples of the
    # matching resolution and >= 2 * sqrt(neighbor_radius_sq); overfull
    # buckets drop new points
    map_n_buckets: int = 1 << 17
    corner_cell: float = 2.0
    surf_cell: float = 2.4
    corner_bucket_cap: int = 32
    surf_bucket_cap: int = 16


@dataclass(frozen=True)
class VisualOdometryConfig:
    """DEMO-style depth-enhanced VO (reference visual_odometry.cpp,
    image_util.cpp, point_cloud_util.cpp)."""

    img_width: int = 1242
    img_height: int = 375
    detector: str = "shi_tomasi"  # | fast | orb | brisk | sift | akaze
    descriptor: str = "zncc"  # | orb
    matcher: str = "bf"  # | flann
    match_select: str = "knn"  # ratio test | nn (best match only)
    fast_threshold: float = 100.0 / 255.0  # image_util.cpp:39
    max_keypoints: int = 2048
    shi_tomasi_block: int = 5  # image_util.cpp:15
    shi_tomasi_quality: float = 0.01
    shi_tomasi_min_distance: float = 7.5  # block * 1.5 (image_util.cpp:18)
    match_ratio: float = 0.8  # KNN ratio test (image_util.cpp:278)
    descriptor_patch: int = 24  # ZNCC patch side (kernel K3)
    optical_flow_match: bool = False  # vloam_main.launch:10
    flow_window: int = 15
    flow_levels: int = 3
    flow_iterations: int = 10
    remove_VO_outlier: float = 100.0  # px gate, vloam_main.launch:6
    reset_VO_to_identity: bool = False  # vloam_main.launch:5
    clahe: bool = False  # vloam_main.launch:8
    keypoint_nms: bool = False  # vloam_main.launch:7
    nms_bucket: int = 100
    nms_max_total: int = 400
    downsample_grid_size: int = 5  # point_cloud_util.h:26
    depth_search_radius: int = 2  # point_cloud_util.h:35
    min_depth_neighbors: int = 10  # point_cloud_util.cpp:337
    # reject depth queries whose 3 nearest buckets span more than this many
    # metres (0 = the reference's behaviour)
    max_depth_spread: float = 0.0
    min_depth: float = 0.1  # projection front filter
    huber_delta: float = 0.05
    max_iterations: int = 24  # VO LM iterations per frame
    max_matches: int = 2048
    # a VO solve with fewer matches does not seed LO
    min_vo_matches: int = 20
    lowtex_fallback: bool = False
    # polar ingest: the forward fraction of azimuth columns decoded for the
    # camera depth grid (1/3 = +-60 deg; the KITTI camera's half-FOV is ~41)
    polar_fov_fraction: float = 1.0 / 3.0
    # quadratic-peak subpixel corners, kept in the VO residuals; False is the
    # reference's int-truncation quirk (visual_odometry.cpp:283-307)
    subpixel: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """The engines' and the host layer's configuration tree."""

    # True: VO and LO run side by side; False: each LO solve is seeded from
    # the same frame's VO (reference vloam_main.launch:4)
    detach_VO_LO: bool = True
    save_traj: bool = True  # write {VO,LO,MO}<d>.txt (run_sequence_fused)
    verbose_level: int = 0
    lidar: LidarProfile = field(default_factory=lambda: HDL64_KITTI)
    scanreg: ScanRegistrationConfig = field(
        default_factory=ScanRegistrationConfig)
    lo: LaserOdometryConfig = field(default_factory=LaserOdometryConfig)
    mapping: LaserMappingConfig = field(default_factory=LaserMappingConfig)
    vo: VisualOdometryConfig = field(default_factory=VisualOdometryConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def kitti_hdl64() -> PipelineConfig:
    """The KITTI HDL-64 profile at full width."""
    return PipelineConfig()


def reference_exact() -> PipelineConfig:
    """The KITTI profile with the accuracy-motivated VO defaults rolled back
    to the reference's values (vloam_tpu/config.py:240-265): 1024
    keypoints at quality 0.03, Huber 0.1, a 16 px ZNCC patch and the
    int-truncation quirk."""
    return PipelineConfig(
        vo=VisualOdometryConfig(
            max_keypoints=1024,
            shi_tomasi_quality=0.03,
            huber_delta=0.1,
            descriptor_patch=16,
            subpixel=False,
        ),
    )


def tiny_test_profile() -> PipelineConfig:
    """Small shapes for fast unit tests."""
    return PipelineConfig(
        lidar=LidarProfile(name="tiny", n_scans=16, minimum_range=0.5,
                           max_points=8192, ring_capacity=512),
        scanreg=ScanRegistrationConfig(sharp_cap=256, less_sharp_cap=2048,
                                       flat_cap=512, less_flat_cap=4096),
        mapping=LaserMappingConfig(cube_width=11, cube_height=11, cube_depth=5,
                                   map_n_buckets=1 << 13,
                                   corner_bucket_cap=16, surf_bucket_cap=16,
                                   corner_stack_cap=1024, surf_stack_cap=2048),
        vo=VisualOdometryConfig(img_width=320, img_height=96, max_keypoints=256,
                                max_matches=512),
    )
