"""One frame of each engine, assembled from the copied plain stages.

The engines' frame steps (`LoamEngine`'s LiDAR frame, `VloamEngine`'s
vision + LiDAR frame, `BatchLoamEngine`'s streams) split into the stages
that `check.py` runs one at a time from a run's own rows: the features of a
range image, LO from a seed, the LO world pose, the map's prediction, the
scan-to-map solve, the map's insert, and VO between two camera views.

`precision` is "float32" (the configurations' precision: the reference) or
"bfloat16" (the control: every point cloud and image held in bfloat16, the
step a later change to the clouds' or the map's storage would take).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import so3
from .lidar.mapping import GridMap, map_update, solve_mapping
from .lidar.odometry import solve_lo
from .lidar.ring_assoc import RingSlab
from .lidar.scan_registration import (_features_from_layout,
                                      polar_directions, polar_layout,
                                      ray_directions, ring_labels)
from .lidar.voxel import reciprocal_f32, voxel_downsample
from .vision import features
from .vision.depth_map import build_depth_grid
from .vision.vo import solve_vo

PRECISIONS = ("float32", "bfloat16")


def held(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as a cloud or image held in `precision` (and computed on in
    float32)."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    raise ValueError(f"unknown precision {precision!r}")


class Sensor(NamedTuple):
    """The ray geometry of a range image: every ray for scan registration,
    and the forward columns the camera's depth grid decodes."""

    dirs: torch.Tensor  # [S, A, 3]
    fov_dirs: torch.Tensor  # [S, A', 3]
    half: int  # the first and last `half` columns; 0 = every column

    @staticmethod
    def create(elevations_deg, n_azimuth: int, fov_fraction: float,
               device) -> "Sensor":
        elev = np.radians(np.asarray(elevations_deg)).astype(np.float32)
        A = n_azimuth
        half = min(A, max(1, int(round(A * min(max(fov_fraction, 0.0), 1.0)
                                       / 2.0))))
        az = -(np.arange(A, dtype=np.float32) * np.float32(2.0 * math.pi / A))
        if 2 * half < A:
            az = np.concatenate([az[:half], az[A - half:]])
        else:
            half = 0
        return Sensor(polar_directions(elev, A, device),
                      ray_directions(elev, az, device), half)

    def fov_columns(self, r_img: torch.Tensor) -> torch.Tensor:
        if self.half == 0:
            return r_img
        A = r_img.shape[1]
        return torch.cat([r_img[:, :self.half], r_img[:, A - self.half:]],
                         dim=1)


class Camera(NamedTuple):
    """The rig's extrinsics as quaternion poses, the inverse intrinsics and
    the velodyne -> image projection, on the device."""

    q_base_cam: torch.Tensor
    t_base_cam: torch.Tensor
    q_velo_cam: torch.Tensor
    t_velo_cam: torch.Tensor
    Kinv: torch.Tensor
    P_velo_to_img: torch.Tensor

    @staticmethod
    def create(K, P_velo_to_img, imu_T_velo, imu_T_cam0, device) -> "Camera":
        from scipy.spatial.transform import Rotation

        base_T_cam = np.asarray(imu_T_cam0, np.float64)
        velo_T_cam = np.linalg.inv(np.asarray(imu_T_velo, np.float64)) \
            @ base_T_cam

        def t(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=device)

        return Camera(
            q_base_cam=t(Rotation.from_matrix(base_T_cam[:3, :3]).as_quat()),
            t_base_cam=t(base_T_cam[:3, 3]),
            q_velo_cam=t(Rotation.from_matrix(velo_T_cam[:3, :3]).as_quat()),
            t_velo_cam=t(velo_T_cam[:3, 3]),
            Kinv=t(np.linalg.inv(np.asarray(K, np.float32))),
            P_velo_to_img=t(P_velo_to_img))


# ---- LiDAR ------------------------------------------------------------------

def lidar_features(r_imgs: torch.Tensor, sensor: Sensor, cfg, scale: float,
                   precision: str = "float32") -> list:
    """Scan registration of range images [F, S, A] (integer units of
    `scale` metres, 0 = no return): each frame's ScanFeatures. The rings
    of all F frames go through the curvature and the sector selection in
    one call (ring_labels: each frame's labels bit for bit)."""
    F_, S, A = r_imgs.shape
    layouts = [polar_layout(r, sensor.dirs, cfg.lidar, scale)
               for r in r_imgs]
    pts = torch.cat([held(p, precision) for p, _, _ in layouts])
    counts = torch.cat([c for _, _, c in layouts])
    labels = ring_labels(pts, counts, cfg.scanreg).reshape(F_, S, -1)
    return [_features_from_layout(pts[f * S:(f + 1) * S], rt, c,
                                  cfg.scanreg, labels[f])
            for f, (_, rt, c) in enumerate(layouts)]


def empty_features(cfg, device):
    """The 'last' slabs before the first frame: every slot SENTINEL."""
    S, sr = cfg.lidar.n_scans, cfg.scanreg
    return (RingSlab.empty(S, sr.less_sharp_cap // S, device),
            RingSlab.empty(S, sr.less_flat_cap // S, device))


def map_stacks(feats, cfg):
    """The two voxel-downsampled mapping stacks (c_xyz, c_m, s_xyz, s_m)."""
    m = cfg.mapping
    c_xyz, _, _, c_m = voxel_downsample(feats.less_sharp.xyz,
                                        feats.less_sharp.mask,
                                        m.line_resolution, m.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(feats.less_flat.xyz,
                                        feats.less_flat.mask,
                                        m.plane_resolution, m.surf_stack_cap)
    return c_xyz, c_m, s_xyz, s_m


def lo_f2f(feats, last_slabs, q0, t0, initialized: bool, cfg):
    """LO of a frame against the last frame's slabs from the seed (q0, t0):
    (q, t, n_corner, n_surf); the first frame gives the identity and no
    correspondences."""
    q, t, n_c, n_s = solve_lo(feats.sharp, feats.flat, last_slabs[0],
                              last_slabs[1], q0, t0, cfg.lo)
    if not initialized:
        return (so3.identity_quat(q.device), torch.zeros_like(t),
                torch.zeros_like(n_c), torch.zeros_like(n_s))
    return q, t, n_c, n_s


def compose(q1, t1, q2, t2):
    """(q1, t1) * (q2, t2), the quaternion normalized."""
    return (so3.quat_normalize(so3.quat_multiply(q1, q2)),
            t1 + so3.quat_rotate(q1, t2))


def map_offset(q_m, t_m, q_w, t_w):
    """The odom -> map offset after a mapped frame (transformUpdate)."""
    q_off = so3.quat_normalize(so3.quat_multiply(q_m, so3.quat_conjugate(q_w)))
    return q_off, t_m - so3.quat_rotate(q_off, t_w)


def mo_refine(gmap: GridMap, stacks, q_pred, t_pred, cfg):
    """The scan-to-map solve of one frame's stacks from the prediction."""
    _, q_m, t_m, _ = solve_mapping(gmap, *stacks, q_pred, t_pred,
                                   cfg.mapping)
    return q_m, t_m


def map_insert(gmap: GridMap, stacks, q_m, t_m, cfg,
               streams: int = 0) -> GridMap:
    """The map after a frame's stacks are inserted at the pose (q_m, t_m);
    streams > 0: a stream's map of the lockstep engine with that many
    streams (its points stored in fixed point, mapping.fixed_point)."""
    return map_update(gmap, *stacks, q_m, t_m, cfg.mapping, streams)


def new_map(cfg, device) -> GridMap:
    return GridMap.create(cfg.mapping, device)


# ---- vision -----------------------------------------------------------------

class View(NamedTuple):
    """A frame's camera state: keypoints, descriptors, the depth grid of its
    LiDAR points."""

    xy: torch.Tensor
    kp_mask: torch.Tensor
    desc: torch.Tensor
    grid: object


def _check_vo_options(vo):
    """The reference follows the engines' one VO path: Shi-Tomasi keypoints
    refined to subpixel, ZNCC descriptors, a brute-force ratio-test matcher;
    no CLAHE, bucket NMS, LK flow, low-texture fallback, identity resets or
    depth-spread gate."""
    if (vo.detector != "shi_tomasi" or vo.descriptor != "zncc"
            or vo.matcher != "bf" or vo.match_select != "knn"
            or not vo.subpixel or vo.clahe or vo.keypoint_nms
            or vo.optical_flow_match or vo.lowtex_fallback
            or vo.reset_VO_to_identity or vo.max_depth_spread > 0):
        raise ValueError("the reference follows the VO path of Shi-Tomasi "
                         "keypoints, ZNCC descriptors and a brute-force "
                         "ratio-test matcher, with no other VO option")


def camera_view(image_u8: torch.Tensor, r_img: torch.Tensor, sensor: Sensor,
                camera: Camera, cfg, scale: float,
                precision: str = "float32") -> View:
    """Detect, describe and build the depth grid of one frame's image
    [H, W] uint8 and range image."""
    vo = cfg.vo
    _check_vo_options(vo)
    img = held(image_u8.to(torch.float32) * reciprocal_f32(255.0), precision)
    xy, _, kp_mask = features.detect_keypoints(img, vo)
    desc = features.zncc_describe(img, xy, vo.descriptor_patch)
    r = sensor.fov_columns(r_img).to(torch.float32) * scale
    scan = held((sensor.fov_dirs * r[..., None]).reshape(-1, 3), precision)
    in_mask = torch.ones(scan.shape[0], dtype=torch.bool, device=scan.device)
    return View(xy, kp_mask, desc,
                build_depth_grid(scan, in_mask, camera.P_velo_to_img, vo))


def _invert(q, t):
    qi = so3.quat_conjugate(q)
    return qi, -so3.quat_rotate(qi, t)


def _conjugate(q_a, t_a, q_x, t_x):
    """a^-1 * x * a."""
    qa_i, ta_i = _invert(q_a, t_a)
    return compose(*compose(qa_i, ta_i, q_x, t_x), q_a, t_a)


def vo_solve(prev: View, view: View, q_f2f_prev, t_f2f_prev,
             initialized: bool, camera: Camera, cfg):
    """VO between two views seeded from the last LO f2f, as the combined
    engine's frame: (LO seed q, t, vo_ok, vo row [9] = q_vo, t_vo, n32,
    n22)."""
    vo = cfg.vo
    dev = q_f2f_prev.device
    q_lo_i, t_lo_i = _invert(q_f2f_prev, t_f2f_prev)
    q_seed, t_seed = _conjugate(camera.q_base_cam, camera.t_base_cam, q_lo_i,
                                t_lo_i)
    a_seed = so3.axis_angle_from_quat(q_seed)
    idx1, valid = features.match_descriptors(
        prev.desc, prev.kp_mask, view.desc, view.kp_mask, vo.match_ratio)
    curr_uv = torch.index_select(view.xy, 0, idx1)
    valid = valid & initialized
    angles, t_vo, n32, n22 = solve_vo(prev.xy, curr_uv, valid, prev.grid,
                                      camera.Kinv, a_seed, t_seed, vo)
    q_vo = so3.quat_from_axis_angle(angles)
    vo_ok = (initialized & torch.all(torch.isfinite(angles))
             & torch.all(torch.isfinite(t_vo))
             & (n32 + n22 >= vo.min_vo_matches))
    q_vo = torch.where(vo_ok, q_vo, so3.identity_quat(dev))
    t_vo = torch.where(vo_ok, t_vo, 0.0)
    q_vo_i, t_vo_i = _invert(q_vo, t_vo)
    qv_i, tv_i = _invert(camera.q_velo_cam, camera.t_velo_cam)
    q_pr, t_pr = _conjugate(qv_i, tv_i, q_vo_i, t_vo_i)
    row = torch.cat([q_vo, t_vo, torch.stack([n32, n22]).to(torch.float32)])
    return q_pr, t_pr, vo_ok, row
