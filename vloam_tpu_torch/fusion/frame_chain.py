"""Frame chain / fusion bus, the VloamTF equivalent (the port's copy of
vloam_tpu/fusion/frame_chain.py, tested equal to it).

Reimplements reference src/vloam_tf/src/vloam_tf.cpp: the static extrinsic
chain, the three world-pose accumulators (VO / LO / MO), the VO->LO and
LO->VO coupling transforms, and the KITTI-format export re-based to the cam0
start frame. All host-side float64 numpy (4x4 homogeneous matrices): this
is bookkeeping, not compute.

Reference quirk preserved: the LO frame-to-frame estimate is computed in the
velodyne frame but assigned to base_prev_LOT_base_curr directly
(laser_odometry.cpp:563-567); mirrored so exported trajectories match.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R

# the vehicle base frame is the IMU frame (FrameChain's default base_T_imu)
BASE_T_IMU = np.eye(4)


def base_T_cam0(imu_T_cam0: np.ndarray) -> np.ndarray:
    """base_T_cam0 = base_T_imu @ imu_T_cam0 (vloam_tf.cpp:55-56)."""
    return BASE_T_IMU @ np.asarray(imu_T_cam0, np.float64)


def make_T(rot: np.ndarray | None = None, t: np.ndarray | None = None) -> np.ndarray:
    T = np.eye(4)
    if rot is not None:
        T[:3, :3] = rot
    if t is not None:
        T[:3, 3] = t
    return T


def from_qt(q, t) -> np.ndarray:
    return make_T(R.from_quat(np.asarray(q)).as_matrix(), np.asarray(t))


def inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


class FrameChain:
    """Holds extrinsics + odometry accumulators (vloam_tf.h:14-51)."""

    def __init__(self, imu_T_velo: np.ndarray, imu_T_cam0: np.ndarray,
                 base_T_imu: np.ndarray | None = None):
        self.imu_T_velo = imu_T_velo
        self.imu_T_cam0 = imu_T_cam0
        self.base_T_imu = np.eye(4) if base_T_imu is None else base_T_imu
        # derived (vloam_tf.cpp:55-56)
        self.base_T_cam0 = self.base_T_imu @ imu_T_cam0
        self.velo_T_cam0 = inv(imu_T_velo) @ imu_T_cam0

        self.world_VOT_base_last = np.eye(4)
        self.world_LOT_base_last = np.eye(4)
        self.world_MOT_base_last = np.eye(4)
        self.velo_last_VOT_velo_curr = np.eye(4)
        self.cam0_curr_LOT_cam0_prev = np.eye(4)
        self._starts = {}

    # ---- VO side (vloam_tf.cpp:59-75) ----
    def vo_update(self, cam0_curr_T_cam0_last: np.ndarray):
        """Convert f2f camera VO to velo/base frames and integrate world."""
        c = cam0_curr_T_cam0_last
        self.velo_last_VOT_velo_curr = (
            self.velo_T_cam0 @ inv(c) @ inv(self.velo_T_cam0)
        )
        base_last_VOT_base_curr = self.base_T_cam0 @ inv(c) @ inv(self.base_T_cam0)
        if np.all(np.isfinite(base_last_VOT_base_curr)):
            self.world_VOT_base_last = self.world_VOT_base_last @ base_last_VOT_base_curr

    def lo_prior(self):
        """(q, t) seed for LO in the velodyne frame (laser_odometry.cpp:
        223-236): velo_last_VOT_velo_curr."""
        T = self.velo_last_VOT_velo_curr
        return R.from_matrix(T[:3, :3]).as_quat(), T[:3, 3].copy()

    # ---- LO side (laser_odometry.cpp publish(), :563-571) ----
    def lo_update(self, q_f2f, t_f2f, q_w, t_w):
        base_prev_LOT_base_curr = from_qt(q_f2f, t_f2f)
        self.cam0_curr_LOT_cam0_prev = (
            inv(self.base_T_cam0) @ inv(base_prev_LOT_base_curr) @ self.base_T_cam0
        )
        self.world_LOT_base_last = from_qt(q_w, t_w)

    def vo_prior(self):
        """(angle-axis, t) seed for VO (visual_odometry.cpp:269-281):
        cam0_curr_LOT_cam0_prev."""
        T = self.cam0_curr_LOT_cam0_prev
        return R.from_matrix(T[:3, :3]).as_rotvec(), T[:3, 3].copy()

    # ---- MO side (laser_mapping.cpp:728-729) ----
    def mo_update(self, q_w, t_w):
        self.world_MOT_base_last = from_qt(q_w, t_w)

    # ---- export (vloam_tf.cpp:77-153) ----
    def to_cam0_start(self, which: str, count: int) -> np.ndarray | None:
        """Return the 3x4 cam0-start-frame pose for stream 'VO'|'LO'|'MO'."""
        if count < 0:
            return None
        world_T_base = {
            "VO": self.world_VOT_base_last,
            "LO": self.world_LOT_base_last,
            "MO": self.world_MOT_base_last,
        }[which]
        cam0_init_T_cam0_last = (
            inv(self.base_T_cam0) @ world_T_base @ self.base_T_cam0
        )
        if count == 0:
            self._starts[which] = cam0_init_T_cam0_last.copy()
        start = self._starts.get(which, np.eye(4))
        out = inv(start) @ cam0_init_T_cam0_last
        return out[:3, :]


def write_kitti_pose_line(fp, T34: np.ndarray):
    """KITTI 3x4 row-major format (vloam_tf.cpp:93-99)."""
    fp.write(" ".join(f"{v:f}" for v in T34.reshape(-1)) + "\n")
